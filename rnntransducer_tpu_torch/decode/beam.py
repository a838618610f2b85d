"""RNN-T beam search with improved pruning and LM shallow fusion (port of
``rnntransducer_tpu/decode/beam.py``).

The Graves A/B-set beam search with the "improved" pruning of
arXiv:1911.01629 (``state_beam`` early exit, ``expand_beam`` candidate
pruning), KenLM-style shallow fusion gated on completed words and hotword
boosting.  The prediction-net step, the joint and the log-softmax run as
one K-wide batched function on the device (:func:`predict_joint_rows`);
hypothesis management, LM scoring and the hotword trie are host work.

Scoring waves: when the popped best hypothesis has no cached scores, the
top ``wave_size`` unscored hypotheses in A (by search key, the pop order)
are scored in one padded device call (K padded to a power of two) and
brought back in one transfer.  Scoring is a pure function of (enc_t, last
token, prediction state), so prefetching leaves the search unchanged.

Reference quirks kept:

* expansions feed ``y_star[-1]`` (the last appended token) to the
  prediction network, not the last emitted one;
* the final ranking divides by ``len(y_star)``, which counts the blank seed;
* duplicate hypotheses are not merged (per-expansion scores);
* the cumulative completed-word LM score is read only at word boundaries:
  a mid-word hypothesis is keyed by its acoustic plus partial-token score,
  and a single-word utterance that never emits a delimiter reaches
  ``finalize(is_eos=True)`` with ``flag False``, its word scored by the
  partial-token score alone;
* a hypothesis ending in the delimiter scores its just-completed word with
  both the completed-hotword bonus and ``score_partial_token``.

Divergences from the reference kept as the JAX package has them:

* hypothesis texts decode with ``group_tokens=False`` (RNN-T emissions are
  real tokens, not CTC frame repeats);
* the no-LM hotword branch scores ``score_partial_token`` on the last
  (in-progress) word rather than the whole text;
* a missing ``current_text`` LM-cache entry falls back to the LM start
  state instead of raising ``KeyError``.
"""

from __future__ import annotations

import operator
from typing import Iterable, List, Optional

import numpy as np
import torch

from rnntransducer_tpu_torch.decode.greedy import _device, _encode
from rnntransducer_tpu_torch.decode.hotwords import DEFAULT_HOTWORD_WEIGHT, HotwordScorer
from rnntransducer_tpu_torch.models.cells import RNNState
from rnntransducer_tpu_torch.models.transducer import RNNTransducer
from rnntransducer_tpu_torch.utils.precision import match_param_dtype, param_dtype


def _zero_prednet_state(model: RNNTransducer):
    """Host (numpy) zero state: (h, c | None) of shape (L, 1, 1, H)."""
    cfg = model.cfg.prednet
    h = np.zeros((cfg.num_layers, 1, 1, cfg.hidden_size), np.float32)
    c = h if cfg.rnn_type.lower() == "lstm" else None
    return (h, c)


@torch.inference_mode()
def predict_joint_rows(model: RNNTransducer, enc_rows: torch.Tensor,
                       tokens: torch.Tensor, state: RNNState):
    """K-wide expansion scoring: one prediction-net step on ``tokens`` (K,)
    from ``state`` (batch K), the joint against ``enc_rows`` ((K, De), or
    (1, De) for one frame shared by every row) and ``log_softmax`` in fp32.
    Returns (log_probs (K, V) fp32, new_state)."""
    dt = param_dtype(model)
    state = RNNState(state.h.to(dt), None if state.c is None else state.c.to(dt))
    dec_out, new_state = model.predict_step(tokens, state)
    enc = match_param_dtype(model, enc_rows).expand(tokens.shape[0], -1)
    logits = model.joint_step(enc, dec_out)
    # fp32 scores: the host search accumulates them across frames
    return torch.log_softmax(logits.float(), dim=-1), new_state


class _Hyp:
    __slots__ = ("asr_score", "y_star", "state", "lm_score", "lm_state",
                 "cache")

    def __init__(self, asr_score, y_star, state, lm_score, lm_state,
                 cache=None):
        self.asr_score = asr_score
        self.y_star = y_star
        self.state = state      # (h, c | None) numpy, shapes (L, 1, 1, H)
        self.lm_score = lm_score
        self.lm_state = lm_state
        self.cache = cache      # (log_probs (V,), new_state) for this frame


class HostBeamSession:
    """Resumable A/B-set search state (see BeamSearchDecoder.open_session)."""
    __slots__ = ("B_hyps", "cached_lm", "cached_partial")

    def __init__(self, B_hyps, cached_lm, cached_partial):
        self.B_hyps = B_hyps
        self.cached_lm = cached_lm
        self.cached_partial = cached_partial


class BeamSearchDecoder:
    def __init__(self, model: RNNTransducer, blank_id: int = 0,
                 tokenizer=None, beam_width: int = 5, improved: bool = True,
                 state_beam: float = 4.6, expand_beam: float = 2.3,
                 lm=None, hotwords: Optional[Iterable[str]] = None,
                 hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
                 max_expansions_per_frame: int = 200,
                 length_norm_alpha: Optional[float] = None,
                 merge_duplicates: bool = False):
        """``length_norm_alpha``: rank the final n-best by ``score /
        max(emitted_len, 1)**alpha`` (seed blank excluded) instead of the
        reference's ``score / len(y_star)``; ``merge_duplicates``: combine
        identical-token-sequence hypotheses in B with logsumexp at each
        frame boundary (``decode/beam_batched.py``'s options)."""
        self.model = model
        self.blank_id = blank_id
        self.tokenizer = tokenizer
        self.beam_width = beam_width
        self.improved = improved
        self.state_beam = state_beam
        self.expand_beam = expand_beam
        self.length_norm_alpha = length_norm_alpha
        self.merge_duplicates = merge_duplicates
        self.lm = lm
        self.hotword_scorer = HotwordScorer.build_scorer(hotwords,
                                                         weight=hotword_weight)
        self.max_expansions = max_expansions_per_frame
        # per-wave device-call width: enough to cover several future pops
        self.wave_size = max(4 * beam_width, 16)
        self.max_live = max(64 * beam_width, 512)
        self._use_lm = lm is not None or bool(self.hotword_scorer)
        if self._use_lm and tokenizer is None:
            raise ValueError("LM/hotword fusion requires a tokenizer")
        if (lm is not None
                and getattr(tokenizer, "word_delimiter_token_id", None) is None):
            # word boundaries are the delimiter token; subword vocabularies
            # mark them inside pieces, which word-level fusion cannot see
            raise ValueError(
                "word-level LM fusion requires a word-delimiter tokenizer "
                "(grapheme vocab.json); for subword (BPE) vocabs use the "
                "on-device char LM (decode/device_lm.py) instead")
        # the search key: the fused score with LM / hotwords, else acoustic
        self._key = operator.attrgetter("lm_score" if self._use_lm else "asr_score")

    # ---------------------------------------------------------------- LM
    def _score_lm_beams(self, beams: List[_Hyp], cached_lm, cached_partial,
                        is_eos: bool) -> None:
        """In-place lm_score update."""
        hw = self.hotword_scorer
        tok = self.tokenizer
        if self.lm is None:
            for hyp in beams:
                text = tok.decode(hyp.y_star, group_tokens=False)
                if not text:
                    # no words yet: the key tracks this hyp's acoustics (a
                    # parent's stale lm_score would rank a delimiter-only
                    # expansion above every scored hypothesis)
                    hyp.lm_score = hyp.asr_score
                    continue
                hyp.lm_score = (hyp.asr_score + hw.score(text) +
                                hw.score_partial_token(text.split()[-1]))
            return

        delim_id = tok.word_delimiter_token_id
        for hyp in beams:
            lm_score = 0.0
            text = tok.decode(hyp.y_star, group_tokens=False)
            if not text:
                hyp.lm_score = hyp.asr_score  # see the hotword-only branch
                continue
            words = text.split()
            current_text = " ".join(words[:-1])
            next_word = words[-1]
            new_text = (current_text + " " + next_word) if current_text else next_word
            if is_eos:
                flag = delim_id in hyp.y_star
            else:
                flag = hyp.y_star[-1] == delim_id
            if flag:
                if new_text not in cached_lm:
                    _, prev_raw, start_state = cached_lm.get(
                        current_text, (0.0, 0.0, self.lm.get_start_state()))
                    score, end_state = self.lm.score(start_state, next_word,
                                                     is_last_word=is_eos)
                    raw = prev_raw + score
                    cached_lm[new_text] = (raw + hw.score(new_text), raw,
                                           end_state)
                lm_score, _, _ = cached_lm[new_text]
            if next_word not in cached_partial:
                if next_word in hw:
                    cached_partial[next_word] = hw.score_partial_token(next_word)
                else:
                    cached_partial[next_word] = self.lm.score_partial_token(next_word)
            lm_score += cached_partial[next_word]
            hyp.lm_score = hyp.asr_score + lm_score

    # ----------------------------------------------------- device batching
    def _score_rows(self, hyps: List[_Hyp], enc: torch.Tensor) -> None:
        """Score ``hyps`` against ``enc`` ((1, De) shared, or one row per
        hypothesis) in one device call padded to a power of two, and cache
        (log_probs, new_state) on each; one host transfer."""
        K = len(hyps)
        Kp = 1 << (K - 1).bit_length()
        tokens = np.full((Kp,), self.blank_id, np.int64)
        tokens[:K] = [h.y_star[-1] for h in hyps]
        h0, c0 = hyps[0].state
        h = np.zeros(h0.shape[:2] + (Kp,) + h0.shape[3:], np.float32)
        c = None if c0 is None else np.zeros_like(h)
        for i, hyp in enumerate(hyps):
            h[:, :, i] = hyp.state[0][:, :, 0]
            if c is not None:
                c[:, :, i] = hyp.state[1][:, :, 0]
        if enc.shape[0] > 1:
            enc = torch.cat([enc, enc.new_zeros((Kp - K, enc.shape[1]))])
        dev = enc.device
        log_probs, new_state = predict_joint_rows(
            self.model, enc, torch.from_numpy(tokens).to(dev),
            RNNState(torch.from_numpy(h).to(dev),
                     None if c is None else torch.from_numpy(c).to(dev)))
        # one transfer: log-probs and the new states (lossless in fp32)
        parts = [log_probs, new_state.h.float()] + (
            [] if new_state.c is None else [new_state.c.float()])
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        log_probs = host[:log_probs.numel()].reshape(log_probs.shape)
        nh = host[log_probs.size:log_probs.size + h.size].reshape(h.shape)
        nc = None if c is None else host[log_probs.size + h.size:].reshape(h.shape)
        for i, hyp in enumerate(hyps):
            state_i = (nh[:, :, i:i + 1],
                       None if nc is None else nc[:, :, i:i + 1])
            hyp.cache = (log_probs[i].astype(np.float64), state_i)

    def _score_wave_multi(self, requests) -> None:
        """Fulfil several lanes' wave requests, each ``(hyps, enc_t)`` with
        its own frame, in one padded device call: the rows are all the
        hypotheses, each against its request's frame.  Per-row results are
        those of per-request calls (a pure function), so batching changes
        latency, not tokens."""
        if len(requests) == 1:
            self._score_rows(*requests[0])
            return
        all_hyps: List[_Hyp] = []
        rows = []
        for hyps, enc_t in requests:
            all_hyps.extend(hyps)
            rows.append(enc_t.expand(len(hyps), -1))
        self._score_rows(all_hyps, torch.cat(rows))

    def decode_frames_multilane(self, lanes) -> None:
        """Advance several independent sessions together, batching their
        device work: ``lanes`` is a list of ``(session, enc_frames)``.  Each
        round advances every live lane's search to its next wave request,
        then fulfils all pending requests in one device call; per-lane
        results equal ``decode_frames(session, enc_frames)`` lane by lane."""
        gens = {i: self._search_steps(s, self._frames(e))
                for i, (s, e) in enumerate(lanes)}
        ready = list(gens)
        while ready:
            requests, owners = [], []
            for i in ready:
                try:
                    requests.append(next(gens[i]))
                    owners.append(i)
                except StopIteration:
                    pass  # lane finished its frames
            if not requests:
                break
            self._score_wave_multi(requests)
            ready = owners

    # ------------------------------------------------------------ session
    def open_session(self) -> HostBeamSession:
        """Resumable search state: feed encoder frames in chunks of any size
        with ``decode_frames`` and settle with ``finalize``; the frame loop
        is ``decode``'s, so chunked decoding equals offline decoding."""
        start_lm_state = self.lm.get_start_state() if self.lm else None
        return HostBeamSession(
            B_hyps=[_Hyp(0.0, [self.blank_id], _zero_prednet_state(self.model),
                         0.0, start_lm_state)],
            cached_lm={"": (0.0, 0.0, start_lm_state)},
            cached_partial={})

    def current_best(self, session: HostBeamSession) -> List[int]:
        """Best-so-far tokens for streaming partials (no EOS settling)."""
        return max(session.B_hyps, key=self._key).y_star[1:]

    def finalize(self, session: HostBeamSession,
                 n_best: Optional[int] = None) -> List[List[int]]:
        B_hyps = session.B_hyps
        if self._use_lm:
            self._score_lm_beams(B_hyps, session.cached_lm,
                                 session.cached_partial, is_eos=True)
        if self.length_norm_alpha is not None:
            a = self.length_norm_alpha
            rank = lambda h: self._key(h) / max(len(h.y_star) - 1, 1) ** a
        else:  # the reference ranking: the seed blank counted
            rank = lambda h: self._key(h) / len(h.y_star)
        nbest = sorted(B_hyps, key=rank,
                       reverse=True)[:(n_best or self.beam_width)]
        return [h.y_star[1:] for h in nbest]  # strip the blank seed

    def _merge_B(self, B_hyps: List[_Hyp]) -> List[_Hyp]:
        """Frame-boundary duplicate merge (``merge_duplicates``): identical
        token sequences combine with logsumexp; the better path keeps its
        prediction state.  The LM part of the key is a function of
        ``y_star``, so it carries over to the merged score unchanged."""
        by_seq: dict = {}
        for h in B_hyps:
            key = tuple(h.y_star)
            ex = by_seq.get(key)
            if ex is None:
                by_seq[key] = h
                continue
            lm_part = ex.lm_score - ex.asr_score
            merged = float(np.logaddexp(ex.asr_score, h.asr_score))
            keep = ex if ex.asr_score >= h.asr_score else h
            keep.asr_score = merged
            keep.lm_score = merged + lm_part
            by_seq[key] = keep
        return list(by_seq.values())

    # ------------------------------------------------------------- decode
    @torch.inference_mode()
    def decode(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
               n_best: Optional[int] = None) -> List[List[int]]:
        """feats: (1, T, n_mels) on the model's device (batch 1, as the
        reference).  Returns n-best token lists."""
        enc, enc_lengths = _encode(self.model, feats, feat_lengths)
        session = self.open_session()
        self.decode_frames(session, enc[0, :int(enc_lengths[0])])
        return self.finalize(session, n_best)

    def _frames(self, enc_frames) -> torch.Tensor:
        if isinstance(enc_frames, np.ndarray):
            enc_frames = torch.from_numpy(enc_frames)
        return enc_frames.to(_device(self.model))

    def decode_frames(self, session: HostBeamSession, enc_frames) -> None:
        """Advance the search over encoder frames (T, De), resumable.  The
        frames stay on the device: each wave reads its frame there."""
        for wave, enc_t in self._search_steps(session, self._frames(enc_frames)):
            self._score_rows(wave, enc_t)

    def _search_steps(self, session: HostBeamSession, enc_frames: torch.Tensor):
        """The search loop as a generator of scoring requests: it yields
        ``(wave_hyps, enc_t)`` whenever a wave needs scores, and the consumer
        fills each hypothesis's ``.cache`` with ``(log_probs (V,),
        new_state)`` before resuming.  Who fulfils a request never changes
        the search."""
        cached_lm = session.cached_lm
        cached_partial = session.cached_partial
        B_hyps = session.B_hyps

        for t in range(len(enc_frames)):
            enc_t = enc_frames[t:t + 1]
            A_hyps = B_hyps
            B_hyps = []
            for hyp in A_hyps:
                hyp.cache = None  # scores are per frame
            expansions = 0
            while A_hyps:
                most_prob_A = max(A_hyps, key=self._key)
                a_best = self._key(most_prob_A)
                b_best = max((self._key(h) for h in B_hyps),
                             default=float("-inf"))
                if self.improved and b_best >= self.state_beam + a_best:
                    break  # B is unbeatable
                expansions += 1
                if expansions > self.max_expansions:
                    break  # safety valve (not in the reference)
                if most_prob_A.cache is None:
                    # score the top of the unscored pool by search key (the
                    # pop order), capped; most_prob_A goes in explicitly (under
                    # NaN scores the sort order is undefined)
                    unscored = [h for h in A_hyps
                                if h.cache is None and h is not most_prob_A]
                    unscored.sort(key=self._key, reverse=True)
                    yield ([most_prob_A]
                           + unscored[:self.wave_size - 1], enc_t)
                A_hyps.remove(most_prob_A)

                log_probs, new_state = most_prob_A.cache
                best_prob = float(np.max(np.delete(log_probs, self.blank_id)))

                new_A: List[_Hyp] = []
                for k, asr_score in enumerate(log_probs):
                    cand = _Hyp(most_prob_A.asr_score + float(asr_score),
                                list(most_prob_A.y_star), most_prob_A.state,
                                most_prob_A.lm_score, most_prob_A.lm_state)
                    if k == self.blank_id:
                        # blank closes the hyp at this frame; its lm_score is
                        # settled at once
                        cand.lm_score = most_prob_A.lm_score + float(asr_score)
                        B_hyps.append(cand)
                    else:
                        if self.improved and float(asr_score) < best_prob - self.expand_beam:
                            continue  # expand_beam prune
                        if cand.y_star[-1] != k:  # consecutive-duplicate drop
                            cand.y_star.append(k)
                        cand.state = new_state
                        new_A.append(cand)
                A_hyps.extend(new_A)
                if self._use_lm and new_A:
                    # only the fresh expansions: the LM score is a function
                    # of y_star (and monotone caches)
                    self._score_lm_beams(new_A, cached_lm, cached_partial,
                                         is_eos=False)
                if len(A_hyps) > self.max_live:
                    # safety valve (not in the reference): under weak pruning
                    # A grows without bound; keep the top of the pop order
                    A_hyps.sort(key=self._key, reverse=True)
                    del A_hyps[self.max_live:]
                best_next_A = max((self._key(h) for h in A_hyps),
                                  default=float("-inf"))
                best_next_B = max(self._key(h) for h in B_hyps)
                if len(B_hyps) >= self.beam_width and best_next_B > best_next_A:
                    break
            if self.merge_duplicates and len(B_hyps) > 1:
                # every B hyp is blank-closed here: merging is
                # alignment-consistent
                B_hyps = self._merge_B(B_hyps)

        session.B_hyps = B_hyps
