"""Batched RNN-T beam search on the device (port of
``rnntransducer_tpu/decode/beam_batched.py``).

Frame-synchronous beam with a fixed expansion budget per frame:

* K hypotheses per utterance, the whole batch decoded together;
* per frame, ``max_symbols`` expansion rounds: every live hypothesis offers
  a "stay" (emit blank, close for this frame) and V-1 token extensions, and
  the top K of the pooled candidates survive (per-path scores, no prefix
  merging);
* a consecutive duplicate is not appended but still advances the
  prediction network;
* hypotheses still live after the round budget are blank-closed;
* the final ranking divides the score by len + 1 (the +1 is the blank seed).

With beam_width=1 this is greedy decoding.  The beam state is an explicit
``BeamCarry``, so the same frame loop serves offline decoding and chunked
streaming (``decode/streaming.py``).

One frame is :func:`beam_frame_step`, a function of the carry with no
in-place writes.  The eager frame loop is a Python loop over it with no
host sync inside; an exported program (``utils/export.py``) runs the same
step in one ``while_loop`` (the JAX package's is one ``lax.scan``).  Frames
past an utterance's ``enc_lengths`` are skipped with ``torch.where``, not
by slicing on host lengths.  Hypotheses are batch-major (row b*K + k) in
every flat tensor, and the prediction network's state keeps its (layers,
directions, B*K, H) layout.  Scores are fp32 whatever the params' dtype: the joint's logits
are cast before ``log_softmax``.

Search options (the reference ranking is the default):

* ``length_norm_alpha``: rank by ``score / max(len, 1)**alpha`` over the
  emitted tokens (the seed blank excluded); ``None`` keeps the reference
  ranking;
* ``merge_duplicates``: identical token sequences are combined once per
  frame with ``logsumexp`` (the better path keeps its prediction state).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rnntransducer_tpu_torch.decode.greedy import _device, _encode
from rnntransducer_tpu_torch.models.cells import RNNState
from rnntransducer_tpu_torch.models.transducer import RNNTransducer

NEG = -1e30


class BeamCarry(NamedTuple):
    """Resumable beam state across frame chunks.  scores / lens / last:
    (B, K); tokens (B, K, L); dec_out (B*K, Dd); state: the prediction
    network's RNNState over batch B*K; ctx (B, K, order-1): the last emitted
    graphemes, for device char-LM fusion (None when unused); wlm_state /
    wlm_node (B, K): the word-LM state and lexicon-trie node of device
    word-boundary fusion (None when unused)."""
    scores: torch.Tensor
    tokens: torch.Tensor
    lens: torch.Tensor
    last: torch.Tensor
    dec_out: torch.Tensor
    state: RNNState
    ctx: Optional[torch.Tensor] = None
    wlm_state: Optional[torch.Tensor] = None
    wlm_node: Optional[torch.Tensor] = None


def beam_carry(model: RNNTransducer, batch: int, beam_width: int,
               blank_id: int = 0, max_output_len: int = 256,
               lm_context: int = 0, word_lm_start: int = -1) -> BeamCarry:
    """The carry before the first frame: hypothesis 0 of each utterance
    live at score 0, the others at NEG.  ``lm_context > 0`` adds a (B, K,
    lm_context) emitted-grapheme history for device char-LM fusion (pass
    the LM's ``.context``), blank-filled = no history yet.
    ``word_lm_start >= 0`` adds the word-boundary fusion state: every
    hypothesis starts in LM state ``word_lm_start`` (the LM's ``<s>`` row)
    at the trie root.  Runs under the caller's grad mode (a tracer's too);
    :func:`init_beam_carry` is the inference-mode entry point."""
    B, K = batch, beam_width
    dev = _device(model)
    dec_out0, state0 = model.predict_step(
        torch.full((B * K,), blank_id, dtype=torch.int64, device=dev), None)
    first = torch.arange(K, device=dev) == 0
    scores = torch.where(first, 0.0, NEG).to(torch.float32).expand(B, K).contiguous()

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int64, device=dev)

    return BeamCarry(
        scores=scores, tokens=full((B, K, max_output_len), blank_id),
        lens=full((B, K), 0), last=full((B, K), blank_id), dec_out=dec_out0,
        state=state0,
        ctx=full((B, K, lm_context), blank_id) if lm_context > 0 else None,
        wlm_state=full((B, K), word_lm_start) if word_lm_start >= 0 else None,
        wlm_node=full((B, K), 0) if word_lm_start >= 0 else None)


init_beam_carry = torch.inference_mode()(beam_carry)


def _merge_duplicate_hyps(scores, tokens, lens):
    """Marginalise identical token sequences: in each group of beam slots
    holding the same (lens, tokens), the best-scoring slot (the lowest index
    among equals) gets the group's logsumexp and the rest drop to NEG.
    Token buffers are blank-filled past ``lens``, so whole-buffer equality
    is prefix equality."""
    K = scores.shape[1]
    same = ((lens[:, :, None] == lens[:, None, :])
            & (tokens[:, :, None, :] == tokens[:, None, :, :]).all(-1))
    group = torch.where(same, scores[:, None, :], NEG)  # row i: i's group
    merged = torch.logsumexp(group, dim=-1)
    best_j = group.argmax(dim=-1)  # the first maximum, as jnp.argmax
    is_rep = best_j == torch.arange(K, device=scores.device)[None, :]
    return torch.where(is_rep, merged, NEG)


def _gather_k(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) -> x[b, parent[b, k], ...]."""
    idx = parent.reshape(parent.shape + (1,) * (x.ndim - 2)).expand(
        parent.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _map_state(state: RNNState, fn, other: Optional[RNNState] = None) -> RNNState:
    """``fn`` applied to h and c (and to ``other``'s h and c beside them)."""
    if other is None:
        return RNNState(fn(state.h), None if state.c is None else fn(state.c))
    return RNNState(fn(state.h, other.h),
                    None if state.c is None else fn(state.c, other.c))


def _top_k(pool: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along dim 1 with ``lax.top_k``'s tie rule, the lower index
    first.  ``torch.topk`` promises no order among equal values, and ties
    are common here: every NEG-filled candidate is exactly -1e30 (NEG plus
    a log-prob rounds back to NEG in fp32).  A stable descending sort keeps
    the lower index first among equals."""
    values, idx = torch.sort(pool, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _check_fusion(carry: BeamCarry, lm_table, word_lm) -> None:
    if lm_table is not None:
        if carry.ctx is None:
            raise ValueError("lm_table given but the beam carry has no ctx "
                             "history — init_beam_carry(lm_context=order-1)")
        if carry.ctx.shape[2] != lm_table.ndim - 1:
            raise ValueError(
                f"carry ctx holds {carry.ctx.shape[2]} tokens of history "
                f"but the LM table is order {lm_table.ndim}")
    if word_lm is not None and carry.wlm_state is None:
        raise ValueError("word_lm given but the beam carry has no word-LM "
                         "state — init_beam_carry(word_lm_start=...)")


def beam_frame_step(model: RNNTransducer, carry: BeamCarry, enc_t: torch.Tensor,
                    frame_valid: torch.Tensor, blank_id: int = 0,
                    max_symbols: int = 3, lm_table: Optional[torch.Tensor] = None,
                    lm_weight: float = 0.0, merge_duplicates: bool = False,
                    word_lm=None) -> BeamCarry:
    """One encoder frame enc_t (B, De) of the beam, valid where
    ``frame_valid`` (B,): ``max_symbols`` expansion rounds, then the
    blank-close.  Returns the new carry (an invalid frame's rows unchanged)
    and writes nothing in place.  Fusion arguments as
    :func:`beam_decode_frames`."""
    B, K = carry.scores.shape
    V = model.cfg.jointnet.num_classes
    max_len = carry.tokens.shape[2]
    vocab = torch.arange(V, device=enc_t.device)
    rows_k = torch.arange(B, device=enc_t.device)[:, None] * K

    def joint(enc_bk, dec_flat):
        # fp32 scores whatever the compute dtype: the ranking accumulates
        # log-probs across frames
        return torch.log_softmax(model.joint_step(enc_bk, dec_flat).float(), -1)

    enc_bk = enc_t.repeat_interleave(K, dim=0)
    done = torch.zeros_like(carry.lens, dtype=torch.bool)
    (scores, tokens, lens, last, dec_out, state, ctx, wlm_s, wlm_n) = carry
    for _ in range(max_symbols):
        logp = joint(enc_bk, dec_out).reshape(B, K, V)
        stay = torch.where(done, scores, scores + logp[..., blank_id])
        ext = scores[..., None] + logp
        if lm_table is not None:
            # one gather of the (B, K, V) next-grapheme row per round
            ext = ext + lm_weight * lm_table[tuple(ctx.unbind(-1))]
        if word_lm is not None:
            # the delimiter extension closes the in-progress word: its
            # fused n-gram score joins the candidate before top-K; an
            # empty current word (trie root) scores nothing
            bonus = word_lm.rows[wlm_s, word_lm.node_word[wlm_n]]
            bonus = torch.where(wlm_n == 0, 0.0, bonus)
            ext = torch.where(vocab == word_lm.delimiter_id, ext + bonus[..., None], ext)
        ext = torch.where(vocab == blank_id, NEG, ext)
        ext = torch.where(done[..., None], NEG, ext)
        top_sc, top_idx = _top_k(
            torch.cat([stay, ext.reshape(B, K * V)], dim=1), K)
        is_stay = top_idx < K
        parent = torch.where(is_stay, top_idx, (top_idx - K) // V)
        tok = torch.where(is_stay, blank_id, (top_idx - K) % V)

        # hypotheses are batch-major: row b*K + k of every flat tensor
        flat = (rows_k + parent).reshape(B * K)
        tokens_g = _gather_k(tokens, parent)
        lens_g = torch.gather(lens, 1, parent)
        last_g = torch.gather(last, 1, parent)
        dec_g = dec_out.index_select(0, flat)
        state_g = _map_state(state, lambda a: a.index_select(2, flat))

        append = (~is_stay) & (tok != last_g) & (lens_g < max_len)
        if ctx is not None:
            # the LM history mirrors the token buffer: appended graphemes
            # shift in, duplicate drops advance nothing
            ctx_g = _gather_k(ctx, parent)
            shifted = torch.cat([ctx_g[..., 1:], tok[..., None]], dim=-1)
            ctx = torch.where(append[..., None], shifted, ctx_g)
        if word_lm is not None:
            # an appended delimiter commits the completed word (OOV keeps
            # the previous state) and resets the trie walk; an appended
            # grapheme advances the trie; drops and stays change nothing
            wlm_s_g = torch.gather(wlm_s, 1, parent)
            wlm_n_g = torch.gather(wlm_n, 1, parent)
            is_delim = tok == word_lm.delimiter_id
            ns_cand = word_lm.next_state[word_lm.node_word[wlm_n_g]]
            committed = torch.where(ns_cand >= 0, ns_cand, wlm_s_g)
            wlm_s = torch.where(append & is_delim & (wlm_n_g != 0),
                                committed, wlm_s_g)
            walk = word_lm.trie_next[wlm_n_g, tok]
            wlm_n = torch.where(append, torch.where(is_delim, 0, walk),
                                wlm_n_g)
        idx = lens_g.clamp(max=max_len - 1)[..., None]
        cur = torch.gather(tokens_g, 2, idx)
        tokens = tokens_g.scatter(2, idx, torch.where(append[..., None],
                                                      tok[..., None], cur))
        lens = lens_g + append.to(torch.int64)
        last = torch.where(is_stay, last_g, tok)

        feed = torch.where(is_stay, blank_id, tok).reshape(B * K)
        new_dec, new_state = model.predict_step(feed, state_g)
        stay_bk = is_stay.reshape(B * K)
        dec_out = torch.where(stay_bk[:, None], dec_g, new_dec)
        state = _map_state(state_g, lambda a, n: torch.where(
            stay_bk.reshape(1, 1, -1, 1), a, n), new_state)
        done = is_stay
        scores = top_sc

    # blank-close the hypotheses that used up the round budget
    logp = joint(enc_bk, dec_out).reshape(B, K, V)
    scores = torch.where(done, scores, scores + logp[..., blank_id])
    if merge_duplicates:
        # every hypothesis is blank-closed here, so merging at the frame
        # boundary is alignment-consistent
        scores = _merge_duplicate_hyps(scores, tokens, lens)

    # invalid frames change nothing
    def pick(new, old):
        if new is None:
            return None
        return torch.where(frame_valid.reshape((B,) + (1,) * (new.ndim - 1)),
                           new, old)

    valid_bk = frame_valid.repeat_interleave(K)
    return BeamCarry(
        pick(scores, carry.scores), pick(tokens, carry.tokens),
        pick(lens, carry.lens), pick(last, carry.last),
        torch.where(valid_bk[:, None], dec_out, carry.dec_out),
        _map_state(state, lambda n, o: torch.where(
            valid_bk.reshape(1, 1, -1, 1), n, o), carry.state),
        pick(ctx, carry.ctx), pick(wlm_s, carry.wlm_state),
        pick(wlm_n, carry.wlm_node))


@torch.inference_mode()
def beam_decode_frames(model: RNNTransducer, enc: torch.Tensor,
                       enc_lengths: torch.Tensor, carry: BeamCarry,
                       blank_id: int = 0, max_symbols: int = 3,
                       lm_table: Optional[torch.Tensor] = None,
                       lm_weight: float = 0.0, merge_duplicates: bool = False,
                       word_lm=None) -> BeamCarry:
    """Advance the beam over encoder frames enc (B, T, De), valid up to
    enc_lengths (B,).  The beam width is ``carry.scores.shape[1]``.

    ``lm_table``: a dense char-LM table (V,) * order on enc's device
    (``decode/device_lm.py``): every non-blank extension gains ``lm_weight *
    ln p(tok | ctx)``; the carry must hold a ctx of order-1 tokens.
    ``word_lm``: a ``DeviceWordLM`` on enc's device: a delimiter extension
    gains the just-completed word's fused n-gram score; the carry must hold
    the word-LM fields."""
    _check_fusion(carry, lm_table, word_lm)
    enc_lengths = enc_lengths.to(device=enc.device, dtype=torch.int64)
    for t in range(enc.shape[1]):
        carry = beam_frame_step(model, carry, enc[:, t], t < enc_lengths, blank_id,
                                max_symbols, lm_table, lm_weight, merge_duplicates,
                                word_lm)
    return carry


@torch.inference_mode()
def settle_word_lm(carry: BeamCarry, word_lm) -> BeamCarry:
    """End-of-stream word-LM settling (the host path's ``is_last_word``):
    the in-progress word (trie node not at the root) is scored from the
    current LM state, then ``</s>`` from the resulting state.  Returns the
    carry with adjusted scores; call once before the final ranking."""
    completed = word_lm.node_word[carry.wlm_node]
    at_root = carry.wlm_node == 0
    word_bonus = torch.where(at_root, 0.0,
                             word_lm.rows[carry.wlm_state, completed])
    ns_cand = word_lm.next_state[completed]
    final_state = torch.where(
        at_root, carry.wlm_state,
        torch.where(ns_cand >= 0, ns_cand, carry.wlm_state))
    eos_bonus = word_lm.eos_col[final_state]
    return carry._replace(scores=carry.scores + word_bonus + eos_bonus)


def _rank_scores(scores, lens, length_norm: bool, alpha):
    """The ranking key: the reference's ``score / (len + 1)`` when ``alpha``
    is None, else ``score / max(len, 1)**alpha`` over emitted tokens."""
    if alpha is not None:
        return scores / lens.clamp(min=1).to(scores.dtype) ** alpha
    return scores / (lens + 1) if length_norm else scores


@torch.inference_mode()
def rank_beam(carry: BeamCarry, length_norm: bool = True,
              length_norm_alpha=None):
    """Hypotheses best first: (tokens (B, K, L), lens (B, K), scores (B, K))."""
    rank = _rank_scores(carry.scores, carry.lens, length_norm, length_norm_alpha)
    order = torch.argsort(-rank, dim=1, stable=True)
    return (_gather_k(carry.tokens, order), torch.gather(carry.lens, 1, order),
            torch.gather(carry.scores, 1, order))


@torch.inference_mode()
def best_hyp_all(carry: BeamCarry, length_norm: bool = True):
    """The best hypothesis of every utterance: (tokens (B, L), lens (B,))."""
    rank = carry.scores / (carry.lens + 1) if length_norm else carry.scores
    k = rank.argmax(dim=1)
    rows = torch.arange(k.shape[0], device=k.device)
    return carry.tokens[rows, k], carry.lens[rows, k]


@torch.inference_mode()
def best_hyp(carry: BeamCarry, length_norm: bool = True):
    """The best hypothesis of utterance 0: (tokens (L,), len ())."""
    rank = carry.scores / (carry.lens + 1) if length_norm else carry.scores
    k = rank[0].argmax()
    return carry.tokens[0, k], carry.lens[0, k]


@torch.inference_mode()
def batched_beam_decode(model: RNNTransducer, feats: torch.Tensor,
                        feat_lengths: torch.Tensor, blank_id: int = 0,
                        beam_width: int = 4, max_symbols: int = 3,
                        max_output_len: int = 256, length_norm: bool = True,
                        device_lm=None, length_norm_alpha=None,
                        merge_duplicates: bool = False, word_lm=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode feats (B, T, n_mels), run the beam over every frame, rank.
    Returns (tokens (B, K, max_output_len), lengths (B, K), scores (B, K))
    best first.

    ``device_lm``: a ``DeviceCharLM``, grapheme-level fusion inside the
    frame loop.  ``word_lm``: a ``DeviceWordLM``, word-boundary fusion
    inside the loop and end-of-stream settling before the ranking."""
    enc, enc_lengths = _encode(model, feats, feat_lengths)
    if device_lm is not None:
        device_lm = device_lm.to(enc.device)
    if word_lm is not None:
        word_lm = word_lm.to(enc.device)
    carry = init_beam_carry(
        model, feats.shape[0], beam_width, blank_id, max_output_len,
        lm_context=device_lm.context if device_lm is not None else 0,
        word_lm_start=word_lm.start_state if word_lm is not None else -1)
    carry = beam_decode_frames(
        model, enc, enc_lengths, carry, blank_id, max_symbols,
        lm_table=device_lm.table if device_lm is not None else None,
        lm_weight=device_lm.weight if device_lm is not None else 0.0,
        merge_duplicates=merge_duplicates, word_lm=word_lm)
    if word_lm is not None:
        carry = settle_word_lm(carry, word_lm)
    return rank_beam(carry, length_norm, length_norm_alpha)
