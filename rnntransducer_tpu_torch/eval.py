"""Corpus evaluation (port of ``rnntransducer_tpu/eval.py``): batched decode
-> CER / WER / RTF over a test set.

Point it at a manifest or a prepared Arrow dataset and any of the port's
decoders (greedy, the device beam with an optional on-device char LM or
word LM, the host A/B beam with word-level LM + hotwords) and it returns
corpus CER / WER, the decode real-time factor and per-utterance
hypotheses.

Utterances are length-sorted and padded to multiples of ``frame_bucket``
frames, as the JAX package does (there it bounds the compiled programs;
here it keeps each batch's padding small).  Raw-PCM items go through the
plain log-mel frontend (``frontend.melspec.LogMelFrontend``), as in the
JAX package, on the model's device.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.decode.greedy import _device
from rnntransducer_tpu_torch.models.transducer import RNNTransducer
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.metrics import (char_error_rate, edit_distance,
                                                   word_error_rate)
from rnntransducer_tpu_torch.utils.precision import decode_dtype, param_dtype


@dataclasses.dataclass
class EvalResult:
    """Corpus-level metrics + per-utterance records (input order)."""

    cer: float
    wer: float
    n_utts: int
    audio_seconds: float
    decode_seconds: float  # wall: frontend + decode + host detokenization
    per_utt: List[dict]    # {id, ref, hyp, cer, wer, audio_sec}
    oracle_cer: Optional[float] = None  # best of the n-best (oracle_nbest=True)

    @property
    def rtf(self) -> float:
        """Decode real-time factor (wall seconds per audio second); < 1 is
        faster than real time."""
        return self.decode_seconds / max(self.audio_seconds, 1e-9)

    def summary(self) -> dict:
        out = {"cer": round(self.cer, 6), "wer": round(self.wer, 6),
               "n_utts": self.n_utts,
               "audio_seconds": round(self.audio_seconds, 3),
               "decode_seconds": round(self.decode_seconds, 3),
               "rtf": round(self.rtf, 6)}
        if self.oracle_cer is not None:
            out["oracle_cer"] = round(self.oracle_cer, 6)
        return out


def _utt_scores(ref: str, hyp: str) -> dict:
    c = edit_distance(list(ref), list(hyp)) / max(len(ref), 1)
    w = edit_distance(ref.split(), hyp.split()) / max(len(ref.split()), 1)
    return {"cer": round(c, 6), "wer": round(w, 6)}


def _bucketed(n: int, bucket: int) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _check_decoder(decoder, device_lm, word_lm, lm, hotwords, oracle_nbest) -> None:
    if decoder not in ("greedy", "beam", "beam_batched"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if device_lm is not None and decoder != "beam_batched":
        raise ValueError("device_lm fuses inside the device beam — use "
                         "decoder='beam_batched' (word LM/hotwords: 'beam')")
    if word_lm is not None and decoder != "beam_batched":
        raise ValueError("word_lm (device word-boundary fusion) rides the "
                         "device beam — use decoder='beam_batched' (host "
                         "word fusion: 'beam' with lm=...)")
    if (lm is not None or hotwords) and decoder != "beam":
        raise ValueError("lm/hotwords fuse in the host beam — use "
                         "decoder='beam' (device char LM: 'beam_batched')")
    if oracle_nbest and decoder == "greedy":
        raise ValueError("oracle_nbest needs an n-best list — use a beam "
                         "decoder")


def _batch_inputs(batch, is_wav: bool, tpad: int, hop: int, frontend, device):
    """One length-sorted batch padded to ``tpad`` frames on ``device``:
    (feats (b, T, n_mels), feat_lengths (b,))."""
    b = len(batch)
    if is_wav:
        spad = tpad * hop
        wavs = np.zeros((b, spad), np.float32)
        slens = np.zeros((b,), np.int64)
        for r, it in enumerate(batch):
            w = np.asarray(it["wav"], np.float32)[:spad]
            wavs[r, :len(w)] = w
            slens[r] = len(w)
        return frontend(torch.from_numpy(wavs).to(device),
                        torch.from_numpy(slens).to(device))
    n_mels = int(np.asarray(batch[0]["feats"]).shape[-1])
    fe = np.zeros((b, tpad, n_mels), np.float32)
    fl = np.zeros((b,), np.int64)
    for r, it in enumerate(batch):
        f = np.asarray(it["feats"], np.float32)[:tpad]
        fe[r, :len(f)] = f
        fl[r] = len(f)
    return torch.from_numpy(fe).to(device), torch.from_numpy(fl).to(device)


@torch.inference_mode()
def evaluate_corpus(model: RNNTransducer, tok: GraphemeTokenizer,
                    audio_cfg: AudioConfig, items: Iterable[dict], *,
                    decoder: str = "greedy", beam_width: int = 4,
                    improved: bool = True, state_beam: float = 4.6,
                    expand_beam: float = 2.3, lm=None,
                    hotwords: Optional[Sequence[str]] = None,
                    hotword_weight: Optional[float] = None, device_lm=None,
                    batch_size: int = 16, max_symbols: int = 3,
                    max_output_len: int = 256, frame_bucket: int = 128,
                    ids: Optional[Sequence[str]] = None,
                    oracle_nbest: bool = False,
                    precision: Optional[str] = None,
                    length_norm_alpha: Optional[float] = None,
                    merge_duplicates: bool = False,
                    word_lm=None) -> EvalResult:
    """Decode every item on the model's device and score it against its
    reference.  The model holds its own weights (the JAX function takes
    ``(model, variables)``).

    ``items``: dicts carrying ``labels`` (int grapheme ids, the reference
    transcript) plus either ``wav`` (float32 PCM at
    ``audio_cfg.sample_rate``; the log-mel frontend runs per batch) or
    ``feats`` ((T, n_mels) precomputed log-mel): the row formats of
    ``ArrowWaveformDataset`` / ``ArrowAudioDataset``.

    ``decoder``: ``greedy`` | ``beam_batched`` (the device beam; optional
    ``device_lm`` char fusion or ``word_lm`` word fusion) | ``beam`` (the
    host A/B search; optional word ``lm`` + ``hotwords``, one utterance at
    a time).

    ``oracle_nbest`` (beam decoders): also score the best hypothesis of each
    utterance's n-best list, the oracle CER (oracle well below top-1: a
    rescorer or LM would help; oracle near top-1: model errors).  Per-utt
    records gain ``oracle_cer`` / ``oracle_hyp``; the corpus number is
    ``EvalResult.oracle_cer``.

    ``precision``: 'bf16' / 'fp32' decodes with a cast copy of the model
    (beam scores stay fp32); None keeps the model's dtype.
    """
    items = list(items)
    if not items:
        raise ValueError("evaluate_corpus: empty item list")
    if ids is not None and len(ids) != len(items):
        raise ValueError(f"{len(ids)} ids for {len(items)} items")
    _check_decoder(decoder, device_lm, word_lm, lm, hotwords, oracle_nbest)
    if precision is not None and decode_dtype(precision) != param_dtype(model):
        model = copy.deepcopy(model).to(decode_dtype(precision))

    device = _device(model)
    hop = audio_cfg.hop_length
    is_wav = "wav" in items[0]
    key = "wav" if is_wav else "feats"
    frames = np.asarray([(len(it[key]) + hop - 1) // hop if is_wav
                         else len(it[key]) for it in items])
    audio_sec = float(frames.sum()) * audio_cfg.window_stride_sec
    # length-sorted batches: neighbours share a frame bucket, so padding
    # stays small
    order = np.argsort(frames, kind="stable")
    hyps: List[Optional[str]] = [None] * len(items)
    nbests: List[Optional[List[str]]] = [None] * len(items)
    t0 = time.monotonic()

    from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
    frontend = LogMelFrontend(audio_cfg)

    host_beam = None
    if decoder == "beam":
        from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
        from rnntransducer_tpu_torch.decode.hotwords import DEFAULT_HOTWORD_WEIGHT
        # an unset weight takes the default, as the Recognizer does (the JAX
        # scorer multiplies by None and raises)
        host_beam = BeamSearchDecoder(
            model, blank_id=tok.blank_token_id, tokenizer=tok,
            beam_width=beam_width, improved=improved, state_beam=state_beam,
            expand_beam=expand_beam, lm=lm, hotwords=hotwords,
            hotword_weight=(DEFAULT_HOTWORD_WEIGHT if hotword_weight is None
                            else hotword_weight),
            length_norm_alpha=length_norm_alpha,
            merge_duplicates=merge_duplicates)

    for lo in range(0, len(order), batch_size):
        idxs = order[lo:lo + batch_size]
        batch = [items[int(i)] for i in idxs]
        tpad = _bucketed(int(frames[idxs].max()), frame_bucket)
        b = len(batch)
        feats, feat_lengths = _batch_inputs(batch, is_wav, tpad, hop, frontend,
                                            device)
        if decoder == "greedy":
            from rnntransducer_tpu_torch.decode.greedy import greedy_decode
            toks, lens = greedy_decode(
                model, feats, feat_lengths, blank_id=tok.blank_token_id,
                max_symbols=max_symbols, max_output_len=max_output_len)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            rows = [list(toks[r, :lens[r]]) for r in range(b)]
        elif decoder == "beam_batched":
            from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
            toks, lens, _ = batched_beam_decode(
                model, feats, feat_lengths, blank_id=tok.blank_token_id,
                beam_width=beam_width, max_symbols=max_symbols,
                max_output_len=max_output_len, device_lm=device_lm,
                length_norm_alpha=length_norm_alpha,
                merge_duplicates=merge_duplicates, word_lm=word_lm)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            rows = [list(toks[r, 0, :lens[r, 0]]) for r in range(b)]
            if oracle_nbest:
                K = toks.shape[1]
                for r, i in enumerate(idxs):
                    nbests[int(i)] = [
                        tok.decode(list(toks[r, k, :lens[r, k]]),
                                   group_tokens=False) for k in range(K)]
        else:
            all_rows = [host_beam.decode(feats[r:r + 1], feat_lengths[r:r + 1])
                        for r in range(b)]
            rows = [nb[0] for nb in all_rows]
            if oracle_nbest:
                for r, i in enumerate(idxs):
                    nbests[int(i)] = [tok.decode(y, group_tokens=False)
                                      for y in all_rows[r]]
        for r, i in enumerate(idxs):
            hyps[int(i)] = tok.decode(rows[r], group_tokens=False)
    decode_sec = time.monotonic() - t0

    refs = [tok.decode(list(np.asarray(it["labels"])), group_tokens=False)
            for it in items]
    per_utt = []
    oracle_hyps = [] if oracle_nbest else None
    for i, (ref, hyp) in enumerate(zip(refs, hyps)):
        rec = {"id": str(ids[i]) if ids is not None else str(i),
               "ref": ref, "hyp": hyp,
               "audio_sec": round(float(frames[i]) * audio_cfg.window_stride_sec, 3),
               **_utt_scores(ref, hyp)}
        if oracle_nbest:
            best = min(nbests[i], key=lambda h: edit_distance(list(ref), list(h)))
            rec["oracle_hyp"] = best
            rec["oracle_cer"] = _utt_scores(ref, best)["cer"]
            oracle_hyps.append(best)
        per_utt.append(rec)
    return EvalResult(cer=char_error_rate(hyps, refs),
                      wer=word_error_rate(hyps, refs),
                      n_utts=len(items), audio_seconds=audio_sec,
                      decode_seconds=decode_sec, per_utt=per_utt,
                      oracle_cer=(char_error_rate(oracle_hyps, refs)
                                  if oracle_nbest else None))


def load_manifest_items(manifest: str, tok: GraphemeTokenizer, sample_rate: int,
                        max_utts: Optional[int] = None):
    """Read a ``wav_path<TAB>transcript`` TSV (the ``prepare_manifest.py``
    format) into evaluate_corpus items.  Returns ``(items, ids)``; malformed
    or empty rows are skipped with a message."""
    from rnntransducer_tpu_torch.tokenizer import decompose_hangul
    from rnntransducer_tpu_torch.utils.audio_io import read_wav

    items, ids = [], []
    with open(manifest, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            if max_utts is not None and len(items) >= max_utts:
                break
            try:
                path, text = line.split("\t", 1)
                wav = read_wav(path, sample_rate)
                labels = tok.encode(decompose_hangul(text.strip()))
            except Exception as e:  # a bad row is skipped, the rest scored
                print(f"[skip] line {ln}: {e}")
                continue
            if len(wav) == 0 or len(labels) == 0:
                print(f"[skip] line {ln}: empty audio or transcript")
                continue
            items.append({"wav": np.asarray(wav, np.float32),
                          "labels": np.asarray(labels, np.int32)})
            ids.append(path)
    return items, ids


def load_dataset_items(data_dirs: Sequence[str], split: str, audio_cfg: AudioConfig,
                       max_utts: Optional[int] = None):
    """Load a prepared Arrow split (log-mel or raw-PCM rows, told apart by
    the row shape: PCM rows are 1-D, log-mel rows (T, n_mels)) into
    evaluate_corpus items.  Returns ``(items, ids)``."""
    from rnntransducer_tpu_torch.data.dataset import (ArrowAudioDataset,
                                                      ArrowWaveformDataset)

    probe = ArrowAudioDataset(data_dirs, split)
    is_wav = np.asarray(probe[0]["feats"]).ndim == 1
    ds = ArrowWaveformDataset(data_dirs, split, audio_cfg) if is_wav else probe
    n = len(ds) if max_utts is None else min(len(ds), max_utts)
    return ds.get_batch(range(n)), [f"{split}/{i}" for i in range(n)]


def write_per_utt_jsonl(result: EvalResult, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for rec in result.per_utt:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
