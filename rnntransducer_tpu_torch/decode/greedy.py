"""Batched greedy RNN-T decoding (port of ``rnntransducer_tpu/decode/greedy.py``).

Same emission rule as the JAX frame scan:

* argmax of the joint; a non-blank token is fed back into the prediction
  net (duplicates included), but a token equal to the last *appended* token
  is not appended;
* blank, or an exhausted ``max_symbols`` budget, advances to the next frame;
* frames past each utterance's ``enc_lengths`` are skipped;
* emission times are absolute encoder-frame indices (``frames_done``
  offset), so the carry can resume across chunks.

One frame is :func:`greedy_frame_step`, a function of the carry with no
in-place writes: the eager frame loop is a Python loop over it with no host
sync inside, and an exported program (``utils/export.py``) runs the same
step in one ``while_loop`` over frames, as the JAX package runs its step in
one ``lax.scan``.  :func:`greedy_decode_label_looping` walks events instead
of frames and emits the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rnntransducer_tpu_torch.models.cells import RNNState
from rnntransducer_tpu_torch.models.transducer import RNNTransducer
from rnntransducer_tpu_torch.utils.precision import match_param_dtype


class GreedyCarry(NamedTuple):
    """Resumable greedy-decode state across frame chunks."""
    dec_out: torch.Tensor        # (B, Dd) last prediction-net output
    state: RNNState              # prediction-net recurrent state
    last_appended: torch.Tensor  # (B,) int64
    tokens: torch.Tensor         # (B, max_output_len) int64
    lengths: torch.Tensor        # (B,) int64 emitted so far
    times: torch.Tensor          # (B, max_output_len) int64 emission frames
    frames_done: torch.Tensor    # (B,) int64 valid frames consumed so far


def _device(model: RNNTransducer) -> torch.device:
    return next(model.parameters()).device


def greedy_carry(model: RNNTransducer, batch: int, blank_id: int = 0,
                 max_output_len: int = 256) -> GreedyCarry:
    """The carry before the first frame: the prediction net primed with
    blank, an empty output.  Runs under the caller's grad mode (a tracer's
    too); :func:`init_greedy_carry` is the inference-mode entry point."""
    dev = _device(model)
    blank = torch.full((batch,), blank_id, dtype=torch.int64, device=dev)
    dec_out0, state0 = model.predict_step(blank, None)
    zeros = torch.zeros((batch,), dtype=torch.int64, device=dev)
    return GreedyCarry(
        dec_out=dec_out0, state=state0, last_appended=blank,
        tokens=torch.full((batch, max_output_len), blank_id, dtype=torch.int64,
                          device=dev),
        lengths=zeros,
        times=torch.zeros((batch, max_output_len), dtype=torch.int64, device=dev),
        frames_done=zeros)


init_greedy_carry = torch.inference_mode()(greedy_carry)


def _select_state(keep: torch.Tensor, new: RNNState, old: RNNState) -> RNNState:
    """Per-row choice between two (L, D, B, H) states."""
    m = keep.view(1, 1, -1, 1)
    c = None if new.c is None else torch.where(m, new.c, old.c)
    return RNNState(torch.where(m, new.h, old.h), c)


def _put(buf: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
         value: torch.Tensor) -> torch.Tensor:
    """``buf`` (B, L) with ``value`` written at column idx[b] of the rows
    where ``keep``; out of place."""
    col = idx[:, None]
    return buf.scatter(1, col, torch.where(keep[:, None], value[:, None],
                                           buf.gather(1, col)))


def greedy_frame_step(model: RNNTransducer, carry: GreedyCarry, enc_t: torch.Tensor,
                      t, enc_lengths: torch.Tensor, blank_id: int = 0,
                      max_symbols: int = 3) -> GreedyCarry:
    """One encoder frame enc_t (B, De) at frame index ``t`` (an int, or a
    0-dim int64 tensor inside a traced loop) of this call's chunk: up to
    ``max_symbols`` joint + prediction steps.  Returns the new carry and
    writes nothing in place; ``frames_done`` is left for the caller to
    advance once the chunk is consumed."""
    dec_out, state, last_app, out_buf, out_len, time_buf, frames_done = carry
    max_len = out_buf.shape[1]
    abs_t = frames_done + t
    emitting = t < enc_lengths
    for _ in range(max_symbols):
        tok = model.joint_step(enc_t, dec_out).argmax(dim=-1)
        advance = emitting & (tok != blank_id)
        do_append = advance & (tok != last_app) & (out_len < max_len)
        idx = out_len.clamp(max=max_len - 1)
        out_buf = _put(out_buf, idx, do_append, tok)
        time_buf = _put(time_buf, idx, do_append, abs_t)
        out_len = out_len + do_append.to(torch.int64)
        last_app = torch.where(do_append, tok, last_app)
        new_dec_out, new_state = model.predict_step(
            torch.where(advance, tok, blank_id), state)
        dec_out = torch.where(advance[:, None], new_dec_out, dec_out)
        state = _select_state(advance, new_state, state)
        emitting = advance
    return GreedyCarry(dec_out, state, last_app, out_buf, out_len, time_buf,
                       frames_done)


@torch.inference_mode()
def greedy_decode_frames(model: RNNTransducer, enc: torch.Tensor,
                         enc_lengths: torch.Tensor, carry: GreedyCarry,
                         blank_id: int = 0, max_symbols: int = 3) -> GreedyCarry:
    """Consume encoder frames enc (B, T, De), valid up to enc_lengths, and
    return the advanced carry."""
    enc_lengths = enc_lengths.to(device=enc.device, dtype=torch.int64)
    for t in range(enc.shape[1]):
        carry = greedy_frame_step(model, carry, enc[:, t], t, enc_lengths,
                                  blank_id, max_symbols)
    return carry._replace(frames_done=carry.frames_done + enc_lengths)


def _encode(model: RNNTransducer, feats, feat_lengths):
    feats = match_param_dtype(model, feats)
    enc, _ = model.encode(feats, feat_lengths)
    return enc, model.cfg.transnet.output_lengths(feat_lengths.to(torch.int64))


@torch.inference_mode()
def greedy_decode(model: RNNTransducer, feats: torch.Tensor,
                  feat_lengths: torch.Tensor, blank_id: int = 0,
                  max_symbols: int = 3, max_output_len: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode feats (B, T, n_mels), then run the frame loop.  Returns
    (tokens (B, max_output_len) padded with blank_id, lengths (B,))."""
    tokens, lengths, _ = greedy_decode_with_times(
        model, feats, feat_lengths, blank_id, max_symbols, max_output_len)
    return tokens, lengths


@torch.inference_mode()
def greedy_decode_with_times(model: RNNTransducer, feats: torch.Tensor,
                             feat_lengths: torch.Tensor, blank_id: int = 0,
                             max_symbols: int = 3, max_output_len: int = 256
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """greedy_decode plus per-token emission frames ``times`` (B,
    max_output_len): encoder-frame indices."""
    enc, enc_lengths = _encode(model, feats, feat_lengths)
    carry = init_greedy_carry(model, feats.shape[0], blank_id, max_output_len)
    carry = greedy_decode_frames(model, enc, enc_lengths, carry, blank_id,
                                 max_symbols)
    return carry.tokens, carry.lengths, carry.times


# iterations of the label loop between two host reads of "any utterance
# still active" (each read is a sync)
_CHECK_EVERY = 8


@torch.inference_mode()
def greedy_decode_label_looping(model: RNNTransducer, feats: torch.Tensor,
                                feat_lengths: torch.Tensor, blank_id: int = 0,
                                max_symbols: int = 3, max_output_len: int = 256
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label-looping greedy decode (after arXiv:2406.03791): a loop over
    events instead of frames.  Each iteration advances every utterance by
    one event, a blank (its frame pointer moves on) or a label (one
    prediction-network step), so the loop runs about T + U iterations of
    one joint and one prediction step, where the frame loop runs
    ``max_symbols`` of each on every frame.  The tokens are the frame loop's
    (the same emission rule).  The loop is Python over device tensors; the
    host reads whether any utterance is still active every ``_CHECK_EVERY``
    iterations (an iteration after all are done changes nothing).  Returns
    (tokens (B, max_output_len) padded with blank_id, lengths (B,))."""
    enc, lengths = _encode(model, feats, feat_lengths)
    B, T = enc.shape[0], enc.shape[1]
    dev = enc.device
    lengths = lengths.to(dev)
    rows = torch.arange(B, device=dev)
    blank = torch.full((B,), blank_id, dtype=torch.int64, device=dev)
    dec_out, state = model.predict_step(blank, None)
    t_ptr = torch.zeros((B,), dtype=torch.int64, device=dev)
    syms = torch.zeros_like(t_ptr)
    last_app = blank.clone()
    out_buf = torch.full((B, max_output_len), blank_id, dtype=torch.int64, device=dev)
    out_len = torch.zeros_like(t_ptr)
    it = 0
    while it % _CHECK_EVERY or bool((t_ptr < lengths).any()):
        it += 1
        active = t_ptr < lengths
        enc_t = enc[rows, t_ptr.clamp(max=T - 1)]
        tok = model.joint_step(enc_t, dec_out).argmax(dim=-1)
        emit = active & (tok != blank_id) & (syms < max_symbols)
        # a blank or an exhausted budget moves the frame pointer on
        t_ptr = torch.where(active & ~emit, t_ptr + 1, t_ptr)
        syms = torch.where(emit, syms + 1, torch.where(active, 0, syms))
        # a label: appended unless it repeats the last one, then fed back
        do_append = emit & (tok != last_app) & (out_len < max_output_len)
        idx = out_len.clamp(max=max_output_len - 1)
        out_buf[rows, idx] = torch.where(do_append, tok, out_buf[rows, idx])
        out_len = out_len + do_append.to(torch.int64)
        last_app = torch.where(do_append, tok, last_app)
        new_dec_out, new_state = model.predict_step(torch.where(emit, tok, blank), state)
        dec_out = torch.where(emit[:, None], new_dec_out, dec_out)
        state = _select_state(emit, new_state, state)
    return out_buf, out_len
