"""Masked GRU and LSTM recurrences, forward and backward: the CUDA
kernels' wrappers and their plain versions.

``gru_scan`` and ``lstm_scan`` have the signatures and layouts of the JAX
package's ``rnntransducer_tpu/ops/rnn_pallas.py::gru_scan`` / ``lstm_scan``.
Each dispatches on the device of ``xw``: a CPU tensor goes to the plain
version (:func:`gru_scan_reference`, :func:`lstm_scan_reference`); a CUDA
tensor goes to the hand-written kernel (``csrc/gru_fwd.cu``,
``csrc/lstm_fwd.cu``) or the call raises.  ``gru_scan_backward`` and
``lstm_scan_backward`` do the same for the backward through time
(``csrc/gru_bwd.cu``, ``csrc/lstm_bwd.cu``).  There is no fallback from a
kernel to its plain version.  While a tracer runs (``torch.export``), each
wrapper calls its registered op instead (``ops/library.py``), which
resolves to the same two implementations when the traced program runs.

:class:`GRUScanFunction` and :class:`LSTMScanFunction` are the autograd
forms: the forward is the scan, the backward the backward scan plus the
off-loop dW_hh / db_hh GEMMs (:func:`gru_weight_grads`,
:func:`lstm_weight_grads`), as the JAX package's custom VJPs
(``rnn_pallas.py:479-558``, ``:628-698``).  They look the scans up in this
module when they run, so a caller may swap any of them for its plain
version.

Each wrapper's ``.launches`` counts the kernel launches it made, so a run
can show that its recurrent layers went through the kernels.  The kernels
are persistent: 1 launch per forward scan, 2 per backward scan (the gates
GEMM and the chain).  A persistent grid must be co-resident, one block per
SM: :func:`gru_max_hidden` and :func:`lstm_max_hidden` give the largest H
it takes on a card, from the card's SM count and the shared memory a block
may opt in to (:func:`device_limits`).  Above it a call takes the per-step
kernels (T launches per forward scan, T + 1 per backward scan), chosen by
:func:`gru_route` / :func:`lstm_route` from (H, B, dtype, device) before
any launch, as the JAX package's ``rnn_pallas.supported()`` gate chooses.
Where even a per-step block's whole slice does not fit the card's shared
memory (:func:`step_max_hidden`), the per-step kernels stream the slice
through shared memory in K chunks (route ``"step_chunked"``, the same
launch counts), so every H runs; :func:`step_chunked_reference` mirrors
that arithmetic on the CPU.

The two directions of a bidirectional GRU layer may take their backward
scans together (:func:`gru_scan_backward_pair`, :class:`GRUPairScanFunction`):
one gates GEMM launch for both, then one persistent launch that runs both
chains, each on its own half of the SMs (2 launches a pair), where
:func:`gru_pair_fits`.  ``utils.profiling`` counts the backward scans the
kernels ran while a profiler records: ``kernels/gru_bwd_pair`` per paired
launch, ``kernels/gru_bwd_single`` per scan run alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.ops import build, library
from rnntransducer_tpu_torch.ops.device import device_limits
from rnntransducer_tpu_torch.utils import profiling
from rnntransducer_tpu_torch.utils.precision import full_precision_matmul

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_WIDTH = 8                    # GRU hidden units per block (kJT in the kernels)
_PAIR_TILE_WIDTH = 16              # GRU units per block of the paired backward (kPairJT)
_LSTM_STEP_TILE_WIDTH = 4          # LSTM units per block, per-step route (kStepJT)
_LSTM_CHAIN_ROWS = 8               # rows of a persistent LSTM chain slice (CC)
_K_ALIGN = 64                      # the kernel's K loop walks 64 at a time
_STEP_ROWS = 64                    # rows of a per-step block's dot buffer (kRowChunk)
_STEP_CHUNK = 256                  # K values a streamed per-step block holds (kChunk)
_COOPERATIVE_TOO_LARGE = 720       # cudaErrorCooperativeLaunchTooLarge
def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _limits(device, sms: Optional[int], smem: Optional[int]) -> Tuple[int, int]:
    """The card's SM count and opt-in shared memory (the H100 SXM's where no
    CUDA device is named), each capped by ``sms`` / ``smem`` where given."""
    d_sms, d_smem = device_limits(device)
    if _is_cuda(device):
        return (d_sms if sms is None else min(sms, d_sms),
                d_smem if smem is None else min(smem, d_smem))
    return (d_sms if sms is None else sms), (d_smem if smem is None else smem)


def _product(a, w, chunk: Optional[int] = None):
    """a @ w in fp32; with ``chunk``, summed over K in chunks of that many
    values, as a per-step block that streams its slice sums it
    (``csrc/step_stream.cuh``)."""
    if chunk is None:
        return torch.matmul(a, w)
    out = torch.matmul(a[..., :chunk], w[:chunk])
    for k0 in range(chunk, a.shape[-1], chunk):
        out = out + torch.matmul(a[..., k0:k0 + chunk], w[k0:k0 + chunk])
    return out


def gru_scan_reference(xw, w_hh, b_hh, h0, lengths, reverse: bool = False, *,
                       chunk: Optional[int] = None):
    """Plain PyTorch version of the kernel, under the same numeric contract:
    fp32 carry, h rounded to W's dtype for the product, fp32 accumulation,
    b_hh added in fp32, xw read as fp32, outputs in xw's dtype.

    xw (T, B, 3H); w_hh (H, 3H); b_hh (3H,); h0 (B, H); lengths (B,).
    Returns (h_all (T, B, H), h_final (B, H)); steps t >= lengths[b] keep
    the carry and emit zeros.  ``chunk``: sum each product over K in chunks
    (:func:`step_chunked_reference`)."""
    T, B, G = xw.shape
    H = G // 3
    w = w_hh.float()
    b = b_hh.float()
    h = h0.float()
    lengths = lengths.to(xw.device)
    h_all = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hw = _product(h.to(w_hh.dtype).float(), w, chunk) + b
        x = xw[t].float()
        r = torch.sigmoid(x[:, :H] + hw[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hw[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hw[:, 2 * H:])
        h_new = (1.0 - z) * n + z * h
        m = (lengths > t)[:, None]
        h = torch.where(m, h_new, h)
        h_all[t] = torch.where(m, h_new, 0.0).to(xw.dtype)
    return h_all, h.to(xw.dtype)


def _library():
    lib = build.load("gru_fwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_fwd.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.gru_scan_fwd.restype = i
        for fn in (lib.gru_scan_fwd_step, lib.gru_scan_fwd_step_chunked):
            fn.argtypes = [p] * 8 + [i] * 7 + [p]
            fn.restype = i
        lib.gru_scan_fwd_step_chunked_smem.argtypes = [i]
        lib.gru_scan_fwd_step_chunked_smem.restype = i
        for fn in (lib.gru_scan_fwd_smem, lib.gru_scan_fwd_max_blocks):
            fn.argtypes = [i, i]
            fn.restype = i
        lib._argtypes_set = True
    return lib


def _tile_weights(w_hh: torch.Tensor, H: int, Hk: int, jt: int) -> torch.Tensor:
    """(H, G*H) -> (ceil(H/jt), G*jt, Hk): block i's gate columns (r, z, n
    or i, f, g, o) for its jt hidden units, transposed so K runs
    contiguously, zero padded for k >= H and j >= H."""
    Hp = -(-H // jt) * jt
    G = w_hh.shape[1] // H
    wg = F.pad(w_hh.view(H, G, H), (0, Hp - H, 0, 0, 0, Hk - H))
    return (wg.view(Hk, G, Hp // jt, jt).permute(2, 1, 3, 0)
            .reshape(Hp // jt, G * jt, Hk).contiguous())


def _padded(n: int) -> int:
    return -(-n // _K_ALIGN) * _K_ALIGN


def _fp32_copy(x):
    """A dense fp32 copy of x, which a kernel may update in place."""
    return torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)


def gru_smem_bytes(H: int, dtype: torch.dtype, backward: bool = False) -> int:
    """Dynamic shared memory of one block of the persistent GRU kernels
    (``csrc/rnn_persistent.cuh::slice_smem``): the block's W_hh slice, 24
    rows of Hk forward or 8 rows of Kc backward, bf16 rows padded by 32
    values, plus a 128-row fp32 dot buffer."""
    e = 2 if dtype == torch.bfloat16 else 4
    C = _TILE_WIDTH if backward else 3 * _TILE_WIDTH
    K = _padded(3 * H) if backward else _padded(H)
    return e * C * (K + 32 if e == 2 else K) + 4 * 128 * C


@functools.lru_cache(maxsize=None)
def _reported_blocks(cell: str, H: int, jt: int, dtype: torch.dtype,
                     device: torch.device) -> int:
    """The fewer of the persistent forward and backward kernels' co-resident
    blocks at hidden size H, as the kernels' own occupancy query on the card
    reports them (``*_max_blocks``; -1 where a block does not fit)."""
    code = _DTYPE_CODES[dtype]
    Hk, Kc = _padded(H), _padded((3 if cell == "gru" else 4) * H)
    with torch.cuda.device(device):
        if cell == "gru":
            return min(_library().gru_scan_fwd_max_blocks(Hk, code),
                       _bwd_library().gru_scan_bwd_max_blocks(Kc, code))
        return min(_lstm_fwd_library().lstm_scan_fwd_max_blocks(Hk, jt, code),
                   _lstm_bwd_library().lstm_scan_bwd_max_blocks(Kc, jt, code))


def _persistent_fits(cell, H, jt, smem_bytes, dtype, device, sms, smem) -> bool:
    """ceil(H / jt) blocks, one per SM, co-resident on the card, each within
    the shared memory a block may opt in to; on a card also within what the
    kernels' occupancy query reports."""
    n_sms, n_smem = _limits(device, sms, smem)
    blocks = -(-H // jt)
    if blocks > n_sms or max(smem_bytes) > n_smem:
        return False
    if _is_cuda(device):
        return blocks <= _reported_blocks(cell, H, jt, dtype, torch.device(device))
    return True


def gru_fits(H: int, B: int, dtype: torch.dtype, device=None, *,
             sms: Optional[int] = None, smem: Optional[int] = None) -> bool:
    """Whether both persistent GRU kernels take hidden size H on the card of
    ``device`` (or one with ``sms`` SMs and ``smem`` bytes of opt-in shared
    memory per block; the H100 SXM where neither is given): ceil(H / 8)
    blocks, one per SM, must be co-resident, each holding its W_hh slice.
    B does not move the limit: rows are walked in 64-row chunks inside a
    step."""
    del B
    return _persistent_fits("gru", H, _TILE_WIDTH,
                            (gru_smem_bytes(H, dtype), gru_smem_bytes(H, dtype, True)),
                            dtype, device, sms, smem)


def gru_max_hidden(B: int, dtype: torch.dtype, device=None, *,
                   sms: Optional[int] = None, smem: Optional[int] = None) -> int:
    """The largest hidden size the persistent GRU kernels take on that card."""
    H = _limits(device, sms, smem)[0] * _TILE_WIDTH
    while H > 0 and not gru_fits(H, B, dtype, device, sms=sms, smem=smem):
        H -= 1
    return H


def gru_pair_smem_bytes(H: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the paired backward kernel
    (``csrc/gru_bwd.cu::gru_bwd_pair``): 16 chain rows of Kc, bf16 rows padded
    by 32 values, plus a 128-row fp32 dot buffer."""
    e = 2 if dtype == torch.bfloat16 else 4
    K = _padded(3 * H)
    C = _PAIR_TILE_WIDTH
    return e * C * (K + 32 if e == 2 else K) + 4 * 128 * C


@functools.lru_cache(maxsize=None)
def _reported_pair_blocks(H: int, dtype: torch.dtype, device: torch.device) -> int:
    """The paired backward kernel's co-resident blocks at hidden size H, as
    its own occupancy query on the card reports them (-1 where a block does
    not fit)."""
    with torch.cuda.device(device):
        return _bwd_library().gru_scan_bwd_pair_max_blocks(_padded(3 * H),
                                                           _DTYPE_CODES[dtype])


def gru_pair_fits(H: int, B: int, dtype: torch.dtype, device=None, *,
                  sms: Optional[int] = None, smem: Optional[int] = None) -> bool:
    """Whether the paired backward kernel takes both directions of a
    bidirectional GRU layer of hidden size H on the card of ``device`` (or
    one with ``sms`` SMs and ``smem`` bytes of opt-in shared memory per
    block; the H100 SXM where neither is given): 2 ceil(H / 16) blocks, one
    per SM, must be co-resident, each holding its 16-row chain slice.  B
    does not move the limit (64-row chunks inside a step)."""
    del B
    n_sms, n_smem = _limits(device, sms, smem)
    blocks = 2 * -(-H // _PAIR_TILE_WIDTH)
    if blocks > n_sms or gru_pair_smem_bytes(H, dtype) > n_smem:
        return False
    if _is_cuda(device):
        return blocks <= _reported_pair_blocks(H, dtype, torch.device(device))
    return True


def gru_pair_applies(x: torch.Tensor, H: int) -> bool:
    """Whether the two directions of a bidirectional GRU layer of hidden
    size H over the input x (B, T, F) take the paired backward: on a card,
    outside a tracer (no registered op stands for the pair) and where
    :func:`gru_pair_fits` on x's card and dtype."""
    return (x.device.type == "cuda" and not library.tracing(x)
            and gru_pair_fits(H, x.shape[0], x.dtype, x.device))


def gru_route(H: int, B: int, dtype: torch.dtype, device=None, *,
              backward: bool = False, sms: Optional[int] = None,
              smem: Optional[int] = None) -> str:
    """The GRU kernels a CUDA call of hidden size H takes (the backward scan
    where ``backward``), from the shape and the card alone and before any
    launch: ``"persistent"`` (1 forward launch, 2 backward); above
    :func:`gru_max_hidden`, ``"per_step"`` (T forward, T + 1 backward); and
    above the per-step block's whole-slice limit (:func:`step_max_hidden`),
    ``"step_chunked"`` (the same launches, the slice streamed in K chunks).
    The counterpart of the JAX package's shape gate
    ``rnn_pallas.supported()``; never a reaction to a failed launch."""
    if gru_fits(H, B, dtype, device, sms=sms, smem=smem):
        return "persistent"
    return _step_route("gru", H, dtype, backward, device, smem)


def _step_route(cell, H, dtype, backward, device, smem) -> str:
    top = _step_max_hidden(cell, dtype, backward, _limits(device, None, smem)[1])
    return "per_step" if H <= top else "step_chunked"


def step_smem_bytes(cell: str, H: int, dtype: torch.dtype,
                    backward: bool = False) -> int:
    """Dynamic shared memory of one block of the per-step kernels
    (``per_step::step_smem`` of ``csrc/gru_*.cu``; ``launch_steps`` of
    ``csrc/lstm_*.cu``): the block's gate slice (G jt rows of Hk), backward
    also its chain slice (jt rows of Kc), plus 64-row fp32 dot buffers for
    every slice row (G jt forward, (G + 1) jt backward)."""
    e = 2 if dtype == torch.bfloat16 else 4
    G, jt = (3, _TILE_WIDTH) if cell == "gru" else (4, _LSTM_STEP_TILE_WIDTH)
    Hk, Kc = _padded(H), _padded(G * H)
    if backward:
        return e * (jt * Kc + G * jt * Hk) + 4 * _STEP_ROWS * (G + 1) * jt
    return e * G * jt * Hk + 4 * _STEP_ROWS * G * jt


def step_chunked_smem_bytes(cell: str, dtype: torch.dtype,
                            backward: bool = False) -> int:
    """Dynamic shared memory of one per-step block that streams its slice
    (``*_step_chunked_smem`` of ``csrc/{gru,lstm}_*.cu``): two chunk buffers
    of its widest slice (G jt rows of ``_STEP_CHUNK`` values) plus the dot
    buffers, the same for every H."""
    e = 2 if dtype == torch.bfloat16 else 4
    G, jt = (3, _TILE_WIDTH) if cell == "gru" else (4, _LSTM_STEP_TILE_WIDTH)
    rows = (G + 1) * jt if backward else G * jt
    return 2 * e * G * jt * _STEP_CHUNK + 4 * _STEP_ROWS * rows


def step_max_hidden(cell: str, dtype: torch.dtype, backward: bool = False,
                    device=None, *, smem: Optional[int] = None) -> int:
    """The largest hidden size whose per-step block holds its whole slice in
    the shared memory a block may opt in to on that card (the H100 SXM's
    where no device or ``smem`` is given); above it the per-step kernels
    stream the slice (route ``"step_chunked"``)."""
    return _step_max_hidden(cell, dtype, backward, _limits(device, None, smem)[1])


@functools.lru_cache(maxsize=None)
def _step_max_hidden(cell: str, dtype: torch.dtype, backward: bool, limit: int) -> int:
    lo, hi = 0, 1 << 16                  # step_smem_bytes grows with H
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if step_smem_bytes(cell, mid, dtype, backward) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _cuda_error(op: str, err: int) -> RuntimeError:
    if err == _COOPERATIVE_TOO_LARGE:
        return RuntimeError(f"{op}: the persistent grid cannot be co-resident on "
                            f"this card (CUDA error {err})")
    return RuntimeError(f"{op} kernel failed with CUDA error {err}")


def _gru_scan_cuda(xw, w_hh, b_hh, h0, lengths, reverse):
    dev = xw.device
    for name, x in (("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0),
                    ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"gru_scan: {name} is on {x.device}, xw on {dev}")
    if xw.dim() != 3 or xw.shape[2] % 3:
        raise ValueError(f"gru_scan: xw must be (T, B, 3H), got {tuple(xw.shape)}")
    T, B, G = xw.shape
    H = G // 3
    if (tuple(w_hh.shape) != (H, G) or tuple(b_hh.shape) != (G,)
            or tuple(h0.shape) != (B, H) or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"gru_scan: shapes xw {tuple(xw.shape)}, w_hh {tuple(w_hh.shape)}, "
            f"b_hh {tuple(b_hh.shape)}, h0 {tuple(h0.shape)}, lengths "
            f"{tuple(lengths.shape)} do not agree")
    if xw.dtype not in _DTYPE_CODES:
        raise TypeError(f"gru_scan kernel takes float32 or bfloat16, got {xw.dtype}")
    if w_hh.dtype != xw.dtype or b_hh.dtype != xw.dtype:
        raise TypeError("gru_scan kernel needs xw, w_hh and b_hh of one dtype, "
                        f"got {xw.dtype}, {w_hh.dtype}, {b_hh.dtype}")
    if not (xw.is_contiguous() and w_hh.is_contiguous() and b_hh.is_contiguous()):
        raise ValueError("gru_scan kernel needs contiguous xw, w_hh and b_hh")
    route = gru_route(H, B, xw.dtype, dev)
    persistent = route == "persistent"

    lib = _library()
    Hk = _padded(H)
    code = _DTYPE_CODES[xw.dtype]
    with torch.cuda.device(dev):
        h_all = torch.empty((T, B, H), dtype=xw.dtype, device=dev)
        if T == 0:
            return h_all, h0.to(xw.dtype)
        tiles = _tile_weights(w_hh, H, Hk, _TILE_WIDTH)
        lens = lengths.to(torch.int32).contiguous()
        h_fin = torch.empty((B, H), dtype=xw.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if persistent:
            hb = torch.zeros((2, B, Hk), dtype=xw.dtype, device=dev)
            hb[0, :, :H] = h0
            carry = _fp32_copy(h0)           # j-local carry, updated in place
            count = torch.zeros((1,), dtype=torch.int32, device=dev)
            err = lib.gru_scan_fwd(
                xw.data_ptr(), tiles.data_ptr(), b_hh.data_ptr(), hb.data_ptr(),
                carry.data_ptr(), h_all.data_ptr(), h_fin.data_ptr(), lens.data_ptr(),
                count.data_ptr(), T, B, H, Hk, _TILE_WIDTH, int(reverse), code, stream)
        else:
            h_a = torch.zeros((B, Hk), dtype=torch.float32, device=dev)
            h_a[:, :H] = h0.float()
            h_b = torch.zeros_like(h_a)
            step = (lib.gru_scan_fwd_step_chunked if route == "step_chunked"
                    else lib.gru_scan_fwd_step)
            err = step(
                xw.data_ptr(), tiles.data_ptr(), b_hh.data_ptr(), h_a.data_ptr(),
                h_b.data_ptr(), h_all.data_ptr(), h_fin.data_ptr(), lens.data_ptr(),
                T, B, H, Hk, _TILE_WIDTH, int(reverse), code, stream)
    if err != 0:
        raise _cuda_error("gru_scan", err)
    gru_scan.launches += 1 if persistent else T
    return h_all, h_fin


def gru_scan(xw, w_hh, b_hh, h0, lengths, reverse: bool = False):
    """Masked GRU scan.

    Args:
      xw: (T, B, 3H) hoisted input pre-activations (x @ W_ih + b_ih).
      w_hh: (H, 3H); b_hh: (3H,); h0: (B, H); lengths: (B,) int or float.
      reverse: process t = T-1..0 (the backward direction of a bi-RNN).
    Returns:
      (h_all (T, B, H), h_final (B, H)) in xw's dtype.
    """
    if library.tracing(xw):
        return torch.ops.rnntransducer_tpu_torch.gru_scan(xw, w_hh, b_hh, h0, lengths,
                                                          bool(reverse))
    if xw.device.type == "cpu":
        return gru_scan_reference(xw, w_hh, b_hh, h0, lengths, reverse)
    if xw.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cpu or cuda, not {xw.device}")
    return _gru_scan_cuda(xw, w_hh, b_hh, h0, lengths, reverse)


gru_scan.launches = 0


# ---------------------------------------------------------------------------
# backward through time
# ---------------------------------------------------------------------------


def prev_all(h_all, h0, lengths, reverse: bool = False):
    """Predecessor state of every step, (T, B, H) in h_all's dtype.
    Forward: h0, then h_all[:-1].  Reversed: h_all[t+1] where step t+1 is
    valid, else h0 (the masked steps form a prefix of the reversed walk and
    leave the carry at h0).  Port of ``rnn_pallas.py::_prev_all``."""
    T = h_all.shape[0]
    h0 = h0.to(h_all.dtype)
    if not reverse:
        return torch.cat([h0[None], h_all[:-1]], dim=0)
    shifted = torch.cat([h_all[1:], torch.zeros_like(h_all[:1])], dim=0)
    steps = torch.arange(1, T + 1, device=h_all.device)
    valid = lengths.to(h_all.device)[None, :, None] > steps[:, None, None]
    return torch.where(valid, shifted, h0[None])


def gru_scan_backward_reference(xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin,
                                reverse: bool = False, *, chunk: Optional[int] = None):
    """Plain PyTorch version of the backward kernel, under its numeric
    contract: fp32 dh carry; gates rebuilt in fp32 from xw and h_prev (h_prev
    rounded to W's dtype for the product, b_hh added in fp32); dhw rounded to
    W's dtype for the dh-chain product with fp32 accumulation; dxw and dnr in
    xw's dtype.

    xw (T, B, 3H); h_prev (T, B, H) from :func:`prev_all`; g_hall (T, B, H)
    and g_hfin (B, H) are the cotangents of h_all and h_final.  Returns
    (dxw (T, B, 3H), dnr (T, B, H), dh0 (B, H)): dxw = [dr, dz, dn] of the
    pre-activations, dnr = dn * r the n third of d(hw).  ``chunk``: sum each
    product over K in chunks (:func:`step_chunked_reference`)."""
    T, B, G = xw.shape
    H = G // 3
    w = w_hh.float()
    b = b_hh.float()
    lengths = lengths.to(xw.device)
    dh = g_hfin.float()
    dxw = torch.empty((T, B, G), dtype=xw.dtype, device=xw.device)
    dnr = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hp = h_prev[t]
        hw = _product(hp.to(w_hh.dtype).float(), w, chunk) + b
        x = xw[t].float()
        hn = hw[:, 2 * H:]
        r = torch.sigmoid(x[:, :H] + hw[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hw[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hn)
        m = (lengths > t)[:, None]
        g = torch.where(m, dh + g_hall[t].float(), 0.0)
        dz = g * (hp.float() - n) * z * (1.0 - z)
        dn = g * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        dnr_t = dn * r
        dxw[t] = torch.cat([dr, dz, dn], dim=1).to(xw.dtype)
        dnr[t] = dnr_t.to(xw.dtype)
        dhw = torch.cat([dr, dz, dnr_t], dim=1).to(w_hh.dtype).float()
        dh = _product(dhw, w.t(), chunk) + g * z + torch.where(m, 0.0, dh)
    return dxw, dnr, dh.to(xw.dtype)


def gru_weight_grads(h_prev, dxw, dnr, w_dtype):
    """dW_hh (H, 3H) and db_hh (3H,) from the backward scan's outputs: the
    large GEMMs the JAX package runs outside the loop (``rnn_pallas.py:
    518-535``).  d(hw) = [dxw[..., :2H], dnr] (b_hn sits inside r * (...),
    so the n third reduces dnr); fp32 accumulation, results in ``w_dtype``
    and dxw's dtype."""
    T, B, H = dnr.shape
    hp = h_prev.reshape(T * B, H).to(dxw.dtype)
    with full_precision_matmul():
        dw_rz = torch.matmul(hp.t(), dxw[:, :, :2 * H].reshape(T * B, 2 * H))
        dw_n = torch.matmul(hp.t(), dnr.reshape(T * B, H))
    dw = torch.cat([dw_rz, dw_n], dim=1).to(w_dtype)
    db = torch.cat([dxw[:, :, :2 * H].float().sum((0, 1)),
                    dnr.float().sum((0, 1))]).to(dxw.dtype)
    return dw, db


def _hoisted_gates(h_prev, w_hh, b_hh):
    """hw = h_prev @ W_hh + b_hh for every step, (T, B, G*H) in fp32: h_prev
    rounded to W's dtype, fp32 accumulation, b_hh added in fp32."""
    hp = h_prev.to(w_hh.dtype).float()
    with full_precision_matmul():
        return torch.matmul(hp, w_hh.float()) + b_hh.float()


def gru_bwd_gates_reference(h_prev, w_hh, b_hh):
    """Plain version of the backward kernel's off-chain GEMM: the gate
    pre-activations of every step, hw = h_prev @ W_hh + b_hh, (T, B, 3H) in
    fp32 (h_prev rounded to W's dtype, fp32 accumulation, b_hh added in
    fp32), as the TPU kernel rebuilds them off the chain
    (``rnn_pallas.py:177-185``)."""
    return _hoisted_gates(h_prev, w_hh, b_hh)


def gru_bwd_chain_reference(xw, hw, h_prev, w_hh, lengths, g_hall, g_hfin,
                            reverse: bool = False):
    """Plain version of the backward kernel's chain, given the gates' hw
    from :func:`gru_bwd_gates_reference`: the steps of
    :func:`gru_scan_backward_reference` with the recompute taken off the
    chain.  Same arguments and results otherwise."""
    T, B, G = xw.shape
    H = G // 3
    w = w_hh.float()
    lengths = lengths.to(xw.device)
    dh = g_hfin.float()
    dxw = torch.empty((T, B, G), dtype=xw.dtype, device=xw.device)
    dnr = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        x = xw[t].float()
        hn = hw[t, :, 2 * H:]
        r = torch.sigmoid(x[:, :H] + hw[t, :, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hw[t, :, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hn)
        m = (lengths > t)[:, None]
        g = torch.where(m, dh + g_hall[t].float(), 0.0)
        dz = g * (h_prev[t].float() - n) * z * (1.0 - z)
        dn = g * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        dnr_t = dn * r
        dxw[t] = torch.cat([dr, dz, dn], dim=1).to(xw.dtype)
        dnr[t] = dnr_t.to(xw.dtype)
        dhw = torch.cat([dr, dz, dnr_t], dim=1).to(w_hh.dtype).float()
        dh = torch.matmul(dhw, w.t()) + g * z + torch.where(m, 0.0, dh)
    return dxw, dnr, dh.to(xw.dtype)


def _bwd_library():
    lib = build.load("gru_bwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_bwd.argtypes = [p] * 14 + [i] * 8 + [p]
        lib.gru_scan_bwd.restype = i
        for fn in (lib.gru_scan_bwd_step, lib.gru_scan_bwd_step_chunked):
            fn.argtypes = [p] * 14 + [i] * 8 + [p]
            fn.restype = i
        lib.gru_scan_bwd_step_chunked_smem.argtypes = [i]
        lib.gru_scan_bwd_step_chunked_smem.restype = i
        lib.gru_bwd_gates.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.gru_bwd_gates.restype = i
        lib.gru_scan_bwd_pair.argtypes = [p] * 3 + [i] * 7 + [p]
        lib.gru_scan_bwd_pair.restype = i
        for fn in (lib.gru_scan_bwd_smem, lib.gru_scan_bwd_max_blocks,
                   lib.gru_scan_bwd_pair_smem, lib.gru_scan_bwd_pair_max_blocks):
            fn.argtypes = [i, i]
            fn.restype = i
        lib._argtypes_set = True
    return lib


def _chain_tiles(w_hh: torch.Tensor, H: int, Kc: int, jt: int) -> torch.Tensor:
    """(H, G*H) -> (ceil(H/jt), jt, Kc): block i's jt contiguous rows of
    W_hh (the dh chain dh_j = dhw . W_hh[j, :]), zero padded for j >= H and
    k >= G*H."""
    Hp = -(-H // jt) * jt
    return (F.pad(w_hh, (0, Kc - w_hh.shape[1], 0, Hp - H))
            .view(Hp // jt, jt, Kc).contiguous())


def _gemm_operands(h_prev, w_hh, Hk):
    """The gates GEMM's operands: h_prev as (T, B, Hk) and W_hh^T as
    (G*H, Hk), both zero padded in K, dense."""
    H = w_hh.shape[0]
    hp = h_prev if Hk == H else F.pad(h_prev, (0, Hk - H))
    return hp.contiguous(), F.pad(w_hh.t(), (0, Hk - H)).contiguous()


def gru_bwd_gates(h_prev, w_hh, b_hh):
    """The backward kernel's gates GEMM on its own, for a CUDA h_prev
    (T, B, H) and W_hh, b_hh of its dtype: hw (T, B, 3H) fp32.  The scan
    launches it itself; this entry point is for checking it against
    :func:`gru_bwd_gates_reference`.  ``.launches`` counts its launches."""
    if h_prev.device.type != "cuda":
        raise ValueError(f"gru_bwd_gates runs on cuda, not {h_prev.device}")
    T, B, H = h_prev.shape
    if h_prev.dtype not in _DTYPE_CODES or w_hh.dtype != h_prev.dtype \
            or b_hh.dtype != h_prev.dtype or not b_hh.is_contiguous():
        raise TypeError("gru_bwd_gates needs contiguous float32 or bfloat16 "
                        "operands of one dtype")
    lib = _bwd_library()
    Hk = _padded(H)
    dev = h_prev.device
    with torch.cuda.device(dev):
        hp, w_t = _gemm_operands(h_prev, w_hh, Hk)
        hw = torch.empty((T, B, 3 * H), dtype=torch.float32, device=dev)
        err = lib.gru_bwd_gates(hp.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(),
                                hw.data_ptr(), T * B, H, Hk,
                                _DTYPE_CODES[h_prev.dtype],
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _cuda_error("gru_bwd_gates", err)
    gru_bwd_gates.launches += 1
    return hw


gru_bwd_gates.launches = 0


def _check_backward_args(op, xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin):
    """Raise unless the backward kernel takes these arguments: shapes that
    agree, one device, one float32 or bfloat16 dtype, dense xw, w_hh, b_hh
    and g_hall.  Returns (T, B, H)."""
    dev = xw.device
    if xw.dim() != 3 or xw.shape[2] % 3:
        raise ValueError(f"{op}: xw must be (T, B, 3H), got {tuple(xw.shape)}")
    T, B, G = xw.shape
    H = G // 3
    named = (("h_prev", h_prev, (T, B, H)), ("w_hh", w_hh, (H, G)),
             ("b_hh", b_hh, (G,)), ("lengths", lengths, (B,)),
             ("g_hall", g_hall, (T, B, H)), ("g_hfin", g_hfin, (B, H)))
    for name, x, shape in named:
        if x.device != dev:
            raise ValueError(f"{op}: {name} is on {x.device}, xw on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape} for xw {tuple(xw.shape)}")
    if xw.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, got {xw.dtype}")
    for name, x in (("h_prev", h_prev), ("w_hh", w_hh), ("b_hh", b_hh),
                    ("g_hall", g_hall), ("g_hfin", g_hfin)):
        if x.dtype != xw.dtype:
            raise TypeError(f"{op} kernel needs {name} in xw's dtype "
                            f"{xw.dtype}, got {x.dtype}")
    if not all(x.is_contiguous() for x in (xw, w_hh, b_hh, g_hall)):
        raise ValueError(f"{op} kernel needs contiguous xw, w_hh, b_hh and g_hall")
    return T, B, H


def _gru_scan_backward_cuda(xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin,
                            reverse):
    dev = xw.device
    T, B, H = _check_backward_args("gru_scan_backward", xw, h_prev, w_hh, b_hh,
                                   lengths, g_hall, g_hfin)
    G = 3 * H
    route = gru_route(H, B, xw.dtype, dev, backward=True)
    persistent = route == "persistent"

    lib = _bwd_library()
    Hk, Kc = _padded(H), _padded(G)
    code = _DTYPE_CODES[xw.dtype]
    with torch.cuda.device(dev):
        dxw = torch.empty((T, B, G), dtype=xw.dtype, device=dev)
        dnr = torch.empty((T, B, H), dtype=xw.dtype, device=dev)
        if T == 0:
            return dxw, dnr, g_hfin.clone()
        chain = _chain_tiles(w_hh, H, Kc, _TILE_WIDTH)
        lens = lengths.to(torch.int32).contiguous()
        dh0 = torch.empty((B, H), dtype=xw.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if persistent:
            hprev, w_t = _gemm_operands(h_prev, w_hh, Hk)
            hw = torch.empty((T, B, G), dtype=torch.float32, device=dev)
            dhw = torch.zeros((2, B, Kc), dtype=xw.dtype, device=dev)
            rest = _fp32_copy(g_hfin)        # j-local carry, updated in place
            count = torch.zeros((1,), dtype=torch.int32, device=dev)
            err = lib.gru_scan_bwd(
                xw.data_ptr(), hprev.data_ptr(), g_hall.data_ptr(), w_t.data_ptr(),
                chain.data_ptr(), b_hh.data_ptr(), lens.data_ptr(), hw.data_ptr(),
                dhw.data_ptr(), rest.data_ptr(), dxw.data_ptr(), dnr.data_ptr(),
                dh0.data_ptr(), count.data_ptr(), T, B, H, Hk, Kc, _TILE_WIDTH,
                int(reverse), code, stream)
        else:
            rec = _tile_weights(w_hh, H, Hk, _TILE_WIDTH)
            hprev = F.pad(h_prev, (0, Hk - H)).contiguous()
            dhw = torch.zeros((2, B, Kc), dtype=torch.float32, device=dev)
            rest = torch.empty((2, B, H), dtype=torch.float32, device=dev)
            rest[0] = g_hfin.float()
            step = (lib.gru_scan_bwd_step_chunked if route == "step_chunked"
                    else lib.gru_scan_bwd_step)
            err = step(
                xw.data_ptr(), hprev.data_ptr(), g_hall.data_ptr(), rec.data_ptr(),
                chain.data_ptr(), b_hh.data_ptr(), lens.data_ptr(), dhw[0].data_ptr(),
                dhw[1].data_ptr(), rest[0].data_ptr(), rest[1].data_ptr(),
                dxw.data_ptr(), dnr.data_ptr(), dh0.data_ptr(), T, B, H, Hk, Kc,
                _TILE_WIDTH, int(reverse), code, stream)
    if err != 0:
        raise _cuda_error("gru_scan_backward", err)
    gru_scan_backward.launches += 2 if persistent else T + 1
    profiling.count("kernels/gru_bwd_single")
    return dxw, dnr, dh0


def gru_scan_backward(xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin,
                      reverse: bool = False):
    """Backward through a masked GRU scan; see
    :func:`gru_scan_backward_reference` for the arguments and results."""
    if library.tracing(xw):
        return torch.ops.rnntransducer_tpu_torch.gru_scan_backward(
            xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin, bool(reverse))
    if xw.device.type == "cpu":
        return gru_scan_backward_reference(xw, h_prev, w_hh, b_hh, lengths,
                                           g_hall, g_hfin, reverse)
    if xw.device.type != "cuda":
        raise ValueError(f"gru_scan_backward runs on cpu or cuda, not {xw.device}")
    return _gru_scan_backward_cuda(xw, h_prev, w_hh, b_hh, lengths, g_hall,
                                   g_hfin, reverse)


gru_scan_backward.launches = 0


def gru_scan_backward_pair_reference(fwd, bwd, lengths):
    """Plain version of the paired backward: :func:`gru_scan_backward_reference`
    of each direction.  ``fwd`` / ``bwd`` are (xw, h_prev, w_hh, b_hh, g_hall,
    g_hfin) of the forward and the reversed direction."""
    return tuple(gru_scan_backward_reference(*d[:4], lengths, *d[4:], reverse)
                 for d, reverse in ((fwd, False), (bwd, True)))


def _gru_scan_backward_pair_cuda(fwd, bwd, lengths):
    op = "gru_scan_backward_pair"
    shapes = [_check_backward_args(op, *d[:4], lengths, *d[4:]) for d in (fwd, bwd)]
    xw = fwd[0]
    dev = xw.device
    if shapes[0] != shapes[1] or bwd[0].dtype != xw.dtype or bwd[0].device != dev:
        raise ValueError(f"{op}: the directions differ: xw {tuple(xw.shape)} "
                         f"{xw.dtype} on {dev}, {tuple(bwd[0].shape)} {bwd[0].dtype} "
                         f"on {bwd[0].device}")
    T, B, H = shapes[0]
    G = 3 * H
    if not gru_pair_fits(H, B, xw.dtype, dev):
        raise ValueError(f"{op}: H={H} in {xw.dtype} does not fit the paired kernel "
                         "on this card (gru_pair_fits)")

    lib = _bwd_library()
    Hk, Kc = _padded(H), _padded(G)
    with torch.cuda.device(dev):
        outs = [(torch.empty((T, B, G), dtype=xw.dtype, device=dev),
                 torch.empty((T, B, H), dtype=xw.dtype, device=dev),
                 torch.empty((B, H), dtype=xw.dtype, device=dev)) for _ in range(2)]
        if T == 0:
            return tuple((dxw, dnr, d[5].clone())
                         for (dxw, dnr, _), d in zip(outs, (fwd, bwd)))
        bufs = []
        for (xw_d, h_prev, w_hh, b_hh, g_hall, g_hfin), out in zip((fwd, bwd), outs):
            hprev, w_t = _gemm_operands(h_prev, w_hh, Hk)
            bufs += [xw_d, hprev, g_hall, w_t, _chain_tiles(w_hh, H, Kc, _PAIR_TILE_WIDTH),
                     b_hh, torch.empty((T, B, G), dtype=torch.float32, device=dev),
                     torch.zeros((2, B, Kc), dtype=xw.dtype, device=dev),
                     _fp32_copy(g_hfin), *out]
        ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
        lens = lengths.to(torch.int32).contiguous()
        count = torch.zeros((2,), dtype=torch.int32, device=dev)
        err = lib.gru_scan_bwd_pair(ptrs, lens.data_ptr(), count.data_ptr(), T, B, H, Hk,
                                    Kc, _PAIR_TILE_WIDTH, _DTYPE_CODES[xw.dtype],
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _cuda_error(op, err)
    gru_scan_backward_pair.launches += 2
    profiling.count("kernels/gru_bwd_pair")
    return tuple(outs)


def gru_scan_backward_pair(fwd, bwd, lengths):
    """Backward through both directions of a bidirectional GRU layer at once.

    ``fwd`` and ``bwd`` are (xw, h_prev, w_hh, b_hh, g_hall, g_hfin) of the
    forward and the reversed direction, as :func:`gru_scan_backward` takes
    them; ``lengths`` (B,) is shared.  Returns ((dxw, dnr, dh0) of fwd,
    (dxw, dnr, dh0) of bwd).  A CPU tensor goes to
    :func:`gru_scan_backward_pair_reference`; a CUDA tensor to the paired
    kernel (``csrc/gru_bwd.cu::gru_scan_bwd_pair``: one gates GEMM launch for
    both directions, then one persistent launch of both chains, each on half
    the SMs; ``.launches`` counts 2), which must fit (:func:`gru_pair_fits`),
    or the call raises.  Each direction's outputs equal
    :func:`gru_scan_backward`'s bit for bit."""
    xw = fwd[0]
    if xw.device.type == "cpu":
        return gru_scan_backward_pair_reference(fwd, bwd, lengths)
    if xw.device.type != "cuda":
        raise ValueError(f"gru_scan_backward_pair runs on cpu or cuda, not {xw.device}")
    return _gru_scan_backward_pair_cuda(fwd, bwd, lengths)


gru_scan_backward_pair.launches = 0


def _backward_inputs(xw, h_all, w_hh, b_hh, h0, lengths, g_hall, g_hfin, reverse):
    """The backward scan's arguments (xw, h_prev, w_hh, b_hh, g_hall, g_hfin)
    from a scan's saved tensors and its cotangents; a missing cotangent of
    h_all or h_final counts as zeros."""
    g_hall = (torch.zeros_like(h_all) if g_hall is None
              else g_hall.to(h_all.dtype).contiguous())
    g_hfin = (torch.zeros_like(h0, dtype=h_all.dtype) if g_hfin is None
              else g_hfin.to(h_all.dtype))
    return xw, prev_all(h_all, h0, lengths, reverse), w_hh, b_hh, g_hall, g_hfin


def _direction_grads(args, h0, dxw, dnr, dh0):
    """Grads for xw, w_hh, b_hh and h0 of one direction from its backward
    scan's outputs (the off-loop weight GEMMs)."""
    _, h_prev, w_hh, b_hh, _, _ = args
    dw, db = gru_weight_grads(h_prev, dxw, dnr, w_hh.dtype)
    return dxw, dw, db.to(b_hh.dtype), dh0.to(h0.dtype)


class GRUScanFunction(torch.autograd.Function):
    """``gru_scan`` with the JAX package's custom VJP: the backward is the
    backward scan plus the off-loop weight GEMMs.  Returns grads for xw,
    w_hh, b_hh and h0 (in their dtypes), none for lengths and reverse; a
    missing cotangent of h_all or h_final counts as zeros."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh, h0, lengths, reverse):
        h_all, h_fin = gru_scan(xw, w_hh, b_hh, h0, lengths, reverse)
        ctx.save_for_backward(xw, h_all, w_hh, b_hh, h0, lengths)
        ctx.reverse = reverse
        return h_all, h_fin

    @staticmethod
    def backward(ctx, g_hall, g_hfin):
        xw, h_all, w_hh, b_hh, h0, lengths = ctx.saved_tensors
        args = _backward_inputs(xw, h_all, w_hh, b_hh, h0, lengths, g_hall, g_hfin,
                                ctx.reverse)
        outs = gru_scan_backward(*args[:4], lengths, *args[4:], ctx.reverse)
        return _direction_grads(args, h0, *outs) + (None, None)


class GRUPairScanFunction(torch.autograd.Function):
    """Both directions of a bidirectional GRU layer: the forward is
    ``gru_scan`` of each direction, as two :class:`GRUScanFunction` s run it;
    the backward one :func:`gru_scan_backward_pair` call for both, then the
    off-loop weight GEMMs of each.  Inputs: xw, w_hh, b_hh, h0 of the forward
    direction, the same of the reversed one, and the shared lengths; outputs
    (h_all, h_final) of each.  Grads equal two GRUScanFunction's."""

    @staticmethod
    def forward(ctx, xw_f, w_f, b_f, h0_f, xw_b, w_b, b_b, h0_b, lengths):
        f_all, f_fin = gru_scan(xw_f, w_f, b_f, h0_f, lengths, False)
        b_all, b_fin = gru_scan(xw_b, w_b, b_b, h0_b, lengths, True)
        ctx.save_for_backward(xw_f, f_all, w_f, b_f, h0_f, xw_b, b_all, w_b, b_b, h0_b,
                              lengths)
        return f_all, f_fin, b_all, b_fin

    @staticmethod
    def backward(ctx, gf_all, gf_fin, gb_all, gb_fin):
        saved = ctx.saved_tensors
        lengths = saved[10]
        fwd = _backward_inputs(*saved[0:5], lengths, gf_all, gf_fin, False)
        bwd = _backward_inputs(*saved[5:10], lengths, gb_all, gb_fin, True)
        outs = gru_scan_backward_pair(fwd, bwd, lengths)
        return (_direction_grads(fwd, saved[4], *outs[0])
                + _direction_grads(bwd, saved[9], *outs[1]) + (None,))


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def _lstm_gates(s):
    """s = xw + hw, (B, 4H) fp32 -> sigmoid i, f, tanh g, sigmoid o."""
    i, f, g, o = torch.chunk(s, 4, dim=1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def lstm_scan_reference(xw, w_hh, b_hh, h0, c0, lengths, reverse: bool = False,
                        with_carry: bool = False, *, chunk: Optional[int] = None):
    """Plain PyTorch version of the LSTM kernel, under K1's numeric contract:
    fp32 h and c carry, h rounded to W's dtype for the product, fp32
    accumulation, b_hh added in fp32, xw read as fp32, outputs in xw's dtype.

    xw (T, B, 4H); w_hh (H, 4H); b_hh (4H,); h0, c0 (B, H); lengths (B,).
    Gate order i, f, g, o.  Returns (h_all (T, B, H), h_final, c_final);
    steps t >= lengths[b] keep the carry and emit zeros in h_all.  With
    ``with_carry`` it returns (h_all, c_all, h_final, c_final), c_all being
    the cell-state carry after every step (not zeroed at padded steps), which
    the backward reads its predecessor c from.  ``chunk``: sum each product
    over K in chunks (:func:`step_chunked_reference`)."""
    T, B, G = xw.shape
    w = w_hh.float()
    b = b_hh.float()
    h = h0.float()
    c = c0.float()
    lengths = lengths.to(xw.device)
    h_all = torch.empty((T, B, G // 4), dtype=xw.dtype, device=xw.device)
    c_all = torch.empty_like(h_all)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hw = _product(h.to(w_hh.dtype).float(), w, chunk) + b
        i, f, g, o = _lstm_gates(xw[t].float() + hw)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = (lengths > t)[:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        h_all[t] = torch.where(m, h_new, 0.0).to(xw.dtype)
        c_all[t] = c.to(xw.dtype)
    h_fin, c_fin = h.to(xw.dtype), c.to(xw.dtype)
    return (h_all, c_all, h_fin, c_fin) if with_carry else (h_all, h_fin, c_fin)




def lstm_tile_width(H: int, device=None, *, sms: Optional[int] = None) -> int:
    """Hidden units per block of the persistent LSTM kernels (JT in
    ``csrc/lstm_fwd.cu`` / ``lstm_bwd.cu``): 4 where ceil(H / 4) blocks fit
    the card's SMs (H <= 528 on an H100 SXM), else 8.  At tiny_config's
    H=320, 80 blocks of 4 units ran both kernels faster than 40 blocks of 8
    (PERF.md)."""
    return 4 if -(-H // 4) <= _limits(device, sms, None)[0] else 8


def lstm_smem_bytes(H: int, dtype: torch.dtype, backward: bool = False,
                    jt: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of the persistent LSTM kernels
    (``csrc/rnn_persistent.cuh::slice_smem``): the block's W_hh slice, 4 JT
    gate rows of Hk forward (JT from :func:`lstm_tile_width` on the H100
    SXM unless given) or 8 chain rows of Kc backward (its JT rows of W_hh
    padded to an MMA n-tile), bf16 rows padded by 32 values, plus a 128-row
    fp32 dot buffer."""
    e = 2 if dtype == torch.bfloat16 else 4
    C = _LSTM_CHAIN_ROWS if backward else 4 * (jt or lstm_tile_width(H))
    K = _padded(4 * H) if backward else _padded(H)
    return e * C * (K + 32 if e == 2 else K) + 4 * 128 * C


def lstm_fits(H: int, B: int, dtype: torch.dtype, device=None, *,
              sms: Optional[int] = None, smem: Optional[int] = None) -> bool:
    """Whether both persistent LSTM kernels take hidden size H on the card of
    ``device`` (or one with ``sms`` SMs and ``smem`` bytes of opt-in shared
    memory per block; the H100 SXM where neither is given): ceil(H / JT)
    blocks, one per SM, must be co-resident, each holding its W_hh slice.
    B does not move the limit: rows are walked in 64-row chunks inside a
    step."""
    del B
    jt = lstm_tile_width(H, device, sms=sms)
    return _persistent_fits("lstm", H, jt,
                            (lstm_smem_bytes(H, dtype, jt=jt),
                             lstm_smem_bytes(H, dtype, True)),
                            dtype, device, sms, smem)


def lstm_max_hidden(B: int, dtype: torch.dtype, device=None, *,
                    sms: Optional[int] = None, smem: Optional[int] = None) -> int:
    """The largest hidden size the persistent LSTM kernels take on that
    card; above it the LSTM wrappers take the per-step kernels."""
    H = _limits(device, sms, smem)[0] * 8
    while H > 0 and not lstm_fits(H, B, dtype, device, sms=sms, smem=smem):
        H -= 1
    return H


def lstm_route(H: int, B: int, dtype: torch.dtype, device=None, *,
               backward: bool = False, sms: Optional[int] = None,
               smem: Optional[int] = None) -> str:
    """The LSTM kernels a CUDA call of hidden size H takes (the backward
    scan where ``backward``), as :func:`gru_route` chooses the GRU's:
    ``"persistent"``, ``"per_step"`` above :func:`lstm_max_hidden`, or
    ``"step_chunked"`` above the per-step block's whole-slice limit."""
    if lstm_fits(H, B, dtype, device, sms=sms, smem=smem):
        return "persistent"
    return _step_route("lstm", H, dtype, backward, device, smem)


def _check_lstm_args(op, xw, named, contiguous):
    """Device, shape and dtype checks of an LSTM kernel call: ``named``
    holds (name, tensor, shape, must share xw's dtype); the kernel reads xw
    and the tensors in ``contiguous`` as they are, so they must be dense."""
    if xw.dim() != 3 or xw.shape[2] % 4:
        raise ValueError(f"{op}: xw must be (T, B, 4H), got {tuple(xw.shape)}")
    if xw.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, got {xw.dtype}")
    for name, x, shape, same_dtype in named:
        if x.device != xw.device:
            raise ValueError(f"{op}: {name} is on {x.device}, xw on {xw.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(x.shape)}, expected "
                             f"{shape} for xw {tuple(xw.shape)}")
        if same_dtype and x.dtype != xw.dtype:
            raise TypeError(f"{op} kernel needs {name} in xw's dtype {xw.dtype}, "
                            f"got {x.dtype}")
    if not all(x.is_contiguous() for x in (xw,) + contiguous):
        raise ValueError(f"{op} kernel needs contiguous xw, weights and streams")


def _lstm_fwd_library():
    lib = build.load("lstm_fwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_scan_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.lstm_scan_fwd.restype = i
        for fn in (lib.lstm_scan_fwd_step, lib.lstm_scan_fwd_step_chunked):
            fn.argtypes = [p] * 11 + [i] * 7 + [p]
            fn.restype = i
        lib.lstm_scan_fwd_step_chunked_smem.argtypes = [i]
        lib.lstm_scan_fwd_step_chunked_smem.restype = i
        for fn in (lib.lstm_scan_fwd_smem, lib.lstm_scan_fwd_max_blocks):
            fn.argtypes = [i, i, i]
            fn.restype = i
        lib._argtypes_set = True
    return lib


def _lstm_scan_cuda(xw, w_hh, b_hh, h0, c0, lengths, reverse):
    T, B, G = xw.shape
    H = G // 4
    _check_lstm_args("lstm_scan", xw, (
        ("w_hh", w_hh, (H, G), True), ("b_hh", b_hh, (G,), True),
        ("h0", h0, (B, H), False), ("c0", c0, (B, H), False),
        ("lengths", lengths, (B,), False)), (w_hh, b_hh))
    dev = xw.device
    route = lstm_route(H, B, xw.dtype, dev)
    persistent = route == "persistent"
    lib = _lstm_fwd_library()
    Hk = _padded(H)
    code = _DTYPE_CODES[xw.dtype]
    with torch.cuda.device(dev):
        h_all = torch.empty((T, B, H), dtype=xw.dtype, device=dev)
        c_all = torch.empty_like(h_all)
        if T == 0:
            return h_all, c_all, h0.to(xw.dtype), c0.to(xw.dtype)
        lens = lengths.to(torch.int32).contiguous()
        h_fin = torch.empty((B, H), dtype=xw.dtype, device=dev)
        c_fin = torch.empty_like(h_fin)
        c = _fp32_copy(c0)                   # j-local carry, updated in place
        stream = torch.cuda.current_stream(dev).cuda_stream
        if persistent:
            jt = lstm_tile_width(H, dev)
            tiles = _tile_weights(w_hh, H, Hk, jt)
            hb = torch.zeros((2, B, Hk), dtype=xw.dtype, device=dev)
            hb[0, :, :H] = h0
            h = _fp32_copy(h0)               # j-local carry, updated in place
            count = torch.zeros((1,), dtype=torch.int32, device=dev)
            err = lib.lstm_scan_fwd(
                xw.data_ptr(), tiles.data_ptr(), b_hh.data_ptr(), hb.data_ptr(),
                h.data_ptr(), c.data_ptr(), h_all.data_ptr(), c_all.data_ptr(),
                h_fin.data_ptr(), c_fin.data_ptr(), lens.data_ptr(), count.data_ptr(),
                T, B, H, Hk, jt, int(reverse), code, stream)
        else:
            tiles = _tile_weights(w_hh, H, Hk, _LSTM_STEP_TILE_WIDTH)
            h_a = torch.zeros((B, Hk), dtype=torch.float32, device=dev)
            h_a[:, :H] = h0.float()
            h_b = torch.zeros_like(h_a)
            step = (lib.lstm_scan_fwd_step_chunked if route == "step_chunked"
                    else lib.lstm_scan_fwd_step)
            err = step(
                xw.data_ptr(), tiles.data_ptr(), b_hh.data_ptr(), h_a.data_ptr(),
                h_b.data_ptr(), c.data_ptr(), h_all.data_ptr(), c_all.data_ptr(),
                h_fin.data_ptr(), c_fin.data_ptr(), lens.data_ptr(), T, B, H, Hk,
                _LSTM_STEP_TILE_WIDTH, int(reverse), code, stream)
    if err != 0:
        raise _cuda_error("lstm_scan", err)
    lstm_scan.launches += 1 if persistent else T
    return h_all, c_all, h_fin, c_fin


def lstm_scan(xw, w_hh, b_hh, h0, c0, lengths, reverse: bool = False,
              with_carry: bool = False):
    """Masked LSTM scan.

    Args:
      xw: (T, B, 4H) hoisted input pre-activations (x @ W_ih + b_ih).
      w_hh: (H, 4H); b_hh: (4H,); h0, c0: (B, H); lengths: (B,) int or float.
      reverse: process t = T-1..0 (the backward direction of a bi-RNN).
    Returns:
      (h_all (T, B, H), h_final (B, H), c_final (B, H)) in xw's dtype; with
      ``with_carry``, (h_all, c_all, h_final, c_final) as
      :func:`lstm_scan_reference`.
    """
    if library.tracing(xw):
        h_all, c_all, h_fin, c_fin = torch.ops.rnntransducer_tpu_torch.lstm_scan(
            xw, w_hh, b_hh, h0, c0, lengths, bool(reverse))
    elif xw.device.type == "cpu":
        return lstm_scan_reference(xw, w_hh, b_hh, h0, c0, lengths, reverse,
                                   with_carry)
    elif xw.device.type != "cuda":
        raise ValueError(f"lstm_scan runs on cpu or cuda, not {xw.device}")
    else:
        h_all, c_all, h_fin, c_fin = _lstm_scan_cuda(xw, w_hh, b_hh, h0, c0,
                                                     lengths, reverse)
    return (h_all, c_all, h_fin, c_fin) if with_carry else (h_all, h_fin, c_fin)


lstm_scan.launches = 0


def _lstm_bwd_steps(xw, hw_of, c_prev, w_hh, lengths, g_hall, g_hfin, g_cfin,
                    reverse, chunk: Optional[int] = None):
    """The steps of the LSTM backward, the gates' hw of step t from
    ``hw_of(t)``: shared by the undecomposed plain backward and the chain's
    plain mirror."""
    T, B, G = xw.shape
    w = w_hh.float()
    lengths = lengths.to(xw.device)
    dh = g_hfin.float()
    dc = g_cfin.float()
    dxw = torch.empty((T, B, G), dtype=xw.dtype, device=xw.device)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = _lstm_gates(xw[t].float() + hw_of(t))
        cp = c_prev[t].float()
        tc = torch.tanh(f * cp + i * g)
        m = (lengths > t)[:, None]
        g_h = torch.where(m, dh + g_hall[t].float(), 0.0)
        g_c = torch.where(m, dc, 0.0)
        d_o = g_h * tc * o * (1.0 - o)
        dc_new = g_c + g_h * o * (1.0 - tc * tc)
        d_i = dc_new * g * i * (1.0 - i)
        d_f = dc_new * cp * f * (1.0 - f)
        d_g = dc_new * i * (1.0 - g * g)
        dgates = torch.cat([d_i, d_f, d_g, d_o], dim=1)
        dxw[t] = dgates.to(xw.dtype)
        dh = (_product(dgates.to(w_hh.dtype).float(), w.t(), chunk)
              + torch.where(m, 0.0, dh))
        dc = dc_new * f + torch.where(m, 0.0, dc)
    return dxw, dh.to(xw.dtype), dc.to(xw.dtype)


def lstm_scan_backward_reference(xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall,
                                 g_hfin, g_cfin, reverse: bool = False, *,
                                 chunk: Optional[int] = None):
    """Plain PyTorch version of the LSTM backward kernel, under its numeric
    contract: fp32 dh and dc carries; gates rebuilt in fp32 from xw, h_prev
    (rounded to W's dtype for the product, b_hh added in fp32) and c_prev;
    the gate grads rounded to W's dtype for the dh-chain product with fp32
    accumulation; dxw in xw's dtype.

    xw (T, B, 4H); h_prev, c_prev (T, B, H) from :func:`prev_all`; g_hall
    (T, B, H), g_hfin and g_cfin (B, H) are the cotangents of h_all,
    h_final and c_final.  Returns (dxw (T, B, 4H), dh0, dc0): dxw = [di, df,
    dg, do] of the pre-activations, which is also d(hw).  ``chunk``: sum
    each product over K in chunks (:func:`step_chunked_reference`)."""
    w = w_hh.float()
    b = b_hh.float()
    return _lstm_bwd_steps(
        xw, lambda t: _product(h_prev[t].to(w_hh.dtype).float(), w, chunk) + b,
        c_prev, w_hh, lengths, g_hall, g_hfin, g_cfin, reverse, chunk)


def step_chunked_reference(cell: str, backward: bool, *args, chunk: int = _STEP_CHUNK,
                           **kwargs):
    """The arithmetic of the per-step kernels that stream their slice
    (route ``"step_chunked"``): the plain scan of ``cell`` (``"gru"`` /
    ``"lstm"``), forward or ``backward``, with every recurrent product
    summed over K in chunks of ``chunk`` values, each chunk's partial sum
    added to the fp32 running one, as ``csrc/step_stream.cuh`` does.
    Takes and returns what :func:`gru_scan_reference`,
    :func:`gru_scan_backward_reference`, :func:`lstm_scan_reference` or
    :func:`lstm_scan_backward_reference` takes and returns."""
    fn = {("gru", False): gru_scan_reference,
          ("gru", True): gru_scan_backward_reference,
          ("lstm", False): lstm_scan_reference,
          ("lstm", True): lstm_scan_backward_reference}[(cell, backward)]
    return fn(*args, chunk=chunk, **kwargs)


def lstm_bwd_gates_reference(h_prev, w_hh, b_hh):
    """Plain version of the LSTM backward kernel's off-chain GEMM: the gate
    pre-activations of every step, hw = h_prev @ W_hh + b_hh, (T, B, 4H) in
    fp32 (h_prev rounded to W's dtype, fp32 accumulation, b_hh added in
    fp32), as the TPU kernel rebuilds them off the chain
    (``rnn_pallas.py:243-245``)."""
    return _hoisted_gates(h_prev, w_hh, b_hh)


def lstm_bwd_chain_reference(xw, hw, c_prev, w_hh, lengths, g_hall, g_hfin, g_cfin,
                             reverse: bool = False):
    """Plain version of the LSTM backward kernel's chain, given the gates'
    hw from :func:`lstm_bwd_gates_reference`: the steps of
    :func:`lstm_scan_backward_reference` with the recompute taken off the
    chain.  Returns (dxw, dh0, dc0) as that function."""
    return _lstm_bwd_steps(xw, lambda t: hw[t], c_prev, w_hh, lengths, g_hall,
                           g_hfin, g_cfin, reverse)


def lstm_weight_grads(h_prev, dxw, w_dtype):
    """dW_hh (H, 4H) and db_hh (4H,) from the backward scan's dxw (== d(hw),
    every LSTM gate being additive in xw + hw): the GEMMs the JAX package
    runs outside the loop (``rnn_pallas.py:692-698``); fp32 accumulation,
    results in ``w_dtype`` and dxw's dtype."""
    T, B, G = dxw.shape
    hp = h_prev.reshape(T * B, G // 4).to(dxw.dtype)
    with full_precision_matmul():
        dw = torch.matmul(hp.t(), dxw.reshape(T * B, G)).to(w_dtype)
    db = dxw.float().sum((0, 1)).to(dxw.dtype)
    return dw, db


def _lstm_bwd_library():
    lib = build.load("lstm_bwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_scan_bwd.argtypes = [p] * 16 + [i] * 8 + [p]
        lib.lstm_scan_bwd.restype = i
        for fn in (lib.lstm_scan_bwd_step, lib.lstm_scan_bwd_step_chunked):
            fn.argtypes = [p] * 16 + [i] * 8 + [p]
            fn.restype = i
        lib.lstm_scan_bwd_step_chunked_smem.argtypes = [i]
        lib.lstm_scan_bwd_step_chunked_smem.restype = i
        lib.lstm_scan_bwd_smem.argtypes = [i, i]
        lib.lstm_scan_bwd_smem.restype = i
        lib.lstm_scan_bwd_max_blocks.argtypes = [i, i, i]
        lib.lstm_scan_bwd_max_blocks.restype = i
        lib._argtypes_set = True
    return lib


def _lstm_chain_tiles(w_hh: torch.Tensor, H: int, Kc: int, jt: int) -> torch.Tensor:
    """(H, 4H) -> (ceil(H/jt), 8, Kc): block i's jt rows of W_hh
    (:func:`_chain_tiles`), padded with zero rows to the persistent chain's
    8-row slice."""
    tiles = _chain_tiles(w_hh, H, Kc, jt)
    return F.pad(tiles, (0, 0, 0, _LSTM_CHAIN_ROWS - jt)).contiguous()


def _lstm_scan_backward_cuda(xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall,
                             g_hfin, g_cfin, reverse):
    T, B, G = xw.shape
    H = G // 4
    _check_lstm_args("lstm_scan_backward", xw, (
        ("h_prev", h_prev, (T, B, H), True), ("c_prev", c_prev, (T, B, H), True),
        ("w_hh", w_hh, (H, G), True), ("b_hh", b_hh, (G,), True),
        ("lengths", lengths, (B,), False), ("g_hall", g_hall, (T, B, H), True),
        ("g_hfin", g_hfin, (B, H), True), ("g_cfin", g_cfin, (B, H), True)),
        (c_prev, w_hh, b_hh, g_hall))
    dev = xw.device
    route = lstm_route(H, B, xw.dtype, dev, backward=True)
    persistent = route == "persistent"
    lib = _lstm_bwd_library()
    Hk, Kc = _padded(H), _padded(G)
    code = _DTYPE_CODES[xw.dtype]
    with torch.cuda.device(dev):
        dxw = torch.empty((T, B, G), dtype=xw.dtype, device=dev)
        if T == 0:
            return dxw, g_hfin.clone(), g_cfin.clone()
        dc = _fp32_copy(g_cfin)              # j-local carry, updated in place
        lens = lengths.to(torch.int32).contiguous()
        dh0 = torch.empty((B, H), dtype=xw.dtype, device=dev)
        dc0 = torch.empty_like(dh0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if persistent:
            jt = lstm_tile_width(H, dev)
            hprev, w_t = _gemm_operands(h_prev, w_hh, Hk)
            chain = _lstm_chain_tiles(w_hh, H, Kc, jt)
            hw = torch.empty((T, B, G), dtype=torch.float32, device=dev)
            dgates = torch.zeros((2, B, Kc), dtype=xw.dtype, device=dev)
            rest = _fp32_copy(g_hfin)        # j-local carry, updated in place
            count = torch.zeros((1,), dtype=torch.int32, device=dev)
            err = lib.lstm_scan_bwd(
                xw.data_ptr(), hprev.data_ptr(), c_prev.data_ptr(), g_hall.data_ptr(),
                w_t.data_ptr(), chain.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                hw.data_ptr(), dgates.data_ptr(), rest.data_ptr(), dc.data_ptr(),
                dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), count.data_ptr(),
                T, B, H, Hk, Kc, jt, int(reverse), code, stream)
        else:
            jt = _LSTM_STEP_TILE_WIDTH
            rec = _tile_weights(w_hh, H, Hk, jt)
            chain = _chain_tiles(w_hh, H, Kc, jt)
            hprev = F.pad(h_prev, (0, Hk - H)).contiguous()
            dgates = torch.zeros((2, B, Kc), dtype=torch.float32, device=dev)
            rest = torch.empty((2, B, H), dtype=torch.float32, device=dev)
            rest[0] = g_hfin.float()
            step = (lib.lstm_scan_bwd_step_chunked if route == "step_chunked"
                    else lib.lstm_scan_bwd_step)
            err = step(
                xw.data_ptr(), hprev.data_ptr(), c_prev.data_ptr(), g_hall.data_ptr(),
                rec.data_ptr(), chain.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                dgates[0].data_ptr(), dgates[1].data_ptr(), rest[0].data_ptr(),
                rest[1].data_ptr(), dc.data_ptr(), dxw.data_ptr(), dh0.data_ptr(),
                dc0.data_ptr(), T, B, H, Hk, Kc, jt, int(reverse), code, stream)
    if err != 0:
        raise _cuda_error("lstm_scan_backward", err)
    lstm_scan_backward.launches += 2 if persistent else T + 1
    return dxw, dh0, dc0


def lstm_scan_backward(xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall, g_hfin,
                       g_cfin, reverse: bool = False):
    """Backward through a masked LSTM scan; see
    :func:`lstm_scan_backward_reference` for the arguments and results."""
    if library.tracing(xw):
        return torch.ops.rnntransducer_tpu_torch.lstm_scan_backward(
            xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall, g_hfin, g_cfin,
            bool(reverse))
    if xw.device.type == "cpu":
        return lstm_scan_backward_reference(xw, h_prev, c_prev, w_hh, b_hh, lengths,
                                            g_hall, g_hfin, g_cfin, reverse)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_scan_backward runs on cpu or cuda, not {xw.device}")
    return _lstm_scan_backward_cuda(xw, h_prev, c_prev, w_hh, b_hh, lengths,
                                    g_hall, g_hfin, g_cfin, reverse)


lstm_scan_backward.launches = 0


class LSTMScanFunction(torch.autograd.Function):
    """``lstm_scan`` with the JAX package's custom VJP: the forward keeps the
    cell-state carry c_all, the backward builds both predecessor streams
    with :func:`prev_all` and runs the backward scan plus the off-loop
    weight GEMMs.  Returns (h_all, h_final, c_final); grads for xw, w_hh,
    b_hh, h0 and c0 (in their dtypes), none for lengths and reverse; a
    missing cotangent counts as zeros."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh, h0, c0, lengths, reverse):
        h_all, c_all, h_fin, c_fin = lstm_scan(xw, w_hh, b_hh, h0, c0, lengths,
                                               reverse, with_carry=True)
        ctx.save_for_backward(xw, h_all, c_all, w_hh, b_hh, h0, c0, lengths)
        ctx.reverse = reverse
        return h_all, h_fin, c_fin

    @staticmethod
    def backward(ctx, g_hall, g_hfin, g_cfin):
        xw, h_all, c_all, w_hh, b_hh, h0, c0, lengths = ctx.saved_tensors
        dt = h_all.dtype
        g_hall = (torch.zeros_like(h_all) if g_hall is None
                  else g_hall.to(dt).contiguous())
        g_hfin = (torch.zeros_like(h0, dtype=dt) if g_hfin is None
                  else g_hfin.to(dt).contiguous())
        g_cfin = (torch.zeros_like(c0, dtype=dt) if g_cfin is None
                  else g_cfin.to(dt).contiguous())
        h_prev = prev_all(h_all, h0, lengths, ctx.reverse)
        c_prev = prev_all(c_all, c0, lengths, ctx.reverse)
        dxw, dh0, dc0 = lstm_scan_backward(xw, h_prev, c_prev, w_hh, b_hh, lengths,
                                           g_hall, g_hfin, g_cfin, ctx.reverse)
        dw, db = lstm_weight_grads(h_prev, dxw, w_hh.dtype)
        return (dxw, dw, db.to(b_hh.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype),
                None, None)
