"""Masked GRU recurrence: the CUDA kernel's wrapper and its plain version.

``gru_scan`` has the signature and layout of the JAX package's
``rnntransducer_tpu/ops/rnn_pallas.py::gru_scan``.  It dispatches on the
device of ``xw``: a CPU tensor goes to :func:`gru_scan_reference`; a CUDA
tensor goes to the hand-written kernel ``csrc/gru_fwd.cu`` or the call
raises.  There is no fallback from the kernel to the plain version.

``gru_scan.launches`` counts the kernel launches the wrapper made (one per
timestep), so a run can show that its GRU layers went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_WIDTH = 8                    # hidden units per block (kJT in the kernel)
_K_ALIGN = 64                      # the kernel's K loop walks 64 at a time


def gru_scan_reference(xw, w_hh, b_hh, h0, lengths, reverse: bool = False):
    """Plain PyTorch version of the kernel, under the same numeric contract:
    fp32 carry, h rounded to W's dtype for the product, fp32 accumulation,
    b_hh added in fp32, xw read as fp32, outputs in xw's dtype.

    xw (T, B, 3H); w_hh (H, 3H); b_hh (3H,); h0 (B, H); lengths (B,).
    Returns (h_all (T, B, H), h_final (B, H)); steps t >= lengths[b] keep
    the carry and emit zeros."""
    T, B, G = xw.shape
    H = G // 3
    w = w_hh.float()
    b = b_hh.float()
    h = h0.float()
    lengths = lengths.to(xw.device)
    h_all = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hw = torch.matmul(h.to(w_hh.dtype).float(), w) + b
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
        lib.gru_scan_fwd.argtypes = [p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i, p]
        lib.gru_scan_fwd.restype = i
        lib._argtypes_set = True
    return lib


def _tile_weights(w_hh: torch.Tensor, H: int, Hk: int, jt: int) -> torch.Tensor:
    """(H, 3H) -> (ceil(H/jt), 3*jt, Hk): block i's r, z, n columns for its
    jt hidden units, transposed so K runs contiguously, zero padded for
    k >= H and j >= H."""
    Hp = -(-H // jt) * jt
    w3 = F.pad(w_hh.view(H, 3, H), (0, Hp - H, 0, 0, 0, Hk - H))
    return (w3.view(Hk, 3, Hp // jt, jt).permute(2, 1, 3, 0)
            .reshape(Hp // jt, 3 * jt, Hk).contiguous())


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

    lib = _library()
    Hk = -(-H // _K_ALIGN) * _K_ALIGN
    with torch.cuda.device(dev):
        tiles = _tile_weights(w_hh, H, Hk, _TILE_WIDTH)
        h_a = torch.zeros((B, Hk), dtype=torch.float32, device=dev)
        h_a[:, :H] = h0.float()
        h_b = torch.zeros_like(h_a)
        lens = lengths.to(torch.int32).contiguous()
        h_all = torch.empty((T, B, H), dtype=xw.dtype, device=dev)
        if T == 0:
            return h_all, h0.to(xw.dtype)
        h_fin = torch.empty((B, H), dtype=xw.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gru_scan_fwd(
            xw.data_ptr(), tiles.data_ptr(), b_hh.data_ptr(), h_a.data_ptr(),
            h_b.data_ptr(), h_all.data_ptr(), h_fin.data_ptr(),
            lens.data_ptr(), T, B, H, Hk, _TILE_WIDTH, int(reverse),
            _DTYPE_CODES[xw.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gru_scan kernel failed with CUDA error {err}")
    gru_scan.launches += T
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
    if xw.device.type == "cpu":
        return gru_scan_reference(xw, w_hh, b_hh, h0, lengths, reverse)
    if xw.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cpu or cuda, not {xw.device}")
    return _gru_scan_cuda(xw, w_hh, b_hh, h0, lengths, reverse)


gru_scan.launches = 0
