"""RNN-T lattice sweep: the CUDA kernel's wrapper and its plain version.

``sweep`` computes what the JAX package's ``rnnt_loss._sweep`` and
``rnnt_pallas.sweep_pallas`` compute: alpha over N independent (T, U+1)
lattices, one label column at a time.  It dispatches on the device of its
inputs: a CPU tensor goes to :func:`sweep_reference`; a CUDA tensor goes to
the hand-written kernel ``csrc/rnnt_sweep.cu`` or the call raises.  There is
no fallback from the kernel to the plain version.  While a tracer runs it
calls the registered op ``rnntransducer_tpu_torch::rnnt_sweep`` instead
(``ops/library.py``).

``sweep.launches`` counts the kernel launches (one per call).
:func:`sweep_chunked_reference` is the plain mirror of the kernel's
decomposition: T in chunks, each column's running sum and running
logsumexp carried from chunk to chunk.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.ops import build, library

NEG = -1e30  # the loss's fill (rnnt_loss.py)


def exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift-then-cumsum along ``dim``, NOT cumsum(x) - x: the latter cancels
    catastrophically when x holds the -1e30 fills ((finite + NEG) - NEG = 0).
    Port of ``rnnt_loss.py::_exclusive_cumsum``."""
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - 1 - dim) + [1, 0]
    shifted = F.pad(x, pad).narrow(dim, 0, x.shape[dim])
    return torch.cumsum(shifted, dim=dim)


def sweep_reference(blank_edge: torch.Tensor, label_edge: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (``rnnt_loss.py::_sweep``).

    blank_edge[n, t, u] is the log-weight of (t, u) -> (t+1, u);
    label_edge[n, t, u] that of (t, u) -> (t, u+1); alpha[n, 0, 0] = 0.
    Both (N, T, U+1) float32; returns alpha (N, T, U+1) float32."""
    col = exclusive_cumsum(blank_edge[:, :, 0], 1)
    cols = [col]
    for u in range(1, blank_edge.shape[2]):
        d = col + label_edge[:, :, u - 1]
        cb = exclusive_cumsum(blank_edge[:, :, u], 1)
        col = cb + torch.logcumsumexp(d - cb, dim=1)
        cols.append(col)
    return torch.stack(cols, dim=2)


def sweep_chunked_reference(blank_edge: torch.Tensor, label_edge: torch.Tensor,
                            chunk: int) -> torch.Tensor:
    """:func:`sweep_reference` computed as the kernel splits it: T in chunks of
    ``chunk`` steps, column by column, each column's exclusive cumsum of
    blank_edge and its running logsumexp carried from one chunk into the
    next.  Same arguments and result."""
    N, T, U1 = blank_edge.shape
    cb_carry = blank_edge.new_zeros((N, U1))
    l_carry = blank_edge.new_full((N, U1), NEG)
    out = []
    for t0 in range(0, T, chunk):
        be, le = blank_edge[:, t0:t0 + chunk], label_edge[:, t0:t0 + chunk]
        cols = []
        for u in range(U1):
            cb = cb_carry[:, u:u + 1] + exclusive_cumsum(be[:, :, u], 1)
            cb_carry[:, u] += be[:, :, u].sum(1)
            if u == 0:
                col = cb
            else:
                d = (col + le[:, :, u - 1]) - cb
                lse = torch.logaddexp(l_carry[:, u:u + 1], torch.logcumsumexp(d, 1))
                l_carry[:, u] = lse[:, -1]
                col = cb + lse
            cols.append(col)
        out.append(torch.stack(cols, dim=2))
    return torch.cat(out, dim=1)


def _library():
    lib = build.load("rnnt_sweep")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_sweep.argtypes = [p, p, p, p, i, i, i, p]
        lib.rnnt_sweep.restype = i
        lib._argtypes_set = True
    return lib


def _sweep_cuda(blank_edge, label_edge):
    if blank_edge.dim() != 3 or blank_edge.shape != label_edge.shape:
        raise ValueError(f"sweep: edges must be two (N, T, U+1) arrays, got "
                         f"{tuple(blank_edge.shape)} and {tuple(label_edge.shape)}")
    if label_edge.device != blank_edge.device:
        raise ValueError(f"sweep: label_edge is on {label_edge.device}, "
                         f"blank_edge on {blank_edge.device}")
    if blank_edge.dtype != torch.float32 or label_edge.dtype != torch.float32:
        raise TypeError(f"sweep kernel takes float32 edges, got {blank_edge.dtype} "
                        f"and {label_edge.dtype}")
    N, T, U1 = blank_edge.shape
    lib = _library()
    dev = blank_edge.device
    with torch.cuda.device(dev):
        be, le = blank_edge.contiguous(), label_edge.contiguous()
        alpha = torch.empty((N, T, U1), dtype=torch.float32, device=dev)
        if N == 0 or T == 0 or U1 == 0:
            return alpha
        carry = torch.empty((N, 2, U1), dtype=torch.float32, device=dev)
        err = lib.rnnt_sweep(be.data_ptr(), le.data_ptr(), alpha.data_ptr(),
                             carry.data_ptr(), N, T, U1,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel failed with CUDA error {err}")
    sweep.launches += 1
    return alpha


def sweep(blank_edge: torch.Tensor, label_edge: torch.Tensor) -> torch.Tensor:
    """alpha (N, T, U+1) of N lattices; see :func:`sweep_reference`."""
    if library.tracing(blank_edge):
        return torch.ops.rnntransducer_tpu_torch.rnnt_sweep(blank_edge, label_edge)
    if blank_edge.device.type == "cpu":
        return sweep_reference(blank_edge, label_edge)
    if blank_edge.device.type != "cuda":
        raise ValueError(f"sweep runs on cpu or cuda, not {blank_edge.device}")
    return _sweep_cuda(blank_edge, label_edge)


sweep.launches = 0
