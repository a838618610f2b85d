"""RNN-T lattice sweep: the CUDA kernel's wrapper and its plain version.

``sweep`` computes what the JAX package's ``rnnt_loss._sweep`` and
``rnnt_pallas.sweep_pallas`` compute: alpha over N independent (T, U+1)
lattices, one label column at a time.  It dispatches on the device of its
inputs: a CPU tensor goes to :func:`sweep_reference`; a CUDA tensor goes to
the hand-written kernel ``csrc/rnnt_sweep.cu`` or the call raises.  There is
no fallback from the kernel to the plain version.

``sweep.launches`` counts the kernel launches (one per call).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.ops import build


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


def _library():
    lib = build.load("rnnt_sweep")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_sweep.argtypes = [p, p, p, i, i, i, p]
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
    if T > 8192:
        raise ValueError(f"sweep kernel takes T <= 8192, got {T}")
    lib = _library()
    dev = blank_edge.device
    with torch.cuda.device(dev):
        # time-contiguous (N, U+1, T): a column is one coalesced row
        be = blank_edge.transpose(1, 2).contiguous()
        le = label_edge.transpose(1, 2).contiguous()
        alpha = torch.empty((N, U1, T), dtype=torch.float32, device=dev)
        if N == 0 or T == 0 or U1 == 0:
            return alpha.transpose(1, 2)
        err = lib.rnnt_sweep(be.data_ptr(), le.data_ptr(), alpha.data_ptr(), N, T,
                             U1, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel failed with CUDA error {err}")
    sweep.launches += 1
    return alpha.transpose(1, 2)


def sweep(blank_edge: torch.Tensor, label_edge: torch.Tensor) -> torch.Tensor:
    """alpha (N, T, U+1) of N lattices; see :func:`sweep_reference`."""
    if blank_edge.device.type == "cpu":
        return sweep_reference(blank_edge, label_edge)
    if blank_edge.device.type != "cuda":
        raise ValueError(f"sweep runs on cpu or cuda, not {blank_edge.device}")
    return _sweep_cuda(blank_edge, label_edge)


sweep.launches = 0
