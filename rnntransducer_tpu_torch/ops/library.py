"""The port's six kernels as ``torch.library`` custom ops, so that a tracer
(``torch.export``, ``torch.compile``) sees each kernel call as one node.

The kernels are called through ``ctypes`` (``ops/build.py``), which no
tracer can follow.  Each op here has three implementations:

* CUDA: the kernel's wrapper body (``rnn_kernels._gru_scan_cuda`` and the
  like), unchanged: it launches the kernel and counts the launch;
* CPU: the kernel's plain version;
* fake (``register_fake``): the output shapes and dtypes, for tracing.

| op (``rnntransducer_tpu_torch::``) | kernel | JAX kernel it replaces |
| --- | --- | --- |
| ``gru_scan`` | K1 ``csrc/gru_fwd.cu`` | ``ops/rnn_pallas.py`` ``_gru_fwd_kernel`` |
| ``gru_scan_backward`` | K2 ``csrc/gru_bwd.cu`` | ``_gru_bwd_kernel`` |
| ``lstm_scan`` | K3 ``csrc/lstm_fwd.cu`` | ``_lstm_fwd_kernel`` |
| ``lstm_scan_backward`` | K4 ``csrc/lstm_bwd.cu`` | ``_lstm_bwd_kernel`` |
| ``rnnt_sweep`` | K5 ``csrc/rnnt_sweep.cu`` | ``ops/rnnt_pallas.py`` ``_sweep_kernel`` |
| ``logmel_rows`` | K6 ``csrc/logmel.cu`` | ``frontend/pallas_frontend.py`` ``_logmel_kernel`` |

Eager calls do not go through these ops: Python custom-op dispatch costs
tens of microseconds a call, and the decoders are launch-bound.  The
wrappers (``rnn_kernels.gru_scan`` ...) call an op only while a tracer runs
(:func:`tracing`), and they check that before the device: a program traced
on the CPU holds the op nodes, not the plain versions' aten ops, so the
same program reaches the kernels once it is moved to the card.  Both routes
end in the same CUDA function on a CUDA tensor, so the launch counters
count on both.

The ops have no autograd formula: a traced program is for inference, and
training keeps ``GRUScanFunction`` / ``LSTMScanFunction``.  An op never
returns an alias of an input (a custom op may not): the plain versions hand
back their initial carry when T == 0, and the op returns a copy of it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.multiprocessing.reductions import StorageWeakRef

NAMESPACE = "rnntransducer_tpu_torch"
OPS = ("gru_scan", "gru_scan_backward", "lstm_scan", "lstm_scan_backward",
       "rnnt_sweep", "logmel_rows")


def tracing(x: Tensor) -> bool:
    """True while a tracer runs the caller: under ``torch.compile`` /
    ``torch.export``, or on a fake tensor."""
    return torch.compiler.is_compiling() or isinstance(x, FakeTensor)


def _fresh(outs, *inputs):
    """``outs`` with every tensor that shares an input's storage copied."""
    held = {StorageWeakRef(t.untyped_storage()) for t in inputs}
    return tuple(o.clone() if StorageWeakRef(o.untyped_storage()) in held else o
                 for o in outs)


def _rnn():
    from rnntransducer_tpu_torch.ops import rnn_kernels
    return rnn_kernels


# -- K1: GRU forward ---------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::gru_scan", mutates_args=(), device_types="cpu")
def gru_scan(xw: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor, lengths: Tensor,
             reverse: bool) -> Tuple[Tensor, Tensor]:
    """(h_all (T, B, H), h_final (B, H)); see ``rnn_kernels.gru_scan``."""
    out = _rnn().gru_scan_reference(xw, w_hh, b_hh, h0, lengths, reverse)
    return _fresh(out, xw, w_hh, b_hh, h0, lengths)


@gru_scan.register_kernel("cuda")
def _(xw, w_hh, b_hh, h0, lengths, reverse):
    return _fresh(_rnn()._gru_scan_cuda(xw, w_hh, b_hh, h0, lengths, reverse),
                  xw, w_hh, b_hh, h0, lengths)


@gru_scan.register_fake
def _(xw, w_hh, b_hh, h0, lengths, reverse):
    T, B, G = xw.shape
    return xw.new_empty((T, B, G // 3)), xw.new_empty((B, G // 3))


# -- K2: GRU backward --------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::gru_scan_backward", mutates_args=(),
                         device_types="cpu")
def gru_scan_backward(xw: Tensor, h_prev: Tensor, w_hh: Tensor, b_hh: Tensor,
                      lengths: Tensor, g_hall: Tensor, g_hfin: Tensor,
                      reverse: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """(dxw (T, B, 3H), dnr (T, B, H), dh0 (B, H)); see
    ``rnn_kernels.gru_scan_backward``."""
    args = (xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin)
    return _fresh(_rnn().gru_scan_backward_reference(*args, reverse), *args)


@gru_scan_backward.register_kernel("cuda")
def _(xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin, reverse):
    args = (xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin)
    return _fresh(_rnn()._gru_scan_backward_cuda(*args, reverse), *args)


@gru_scan_backward.register_fake
def _(xw, h_prev, w_hh, b_hh, lengths, g_hall, g_hfin, reverse):
    T, B, G = xw.shape
    return (xw.new_empty((T, B, G)), xw.new_empty((T, B, G // 3)),
            xw.new_empty((B, G // 3)))


# -- K3: LSTM forward --------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::lstm_scan", mutates_args=(), device_types="cpu")
def lstm_scan(xw: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor, c0: Tensor,
              lengths: Tensor, reverse: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(h_all, c_all (T, B, H), h_final, c_final (B, H)): the wrapper's
    ``with_carry`` results; see ``rnn_kernels.lstm_scan``."""
    args = (xw, w_hh, b_hh, h0, c0, lengths)
    return _fresh(_rnn().lstm_scan_reference(*args, reverse, True), *args)


@lstm_scan.register_kernel("cuda")
def _(xw, w_hh, b_hh, h0, c0, lengths, reverse):
    args = (xw, w_hh, b_hh, h0, c0, lengths)
    return _fresh(_rnn()._lstm_scan_cuda(*args, reverse), *args)


@lstm_scan.register_fake
def _(xw, w_hh, b_hh, h0, c0, lengths, reverse):
    T, B, G = xw.shape
    return (xw.new_empty((T, B, G // 4)), xw.new_empty((T, B, G // 4)),
            xw.new_empty((B, G // 4)), xw.new_empty((B, G // 4)))


# -- K4: LSTM backward -------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::lstm_scan_backward", mutates_args=(),
                         device_types="cpu")
def lstm_scan_backward(xw: Tensor, h_prev: Tensor, c_prev: Tensor, w_hh: Tensor,
                       b_hh: Tensor, lengths: Tensor, g_hall: Tensor, g_hfin: Tensor,
                       g_cfin: Tensor, reverse: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """(dxw (T, B, 4H), dh0, dc0 (B, H)); see
    ``rnn_kernels.lstm_scan_backward``."""
    args = (xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall, g_hfin, g_cfin)
    return _fresh(_rnn().lstm_scan_backward_reference(*args, reverse), *args)


@lstm_scan_backward.register_kernel("cuda")
def _(xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall, g_hfin, g_cfin, reverse):
    args = (xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall, g_hfin, g_cfin)
    return _fresh(_rnn()._lstm_scan_backward_cuda(*args, reverse), *args)


@lstm_scan_backward.register_fake
def _(xw, h_prev, c_prev, w_hh, b_hh, lengths, g_hall, g_hfin, g_cfin, reverse):
    T, B, G = xw.shape
    return (xw.new_empty((T, B, G)), xw.new_empty((B, G // 4)),
            xw.new_empty((B, G // 4)))


# -- K5: the RNN-T lattice sweep ---------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::rnnt_sweep", mutates_args=(), device_types="cpu")
def rnnt_sweep(blank_edge: Tensor, label_edge: Tensor) -> Tensor:
    """alpha (N, T, U+1) float32; see ``rnnt_kernels.sweep``."""
    from rnntransducer_tpu_torch.ops import rnnt_kernels
    return rnnt_kernels.sweep_reference(blank_edge, label_edge)


@rnnt_sweep.register_kernel("cuda")
def _(blank_edge, label_edge):
    from rnntransducer_tpu_torch.ops import rnnt_kernels
    return rnnt_kernels._sweep_cuda(blank_edge, label_edge)


@rnnt_sweep.register_fake
def _(blank_edge, label_edge):
    return blank_edge.new_empty(blank_edge.shape, dtype=torch.float32)


# -- K6: log-mel of frame rows -----------------------------------------------

def audio_config(sample_rate: int, window_size_sec: float, window: str, n_mels: int):
    """The ``AudioConfig`` of the fields the log-mel kernel reads."""
    from rnntransducer_tpu_torch.config import AudioConfig
    return AudioConfig(sample_rate=sample_rate, window_size_sec=window_size_sec,
                       window=window, n_mels=n_mels)


@torch.library.custom_op(f"{NAMESPACE}::logmel_rows", mutates_args=(), device_types="cpu")
def logmel_rows(rows: Tensor, sample_rate: int, window_size_sec: float, window: str,
                n_mels: int, high_precision: bool) -> Tensor:
    """log1p(mel(|DFT(rows)|^2)) of frame rows (R, n_fft) float32 -> (R,
    n_mels) float32 under the kernel's numeric contract; see
    ``fused_frontend.logmel_rows_cuda``."""
    from rnntransducer_tpu_torch.frontend import fused_frontend as ff
    cfg = audio_config(sample_rate, window_size_sec, window, n_mels)
    power = ff.dft_power_reference(rows, cfg, high_precision)
    return ff.mel_reference(power, cfg).contiguous()


@logmel_rows.register_kernel("cuda")
def _(rows, sample_rate, window_size_sec, window, n_mels, high_precision):
    from rnntransducer_tpu_torch.frontend import fused_frontend as ff
    cfg = audio_config(sample_rate, window_size_sec, window, n_mels)
    return ff.logmel_rows_cuda(rows, cfg, high_precision)


@logmel_rows.register_fake
def _(rows, sample_rate, window_size_sec, window, n_mels, high_precision):
    return rows.new_empty((rows.shape[0], n_mels), dtype=torch.float32)
