"""Fused log-mel frontend: the CUDA kernel's wrapper and its plain version
(port of ``rnntransducer_tpu/frontend/pallas_frontend.py``).

The torchaudio chain STFT -> power -> mel -> log1p, with the DFT written as
two real matrix products so that everything after framing is one kernel:

    frames (rows, n_fft) @ windowed DFT cos / sin (n_fft, 256) -> re, im
    power = re^2 + im^2 -> @ HTK mel filterbank (256, 128) -> log1p

The window is folded into the DFT matrices; bins and mel filters are zero
padded (zero rows and columns contribute nothing).  Normalisation and the
center / reflect framing (with the exact tail reflection when lengths are
given) stay outside the kernel, in :mod:`frontend.melspec`, as in the JAX
package.

Numeric contract: the products take bf16 operands and accumulate in fp32,
which is what the TPU kernel computes (Mosaic's dot of fp32 operands is one
bf16 pass).  ``high_precision=True`` splits the DFT into the three bf16
products of ``_dot3`` (~fp32 accuracy); the mel product is one bf16 pass in
both modes.  :func:`logmel_fused_reference` makes every rounding explicit
and multiplies in fp32, so on the CPU it is exact up to summation order.

``logmel_fused`` dispatches on the device of ``wav``: the plain version for
a CPU tensor, the hand-written kernel ``csrc/logmel.cu`` for a CUDA tensor,
or the call raises.  ``logmel_fused.launches`` counts its kernel launches
(one per call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.frontend.melspec import (WINDOWS, frame_signal,
                                                      mean_var_normalize,
                                                      mel_filterbank)
from rnntransducer_tpu_torch.ops import build
from rnntransducer_tpu_torch.utils.precision import full_precision_matmul

# the kernel's fixed widths: DFT bins padded to 256, mel filters to 128, the
# sample axis of a frame to a multiple of 16 (one tensor-core K step)
_BINS, _MELS, _K_STEP = 256, 128, 16


def _round_up(x, m):
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=8)
def _dft_mats(n_fft: int, window: str, n_mels: int, sample_rate: int):
    """Windowed DFT cos/sin matrices (n_fft, Kp) and padded filterbank
    (Kp, Mp) as numpy constants, Kp and Mp rounded up to 128 (the JAX
    package's ``pallas_frontend._dft_mats``)."""
    K = n_fft // 2 + 1
    Kp = _round_up(K, 128)
    Mp = _round_up(n_mels, 128)
    win = WINDOWS[window](n_fft).astype(np.float64)
    n = np.arange(n_fft)[:, None]
    k = np.arange(K)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    wc = np.zeros((n_fft, Kp), np.float32)
    ws = np.zeros((n_fft, Kp), np.float32)
    wc[:, :K] = (np.cos(ang) * win[:, None]).astype(np.float32)
    ws[:, :K] = (-np.sin(ang) * win[:, None]).astype(np.float32)
    fb = np.zeros((Kp, Mp), np.float32)
    fb[:K, :n_mels] = mel_filterbank(K, n_mels, sample_rate)
    return wc, ws, fb


def _mats(cfg: AudioConfig, device):
    return _on_device(_dft_mats, cfg.n_fft, cfg.window, cfg.n_mels,
                      cfg.sample_rate, str(device), torch.float32)


@functools.lru_cache(maxsize=16)
def _on_device(make, n_fft, window, n_mels, sample_rate, device, dtype):
    """``make``'s numpy constants as tensors of ``dtype`` on ``device``,
    copied once per device."""
    return tuple(torch.from_numpy(a).to(device, dtype)
                 for a in make(n_fft, window, n_mels, sample_rate))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _dot1(x, w):
    """One bf16 pass: both operands rounded to bf16, products and sums in
    fp32 (a product of two bf16 values is exact in fp32)."""
    return torch.matmul(_bf16(x), _bf16(w))


def _dot3(x, w):
    """The bf16x3 split of the JAX package's ``_dot3``:
    xh wh + xh wl + xl wh with xh = bf16(x), xl = bf16(x - xh), alike for w."""
    xh, wh = _bf16(x), _bf16(w)
    xl, wl = _bf16(x - xh), _bf16(w - wh)
    return torch.matmul(xh, wh) + torch.matmul(xh, wl) + torch.matmul(xl, wh)


def dft_power_reference(rows, cfg: AudioConfig, high_precision: bool = False):
    """re^2 + im^2 of frame rows (R, n_fft) fp32 -> (R, Kp) fp32, before the
    bf16 rounding the mel product applies."""
    wc, ws, _ = _mats(cfg, rows.device)
    dot = _dot3 if high_precision else _dot1
    with full_precision_matmul():
        re, im = dot(rows, wc), dot(rows, ws)
    return re * re + im * im


def mel_reference(power, cfg: AudioConfig):
    """log1p(power @ filterbank) in one bf16 pass: (R, Kp) -> (R, n_mels)."""
    _, _, fb = _mats(cfg, power.device)
    with full_precision_matmul():
        return torch.log1p(_dot1(power, fb))[:, :cfg.n_mels]


def _frames(wav, cfg: AudioConfig, wav_lengths):
    """Normalised, framed signal as (B * F, n_fft) fp32 rows, and F."""
    wav = wav.to(torch.float32)
    if cfg.normalize:
        wav = mean_var_normalize(wav, wav_lengths)
    frames = frame_signal(wav, cfg.n_fft, cfg.hop_length, wav_lengths)
    return frames.reshape(-1, cfg.n_fft).contiguous(), frames.shape[1]


def _lengths(wav, cfg: AudioConfig, wav_lengths, F: int):
    if wav_lengths is None:
        return torch.full((wav.shape[0],), F, dtype=torch.int32, device=wav.device)
    return wav_lengths.to(torch.int32) // cfg.hop_length + 1


def logmel_fused_reference(wav, cfg: AudioConfig, wav_lengths=None,
                           high_precision: bool = False):
    """Plain PyTorch version of the kernel: wav (B, S) -> ((B, F, n_mels)
    fp32 log-mel features, (B,) int32 frame lengths ``wav_lengths // hop +
    1``).  Frames past an utterance's length hold padding."""
    rows, F = _frames(wav, cfg, wav_lengths)
    feats = mel_reference(dft_power_reference(rows, cfg, high_precision), cfg)
    return (feats.reshape(wav.shape[0], F, cfg.n_mels),
            _lengths(wav, cfg, wav_lengths, F))


@functools.lru_cache(maxsize=8)
def _kernel_mats_np(n_fft: int, window: str, n_mels: int, sample_rate: int):
    """The kernel's operands: cos / sin as bf16 high and low parts, zero
    padded to (round_up(n_fft, 16), 256), and the filterbank in bf16 padded
    to (256, 128), as float32 numpy arrays holding bf16 values."""
    wc, ws, fb = _dft_mats(n_fft, window, n_mels, sample_rate)
    Kf = _round_up(n_fft, _K_STEP)
    out = []
    for w in (wc, ws):
        full = np.zeros((Kf, _BINS), np.float32)
        full[:n_fft, :w.shape[1]] = w
        hi = _bf16(torch.from_numpy(full))
        out += [hi, _bf16(torch.from_numpy(full) - hi)]
    fbp = np.zeros((_BINS, _MELS), np.float32)
    fbp[:fb.shape[0], :fb.shape[1]] = fb
    return tuple(a.numpy() for a in out) + (_bf16(torch.from_numpy(fbp)).numpy(),)


def _library():
    lib = build.load("logmel")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.logmel_rows.argtypes = [p, i, i, i, p, p, p, p, p, p, i, p, i, p]
        lib.logmel_rows.restype = i
        lib._argtypes_set = True
    return lib


def logmel_rows_cuda(rows, cfg: AudioConfig, high_precision: bool = False,
                     power: Optional[torch.Tensor] = None):
    """The kernel on frame rows (R, n_fft) fp32 on the card -> (R, n_mels)
    fp32.  ``power``, a (R, 256) fp32 tensor, also receives re^2 + im^2
    before its bf16 rounding (for checking the two stages apart)."""
    if rows.device.type != "cuda":
        raise ValueError(f"the logmel kernel runs on cuda, not {rows.device}")
    R, n_fft = rows.shape
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise TypeError("the logmel kernel takes contiguous float32 frame rows")
    if n_fft != cfg.n_fft or n_fft // 2 + 1 > _BINS or cfg.n_mels > _MELS:
        raise ValueError(f"the logmel kernel takes n_fft <= {2 * _BINS - 2} and "
                         f"n_mels <= {_MELS} (rows of n_fft = {cfg.n_fft}), got "
                         f"rows {tuple(rows.shape)}, n_mels {cfg.n_mels}")
    if power is not None and (tuple(power.shape) != (R, _BINS)
                              or power.dtype != torch.float32
                              or power.device != rows.device
                              or not power.is_contiguous()):
        raise ValueError(f"power must be a contiguous ({R}, {_BINS}) float32 "
                         "tensor on the rows' device")
    lib = _library()
    dev = rows.device
    with torch.cuda.device(dev):
        cos_hi, cos_lo, sin_hi, sin_lo, fb = _on_device(
            _kernel_mats_np, cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate,
            str(dev), torch.bfloat16)
        out = torch.empty((R, cfg.n_mels), dtype=torch.float32, device=dev)
        if R == 0:
            return out
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.logmel_rows(
            rows.data_ptr(), R, n_fft, _round_up(n_fft, _K_STEP),
            cos_hi.data_ptr(), sin_hi.data_ptr(), cos_lo.data_ptr(),
            sin_lo.data_ptr(), fb.data_ptr(), out.data_ptr(), cfg.n_mels,
            power.data_ptr() if power is not None else None,
            int(high_precision), stream)
    if err != 0:
        raise RuntimeError(f"logmel kernel failed with CUDA error {err}")
    logmel_fused.launches += 1
    return out


def logmel_fused(wav, cfg: AudioConfig, wav_lengths=None,
                 high_precision: bool = False):
    """Fused log-mel: wav (B, S) float PCM -> ((B, F, n_mels) float32
    features, (B,) int32 frame lengths), as the JAX package's
    ``logmel_pallas``."""
    if wav.device.type == "cpu":
        return logmel_fused_reference(wav, cfg, wav_lengths, high_precision)
    if wav.device.type != "cuda":
        raise ValueError(f"logmel_fused runs on cpu or cuda, not {wav.device}")
    rows, F = _frames(wav, cfg, wav_lengths)
    feats = logmel_rows_cuda(rows, cfg, high_precision)
    return (feats.reshape(wav.shape[0], F, cfg.n_mels),
            _lengths(wav, cfg, wav_lengths, F))


logmel_fused.launches = 0
