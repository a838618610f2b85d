"""Fused log-mel frontend: the CUDA kernel's wrapper and its plain version
(port of ``rnntransducer_tpu/frontend/pallas_frontend.py``).

The torchaudio chain STFT -> power -> mel -> log1p, with the DFT written as
two real matrix products so that everything after framing is one kernel:

    frames (rows, n_fft) @ windowed DFT cos / sin (n_fft, bins) -> re, im
    power = re^2 + im^2 -> @ HTK mel filterbank (bins, n_mels) -> log1p

The window is folded into the DFT matrices; bins and mel filters are zero
padded (zero rows and columns contribute nothing): to 128 in the plain
version, as the JAX package pads them, and to the kernel's own pass width,
64, for the kernel (:func:`kernel_dims`), whatever n_fft and n_mels.
Normalisation and the center / reflect framing (with the exact tail
reflection when lengths are given) stay outside the kernel, in
:mod:`frontend.melspec`, as in the JAX package.

Numeric contract: the products take bf16 operands and accumulate in fp32,
which is what the TPU kernel computes (Mosaic's dot of fp32 operands is one
bf16 pass).  ``high_precision=True`` splits the DFT into the three bf16
products of ``_dot3`` (~fp32 accuracy); the mel product is one bf16 pass in
both modes.  :func:`logmel_fused_reference` makes every rounding explicit
and multiplies in fp32, so on the CPU it is exact up to summation order.

``logmel_fused`` dispatches on the device of ``wav``: the plain version for
a CPU tensor, the hand-written kernel ``csrc/logmel.cu`` for a CUDA tensor,
or the call raises; while a tracer runs, the frame rows go to the
registered op ``rnntransducer_tpu_torch::logmel_rows`` (``ops/library.py``).  ``logmel_fused.launches`` counts its kernel launches
(one per call; two on the chunked engine).  The kernel has three engines
(:func:`kernel_plan`): wgmma where its 64-row slab fits the card's shared
memory, else mma.sync on smaller tiles, else, for windows too wide for a
16-row tile of frames, the chunked engine, which holds only 32-sample
chunks of the frames and passes the power through global memory to its
mel stage, so any n_fft runs.  :func:`kernel_mats_reference` is the plain mirror of the
kernel's padded operands, :func:`kernel_mats_wgmma` the same values in the
wgmma engine's layout.  A launch's plan, operands and mel windows are
worked out once per (config, mode, device).
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
from rnntransducer_tpu_torch.ops import build, library
from rnntransducer_tpu_torch.ops.device import device_limits
from rnntransducer_tpu_torch.utils.precision import full_precision_matmul

# the kernel's widths (csrc/logmel.cu): bins and mel filters are walked in
# passes of 64, the sample axis (and bins, as the mel product's K) in ring
# stages of 32, a ring of 3 stages; the wgmma engine's tile holds 128 or 64
# frame rows, the mma.sync engine's 32 or 16, the chunked engine's blocks 32
_PASS, _K_STAGE = 64, 32
_STAGES = {"wgmma": 3, "mma": 3}
_ENGINES = {"mma": 0, "wgmma": 1, "chunked": 2}
# the plans in the order the wrapper tries them: the wgmma engine where a
# 64-row slab fits the shared memory, else the mma.sync engine's small
# tiles, else the chunked engine (its shared memory does not grow with n_fft)
_PLANS = (("wgmma", 128), ("wgmma", 64), ("mma", 32), ("mma", 16), ("chunked", 32))


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
    """log1p(power @ filterbank) in one bf16 pass: (R, >= n_fft // 2 + 1)
    power, its padding ignored -> (R, n_mels)."""
    _, _, fb = _mats(cfg, power.device)
    K = cfg.n_fft // 2 + 1
    with full_precision_matmul():
        return torch.log1p(_dot1(power[:, :K], fb[:K]))[:, :cfg.n_mels]


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


def _dims(n_fft: int, n_mels: int):
    bins = max(_round_up(n_fft // 2 + 1, _PASS), 2 * _PASS)
    return _round_up(n_fft, _K_STAGE), bins, _round_up(n_mels, _PASS)


def kernel_dims(cfg: AudioConfig):
    """(Kf, Kbp, Mp): the sample axis padded to a ring stage (32), the bins
    n_fft // 2 + 1 padded to a pass (64; at least two passes) and the
    filters padded to a pass."""
    return _dims(cfg.n_fft, cfg.n_mels)


def kernel_mel_windows(cfg: AudioConfig):
    """(k0, ncm): each mel pass of 64 filters multiplies only ncm (at least
    2) 32-bin chunks of the power, from chunk k0[q] on; its filters are zero
    outside them (the filterbank's triangles are narrow)."""
    return _mel_windows(cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate)


@functools.lru_cache(maxsize=8)
def _mel_windows(n_fft: int, window: str, n_mels: int, sample_rate: int):
    _, bm = _kernel_mats_np(n_fft, window, n_mels, sample_rate)
    chunks = bm.shape[2] // _K_STAGE
    spans = []
    for q in range(bm.shape[0]):
        nz = np.flatnonzero((bm[q] != 0).any(0))
        spans.append((int(nz[0]) // _K_STAGE, int(nz[-1]) // _K_STAGE + 1)
                     if nz.size else (0, 0))
    ncm = min(chunks, max([2] + [hi - lo for lo, hi in spans]))
    return tuple(min(lo, chunks - ncm) for lo, _ in spans), ncm


def kernel_smem_bytes(plan, cfg: AudioConfig, high: bool) -> int:
    """Dynamic shared memory of one kernel block for ``plan`` = (engine,
    tile rows) (``csrc/logmel.cu``'s ``smem_bytes``).  wgmma: its ring's 3
    stages of 128 (256 in high mode) operand rows, 128 bytes of barriers,
    and per 64-row slab the bf16 frames (and their remainders in high mode)
    and the bf16 power.  mma.sync: the tile's frames and power, every row
    padded by 8 values, and its ring's 3 stages of 2 (4) x 64 rows.  The
    chunked engine: 32 rows of a 32-sample chunk of frames and of their low
    parts, and 4 x 64 operand rows of the chunk, each row padded by 8, in
    static shared memory, whatever n_fft and the mode."""
    engine, tile_rows = plan
    if engine == "chunked":
        return 2 * (2 * tile_rows + 4 * _PASS) * (_K_STAGE + 8)
    Kf, Kbp, _ = kernel_dims(cfg)
    h = 2 if high else 1
    if engine == "wgmma":
        return (128 + _STAGES[engine] * h * 2 * _PASS * _K_STAGE * 2
                + 2 * tile_rows * (h * Kf + Kbp))
    return 2 * (h * tile_rows * (Kf + 8) + tile_rows * (Kbp + 8)
                + _STAGES[engine] * 2 * h * _PASS * (_K_STAGE + 8))


def kernel_plan(cfg: AudioConfig, high: bool, smem: int):
    """(engine, tile rows) of a launch: the first of 128 and 64 rows on the
    wgmma engine, then 32 and 16 on the mma.sync engine, whose block fits
    ``smem`` bytes of shared memory (larger tiles read the operands from L2
    fewer times); where not even 16 rows of frames fit, the chunked engine,
    whose shared memory does not depend on n_fft."""
    for plan in _PLANS:
        if kernel_smem_bytes(plan, cfg, high) <= smem:
            return plan
    raise ValueError(f"the logmel kernel needs {kernel_smem_bytes(_PLANS[-1], cfg, high)} "
                     f"bytes of shared memory, above the {smem} a block may use")


def kernel_mats_reference(cfg: AudioConfig):
    """The kernel's operands as float32 tensors holding bf16 values: ``bd``
    (Kbp / 64, 4, 64, Kf), per pass of 64 bins the windowed cos, sin, cos-low
    and sin-low rows over the samples (the low parts are w - bf16(w)), and
    ``bm`` (Mp / 64, 64, Kbp), the filterbank transposed, both zero padded
    (:func:`kernel_dims`)."""
    return tuple(torch.from_numpy(a) for a in _kernel_mats_np(
        cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate))


@functools.lru_cache(maxsize=8)
def _kernel_mats_np(n_fft: int, window: str, n_mels: int, sample_rate: int):
    Kf, Kbp, Mp = _dims(n_fft, n_mels)
    K = n_fft // 2 + 1
    wc, ws, fb = _dft_mats(n_fft, window, n_mels, sample_rate)
    parts = []
    for w in (wc, ws):
        full = torch.zeros((Kbp, Kf))
        full[:K, :n_fft] = torch.from_numpy(w[:, :K]).t()
        hi = _bf16(full)
        parts.append((hi, _bf16(full - hi)))
    (c_hi, c_lo), (s_hi, s_lo) = parts
    bd = torch.stack([c_hi, s_hi, c_lo, s_lo]).view(4, Kbp // _PASS, _PASS, Kf)
    fbp = torch.zeros((Mp, Kbp))
    fbp[:n_mels, :K] = torch.from_numpy(fb[:K, :n_mels]).t()
    bm = _bf16(fbp).view(Mp // _PASS, _PASS, Kbp)
    return bd.transpose(0, 1).contiguous().numpy(), bm.contiguous().numpy()


def kernel_mats_wgmma(cfg: AudioConfig):
    """The wgmma engine's operands, :func:`kernel_mats_reference`'s values
    rearranged into its shared-memory layout so that each ring stage is one
    contiguous copy: ``bd`` (Kbp / 64, Kf / 32, 2, 16, 4, 8, 8), per DFT pass
    and 32-sample chunk the bf16 values and their low parts, each 128 rows
    (cos of the pass's bins 0-31, sin of 0-31, cos of 32-63, sin of 32-63)
    by 32 samples in 8 x 8 core matrices (row group, sample group, row,
    sample); ``bm`` (Mp / 64, Kbp / 32, 8, 4, 8, 8), per mel pass and 32-bin
    chunk its 64 filters by 32 bins alike."""
    return tuple(torch.from_numpy(a) for a in _kernel_mats_wgmma_np(
        cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate))


@functools.lru_cache(maxsize=8)
def _kernel_mats_wgmma_np(n_fft: int, window: str, n_mels: int, sample_rate: int):
    bd, bm = _kernel_mats_np(n_fft, window, n_mels, sample_rate)
    n_dp, _, _, Kf = bd.shape
    half = _PASS // 2
    parts = np.stack([np.concatenate([bd[:, c, :half], bd[:, s, :half],
                                      bd[:, c, half:], bd[:, s, half:]], axis=1)
                      for c, s in ((0, 1), (2, 3))], axis=1)   # (n_dp, 2, 128, Kf)
    parts = parts.reshape(n_dp, 2, 16, 8, Kf // _K_STAGE, 4, 8)
    n_mp, _, Kbp = bm.shape
    mel = bm.reshape(n_mp, 8, 8, Kbp // _K_STAGE, 4, 8)
    return (np.ascontiguousarray(parts.transpose(0, 4, 1, 2, 5, 3, 6)),
            np.ascontiguousarray(mel.transpose(0, 3, 1, 4, 2, 5)))


def _library():
    lib = build.load("logmel")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.logmel_rows.argtypes = [p] + [i] * 5 + [p] * 3 + [i, p, i, p] + [i] * 4 + [p]
        lib.logmel_rows.restype = i
        lib.logmel_rows_chunked.argtypes = [p] + [i] * 5 + [p] * 3 + [i, p, i, p, p, i, p]
        lib.logmel_rows_chunked.restype = i
        lib.logmel_smem.argtypes = [i] * 5
        lib.logmel_smem.restype = i
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=16)
def _launch_plan(cfg: AudioConfig, high: bool, device: str, plan):
    """Everything of a launch but the rows, worked out once per (config,
    mode, device, forced plan): (engine code, tile rows, Kf, Kbp, Mp, the
    engine's operands and mel windows on the device, ncm, grid)."""
    sms, smem = device_limits(device)
    engine, tile_rows = plan or kernel_plan(cfg, high, smem)
    make = _kernel_mats_wgmma_np if engine == "wgmma" else _kernel_mats_np
    bd, bm = _on_device(make, cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate,
                        device, torch.bfloat16)
    k0, ncm = kernel_mel_windows(cfg)
    mel_k0 = torch.tensor(k0, dtype=torch.int32, device=device)
    return (_ENGINES[engine], tile_rows, *kernel_dims(cfg), bd, bm, mel_k0, ncm, sms)


def logmel_rows_cuda(rows, cfg: AudioConfig, high_precision: bool = False,
                     power: Optional[torch.Tensor] = None, plan=None):
    """The kernel on frame rows (R, n_fft) fp32 on the card -> (R, n_mels)
    fp32.  ``power``, a (R, Kbp) fp32 tensor (:func:`kernel_dims`), also
    receives re^2 + im^2 before its bf16 rounding (for checking the two
    stages apart).  ``plan`` forces an (engine, tile rows) of
    :func:`kernel_plan`'s, for checking and timing the engines apart."""
    if rows.device.type != "cuda":
        raise ValueError(f"the logmel kernel runs on cuda, not {rows.device}")
    R, n_fft = rows.shape
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise TypeError("the logmel kernel takes contiguous float32 frame rows")
    if n_fft != cfg.n_fft:
        raise ValueError(f"the logmel kernel takes rows of n_fft = {cfg.n_fft}, got "
                         f"{tuple(rows.shape)}")
    dev = rows.device
    engine, tile_rows, Kf, Kbp, Mp, bd, bm, mel_k0, ncm, grid = _launch_plan(
        cfg, bool(high_precision), str(dev), plan)
    if power is not None and (tuple(power.shape) != (R, Kbp)
                              or power.dtype != torch.float32
                              or power.device != rows.device
                              or not power.is_contiguous()):
        raise ValueError(f"power must be a contiguous ({R}, {Kbp}) float32 "
                         "tensor on the rows' device")
    out = torch.empty((R, cfg.n_mels), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    if engine == _ENGINES["chunked"]:
        pw = torch.empty((R, Kbp), dtype=torch.bfloat16, device=dev)
        err = _library().logmel_rows_chunked(
            rows.data_ptr(), R, n_fft, Kf, Kbp, Mp, bd.data_ptr(), bm.data_ptr(),
            mel_k0.data_ptr(), ncm, out.data_ptr(), cfg.n_mels,
            power.data_ptr() if power is not None else None, pw.data_ptr(),
            int(high_precision), stream)
        if err != 0:
            raise RuntimeError(f"logmel kernel failed with CUDA error {err}")
        logmel_fused.launches += 2
        return out
    err = _library().logmel_rows(
        rows.data_ptr(), R, n_fft, Kf, Kbp, Mp, bd.data_ptr(), bm.data_ptr(),
        mel_k0.data_ptr(), ncm, out.data_ptr(), cfg.n_mels,
        power.data_ptr() if power is not None else None,
        int(high_precision), tile_rows, engine, grid, stream)
    if err != 0:
        raise RuntimeError(f"logmel kernel failed with CUDA error {err}")
    logmel_fused.launches += 1
    return out


def logmel_fused(wav, cfg: AudioConfig, wav_lengths=None,
                 high_precision: bool = False):
    """Fused log-mel: wav (B, S) float PCM -> ((B, F, n_mels) float32
    features, (B,) int32 frame lengths), as the JAX package's
    ``logmel_pallas``."""
    if library.tracing(wav):
        rows, F = _frames(wav, cfg, wav_lengths)
        feats = torch.ops.rnntransducer_tpu_torch.logmel_rows(
            rows, cfg.sample_rate, cfg.window_size_sec, cfg.window, cfg.n_mels,
            bool(high_precision))
    elif wav.device.type == "cpu":
        return logmel_fused_reference(wav, cfg, wav_lengths, high_precision)
    elif wav.device.type != "cuda":
        raise ValueError(f"logmel_fused runs on cpu or cuda, not {wav.device}")
    else:
        rows, F = _frames(wav, cfg, wav_lengths)
        feats = logmel_rows_cuda(rows, cfg, high_precision)
    return (feats.reshape(wav.shape[0], F, cfg.n_mels),
            _lengths(wav, cfg, wav_lengths, F))


logmel_fused.launches = 0
