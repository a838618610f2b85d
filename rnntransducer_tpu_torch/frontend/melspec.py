"""Log-mel frontend (port of ``rnntransducer_tpu/frontend/melspec.py``).

torchaudio MelSpectrogram defaults: periodic Hann window, center=True
reflect padding, power-2 spectrum, HTK mel scale without filterbank norm,
f_min=0, f_max=sr/2, then log1p.  With lengths, each utterance reflects at
its own tail (not at the batch padding), exactly as the JAX frontend does.
The window and filterbank are built with numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.config import AudioConfig


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK-scale filterbank, norm=None."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * t / n)).astype(np.float32)


def hamming_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * t / n)).astype(np.float32)


WINDOWS = {"hann": hann_window, "hamming": hamming_window}


def num_frames(num_samples: int, hop_length: int) -> int:
    """center=True STFT frame count."""
    return num_samples // hop_length + 1


def mean_var_normalize(wav: torch.Tensor, wav_lengths: Optional[torch.Tensor] = None,
                       eps: float = 1e-7) -> torch.Tensor:
    """Per-utterance (x - mean) / sqrt(var + eps) over the valid samples.
    wav: (B, S)."""
    if wav_lengths is None:
        mean = wav.mean(dim=-1, keepdim=True)
        var = wav.var(dim=-1, keepdim=True, unbiased=False)
        return (wav - mean) / torch.sqrt(var + eps)
    S = wav.shape[-1]
    mask = (torch.arange(S, device=wav.device)[None, :]
            < wav_lengths[:, None].to(torch.int64))
    n = wav_lengths.to(torch.float32).clamp_min(1.0)[:, None]
    wavm = torch.where(mask, wav, 0.0)
    mean = wavm.sum(-1, keepdim=True) / n
    var = (torch.where(mask, wav - mean, 0.0) ** 2).sum(-1, keepdim=True) / n
    out = (wav - mean) / torch.sqrt(var + eps)
    return torch.where(mask, out, 0.0)


def _reflect_index(n_out: int, pad: int, size: int, device) -> torch.Tensor:
    """Source index of each sample of a signal of ``size`` reflect-padded by
    ``pad`` on both sides (numpy's 'reflect', repeated when pad >= size)."""
    i = torch.arange(n_out, device=device) - pad
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    m = i.remainder(period)
    return torch.where(m < size, m, period - m)


def _strided_frames(wav: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, S) -> (B, frames, n_fft) center/reflect frames, built from shifted
    views of the hop-reshaped padded signal."""
    B, S = wav.shape
    pad = n_fft // 2
    n_frm = num_frames(S, hop_length)
    x = wav[:, _reflect_index(S + 2 * pad, pad, S, wav.device)]
    n_shift = -(-n_fft // hop_length)
    n_rows = n_frm + n_shift
    total = n_rows * hop_length
    if x.shape[1] < total:
        x = F.pad(x, (0, total - x.shape[1]))
    xr = x[:, :total].reshape(B, n_rows, hop_length)
    shifts = [xr[:, i:i + n_frm] for i in range(n_shift)]
    return torch.cat(shifts, dim=2)[:, :, :n_fft]


def frame_signal(wav: torch.Tensor, n_fft: int, hop_length: int,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) -> (B, frames, n_fft) frames with center/reflect padding.

    With ``lengths``, the <=2 valid frames per utterance whose window
    crosses its true tail are recomputed with an exact gather that reflects
    at the tail (``melspec.py:126-156`` of the JAX package); frames past an
    utterance's frame count hold padding and are masked downstream."""
    B, S = wav.shape
    pad = n_fft // 2
    n_frm = num_frames(S, hop_length)
    frames = _strided_frames(wav, n_fft, hop_length)
    if lengths is None:
        return frames
    dev = wav.device
    L = lengths.to(torch.int64).clamp_min(1)                       # (B,)
    n_fix = (n_fft - pad) // hop_length + 2
    j = torch.arange(n_fix, device=dev)
    fidx = (L[:, None] // hop_length - j[None, :]).clamp(0, n_frm - 1)
    pos = (fidx[:, :, None] * hop_length
           + torch.arange(n_fft, device=dev)[None, None, :] - pad)
    Lb = L[:, None, None]
    p = pos.abs()                                                  # reflect at 0
    over = p - (Lb - 1)
    p = torch.where(over > 0, Lb - 1 - over, p)                    # reflect at L-1
    p = p.clamp(0, S - 1)
    fixed = wav.gather(1, p.reshape(B, -1)).reshape(B, n_fix, n_fft)
    iota = torch.arange(n_frm, device=dev)[None, :, None]
    for k in range(n_fix):
        sel = iota == fidx[:, k][:, None, None]
        frames = torch.where(sel, fixed[:, k][:, None, :], frames)
    return frames


def stft_power(wav: torch.Tensor, n_fft: int, hop_length: int,
               window: torch.Tensor, lengths: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Power spectrogram matching torch.stft(center=True, reflect, onesided,
    power=2). wav: (B, S) -> (B, frames, n_fft//2+1)."""
    frames = frame_signal(wav, n_fft, hop_length, lengths) * window[None, None, :]
    spec = torch.fft.rfft(frames, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)


class LogMelFrontend:
    """(B, S) PCM -> ((B, frames, n_mels) log1p mel features, frame lengths).
    Runs on the device of the wave it is given."""

    def __init__(self, cfg: AudioConfig):
        self.cfg = cfg
        self._window = WINDOWS[cfg.window](cfg.win_length)
        self._fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate)
        self._consts = {}

    def _on(self, device: torch.device):
        key = str(device)
        if key not in self._consts:
            self._consts[key] = (torch.from_numpy(self._window).to(device),
                                 torch.from_numpy(self._fb).to(device))
        return self._consts[key]

    def __call__(self, wav: torch.Tensor, wav_lengths: Optional[torch.Tensor] = None):
        cfg = self.cfg
        wav = wav.to(torch.float32)
        window, fb = self._on(wav.device)
        if cfg.normalize:
            wav = mean_var_normalize(wav, wav_lengths)
        power = stft_power(wav, cfg.n_fft, cfg.hop_length, window, wav_lengths)
        feats = torch.log1p(torch.matmul(power, fb))
        if wav_lengths is None:
            lengths = torch.full((wav.shape[0],), feats.shape[1],
                                 dtype=torch.int32, device=wav.device)
        else:
            lengths = (wav_lengths.to(torch.int32) // cfg.hop_length + 1)
        return feats, lengths
