"""Log-mel features, as torchaudio's MelSpectrogram gives them with the
configurations' settings: optional per-utterance mean / variance
normalisation of the samples, a periodic Hann window of ``win_length``
samples, ``n_fft = win_length``, centred frames with reflect padding at the
utterance's own ends, the power spectrum, an HTK-scale triangular filterbank
without norm, then log1p.  Each utterance is featurised alone, at its own
length: ``length // hop + 1`` frames."""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """(n_freqs, n_mels) HTK triangles from 0 Hz to Nyquist."""
    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0),
                                   n_mels + 2))
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def audio_dims(audio: Mapping) -> Tuple[int, int]:
    """(win_length = n_fft, hop) of an audio config."""
    win = int(math.ceil(audio["sample_rate"] * audio["window_size_sec"]))
    return win, int(audio["sample_rate"] * audio["window_stride_sec"])


def logmel(waves: Sequence[torch.Tensor], audio: Mapping, device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 waves (each (S_i,)) -> ((B, max frames, n_mels) features, zero
    past each utterance's frames, (B,) frame counts), on ``device``."""
    win, hop = audio_dims(audio)
    n_mels = audio["n_mels"]
    window = torch.hann_window(win, periodic=True, dtype=torch.float64, device=device)
    fb = torch.from_numpy(filterbank(win // 2 + 1, n_mels, audio["sample_rate"])).to(device)
    feats = []
    for w in waves:
        x = w.to(device=device, dtype=torch.float64)
        if audio.get("normalize", False):
            x = (x - x.mean()) / torch.sqrt(x.var(unbiased=False) + 1e-7)
        spec = torch.stft(x, n_fft=win, hop_length=hop, win_length=win, window=window,
                          center=True, pad_mode="reflect", return_complex=True)
        feats.append(torch.log1p((spec.abs() ** 2).t() @ fb).float())
    n = torch.tensor([f.shape[0] for f in feats], dtype=torch.int64, device=device)
    out = torch.zeros((len(feats), int(n.max()), n_mels), device=device)
    for i, f in enumerate(feats):
        out[i, :f.shape[0]] = f
    return out, n


def int16_transfer(w: np.ndarray) -> np.ndarray:
    """A float wave as it arrives after the int16 transfer: scaled by its
    peak onto 32767 levels, rounded, scaled back."""
    peak = float(np.max(np.abs(w))) if w.size else 0.0
    if peak <= 0:
        return np.zeros_like(w, dtype=np.float32)
    scale = np.float32(peak / 32767.0)
    return (np.round(w / scale).astype(np.int16).astype(np.float32) * scale)
