"""Host-side WAV IO (port of ``rnntransducer_tpu/utils/audio_io.py``): a
dependency-free PCM WAV reader that resamples by linear interpolation."""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str, target_sample_rate: int = 16000) -> np.ndarray:
    """Returns mono float32 PCM in [-1, 1] at target_sample_rate."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if sr != target_sample_rate:
        t_new = np.linspace(0.0, len(x) - 1.0,
                            int(round(len(x) * target_sample_rate / sr)))
        x = np.interp(t_new, np.arange(len(x)), x).astype(np.float32)
    return x


def write_wav(path: str, x: np.ndarray, sample_rate: int = 16000) -> None:
    x16 = np.clip(np.asarray(x) * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(x16.tobytes())
