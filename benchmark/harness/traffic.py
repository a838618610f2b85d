"""The one traffic generator: utterances (audio and labels) from a traffic
file's parameters and the run's seed.

* Durations: log-normal with the file's mean and sigma of the log, clipped
  to [min_s, max_s], at the midpoints of ``n`` equal-probability strata.
  Every seed gets the same set of durations; the seed decides which
  utterance has which.
* Labels: ``rate`` graphemes per second of audio, the rate uniform in the
  file's range per utterance, ids uniform over ``label_ids`` (inclusive).
* Audio: one seeded bank of 16-bit PCM (a few tones whose pitch and level
  move every 50 ms, over noise), long enough for the longest utterance;
  each utterance is the bank from a seeded offset, so no two are alike.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Utterances:
    durations: np.ndarray     # seconds
    samples: np.ndarray       # int
    offsets: np.ndarray       # into the bank
    labels: List[np.ndarray]
    bank: np.ndarray          # float32 on the int16 grid
    sample_rate: int

    def wav(self, i: int) -> np.ndarray:
        o, s = int(self.offsets[i]), int(self.samples[i])
        return self.bank[o:o + s]

    def __len__(self) -> int:
        return len(self.samples)


def stratified_durations(n: int, mean_s: float, sigma_log: float, lo: float,
                         hi: float) -> np.ndarray:
    mu = math.log(mean_s) - sigma_log ** 2 / 2.0
    z = statistics.NormalDist()
    d = np.array([math.exp(mu + sigma_log * z.inv_cdf((i + 0.5) / n)) for i in range(n)])
    return np.clip(d, lo, hi)


def audio_bank(rng: np.random.RandomState, seconds: float, sr: int) -> np.ndarray:
    n = int(seconds * sr)
    seg = int(0.05 * sr)
    segs = -(-n // seg)
    t = np.arange(n) / sr
    out = np.zeros(n, np.float64)
    for _ in range(6):
        f = rng.uniform(80.0, 4000.0, segs).repeat(seg)[:n]
        amp = rng.uniform(0.0, 1.0, segs).repeat(seg)[:n]
        phase = 2.0 * np.pi * np.cumsum(f) / sr
        out += amp * np.sin(phase)
    out += 0.3 * rng.randn(n)
    out *= (0.5 + 0.5 * np.abs(np.sin(2.0 * np.pi * 0.7 * t)))
    out /= np.abs(out).max()
    return (np.round(out * 32000.0) / 32768.0).astype(np.float32)


def utterances(mix: dict, n: int, seed: int) -> Utterances:
    """``n`` utterances of the traffic file's ``utterances`` section."""
    u = mix["utterances"]
    sr = u["sample_rate"]
    rng = np.random.RandomState(seed % (2 ** 32))
    d = stratified_durations(n, u["mean_s"], u["sigma_log"], u["min_s"], u["max_s"])
    d = d[rng.permutation(n)]
    samples = np.minimum(np.round(d * sr).astype(np.int64), int(u["max_samples"]))
    bank_s = u.get("bank_s", 120.0)
    bank = audio_bank(rng, bank_s + u["max_s"] + 1.0, sr)
    offsets = rng.randint(0, int(bank_s * sr), size=n)
    lo, hi = u["label_ids"]
    r0, r1 = u["label_rate"]
    rates = rng.uniform(r0, r1, n)
    labels = [rng.randint(lo, hi + 1, size=max(1, int(round(s / sr * r)))).astype(np.int64)
              for s, r in zip(samples, rates)]
    return Utterances(samples / sr, samples, offsets, labels, bank, sr)
