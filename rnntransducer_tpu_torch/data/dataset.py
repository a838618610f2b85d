"""Datasets (port of the parts of ``rnntransducer_tpu/data/dataset.py``
that the Trainer and the train CLI use).

* ``load_shards``, ``ArrowAudioDataset``, ``ArrowWaveformDataset``: every
  ``root/<split>/<idx>`` Arrow shard, concatenated, as random-access
  datasets of log-mel features or raw PCM.  ``datasets`` is imported only
  when shards are loaded.
* ``SyntheticAudioDataset``, ``PatternedSyntheticDataset``,
  ``PatternedWaveformDataset``: deterministic seeded data for tests,
  benchmarks and smoke training.
* ``logmel_np`` / ``spec_augment_np``: the host log-mel and SpecAugment.

Host IO only: nothing here touches the device.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.frontend.melspec import WINDOWS, mel_filterbank, num_frames


# ---------------------------------------------------------------- numpy DSP
def _stft_power_np(wav: np.ndarray, n_fft: int, hop: int,
                   window: np.ndarray) -> np.ndarray:
    """(S,) -> (frames, n_fft//2+1); same numerics as frontend.stft_power."""
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frm = num_frames(len(wav), hop)
    idx = np.arange(n_frm)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * window[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float32)


def logmel_np(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Host log-mel matching the device frontend: (S,) float32 -> (frames,
    n_mels), with the per-utterance mean-var norm when ``cfg.normalize``."""
    wav = np.asarray(wav, np.float32)
    if cfg.normalize:
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
    win = WINDOWS[cfg.window](cfg.win_length)
    fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate)
    power = _stft_power_np(wav, cfg.n_fft, cfg.hop_length, win)
    return np.log1p(power @ fb)


def spec_augment_np(feats: np.ndarray, cfg: AudioConfig,
                    rng: np.random.RandomState) -> np.ndarray:
    """SpecAugment on the host, for features prepared offline."""
    T, M = feats.shape
    out = feats.copy()
    for _ in range(cfg.freq_mask_cnt):
        f = rng.uniform(0, cfg.freq_mask_para)
        f0 = int(rng.uniform(0, max(M - f, 1)))
        out[:, f0:f0 + int(f)] = 0.0
    for _ in range(cfg.time_mask_cnt):
        t = rng.uniform(0, cfg.time_mask_para)
        t0 = int(rng.uniform(0, max(T - t, 1)))
        out[t0:t0 + int(t)] = 0.0
    return out


# ------------------------------------------------------------ Arrow shards
def shard_dirs(root: str, split: str) -> List[str]:
    """The shard directories root/<split>/<idx>, in index order."""
    base = os.path.join(root, split)
    if not os.path.isdir(base):
        return []
    idxs = sorted((d for d in os.listdir(base) if d.isdigit()), key=int)
    return [os.path.join(base, d) for d in idxs]


def load_shards(roots: Sequence[str], split: str):
    """Every shard of every root, concatenated.  ``datasets`` is imported
    here, so nothing else in the port needs it."""
    from datasets import concatenate_datasets, load_from_disk

    parts = []
    for root in roots:
        for d in shard_dirs(root, split):
            parts.append(load_from_disk(d))
    if not parts:
        raise FileNotFoundError(f"no shards for split '{split}' under {roots}")
    return parts[0] if len(parts) == 1 else concatenate_datasets(parts)


class ArrowAudioDataset:
    """Random-access view over preprocessed shards, feeding the bucketing
    sampler (lengths) and collate (feats/labels).

    Rows are read through the datasets library's numpy formatter, and
    ``get_batch`` fetches a whole batch in one Arrow take instead of B
    row reads."""

    def __init__(self, roots: Sequence[str], split: str):
        self.ds = load_shards(roots, split)
        cols = self.ds.column_names
        self._len_col = "audio_len" if "audio_len" in cols else None
        self._np = self.ds.with_format("numpy",
                                       columns=["input_values", "input_ids"])

    def __len__(self):
        return len(self.ds)

    def lengths(self) -> np.ndarray:
        if self._len_col:
            return np.asarray(self.ds[self._len_col])
        return np.asarray([len(r["input_values"]) for r in self.ds])

    def label_lengths(self) -> np.ndarray:
        if "label_len" in self.ds.column_names:
            return np.asarray(self.ds["label_len"])
        return np.asarray([len(r["input_ids"]) for r in self.ds])

    @staticmethod
    def _item(values, ids) -> dict:
        return {"feats": np.asarray(values, np.float32),
                "labels": np.asarray(ids, np.int32)}

    def __getitem__(self, i: int) -> dict:
        row = self._np[int(i)]
        return self._item(row["input_values"], row["input_ids"])

    def get_batch(self, idxs) -> list:
        rows = self._np[[int(i) for i in idxs]]
        return [self._item(v, t)
                for v, t in zip(rows["input_values"], rows["input_ids"])]


class ArrowWaveformDataset(ArrowAudioDataset):
    """Random-access view over raw-PCM shards (rows: 'input_values' = float32
    waveform at the sample rate, 'input_ids' = grapheme ids) for the raw-PCM
    training path: the Trainer collates waveforms and the log-mel frontend
    (and SpecAugment) runs on the card inside the step.  ``lengths()``
    returns frame counts, so audio bucketing is shared with the feature
    path."""

    def __init__(self, roots: Sequence[str], split: str, audio_cfg: AudioConfig):
        super().__init__(roots, split)
        self.audio_cfg = audio_cfg

    def lengths(self) -> np.ndarray:
        if self._len_col:  # audio_len column already holds frame counts
            return np.asarray(self.ds[self._len_col])
        hop = self.audio_cfg.hop_length
        return np.asarray([num_frames(len(r["input_values"]), hop)
                           for r in self.ds])

    @staticmethod
    def _item(values, ids) -> dict:
        return {"wav": np.asarray(values, np.float32),
                "labels": np.asarray(ids, np.int32)}


class SyntheticAudioDataset:
    """Deterministic random utterances (for tests, benchmarks and smoke
    training): 'speech' is filtered noise; labels are random grapheme ids."""

    def __init__(self, n: int, audio_cfg: AudioConfig, vocab_size: int = 72,
                 min_sec: float = 1.0, max_sec: float = 8.0,
                 min_labels: int = 4, max_labels: int = 48, seed: int = 0,
                 as_waveform: bool = False):
        self.n = n
        self.cfg = audio_cfg
        self.vocab_size = vocab_size
        self.min_sec, self.max_sec = min_sec, max_sec
        self.min_labels, self.max_labels = min_labels, max_labels
        self.seed = seed
        self.as_waveform = as_waveform
        rng = np.random.RandomState(seed)
        sr = audio_cfg.sample_rate
        self._samples = rng.randint(int(min_sec * sr), int(max_sec * sr), n)
        self._n_labels = rng.randint(min_labels, max_labels + 1, n)

    def __len__(self):
        return self.n

    def lengths(self) -> np.ndarray:
        return np.asarray([num_frames(int(s), self.cfg.hop_length)
                           for s in self._samples])

    def label_lengths(self) -> np.ndarray:
        return np.asarray(self._n_labels)

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + 1000 + int(i))
        s = int(self._samples[i])
        wav = rng.randn(s).astype(np.float32)
        # crude comb filter so the spectrum has structure
        wav[1:] += 0.8 * wav[:-1]
        labels = rng.randint(1, self.vocab_size, int(self._n_labels[i])) \
                    .astype(np.int32)
        if self.as_waveform:
            return {"wav": wav, "labels": labels}
        return {"feats": logmel_np(wav, self.cfg), "labels": labels}


class PatternedSyntheticDataset:
    """Learnable synthetic 'speech': each label stamps a label-specific noise
    pattern onto a contiguous feature segment (monotonic alignment), so a
    model trained on one set of utterances GENERALIZES to held-out utterances
    drawn from the same process: an end-to-end learning and generalization
    testbed that needs no corpus.

    Emits log-mel-shaped features directly ('feats' (T, n_mels))."""

    def __init__(self, n: int, n_mels: int = 80, vocab_size: int = 72,
                 min_labels: int = 4, max_labels: int = 12,
                 frames_per_label: int = 8, noise: float = 0.3,
                 seed: int = 0, pattern_seed: int = 777):
        self.n = n
        self.n_mels = n_mels
        self.vocab_size = vocab_size
        self.frames_per_label = frames_per_label
        self.noise = noise
        self.seed = seed
        # the label->pattern codebook is the "language"; shared across
        # train/eval splits via pattern_seed
        self.patterns = np.random.RandomState(pattern_seed).randn(
            vocab_size, n_mels).astype(np.float32)
        rng = np.random.RandomState(seed)
        self._n_labels = rng.randint(min_labels, max_labels + 1, n)

    def __len__(self):
        return self.n

    def lengths(self) -> np.ndarray:
        return self._n_labels * self.frames_per_label

    def label_lengths(self) -> np.ndarray:
        return np.asarray(self._n_labels)

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + 5000 + int(i))
        U = int(self._n_labels[i])
        labels = rng.randint(1, self.vocab_size, U).astype(np.int32)
        for u in range(1, U):  # greedy decode dedups consecutive repeats
            while labels[u] == labels[u - 1]:
                labels[u] = rng.randint(1, self.vocab_size)
        T = U * self.frames_per_label
        feats = np.repeat(self.patterns[labels], self.frames_per_label, axis=0)
        feats = feats + self.noise * rng.randn(T, self.n_mels).astype(np.float32)
        return {"feats": feats.astype(np.float32), "labels": labels}


class PatternedWaveformDataset:
    """Waveform-level learnable testbed: each label stamps a label-specific
    multi-tone 16 kHz snippet (a chord of ``tones_per_label`` label-specific
    sinusoids — distinctive mel peaks, so the mapping generalizes; plain
    noise snippets blur together under mel pooling and get memorized), and
    each utterance applies a random gain and DC offset so that the
    per-utterance mean-var norm is load-bearing: a model trained on
    normalized features degrades on unnormalized ones.

    ``__getitem__`` emits offline-pipeline features (norm per ``cfg``);
    ``waveform(i)`` exposes the raw (gain/offset applied) PCM for streaming.
    """

    def __init__(self, n: int, cfg: AudioConfig, vocab_size: int = 72,
                 min_labels: int = 4, max_labels: int = 12,
                 frames_per_label: int = 8, noise: float = 0.1,
                 gain_range=(0.25, 4.0), offset_range=(-0.5, 0.5),
                 tones_per_label: int = 3, seed: int = 0,
                 pattern_seed: int = 777):
        self.n = n
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.frames_per_label = frames_per_label
        self.samples_per_label = frames_per_label * cfg.hop_length
        self.noise = noise
        self.gain_range = gain_range
        self.offset_range = offset_range
        self.seed = seed
        prng = np.random.RandomState(pattern_seed)
        t = np.arange(self.samples_per_label) / cfg.sample_rate
        freqs = prng.uniform(200.0, cfg.sample_rate * 0.45,
                             (vocab_size, tones_per_label))
        phases = prng.uniform(0, 2 * np.pi, (vocab_size, tones_per_label))
        self.patterns = np.sum(
            np.sin(2 * np.pi * freqs[:, :, None] * t[None, None, :]
                   + phases[:, :, None]),
            axis=1).astype(np.float32) / np.sqrt(tones_per_label)
        rng = np.random.RandomState(seed)
        self._n_labels = rng.randint(min_labels, max_labels + 1, n)
        self._cache: dict = {}

    def __len__(self):
        return self.n

    def lengths(self) -> np.ndarray:
        return np.asarray([
            num_frames(int(u) * self.samples_per_label, self.cfg.hop_length)
            for u in self._n_labels])

    def label_lengths(self) -> np.ndarray:
        return np.asarray(self._n_labels)

    def _labels(self, i: int, rng) -> np.ndarray:
        U = int(self._n_labels[i])
        labels = rng.randint(1, self.vocab_size, U).astype(np.int32)
        for u in range(1, U):  # greedy decode dedups consecutive repeats
            while labels[u] == labels[u - 1]:
                labels[u] = rng.randint(1, self.vocab_size)
        return labels

    def waveform(self, i: int):
        """(wav float32 (S,), labels int32 (U,)) with gain/offset applied."""
        rng = np.random.RandomState(self.seed + 5000 + int(i))
        labels = self._labels(i, rng)
        wav = self.patterns[labels].reshape(-1)
        wav = wav + self.noise * rng.randn(len(wav)).astype(np.float32)
        lo, hi = self.gain_range
        gain = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        offset = float(rng.uniform(*self.offset_range))
        return (gain * wav + offset).astype(np.float32), labels

    def __getitem__(self, i: int) -> dict:
        # deterministic per index -> cache features across epochs (the
        # offline-pipeline stand-in; ~30 KB/utterance)
        hit = self._cache.get(i)
        if hit is None:
            wav, labels = self.waveform(i)
            hit = {"feats": logmel_np(wav, self.cfg), "labels": labels}
            self._cache[i] = hit
        return hit
