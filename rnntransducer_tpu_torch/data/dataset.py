"""Datasets (port of ``rnntransducer_tpu/data/dataset.py``).

* ``load_shards``, ``ArrowAudioDataset``, ``ArrowWaveformDataset``: every
  ``root/<split>/<idx>`` Arrow shard, concatenated, as random-access
  datasets of log-mel features or raw PCM.  ``datasets`` is imported only
  when shards are loaded or written.
* ``prepare_logmel_dataset``: raw PCM shards -> log-mel shards, once per
  split (a ``_SUCCESS`` marker), recorded in the ``postprocess_log.json``
  ledger (``write_ledger_entry`` / ``read_ledger``);
  ``save_waveform_dataset``: items -> raw PCM shards, streamed one shard
  at a time.
* ``SyntheticAudioDataset``, ``PatternedSyntheticDataset``,
  ``PatternedWaveformDataset``, ``HardPatternedWaveformDataset``,
  ``ConfusableWaveformDataset``: deterministic seeded data for tests,
  benchmarks, smoke training and accuracy experiments; each draws what the
  JAX package's class draws, in the same order, so a seed gives the same
  waves, labels and features in both packages.
* ``logmel_np`` / ``spec_augment_np``: the host log-mel and SpecAugment.

Host IO and numpy only: nothing here touches the device.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import List, Optional, Sequence

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


# ---------------------------------------------------------- ledger helpers
def _ledger_path(dataset_dir: str) -> str:
    return os.path.join(dataset_dir, "postprocess_log.json")


def write_ledger_entry(dataset_dir: str, task: str, train_type: str,
                       **extra) -> None:
    """Record ``task`` done on split ``train_type`` (with its time and
    ``extra``) in the dataset root's ledger, ``postprocess_log.json``."""
    path = _ledger_path(dataset_dir)
    log = {}
    if os.path.exists(path):
        with open(path) as f:
            log = json.load(f)
    log.setdefault(train_type, {})[task] = {"time": time.time(), **extra}
    os.makedirs(dataset_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(log, f, indent=1)


def read_ledger(dataset_dir: str) -> dict:
    """The dataset root's ledger, ``{}`` where it has none."""
    path = _ledger_path(dataset_dir)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


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


def prepare_logmel_dataset(source_roots: Sequence[str], target_root: str,
                           split: str, audio_cfg: AudioConfig,
                           num_shards: int = 1, num_proc: int = 1,
                           bake_spec_augment: bool = False,
                           seed: int = 0) -> None:
    """Raw PCM shards -> log-mel shards of one split, on the host.

    Source rows: {'input_values': raw float32 PCM at the sample rate,
    'input_ids': label ids}.  Output rows: {'input_values': (frames,
    n_mels) float32, 'input_ids', 'audio_len', 'label_len'} in
    ``min(num_shards, rows)`` shards under ``target_root/<split>/<i>``.
    SpecAugment runs on the card in every step; ``bake_spec_augment``
    writes it into the features instead (row i drawn from
    ``RandomState(seed + i)``).  A finished split (its ``_SUCCESS``
    marker) is skipped; one without the marker (a crashed run) is redone.
    """
    target = os.path.join(target_root, split)
    marker = os.path.join(target, "_SUCCESS")
    if os.path.exists(marker):
        return

    ds = load_shards(source_roots, split)

    def to_logmel(batch, idx):
        feats = logmel_np(np.asarray(batch["input_values"], np.float32),
                          audio_cfg)
        if bake_spec_augment:
            feats = spec_augment_np(
                feats, audio_cfg, np.random.RandomState(seed + idx))
        return {"input_values": feats, "audio_len": feats.shape[0],
                "label_len": len(batch["input_ids"])}

    ds = ds.map(to_logmel, with_indices=True, num_proc=num_proc or None)
    write_ledger_entry(target_root, "logmel", split,
                       baked_spec_augment=bake_spec_augment)
    num_shards = max(1, min(num_shards, len(ds)))
    for shard_idx in range(num_shards):
        shard = ds.shard(num_shards=num_shards, index=shard_idx)
        shard.save_to_disk(os.path.join(target, str(shard_idx)))
    with open(marker, "w") as f:
        f.write("ok\n")


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


def save_waveform_dataset(items, target_root: str, split: str,
                          hop_length: int, num_shards: int = 1,
                          total: Optional[int] = None) -> None:
    """Write an iterable of {'wav' float32 (S,), 'labels' int (U,)} items as
    raw PCM shards that :class:`ArrowWaveformDataset` reads, with
    ``prepare_logmel_dataset``'s layout, ``_SUCCESS`` marker and ledger.
    'audio_len' holds the frame count (the Trainer's bucketing unit).

    With ``total`` (the item count) the items stream shard by shard, one
    shard's rows in memory at a time, for corpora larger than memory;
    without it the iterable is read whole first.  An iterable that yields
    another count than ``total`` raises ``ValueError`` and leaves no
    marker."""
    from datasets import Dataset

    target = os.path.join(target_root, split)
    marker = os.path.join(target, "_SUCCESS")
    if os.path.exists(marker):
        return

    it = iter(items)
    if total is None:
        rows = [{"wav": np.asarray(r["wav"], np.float32),
                 "labels": np.asarray(r["labels"], np.int32)} for r in it]
        total = len(rows)
        it = iter(rows)
    write_ledger_entry(target_root, "waveform", split)
    num_shards = max(1, min(num_shards, total))
    per = (total + num_shards - 1) // num_shards
    shard_idx = 0
    consumed = 0
    while True:
        chunk = list(itertools.islice(it, per))
        if not chunk:
            break
        consumed += len(chunk)
        shard = Dataset.from_dict({
            "input_values": [np.asarray(r["wav"], np.float32) for r in chunk],
            "input_ids": [np.asarray(r["labels"], np.int32) for r in chunk],
            "audio_len": [num_frames(len(r["wav"]), hop_length) for r in chunk],
            "label_len": [len(r["labels"]) for r in chunk],
        })
        shard.save_to_disk(os.path.join(target, str(shard_idx)))
        shard_idx += 1
    if consumed != total:
        # a wrong total either writes extra shard directories or would mark
        # a short corpus complete: no marker over a miscounted corpus
        raise ValueError(
            f"save_waveform_dataset: iterable yielded {consumed} items but "
            f"total={total}; no _SUCCESS marker written (partial shards "
            f"remain under {target})")
    with open(marker, "w") as f:
        f.write("ok\n")


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


class HardPatternedWaveformDataset:
    """An accuracy testbed hard enough that systems can fail on it: the
    patterned codebook with the difficulty axes of real speech layered on.

    * additive noise at a per-utterance SNR drawn from ``snr_db_range``
      (dB, uniform);
    * tempo: every label snippet of an utterance stretched by one
      log-uniform factor from ``tempo_range``;
    * speaker: every tone frequency of an utterance scaled by one
      log-uniform factor from ``speaker_range``;
    * gain and DC offset, as :class:`PatternedWaveformDataset`, so that the
      per-utterance normalization matters;
    * words: transcripts are sequences of multi-grapheme words from a
      closed lexicon, joined by the word delimiter over silence.  The
      lexicon's first ``n_words - n_oov_words`` entries are in-vocabulary;
      with ``oov_fraction > 0`` a word position draws from the held-out
      rest instead, so word-LM fusion has in-vocabulary words to gain on
      and out-of-vocabulary ones to break on.

    Words draw graphemes from ``[grapheme_lo, grapheme_hi)``
    (``grapheme_hi=None``: up to ``vocab_size``).  With the 72-entry
    vocabulary, ids 56-71 are ``<extra_*>`` special tokens that decode
    drops, so a testbed whose text must survive a decode (LM corpora,
    transcripts in a manifest) passes ``grapheme_hi=56``.

    ``__getitem__`` -> host log-mel features and labels; ``waveform(i)``
    -> raw PCM; ``word_sequences(i)`` -> the word ids.
    """

    def __init__(self, n: int, cfg: AudioConfig, vocab_size: int = 72,
                 n_words: int = 80, n_oov_words: int = 16,
                 words_per_utt=(3, 7), word_len=(2, 4),
                 grapheme_lo: int = 5, grapheme_hi: Optional[int] = None,
                 delimiter_id: int = 4,
                 frames_per_label: int = 8,
                 tempo_range=(0.8, 1.25), speaker_range=(0.9, 1.12),
                 snr_db_range=(5.0, 20.0), gain_range=(0.25, 4.0),
                 offset_range=(-0.5, 0.5), oov_fraction: float = 0.0,
                 tones_per_label: int = 3, seed: int = 0,
                 pattern_seed: int = 777):
        self.n = n
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.delimiter_id = delimiter_id
        self.samples_per_label = frames_per_label * cfg.hop_length
        self.tempo_range = tempo_range
        self.speaker_range = speaker_range
        self.snr_db_range = snr_db_range
        self.gain_range = gain_range
        self.offset_range = offset_range
        self.seed = seed

        prng = np.random.RandomState(pattern_seed)
        # label -> tone chord; the speaker warp scales the frequencies per
        # utterance, so only the frequencies and phases are kept
        self.freqs = prng.uniform(200.0, cfg.sample_rate * 0.40,
                                  (vocab_size, tones_per_label))
        self.phases = prng.uniform(0, 2 * np.pi,
                                   (vocab_size, tones_per_label))
        self.tones_per_label = tones_per_label
        if grapheme_hi is None:
            grapheme_hi = vocab_size
        lex = set()
        lex_list = []
        while len(lex_list) < n_words:
            L = prng.randint(word_len[0], word_len[1] + 1)
            w = []
            for _ in range(L):
                g = prng.randint(grapheme_lo, grapheme_hi)
                while w and g == w[-1]:  # greedy decode dedups repeats
                    g = prng.randint(grapheme_lo, grapheme_hi)
                w.append(int(g))
            w = tuple(w)
            if w not in lex:
                lex.add(w)
                lex_list.append(w)
        self.lexicon = lex_list
        self.n_in_vocab = n_words - n_oov_words

        # per-utterance draws up front, so that lengths() is cheap and exact
        rng = np.random.RandomState(seed)
        self._word_seqs = []
        self._tempo = []
        self._speaker = []
        self._snr_db = []
        self._label_seqs = []
        lo_t, hi_t = tempo_range
        lo_s, hi_s = speaker_range
        for _ in range(n):
            k = rng.randint(words_per_utt[0], words_per_utt[1] + 1)
            ws = []
            for _ in range(k):
                if oov_fraction > 0 and rng.rand() < oov_fraction:
                    ws.append(int(rng.randint(self.n_in_vocab, n_words)))
                else:
                    ws.append(int(rng.randint(0, self.n_in_vocab)))
            self._word_seqs.append(ws)
            labels = []
            for j, w in enumerate(ws):
                if j:
                    labels.append(delimiter_id)
                labels.extend(self.lexicon[w])
            self._label_seqs.append(np.asarray(labels, np.int32))
            self._tempo.append(float(np.exp(
                rng.uniform(np.log(lo_t), np.log(hi_t)))))
            self._speaker.append(float(np.exp(
                rng.uniform(np.log(lo_s), np.log(hi_s)))))
            self._snr_db.append(float(rng.uniform(*snr_db_range)))
        self._cache: dict = {}

    def __len__(self):
        return self.n

    def _samples_per_label(self, i: int) -> int:
        return int(round(self.samples_per_label * self._tempo[i]))

    def lengths(self) -> np.ndarray:
        return np.asarray([
            num_frames(len(self._label_seqs[i]) * self._samples_per_label(i),
                       self.cfg.hop_length)
            for i in range(self.n)])

    def label_lengths(self) -> np.ndarray:
        return np.asarray([len(s) for s in self._label_seqs])

    def word_sequences(self, i: int):
        return list(self._word_seqs[i])

    def _render_labels(self, i: int) -> np.ndarray:
        """The grapheme sequence the audio is rendered from: the transcript
        here; :class:`ConfusableWaveformDataset` renders homophones with
        their twin's graphemes."""
        return self._label_seqs[i]

    def waveform(self, i: int):
        """(wav float32 (S,), labels int32 (U,)) with tempo, speaker, noise,
        gain and offset applied.  The audio renders from
        ``_render_labels``; the labels are always the transcript."""
        rng = np.random.RandomState(self.seed + 9000 + int(i))
        labels = self._render_labels(i)
        spl = self._samples_per_label(i)
        t = np.arange(spl) / self.cfg.sample_rate
        warp = self._speaker[i]
        segs = []
        for l in labels:
            if l == self.delimiter_id:
                segs.append(np.zeros(spl, np.float32))  # silence gap
                continue
            f = self.freqs[l] * warp
            seg = np.sum(
                np.sin(2 * np.pi * f[:, None] * t[None, :]
                       + self.phases[l][:, None]),
                axis=0) / np.sqrt(self.tones_per_label)
            segs.append(seg.astype(np.float32))
        wav = np.concatenate(segs)
        rms = float(np.sqrt(np.mean(wav ** 2)) + 1e-8)
        noise_std = rms * 10.0 ** (-self._snr_db[i] / 20.0)
        wav = wav + noise_std * rng.randn(len(wav)).astype(np.float32)
        lo, hi = self.gain_range
        gain = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        offset = float(rng.uniform(*self.offset_range))
        return ((gain * wav + offset).astype(np.float32),
                self._label_seqs[i].copy())

    def __getitem__(self, i: int) -> dict:
        hit = self._cache.get(i)
        if hit is None:
            wav, labels = self.waveform(i)
            hit = {"feats": logmel_np(wav, self.cfg), "labels": labels}
            self._cache[i] = hit
        return hit


class ConfusableWaveformDataset(HardPatternedWaveformDataset):
    """The LM-fusion testbed: homophones with a predictive context.

    * ``n_homophone_pairs`` same-length in-vocabulary word pairs (a, b) are
      true homophones: b's audio renders with a's graphemes while its
      transcript keeps b's spelling, so no SNR tells them apart;
    * word sequences follow a trigger grammar: a pair slot emits
      ``trigger_a a`` or ``trigger_b b`` (the matching homophone with
      probability ``trigger_coupling``, its twin otherwise), between
      uniform filler words.  A bigram LM of the train transcripts learns
      the coupling and resolves what the audio cannot;
    * ``gap_segments`` silence segments are rendered per word boundary
      (the transcript keeps one delimiter): set it past an acoustic
      model's context reach to put the trigger's audio out of its view.

    Pairs and triggers come from ``pattern_seed``, as the lexicon does, so
    splits drawn with other ``seed`` share them.  ``homophone_slots(i)``
    gives the word positions holding a homophone.
    """

    def __init__(self, n: int, cfg: AudioConfig,
                 n_homophone_pairs: int = 8,
                 trigger_coupling: float = 0.95,
                 pair_fraction: float = 0.6,
                 words_per_utt=(3, 7), seed: int = 0,
                 pattern_seed: int = 777, gap_segments: int = 1,
                 grapheme_hi: Optional[int] = 56, **kw):
        self.gap_segments = int(gap_segments)
        super().__init__(n, cfg, words_per_utt=words_per_utt, seed=seed,
                         oov_fraction=0.0, pattern_seed=pattern_seed,
                         grapheme_hi=grapheme_hi, **kw)
        prng = np.random.RandomState(pattern_seed + 4242)
        # same-length in-vocabulary pairs, and two trigger words per pair
        by_len: dict = {}
        for wi in range(self.n_in_vocab):
            by_len.setdefault(len(self.lexicon[wi]), []).append(wi)
        pool = [g for g in by_len.values() if len(g) >= 2]
        pairs = []
        used = set()
        for group in pool:
            g = list(group)
            prng.shuffle(g)
            while len(g) >= 2 and len(pairs) < n_homophone_pairs:
                a, b = g.pop(), g.pop()
                pairs.append((a, b))
                used.update((a, b))
        if len(pairs) < n_homophone_pairs:
            raise ValueError(
                f"lexicon only admits {len(pairs)} same-length homophone "
                f"pairs (< {n_homophone_pairs}); widen word_len or n_words")
        rest = [wi for wi in range(self.n_in_vocab) if wi not in used]
        if len(rest) < 2 * len(pairs) + 1:
            raise ValueError("not enough non-homophone words for triggers "
                             "and fillers")
        triggers = [(rest[2 * j], rest[2 * j + 1])
                    for j in range(len(pairs))]
        trig_used = {w for t in triggers for w in t}
        fillers = [w for w in rest if w not in trig_used]
        self.pairs = pairs
        self.triggers = triggers
        self.trigger_coupling = float(trigger_coupling)
        self._twin = {b: a for a, b in pairs}  # b sounds exactly like a

        # every utterance drawn again under the trigger grammar
        rng = np.random.RandomState(seed)
        lo_t, hi_t = self.tempo_range
        lo_s, hi_s = self.speaker_range
        self._word_seqs, self._label_seqs = [], []
        self._tempo, self._speaker, self._snr_db = [], [], []
        self._homophone_slots = []
        for _ in range(n):
            k = rng.randint(words_per_utt[0], words_per_utt[1] + 1)
            ws, slots = [], []
            while len(ws) < k:
                if len(ws) + 2 <= k and rng.rand() < pair_fraction:
                    j = rng.randint(len(pairs))
                    side = rng.rand() < 0.5
                    a, b = pairs[j]
                    t_a, t_b = triggers[j]
                    ws.append(t_a if side else t_b)
                    want = (a if side else b)
                    twin = (b if side else a)
                    slots.append(len(ws))
                    ws.append(want if rng.rand() < trigger_coupling
                              else twin)
                else:
                    ws.append(int(fillers[rng.randint(len(fillers))]))
            self._word_seqs.append(ws)
            self._homophone_slots.append(slots)
            labels = []
            for j, w in enumerate(ws):
                if j:
                    labels.append(self.delimiter_id)
                labels.extend(self.lexicon[w])
            self._label_seqs.append(np.asarray(labels, np.int32))
            self._tempo.append(float(np.exp(
                rng.uniform(np.log(lo_t), np.log(hi_t)))))
            self._speaker.append(float(np.exp(
                rng.uniform(np.log(lo_s), np.log(hi_s)))))
            self._snr_db.append(float(rng.uniform(*self.snr_db_range)))
        self._cache = {}

    def homophone_slots(self, i: int):
        """Word positions (into ``word_sequences(i)``) that hold a
        homophone: the confusable decisions an evaluation scores."""
        return list(self._homophone_slots[i])

    def _render_labels(self, i: int) -> np.ndarray:
        out = []
        for j, w in enumerate(self._word_seqs[i]):
            if j:
                out.extend([self.delimiter_id] * self.gap_segments)
            out.extend(self.lexicon[self._twin.get(w, w)])
        return np.asarray(out, np.int32)

    def lengths(self) -> np.ndarray:
        # the audio follows the render sequence (gap_segments widens the
        # silence), not the transcript
        return np.asarray([
            num_frames(len(self._render_labels(i))
                       * self._samples_per_label(i), self.cfg.hop_length)
            for i in range(self.n)])
