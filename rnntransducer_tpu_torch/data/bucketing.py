"""Length-bucketed batching (port of ``rnntransducer_tpu/data/bucketing.py``).

Utterances are grouped into frame-length buckets and batched within a
bucket, so padding waste is bounded by the bucket's width and every batch
is padded to its bucket's upper edge.  The order is drawn from numpy's
``RandomState(seed + epoch)``, so a seed yields the same batches in the same
order as the JAX package's sampler.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def bucket_for(length: int, boundaries: Sequence[int]) -> int:
    """Index of the smallest boundary >= length (lengths beyond the last
    boundary are clamped into the last bucket)."""
    for i, b in enumerate(boundaries):
        if length <= b:
            return i
    return len(boundaries) - 1


class LengthBucketSampler:
    """Yields (bucket_idx, [indices]) batches.

    * groups utterances into frame-length buckets,
    * batches within a bucket (so padding waste is bounded by bucket width),
    * shuffles deterministically per epoch (seed + epoch, like the reference's
      ``DistributedSampler`` contract),
    * optional rank-strided sharding for multi-host data parallelism
      (``datasampler.py:96`` semantics: indices[rank::world]),
    * drop_last pads the final partial batch by wrapping around (reference
      pads to divisibility, ``datasampler.py:87-93``) or drops it.
    """

    def __init__(self, lengths: Sequence[int], boundaries: Sequence[int],
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 rank: int = 0, world_size: int = 1, drop_last: bool = False,
                 max_length: Optional[int] = None,
                 label_lengths: Optional[Sequence[int]] = None,
                 max_label_length: Optional[int] = None):
        self.lengths = np.asarray(lengths)
        self.boundaries = tuple(boundaries)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        # utterances longer than this are dropped (default: the largest
        # bucket boundary) — frame truncation would corrupt supervision
        self.max_length = (max_length if max_length is not None
                           else self.boundaries[-1])
        # same policy for labels: an utterance whose transcript exceeds the
        # largest label bucket is dropped whole, never truncated (truncating
        # labels cuts supervision — the loss would train against a prefix)
        self.label_lengths = (None if label_lengths is None
                              else np.asarray(label_lengths))
        self.max_label_length = max_label_length
        self.last_dropped = 0
        self.last_label_dropped = 0

    def epoch_batches(self, epoch: int = 0) -> List[Tuple[int, np.ndarray, int]]:
        """Returns (bucket_idx, indices, n_valid) triples; indices beyond
        n_valid are wrap-padding duplicates (present so every batch has the
        full static batch size) — evaluation must exclude them."""
        rng = np.random.RandomState(self.seed + epoch)
        buckets: List[List[int]] = [[] for _ in self.boundaries]
        order = np.arange(len(self.lengths))
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.rank::self.world_size]
        dropped = 0
        label_dropped = 0
        for idx in order:
            length = int(self.lengths[idx])
            if self.max_length is not None and length > self.max_length:
                dropped += 1  # never silently truncate audio (see collate)
                continue
            if (self.label_lengths is not None
                    and self.max_label_length is not None
                    and int(self.label_lengths[idx]) > self.max_label_length):
                label_dropped += 1  # never truncate labels either
                continue
            buckets[bucket_for(length, self.boundaries)].append(idx)
        self.last_dropped = dropped
        self.last_label_dropped = label_dropped

        batches: List[Tuple[int, np.ndarray, int]] = []
        for b_idx, idxs in enumerate(buckets):
            idxs = np.asarray(idxs)
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s:s + self.batch_size]
                n_valid = len(chunk)
                if n_valid < self.batch_size:
                    if self.drop_last:
                        continue
                    if len(idxs) < self.batch_size:
                        # tiny bucket: wrap-pad to full batch
                        reps = int(np.ceil(self.batch_size / n_valid))
                        chunk = np.tile(chunk, reps)[:self.batch_size]
                    else:
                        # pad from the bucket's own head (wrap-around)
                        need = self.batch_size - n_valid
                        chunk = np.concatenate([chunk, idxs[:need]])
                batches.append((b_idx, chunk, n_valid))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, int]]:
        return iter(self.epoch_batches(0))
