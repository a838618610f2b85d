from rnntransducer_tpu_torch.data.bucketing import LengthBucketSampler, bucket_for
from rnntransducer_tpu_torch.data.collate import (collate, collate_waveforms,
                                                  pack_features, pack_waveforms,
                                                  quantize_waveforms)
from rnntransducer_tpu_torch.data.dataset import (
    ArrowAudioDataset, ArrowWaveformDataset, PatternedSyntheticDataset,
    PatternedWaveformDataset, SyntheticAudioDataset, load_shards, logmel_np,
    shard_dirs, spec_augment_np,
)
from rnntransducer_tpu_torch.data.prefetch import DevicePrefetcher, ordered_readahead

__all__ = [
    "ArrowAudioDataset", "ArrowWaveformDataset", "DevicePrefetcher",
    "LengthBucketSampler", "PatternedSyntheticDataset", "PatternedWaveformDataset",
    "SyntheticAudioDataset", "bucket_for", "collate", "collate_waveforms",
    "load_shards", "logmel_np", "ordered_readahead", "pack_features",
    "pack_waveforms", "quantize_waveforms", "shard_dirs", "spec_augment_np",
]
