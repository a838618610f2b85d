from rnntransducer_tpu_torch.data.bucketing import LengthBucketSampler, bucket_for
from rnntransducer_tpu_torch.data.collate import (collate, collate_waveforms,
                                                  pack_features, pack_waveforms,
                                                  quantize_waveforms)
from rnntransducer_tpu_torch.data.dataset import (
    ArrowAudioDataset, ArrowWaveformDataset, ConfusableWaveformDataset,
    HardPatternedWaveformDataset, PatternedSyntheticDataset,
    PatternedWaveformDataset, SyntheticAudioDataset, load_shards, logmel_np,
    prepare_logmel_dataset, read_ledger, save_waveform_dataset, shard_dirs,
    spec_augment_np, write_ledger_entry,
)
from rnntransducer_tpu_torch.data.prefetch import DevicePrefetcher, ordered_readahead

__all__ = [
    "ArrowAudioDataset", "ArrowWaveformDataset", "ConfusableWaveformDataset",
    "DevicePrefetcher", "HardPatternedWaveformDataset", "LengthBucketSampler",
    "PatternedSyntheticDataset", "PatternedWaveformDataset",
    "SyntheticAudioDataset", "bucket_for", "collate", "collate_waveforms",
    "load_shards", "logmel_np", "ordered_readahead", "pack_features",
    "pack_waveforms", "prepare_logmel_dataset", "quantize_waveforms",
    "read_ledger", "save_waveform_dataset", "shard_dirs", "spec_augment_np",
    "write_ledger_entry",
]
