from rnntransducer_tpu_torch.frontend.fused_frontend import (
    logmel_fused, logmel_fused_reference,
)
from rnntransducer_tpu_torch.frontend.melspec import (
    LogMelFrontend, frame_signal, hamming_window, hann_window,
    mean_var_normalize, mel_filterbank, num_frames, stft_power,
)
from rnntransducer_tpu_torch.frontend.specaugment import spec_augment

__all__ = ["LogMelFrontend", "frame_signal", "hamming_window", "hann_window",
           "logmel_fused", "logmel_fused_reference", "mean_var_normalize",
           "mel_filterbank", "num_frames", "spec_augment", "stft_power"]
