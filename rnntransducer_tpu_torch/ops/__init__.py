from rnntransducer_tpu_torch.ops import library
from rnntransducer_tpu_torch.ops.rnn_kernels import gru_scan, gru_scan_reference

__all__ = ["gru_scan", "gru_scan_reference", "library"]
