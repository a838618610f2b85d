from rnntransducer_tpu_torch.utils.device import resolve_device
from rnntransducer_tpu_torch.utils.masking import length_mask

__all__ = ["length_mask", "resolve_device"]
