"""PyTorch/CUDA port of ``rnntransducer_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package keeps its layout and
names (``models/cells.py`` <-> ``models/cells.py``) and imports nothing from
it.  The TPU's Pallas kernels become hand-written CUDA kernels under
``csrc/``, built at first use into ``build/kernels/``.  Entry points run on
CUDA unless the caller names another device.
"""

from rnntransducer_tpu_torch.config import Config, base_config, tiny_config
from rnntransducer_tpu_torch.models.transducer import RNNTransducer, build_model
from rnntransducer_tpu_torch.serve import Recognizer

__all__ = ["Config", "RNNTransducer", "Recognizer", "base_config",
           "build_model", "tiny_config"]
