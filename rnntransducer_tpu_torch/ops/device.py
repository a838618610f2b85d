"""What the kernels' wrappers read of the card: its SM count and the shared
memory a block may opt in to, read once per device."""

from __future__ import annotations

import functools
from typing import Tuple

import torch

# The card the port is built for, an H100 SXM: its SMs and the shared memory
# a block may opt in to.  Used only where no CUDA device is named (planning
# on the CPU, the CPU tests); a CUDA call reads its own card.
H100_SMS = 132
H100_SMEM_OPTIN = 232448


@functools.lru_cache(maxsize=None)
def _cuda_limits(index: int) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def device_limits(device=None) -> Tuple[int, int]:
    """(SM count, shared memory in bytes a block may opt in to) of a CUDA
    device, read once per device; the H100 SXM's (132, 232448) for no
    device or a CPU device."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SMS, H100_SMEM_OPTIN
    dev = torch.device(device)
    return _cuda_limits(dev.index if dev.index is not None
                        else torch.cuda.current_device())
