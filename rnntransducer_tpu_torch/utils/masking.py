"""Length-mask helper (port of ``rnntransducer_tpu/utils/masking.py``)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool validity mask."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None].to(torch.int64)
