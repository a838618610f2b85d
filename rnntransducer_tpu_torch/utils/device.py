"""Device choice for the port's entry points.

Entry points run on the card unless the caller names another device: a
missing ``device`` means CUDA, and when CUDA is absent they raise instead of
running on the CPU unasked."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by default; "
                "pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
