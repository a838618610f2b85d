"""Inference precision policy (port of ``rnntransducer_tpu/utils/precision.py``).

* params: float tensors are cast ONCE when a decode surface is built
  (``module.to(decode_dtype(name))``, which leaves integer tensors alone);
* activations: decode entry points cast floating inputs to the params'
  dtype (:func:`match_param_dtype`), so the one cast made at construction
  carries through the encoder, the prediction network and the joint.
"""

from __future__ import annotations

import torch

#: decode-surface precision names -> dtypes
DECODE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def decode_dtype(precision: str) -> torch.dtype:
    """Map a precision name ('fp32' | 'bf16') to its torch dtype."""
    try:
        return DECODE_DTYPES[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; choose from "
            f"{sorted(DECODE_DTYPES)}") from None


def param_dtype(module: torch.nn.Module,
                default: torch.dtype = torch.float32) -> torch.dtype:
    """The dtype of the module's first floating parameter: all float params
    are cast together, so any one speaks for the model."""
    for p in module.parameters():
        if p.is_floating_point():
            return p.dtype
    return default


def match_param_dtype(module: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Cast floating ``x`` to the module's compute dtype (no-op when they
    already agree)."""
    dt = param_dtype(module)
    if x.is_floating_point() and x.dtype != dt:
        return x.to(dt)
    return x
