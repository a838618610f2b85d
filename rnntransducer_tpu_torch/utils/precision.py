"""Precision policies (port of ``rnntransducer_tpu/utils/precision.py``).

Inference:

* params: float tensors are cast ONCE when a decode surface is built
  (``module.to(decode_dtype(name))``, which leaves integer tensors alone);
* activations: decode entry points cast floating inputs to the params'
  dtype (:func:`match_param_dtype`), so the one cast made at construction
  carries through the encoder, the prediction network and the joint.

Training (``cfg.train.precision``, see ``train/state.py``): master params
stay float32; each forward casts every float param to
:func:`train_compute_dtype` with gradients flowing back to the masters, as
the JAX package's ``_cast`` does.

:func:`full_precision_matmul` scopes the matmuls that must not run in
reduced precision whatever the global flags say (TF32 for float32, reduced
precision reductions for bfloat16).
"""

from __future__ import annotations

import contextlib

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


def train_compute_dtype(precision: str) -> torch.dtype:
    """Compute dtype of a training step: 'bf16' -> bfloat16, 'fp32' ->
    float32 (``cfg.train.precision``)."""
    return decode_dtype(precision)


@contextlib.contextmanager
def full_precision_matmul():
    """Within the block, float32 matmuls run in full float32 (no TF32) and
    bfloat16 matmuls reduce in float32; the global flags are restored on
    exit."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


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
