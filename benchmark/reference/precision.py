"""Precision of the reference's products.

``fp32`` is float32 with TF32 off (the reference proper).  ``fp8`` is the
control: both operands of every product are rounded to float8 e4m3 with a
per-tensor scale (amax / 448, the usual fp8 recipe), the product and every
other operation stay float32.  It stands for the precision below bf16, which
the configurations state."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "fp8")
E4M3_MAX = 448.0


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    y = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # straight-through: the rounding has no gradient of its own
    return x + (y - x).detach()


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    return q8(x) if precision == "fp8" else x


def linear(x, weight, bias, precision: str):
    """``x @ weight.T + bias`` with (out, in) weights, as ``nn.Linear``."""
    y = torch.matmul(operand(x, precision), operand(weight, precision).t())
    return y if bias is None else y + bias


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 in cuBLAS and cuDNN, for the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved
