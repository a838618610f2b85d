"""Building blocks the reference's parts share.

Weights come as one dict keyed by parameter name in these layouts: linear
layers ``weight`` (out, in), ``bias`` (out); norms ``weight``, ``bias`` (d).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import linear

NEG = -1e30
LN_EPS = 1e-6

Spec = Tuple[str, tuple, str, int]


def linear_specs(name: str, n_in: int, n_out: int) -> List[Spec]:
    return [(f"{name}.weight", (n_out, n_in), "uniform", n_in),
            (f"{name}.bias", (n_out,), "uniform", n_in)]


def norm_specs(name: str, d: int) -> List[Spec]:
    return [(f"{name}.weight", (d,), "ones", d), (f"{name}.bias", (d,), "zeros", d)]


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def lin(x, P, name, precision):
    return linear(x, P[f"{name}.weight"], P[f"{name}.bias"], precision)
