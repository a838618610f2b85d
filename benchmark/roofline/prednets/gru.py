"""Model FLOPs of the recurrent prediction network with GRU layers."""

from __future__ import annotations

from typing import Mapping

from benchmark.roofline.prednets import lstm

GATES = 3


def train_fwd(pn: Mapping, batch: int, u1: float) -> float:
    return lstm.train_fwd(pn, batch, u1, GATES)


def step_flops(pn: Mapping) -> float:
    return lstm.step_flops(pn, GATES)
