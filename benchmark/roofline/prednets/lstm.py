"""Model FLOPs of the recurrent prediction network (LSTM layers; GRU:
``prednets/gru.py``)."""

from __future__ import annotations

from typing import Mapping

GATES = 4


def train_fwd(pn: Mapping, batch: int, u1: float, gates: int = GATES) -> float:
    """Forward FLOPs over ``u1`` blank-prepended labels a row."""
    Hp = pn["hidden_size"]
    fwd = pn["num_layers"] * 2 * batch * u1 * gates * Hp * (Hp + Hp)
    fwd += 2 * batch * u1 * Hp * pn["output_size"]
    return fwd


def step_flops(pn: Mapping, gates: int = GATES) -> float:
    """Forward FLOPs of one label in decoding."""
    Hp = pn["hidden_size"]
    return pn["num_layers"] * 2 * gates * Hp * (Hp + Hp) + 2 * Hp * pn["output_size"]
