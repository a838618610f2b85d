"""Model FLOPs of the concat joint, computed through its factors: the fc's
encoder columns once per encoder frame, its prediction-network columns once
per label (``reference/joints/concat.py``)."""

from __future__ import annotations

from typing import Mapping


def train_fwd(model: Mapping, batch: int, t_enc: float, u1: float) -> float:
    V = model["jointnet"]["num_classes"]
    fwd = 2 * batch * t_enc * model["transnet"]["output_size"] * V
    fwd += 2 * batch * u1 * model["prednet"]["output_size"] * V
    return fwd


def frame_flops(model: Mapping, t_enc: float) -> float:
    """Decoding: the encoder side over ``t_enc`` encoder frames."""
    return t_enc * 2 * model["transnet"]["output_size"] * model["jointnet"]["num_classes"]


def label_flops(model: Mapping) -> float:
    """Decoding: the prediction side of one label."""
    return 2 * model["prednet"]["output_size"] * model["jointnet"]["num_classes"]
