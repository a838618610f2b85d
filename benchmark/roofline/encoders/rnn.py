"""Model FLOPs of the recurrent encoder (``step_model_flops`` of the
repository's chip smoke test)."""

from __future__ import annotations

from typing import Mapping, Optional

from benchmark.roofline import counts

GATES = {"gru": 3, "lstm": 4, "rnn": 1}


def rnn_step_flops(model: Mapping, batch: int, t_frames: float, u_labels: float) -> float:
    """Matmul FLOPs of one RNN-encoder training step (``step_model_flops``)."""
    tn = model["transnet"]
    H, dirs = tn["hidden_size"], 2 if tn["bidirectional"] else 1
    g = GATES[tn["rnn_type"].lower()]
    fwd, in_size = 0.0, tn["input_size"]
    for _ in range(tn["num_layers"]):
        fwd += dirs * 2 * batch * t_frames * g * H * (in_size + H)
        in_size = dirs * H
    fwd += 2 * batch * t_frames * in_size * tn["output_size"]
    return 3.0 * (fwd + counts.prednet_joint_fwd(model, batch, t_frames, u_labels))


step_flops = rnn_step_flops


def decode_encoder(tn: Mapping, frames: float, keys: int):
    """(forward FLOPs of the encoder over ``frames`` input frames, its
    output frames)."""
    H, dirs = tn["hidden_size"], 2 if tn["bidirectional"] else 1
    g = GATES[tn["rnn_type"].lower()]
    tp, enc, in_size = frames, 0.0, tn["input_size"]
    for _ in range(tn["num_layers"]):
        enc += dirs * 2 * frames * g * H * (in_size + H)
        in_size = dirs * H
    enc += 2 * frames * in_size * tn["output_size"]
    return enc, tp


def gru_scans(tn: Mapping) -> Optional[int]:
    """K1 / K2 scans a pass runs (a layer's directions), where the encoder
    is a GRU stack at full frame rate; None otherwise."""
    if tn.get("rnn_type") != "gru" or tn.get("time_reduction_stride", 1) != 1:
        return None
    return tn["num_layers"] * (2 if tn["bidirectional"] else 1)
