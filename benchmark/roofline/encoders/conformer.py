"""Model FLOPs of the Conformer encoder (``conformer_step_flops`` of the
repository's chip smoke test)."""

from __future__ import annotations

import functools
from typing import Mapping

from benchmark.roofline import counts


@functools.lru_cache(maxsize=4096)
def _attended(tp: int, chunk: int, left: int) -> int:
    """Query-key pairs of ``tp`` frames under full context (chunk 0) or the
    chunked-causal window."""
    if chunk <= 0:
        return tp * tp
    total = 0
    for q in range(tp):
        c = q // chunk
        total += min(tp, (c + 1) * chunk) - max(0, (c - left) * chunk)
    return total


def conformer_step_flops(model: Mapping, batch: int, t_frames: int, u_labels: float,
                         padded: bool = False) -> float:
    """Matmul FLOPs of one Conformer training step (``conformer_step_flops``
    with its prediction-net and joint terms).  ``padded`` counts T'^2
    attention pairs as that copy does; otherwise only the pairs the
    chunked-causal mask lets a frame attend."""
    tn = model["transnet"]
    d, ff, s = tn["hidden_size"], tn["ff_multiplier"], tn.get("time_reduction_stride", 1)
    tp = t_frames // s if padded else -(-t_frames // s)
    pairs = tp * tp if padded else _attended(tp, tn.get("attention_chunk", 0),
                                             tn.get("attention_left_chunks", 4))
    fwd = 2 * batch * tp * (tn["input_size"] * s) * d
    per_block = (2 * (2 * 2 * batch * tp * d * ff * d)
                 + 4 * 2 * batch * tp * d * d
                 + 2 * 2 * batch * pairs * d
                 + 2 * batch * tp * d * 2 * d
                 + 2 * batch * tp * d * d)
    fwd += tn["num_layers"] * per_block
    fwd += 2 * batch * tp * d * tn["output_size"]
    return 3.0 * (fwd + counts.prednet_joint_fwd(model, batch, tp, u_labels))


step_flops = conformer_step_flops


def decode_encoder(tn: Mapping, frames: float, keys: int):
    """(forward FLOPs of the encoder over ``frames`` input frames, each
    query attending ``keys`` keys, its output frames)."""
    d, ff, s = tn["hidden_size"], tn["ff_multiplier"], tn.get("time_reduction_stride", 1)
    tp = frames / s
    per = (2 * (2 * 2 * d * ff * d) + 4 * 2 * d * d + 2 * 2 * keys * d
           + 2 * d * 2 * d + 2 * d * d)
    enc = tp * (2 * tn["input_size"] * s * d + tn["num_layers"] * per
                + 2 * d * tn["output_size"])
    return enc, tp
