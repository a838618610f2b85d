"""Model FLOPs and kernel bounds from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit: 989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores, 3.35
TB/s of HBM3.

The step FLOPs count 2 m n k per forward product and three forward passes a
training step (forward, and the backward's two products); the kernel bounds
are the larger of operations over the peak rate and bytes over HBM
bandwidth, each input read once and each output written once.  They are
copies of the arithmetic the repository's chip smoke test has
(``step_model_flops``, ``conformer_step_flops``, ``gru_bound_ms``,
``gru_bwd_bound_ms``, ``lstm_bound_ms``, ``sweep_bound_ms``,
``logmel_bound_ms``), kept here so the yardstick does not move with that
script; the per-row forms count each row at its own length.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": PEAK_BF16_FLOPS, "fp32": PEAK_FP32_FLOPS}
ELEMENT_BYTES = {"bf16": 2, "fp32": 4}
GATES = {"gru": 3, "lstm": 4, "rnn": 1}


def _bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- step FLOPs
def _prednet_joint_fwd(model: Mapping, batch: int, t_enc: float, u_labels: float) -> float:
    tn, pn, jn = model["transnet"], model["prednet"], model["jointnet"]
    Hp, u1 = pn["hidden_size"], u_labels + 1
    pg = {**GATES, "stateless": 0}[pn["rnn_type"].lower()]
    fwd = pn["num_layers"] * 2 * batch * u1 * pg * Hp * (Hp + Hp) if pg else 0.0
    fwd += 2 * batch * u1 * Hp * pn["output_size"]
    fwd += 2 * batch * t_enc * tn["output_size"] * jn["num_classes"]
    fwd += 2 * batch * u1 * pn["output_size"] * jn["num_classes"]
    return fwd


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
    return 3.0 * (fwd + _prednet_joint_fwd(model, batch, t_frames, u_labels))


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
    return 3.0 * (fwd + _prednet_joint_fwd(model, batch, tp, u_labels))


def train_step_flops(model: Mapping, frames: Sequence[int], labels: Sequence[int]) -> float:
    """A step's model FLOPs, each row at its own frame and label counts."""
    if model["transnet"].get("arch", "rnn") == "conformer":
        return sum(conformer_step_flops(model, 1, int(t), u) for t, u in zip(frames, labels))
    return sum(rnn_step_flops(model, 1, t, u) for t, u in zip(frames, labels))


# ---------------------------------------------------------------- kernels
def gru_bound_ms(T: int, B: int, H: int, dtype: str, lengths: Sequence[int]):
    """K1, one forward scan: xw read at valid steps, W_hh, b_hh, h0 and the
    lengths once, outputs and the final state written once; the recurrent
    product at valid steps."""
    e = ELEMENT_BYTES[dtype]
    valid = int(sum(lengths))
    nbytes = (valid * 3 * H * e + 3 * H * H * e + 3 * H * e + B * H * e + B * 4
              + T * B * H * e + B * H * e)
    return _bound(2.0 * valid * H * 3 * H, nbytes, dtype)


def gru_bwd_bound_ms(T: int, B: int, H: int, dtype: str, lengths: Sequence[int]):
    """K2, one backward scan (gates GEMM + chain): xw, h_prev and g_out read
    at valid steps, W_hh once; dxw, dnr and dh0 written once; the gate
    recompute and the dh-chain products at valid steps."""
    e = ELEMENT_BYTES[dtype]
    valid = int(sum(lengths))
    nbytes = (valid * 5 * H * e + 3 * H * H * e + 3 * H * e + B * H * e + B * 4
              + T * B * 4 * H * e + B * H * e)
    return _bound(2.0 * (2.0 * valid * H * 3 * H), nbytes, dtype)


def lstm_bound_ms(T: int, B: int, H: int, dtype: str, lengths: Sequence[int],
                  backward: bool):
    """K3 (forward) / K4 (backward), one LSTM scan."""
    e = ELEMENT_BYTES[dtype]
    valid = int(sum(lengths))
    weights = 4 * H * H * e + 4 * H * e + B * 4
    if backward:
        nbytes = (valid * 7 * H * e + weights + 2 * B * H * e
                  + T * B * 4 * H * e + 2 * B * H * e)
        flops = 2.0 * (2.0 * valid * H * 4 * H)
    else:
        nbytes = (valid * 4 * H * e + weights + 2 * B * H * e + 2 * T * B * H * e
                  + 2 * B * H * e)
        flops = 2.0 * valid * H * 4 * H
    return _bound(flops, nbytes, dtype)


def sweep_bound_ms(N: int, T: int, U1: int):
    """K5, one lattice sweep: be, le read and alpha written once (fp32),
    about 10 fp32 operations a lattice point."""
    return _bound(10.0 * N * T * U1, 3 * N * T * U1 * 4, "fp32")


def logmel_bound_ms(rows: int, n_fft: int, n_bins: int, n_mels: int, high: bool):
    """K6, one launch: frames read, DFT and filterbank matrices read once,
    features written once; the DFT and mel products at the bf16 peak."""
    nbytes = (rows * n_fft * 4 + (4 if high else 2) * n_fft * n_bins * 2
              + n_bins * n_mels * 2 + rows * n_mels * 4)
    flops = (2.0 * rows * n_fft * 2 * n_bins * (3 if high else 1)
             + 2.0 * rows * n_bins * n_mels)
    return _bound(flops, nbytes, "bf16")


def decode_flops(model: Mapping, frames: float, tokens: float, keys: int = 0) -> float:
    """Forward model FLOPs of decoding ``frames`` input frames that emitted
    ``tokens`` labels: the encoder over the frames (a streaming Conformer's
    query attends ``keys`` keys: its chunk and the left chunks), the joint's
    encoder side per encoder frame, and per label the prediction network
    and the joint's prediction side."""
    tn, pn, jn = model["transnet"], model["prednet"], model["jointnet"]
    V, De = jn["num_classes"], tn["output_size"]
    if tn.get("arch", "rnn") == "conformer":
        d, ff, s = tn["hidden_size"], tn["ff_multiplier"], tn.get("time_reduction_stride", 1)
        tp = frames / s
        per = (2 * (2 * 2 * d * ff * d) + 4 * 2 * d * d + 2 * 2 * keys * d
               + 2 * d * 2 * d + 2 * d * d)
        enc = tp * (2 * tn["input_size"] * s * d + tn["num_layers"] * per + 2 * d * De)
    else:
        H, dirs = tn["hidden_size"], 2 if tn["bidirectional"] else 1
        g = GATES[tn["rnn_type"].lower()]
        tp, enc, in_size = frames, 0.0, tn["input_size"]
        for _ in range(tn["num_layers"]):
            enc += dirs * 2 * frames * g * H * (in_size + H)
            in_size = dirs * H
        enc += 2 * frames * in_size * De
    Hp = pn["hidden_size"]
    pred = (pn["num_layers"] * 2 * GATES[pn["rnn_type"].lower()] * Hp * (Hp + Hp)
            + 2 * Hp * pn["output_size"] + 2 * pn["output_size"] * V)
    return enc + tp * 2 * De * V + tokens * pred
