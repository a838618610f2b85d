"""Model FLOPs and kernel bounds from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit: 989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores, 3.35
TB/s of HBM3.

The step FLOPs count 2 m n k per forward product and three forward passes a
training step (forward, and the backward's two products), each part's in a
module of its own (``encoders/``, ``prednets/``, ``joints/``, found by the
configuration's names as the reference's parts are); the kernel bounds
are the larger of operations over the peak rate and bytes over HBM
bandwidth, each input read once and each output written once.  They are
copies of the arithmetic the repository's chip smoke test has
(``step_model_flops``, ``conformer_step_flops``, ``gru_bound_ms``,
``gru_bwd_bound_ms``, ``lstm_bound_ms``, ``sweep_bound_ms``,
``logmel_bound_ms``), kept here so the yardstick does not move with that
script; the per-row forms count each row at its own length.
"""

from __future__ import annotations

from pathlib import Path
from types import ModuleType
from typing import Mapping, Optional, Sequence, Tuple

from benchmark.reference import parts

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": PEAK_BF16_FLOPS, "fp32": PEAK_FP32_FLOPS}
ELEMENT_BYTES = {"bf16": 2, "fp32": 4}
HERE = Path(__file__).resolve().parent


def _bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- step FLOPs
def part(model: Mapping, which: str) -> ModuleType:
    """The FLOP module of ``model``'s encoder, prediction network or joint,
    found by the name the reference's part is found by
    (``reference.parts``): ``encoders/<arch>.py`` (``step_flops(model,
    batch, t_frames, u_labels)``, the whole training step's, and
    ``decode_encoder(tn, frames, keys) -> (FLOPs, output frames)``),
    ``prednets/<kind>.py`` (``train_fwd(pn, batch, u1)``,
    ``step_flops(pn)``), ``joints/<combine>.py`` (``train_fwd(model,
    batch, t_enc, u1)``, ``frame_flops(model, t_enc)``,
    ``label_flops(model)``)."""
    section, key, _, directory = parts.PARTS[which]
    return parts.find_module(f"benchmark.roofline.{directory}", HERE / directory,
                             f"{section}.{key}", parts.name_of(model, which))


def check(model: Mapping) -> None:
    """``MissingPart`` where a part of ``model`` has no FLOP module."""
    for which in parts.PARTS:
        part(model, which)


def prednet_joint_fwd(model: Mapping, batch: int, t_enc: float, u_labels: float) -> float:
    """Forward FLOPs of the prediction network and the joint of a training
    step over ``t_enc`` encoder frames and ``u_labels`` labels a row."""
    u1 = u_labels + 1
    fwd = part(model, "prednet").train_fwd(model["prednet"], batch, u1)
    return fwd + part(model, "joint").train_fwd(model, batch, t_enc, u1)


def train_step_flops(model: Mapping, frames: Sequence[int], labels: Sequence[int]) -> float:
    """A step's model FLOPs, each row at its own frame and label counts."""
    enc = part(model, "encoder")
    return sum(enc.step_flops(model, 1, int(t), u) for t, u in zip(frames, labels))


def gru_scans(model: Mapping) -> Optional[int]:
    """The GRU scans (K1 / K2) a pass of ``model``'s encoder runs, where its
    FLOP module counts them; None where it runs none."""
    scans = getattr(part(model, "encoder"), "gru_scans", None)
    return scans(model["transnet"]) if scans else None


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
    enc, tp = part(model, "encoder").decode_encoder(model["transnet"], frames, keys)
    joint = part(model, "joint")
    pred = part(model, "prednet").step_flops(model["prednet"]) + joint.label_flops(model)
    return enc + joint.frame_flops(model, tp) + tokens * pred
