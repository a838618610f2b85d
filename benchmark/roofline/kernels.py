"""Kernel roofline shares from a traced window: the bounds of every launch
the window's work made, from its shapes and real lengths, over the kernels'
time by name in the trace."""

from __future__ import annotations

from typing import Optional

from benchmark.harness.trace import kernel_seconds, owned_gemm_seconds
from benchmark.roofline.counts import gru_bound_ms, gru_bwd_bound_ms, gru_scans


def gru_roofline(ctx: dict, kind: str, backward: bool) -> Optional[float]:
    """K1 (``backward=False``) or K2 of the GRU encoder in a ``kind`` window
    ("train" or "infer"), in %; None where the window ran no GRU scan."""
    trace = ctx.get("trace")
    if ctx.get("kind") != kind or not trace or "model" not in ctx:
        return None
    scans = gru_scans(ctx["model"])
    if not scans:
        return None
    tn = ctx["model"]["transnet"]
    bound = gru_bwd_bound_ms if backward else gru_bound_ms
    dtype = ctx["precision"]
    least_ms = sum(scans * bound(s["T"], len(s["frames"]), tn["hidden_size"], dtype,
                                 s["frames"])[0] for s in ctx["steps"])
    name = "gru_bwd" if backward else "gru_fwd"
    _, seconds = kernel_seconds(trace, name)
    if backward:
        seconds += owned_gemm_seconds(trace, name)
    if seconds <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms * 1e-3 / seconds
