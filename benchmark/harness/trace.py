"""The traced window: ``torch.profiler`` over the measured window, reduced
to what the per-layer readers and the breakdown need.

* busy seconds: the union of the intervals of every device activity
  (kernels, copies, sets; not the device-side mirrors of host ranges), so
  overlapping work on two streams counts once;
* kernel launches and kernel seconds by name;
* the gates GEMM launches attributed to the backward scan that follows them
  on their stream (the GRU and LSTM backward kernels share that GEMM);
* idle gaps between device activity, by the innermost harness span
  (``bench/<name>``) the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` of the host and the card while ``enabled``;
    yields the profiler or None."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        yield prof


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarize(prof, window_s: float) -> dict:
    """The reduction of a finished profile (see the module's notes)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    # a host range (record_function) is mirrored on the device's timeline
    # under its own name: those are annotations, not device work
    host_names = {e.name() for e in events if e.device_type() != cuda}
    dev, host_spans = [], []
    for e in events:
        if e.device_type() == cuda and e.name() not in host_names:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        e.device_resource_id()))
        elif e.device_type() != cuda and e.name().startswith("bench/"):
            host_spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()[len("bench/"):]))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    launches = 0
    for s, e, name, _ in dev:
        if "Memcpy" in name or "Memset" in name:
            continue
        launches += 1
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-9
    merged = _union([(s, e) for s, e, *_ in dev])
    busy_s = sum(e - s for s, e in merged) * 1e-9
    # the gates GEMM's launches, by the kernel that follows each on its stream
    gemm_owner: Dict[str, float] = defaultdict(float)
    by_stream: Dict[int, list] = defaultdict(list)
    for ev in dev:
        by_stream[ev[3]].append(ev)
    for evs in by_stream.values():
        evs.sort()
        for i, (s, e, name, _) in enumerate(evs):
            if "gates_gemm" in name and i + 1 < len(evs):
                gemm_owner[evs[i + 1][2]] += (e - s) * 1e-9
    # idle gaps by host span
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    host_spans.sort()
    starts = [s for s, _, _ in host_spans]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "outside harness spans"
        best = None
        j = bisect.bisect_right(starts, mid)
        for s, e, name in host_spans[max(0, j - 64):j]:
            if s <= mid <= e and (best is None or s >= best):
                best, label = s, name
        idle[label] += (g1 - g0) * 1e-9
    top_ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda x: -x[1])[:10]
    top_idle = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "launches": launches,
            "kernels": {n: (int(v[0]), float(v[1])) for n, v in kernels.items()},
            "gemm_owner": dict(gemm_owner),
            "breakdown": {"device_ops": [[n, float(s)] for n, s in top_ops],
                          "idle_gaps": [[n, float(s)] for n, s in top_idle]}}


def kernel_seconds(summary: dict, *parts: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose names hold any of ``parts``."""
    n, s = 0, 0.0
    for name, (count, sec) in summary["kernels"].items():
        if any(p in name for p in parts):
            n += count
            s += sec
    return n, s


def owned_gemm_seconds(summary: dict, *parts: str) -> float:
    return sum(s for name, s in summary["gemm_owner"].items()
               if any(p in name for p in parts))


def idle_pct(summary: Optional[dict]) -> Optional[float]:
    if not summary or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - summary["busy_s"] / summary["window_s"])
