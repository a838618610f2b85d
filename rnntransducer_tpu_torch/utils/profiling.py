"""Tracing (port of ``rnntransducer_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` over the enclosed block, CPU and
  CUDA activities, written to ``logdir`` as a Chrome / Perfetto trace, with
  the totals of the spans recorded inside it beside it;
* ``annotate(name, device)``: a named span at a layer boundary.  It records
  only while a ``torch.profiler`` records on the calling thread; otherwise
  it is one flag check and a shared no-op context.  While recording it is a
  ``record_function`` range of that name in the profiler's trace, and it
  keeps in memory its name, its parent (the innermost open span of the same
  thread), its step (the number of the outermost span it lies in, which the
  spans of one train step share), its host start and end, and on a CUDA
  ``device`` a pair of timing events on the current stream, resolved only
  when read (so a profiled window gains no sync).  Elsewhere the work is
  synchronous and the device time is the host duration.  With
  ``within=<name>`` it records only inside an open span of that name (the
  model parts' spans of ``loss_fn`` count in ``train_step`` alone);
* ``count(name, n)``: a counter at the same boundaries, under the same gate;
* ``spans()`` / ``recorded()``: each finished span, and the totals by name
  (``count``, ``host_s``, ``device_s``, ``self_device_s``: the duration less
  the part of it its children cover); ``reset()`` clears the record.

A span or count met while no profiler records marks the record stale; the
first one recorded after that starts the record afresh, so each profiled
window holds its own spans only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class _Record:
    """The spans and counts of the current profiled window."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: List["_Span"] = []
        self.counts: Dict[str, int] = defaultdict(int)
        self.roots = 0
        self.stale = False
        self.pool: List[torch.cuda.Event] = []  # free timing events

    def fresh(self) -> None:
        """Start afresh where a span or count went unrecorded since the last."""
        if self.stale:
            self.stale = False
            self.clear()

    def clear(self) -> None:
        with self.lock:
            for s in self.spans:
                if s.events is not None and s.t1 is not None:  # an open span keeps its own
                    self.pool.extend(s.events)
            self.spans, self.counts, self.roots = [], defaultdict(int), 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def events(self) -> tuple:
        with self.lock:
            if len(self.pool) >= 2:
                return self.pool.pop(), self.pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))


_RECORD = _Record()


class _Span:
    __slots__ = ("name", "cuda", "parent", "step", "t0", "t1", "events", "interval",
                 "_range")

    def __init__(self, name: str, cuda: bool):
        self.name, self.cuda = name, cuda
        self.t1 = self.events = self.interval = None

    def __enter__(self):
        rec = _RECORD
        stack = rec.stack()
        self.parent = stack[-1] if stack else None
        with rec.lock:
            if self.parent is None:
                rec.roots += 1
            self.step = rec.roots if self.parent is None else self.parent.step
            rec.spans.append(self)
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.cuda:
            self.events = rec.events()
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.cuda:
            self.events[1].record()
        self._range.__exit__(*exc)
        _RECORD.stack().pop()
        return False


def annotate(name: str, device: Optional[torch.device] = None,
             within: Optional[str] = None):
    """A span named ``name`` over the enclosed block (see the module's
    notes); ``device``: where the block's work runs (a CUDA device is timed
    by events on its current stream); ``within``: record only while the
    innermost open span of this thread has that name (code with several
    callers is a span of one of them alone)."""
    if not _enabled():
        _RECORD.stale = True
        return _OFF
    if within is not None:
        stack = _RECORD.stack()
        if not stack or stack[-1].name != within:
            return _OFF
    _RECORD.fresh()
    return _Span(name, device is not None and device.type == "cuda")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if not _enabled():
        _RECORD.stale = True
        return
    rec = _RECORD
    rec.fresh()
    with rec.lock:
        rec.counts[name] += n


def _resolve(spans: List[_Span]) -> None:
    """Each span's (start, end) in ns: CUDA-timed spans from the first CUDA
    event of the record, host-timed ones on the host clock."""
    origin = None
    for s in spans:
        if s.interval is not None:
            continue
        if s.events is None:
            s.interval = (s.t0, s.t1)
            continue
        if origin is None:
            origin = next(x.events[0] for x in _RECORD.spans if x.events is not None)
            origin.synchronize()
        s.events[1].synchronize()
        s.interval = (origin.elapsed_time(s.events[0]) * 1e6,
                      origin.elapsed_time(s.events[1]) * 1e6)


def _covered(lo: float, hi: float, intervals) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def spans() -> List[dict]:
    """Every finished span of the record, in the order they were entered:
    name, parent (its name, or None), step, host_s, device_s, self_device_s
    (the children timed on the span's own clock are what it subtracts)."""
    with _RECORD.lock:
        done = [s for s in _RECORD.spans if s.t1 is not None]
    _resolve(done)
    kids = defaultdict(list)
    for s in done:
        if s.parent is not None:
            kids[id(s.parent)].append(s)
    out = []
    for s in done:
        lo, hi = s.interval
        inner = [c.interval for c in kids[id(s)] if (c.events is None) == (s.events is None)]
        out.append({"name": s.name, "parent": None if s.parent is None else s.parent.name,
                    "step": s.step, "host_s": (s.t1 - s.t0) * 1e-9,
                    "device_s": (hi - lo) * 1e-9,
                    "self_device_s": (hi - lo - _covered(lo, hi, inner)) * 1e-9})
    return out


def recorded() -> Dict[str, dict]:
    """Totals by name: ``{count, host_s, device_s, self_device_s}`` of each
    span, ``{count}`` of each counter."""
    out: Dict[str, dict] = {}
    for s in spans():
        t = out.setdefault(s["name"], {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                       "self_device_s": 0.0})
        t["count"] += 1
        for k in ("host_s", "device_s", "self_device_s"):
            t[k] += s[k]
    with _RECORD.lock:
        out.update({name: {"count": n} for name, n in _RECORD.counts.items()})
    return out


def reset() -> None:
    """Clear the record."""
    _RECORD.stale = False
    _RECORD.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block: ``with trace('/tmp/trace'): run_steps()``.
    Yields the profiler.  On exit its Chrome trace is written to ``logdir``
    as ``trace_<pid>_<ms>.json`` (view it at ui.perfetto.dev) and the
    totals of the spans recorded in it (:func:`recorded`) beside it as
    ``spans_<pid>_<ms>.json``."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        tag = f"{os.getpid()}_{int(time.time() * 1e3)}"
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{tag}.json"))
        with open(os.path.join(logdir, f"spans_{tag}.json"), "w") as f:
            json.dump(recorded(), f, indent=1, sort_keys=True)
