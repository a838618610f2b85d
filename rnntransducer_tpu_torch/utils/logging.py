"""Metrics logging to stderr and JSONL files (port of
``rnntransducer_tpu/utils/logging.py``).

Every record lands in ``<log_dir>/metrics.jsonl`` as one JSON object per
line, for any dashboard to tail, and on stderr; parameter and gradient
histograms from ``train.state.watch_step`` go to ``histograms.jsonl``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "metrics",
                 stdout: bool = True):
        self.stdout = stdout
        self._fh = None
        self._hist_fh = None
        self._log_dir = log_dir
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)
            self._fh = open(os.path.join(self._log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("time",))
            print(f"[{rec['time']:9.1f}s] {parts}", file=sys.stderr)

    def log_histograms(self, step: int, hists: dict):
        """Parameter and gradient histograms (``{"params": {name: (counts,
        edges)}, "grads": {...}}``), one JSON line per call in
        ``histograms.jsonl``, kept out of metrics.jsonl (a record is
        tensors x bins long)."""
        rec = {"step": int(step)}
        for group, tensors in hists.items():
            rec[group] = {
                name: {"counts": [int(c) for c in counts],
                       "edges": [float(e) for e in edges]}
                for name, (counts, edges) in tensors.items()}
        if self._hist_fh is None and self._log_dir:
            self._hist_fh = open(os.path.join(self._log_dir, "histograms.jsonl"), "a")
        if self._hist_fh:
            self._hist_fh.write(json.dumps(rec) + "\n")
            self._hist_fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
        if self._hist_fh:
            self._hist_fh.close()
