"""Cell lookup, the process's environment, spans, and the result line.

Everything that belongs to one configuration, traffic mix, driver kind or
per-layer metric lives in a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names): the sizes
  as run (``run``, the port's configuration schema), the source, the
  published and assumed values;
* the model's parts by the names its ``run.model`` gives them
  (``reference/parts.py``): ``reference/{encoders,prednets,joints}/<name>.py``
  and their FLOPs in ``roofline/{encoders,prednets,joints}/<name>.py``;
* ``traffic/<traffic>.json``: the mix's parameters and the ``driver`` that
  plays it;
* ``drivers/<driver>.py``: ``run(cell) -> Outcome``;
* ``metrics/<metric>.py``: ``read(ctx) -> float | None``;
* ``limits/<workload>.json``: the limits of the numbers ``correct`` compares.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: build and kernel caches of the program and of torch, at fixed paths in the checkout
CACHE_DIR = ROOT / "build" / "bench_cache"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rnntransducer_tpu")


def set_environment() -> None:
    """Caches under the checkout at fixed paths; keep libraries off JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE_DIR / "nv")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE_DIR / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def deep_update(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = deep_update(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else copy.deepcopy(v)
    return out


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    limits, as files found by name."""
    name: str
    bench: dict
    workload: dict
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    rehearsal: bool = False
    options: dict = field(default_factory=dict)   # calibration / fault switches

    @property
    def run_cfg(self) -> dict:
        return self.config["run"]

    def metrics_of(self, section: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(workload: str, seed: int, seconds: float, trace: bool,
              rehearsal: bool = False, device: str = "cuda",
              bench_path: Optional[Path] = None) -> Cell:
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    if rehearsal:
        config = deep_update(config, config.get("rehearsal", {}))
        traffic = deep_update(traffic, traffic.get("rehearsal", {}))
        limits = deep_update(limits, limits.get("rehearsal", {}))
    check_parts(workload, config["run"]["model"])
    return Cell(workload, bench, wl, config, traffic, limits, seed, seconds, trace,
                device, rehearsal)


def check_parts(workload: str, model: dict) -> None:
    """Every part of ``model`` has its reference and FLOP modules; else exit
    naming the file to add."""
    from benchmark.reference import parts
    from benchmark.roofline import counts
    try:
        parts.of(model)
        counts.check(model)
    except parts.MissingPart as e:
        raise SystemExit(f"{workload}: {e}") from None


def with_deferred(bench: dict) -> dict:
    """``bench`` with the cells of ``deferred.json`` (built, not admitted)
    added: what the benchmark's own tests rehearse."""
    extra = load_json(BENCH_DIR / "deferred.json")
    out = dict(bench)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in bench[key]}
        out[key] = bench[key] + [e for e in extra[key] if e["name"] not in have]
    return out


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_reader(metric: str):
    """``metrics/<metric>.py``'s module (a metric name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> List[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


# ------------------------------------------------------------------ spans
class Spans:
    """Host-clock spans by name (seconds).  While tracing, each span is also
    a ``record_function`` range named ``bench/<name>`` in the profile, which
    the trace reduction reads to say what the host did in the device's idle
    gaps."""

    def __init__(self, tracing: bool = False):
        self.tracing = tracing
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.tracing:
            import torch
            rf = torch.profiler.record_function(f"bench/{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class Outcome:
    """What a driver measured: end-to-end values by metric name, the
    requests attempted and failed, the comparisons that decide ``correct``
    (name, value, limit, where a value above the limit fails), the context
    the per-layer readers read, and the device's peak memory."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]
    ctx: dict
    memory_peak_bytes: int
    setup_s: float


def card_info(device: str) -> Dict[str, Any]:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def log(msg: str) -> None:
    """A progress line on standard error, with the process's age."""
    print(f"[bench {process_age_s():8.2f}s] {msg}", file=sys.stderr, flush=True)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def emit(result: dict, checks: List[Tuple[str, float, float]]) -> None:
    """The checks on standard error as its last lines, then the result line
    on standard output with the checks under ``checks``, its last key."""
    checks = [(n, v if finite(v) else 1e308, lim) for n, v, lim in checks]
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(result), flush=True)
