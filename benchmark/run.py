"""The benchmark of ``rnntransducer_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Looks the cell up in ``BENCHMARK.json``, plays its traffic through its
driver (``drivers/<driver>.py``, named by the traffic file) on the card,
checks what the timed path produced against the plain reference, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones, each read by ``metrics/<name>.py``), ``device``,
``breakdown`` (traced runs) and ``checks`` (each number compared, with its
limit).  Without a CUDA card, or with fewer cards than the cell asks for,
it exits 2 and prints no result.

``--calibrate SEEDS`` (not part of a measured run) prints, instead of a
result, the readings the cell's limits are set from.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import common  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=_seeds, default=None,
                   help="comma-separated seeds: print the limits' readings instead")
    p.add_argument("--control_seeds", type=_seeds, default=[])
    p.add_argument("--fault_seeds", type=_seeds, default=[])
    p.add_argument("--sweep", type=_seeds, default=None,
                   help="with --calibrate on a streaming cell: the stream counts of the knee sweep")
    return p.parse_args(argv)


def result_line(cell, out: "common.Outcome", setup_s: float) -> dict:
    """The result line from a driver's outcome."""
    section = "per_layer" if cell.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics_of(section):
        if m["name"] == "setup_s":
            value = setup_s
        elif section == "end_to_end":
            value = out.end_to_end.get(m["name"])
        else:
            value = common.load_reader(m["name"]).read(out.ctx)
        if value is not None and common.finite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(common.card_info(cell.device), count=cell.workload["chips"],
                  memory_peak_bytes=out.memory_peak_bytes)
    line = {"correct": all(common.finite(v) and v <= lim for _, v, lim in out.checks),
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device}
    summary = out.ctx.get("trace")
    if cell.trace and summary:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = summary["breakdown"]
    return line


def run_cell(cell) -> int:
    """Drive ``cell`` and print its result; the exit code."""
    driver = common.load_driver(cell.traffic["driver"])
    out = driver.run(cell)
    found = common.forbidden_loaded()
    if found:
        print(f"refusing to report: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(cell, out, out.setup_s)
    print(f"card: {common.power_limit() or cell.device}", file=sys.stderr, flush=True)
    common.emit(line, out.checks)
    return 0


def rehearse(workload: str, seed: int, seconds: float, trace: bool = False,
             options: dict = None, bench_path=None) -> int:
    """The CPU rehearsal the benchmark's own tests run: the cell's driver end
    to end at the tiny sizes of its configuration's and traffic's
    ``rehearsal`` sections, with the kernels' plain versions.  A measured run
    never takes this path."""
    common.set_environment()
    cell = common.load_cell(workload, seed, seconds, trace, rehearsal=True, device="cpu",
                            bench_path=bench_path)
    cell.options.update(options or {})
    return run_cell(cell)


def main(argv=None) -> int:
    args = parse(argv)
    common.set_environment()
    import torch
    cell = common.load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.calibrate is not None:
        if args.sweep:
            cell.options["sweep"] = args.sweep
        driver = common.load_driver(cell.traffic["driver"])
        driver.calibrate(cell, args.calibrate, args.control_seeds, args.fault_seeds,
                         sys.stdout)
        return 0
    return run_cell(cell)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
