"""Each cell's driver end to end on the CPU at its rehearsal sizes: a
well-formed last line, correct on a sound run, not correct with a fault
planted under the timed path; and the measured command refusing to run
without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.common import ROOT, load_json, with_deferred

ADMITTED = load_json(ROOT / "BENCHMARK.json")
BENCH = with_deferred(ADMITTED)
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS = {"train": ["half_batch", "unchanged"], "stream": ["token"], "infer": ["token"]}


def _driver(cell):
    from benchmark.harness.common import BENCH_DIR
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    return load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")["driver"]


@pytest.fixture(scope="module")
def bench_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(BENCH))
    return path


def _rehearse(capsys, bench_path, cell, seed, trace=False, fault=None):
    from benchmark import run
    code = run.rehearse(cell, seed, 1.5, trace, {"fault": fault} if fault else None,
                        bench_path=bench_path)
    out = capsys.readouterr()
    assert code == 0, out.err[-3000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    checks = [ln for ln in out.err.strip().splitlines() if ln.startswith("check ")]
    assert checks and out.err.strip().splitlines()[-len(checks):] == checks
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_well_formed(capsys, bench_path, cell):
    line = _rehearse(capsys, bench_path, cell, 2 ** 31 + 11)
    assert line["correct"], line
    names = {m["name"] for m in BENCH["end_to_end"]
             if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == names
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(capsys, bench_path, cell):
    line = _rehearse(capsys, bench_path, cell, 5, trace=True)
    per_layer = {m["name"] for m in BENCH["per_layer"]
                 if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) <= per_layer
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[_driver(c)]])
def test_a_planted_fault_makes_correct_false(capsys, bench_path, cell, fault):
    assert not _rehearse(capsys, bench_path, cell, 3, fault=fault)["correct"]


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          ADMITTED["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          ADMITTED["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
