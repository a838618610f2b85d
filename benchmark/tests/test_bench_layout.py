"""BENCHMARK.json against its schema, every name resolving to
its own file, and no module of the benchmark loading JAX or the JAX
package (top-level names compared whole: rnntransducer_tpu_torch begins
with rnntransducer_tpu)."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.common import BENCH_DIR, ROOT, load_cell, load_json, with_deferred

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "rnntransducer_tpu")


def _sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), m) for p in _sources() for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_port():
    ref = [p for p in _sources() if "reference" in p.parts]
    assert ref
    bad = [(str(p.relative_to(ROOT)), m) for p in ref for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN + ("rnntransducer_tpu_torch",)
           or (m.startswith("benchmark.") and not m.startswith("benchmark.reference"))]
    assert not bad, bad


def test_what_the_harness_loads_holds_neither_jax_nor_the_jax_package():
    """Every module of the benchmark and the port modules its drivers use,
    imported in a fresh process: sys.modules then holds no forbidden
    top-level name."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in _sources()
            if p.parent.name != "metrics" and p.parent.name != "tests"]
    code = ("import sys\nsys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in mods)
            + "import rnntransducer_tpu_torch.train.state, rnntransducer_tpu_torch.serve\n"
            + "import rnntransducer_tpu_torch.decode.session_batch\n"
            + "from benchmark.harness.common import forbidden_loaded, load_reader\n"
            + "import pathlib\n"
            + "[load_reader(p.stem) for p in pathlib.Path(%r).glob('*.py')]\n"
              % str(BENCH_DIR / "metrics")
            + "print(forbidden_loaded())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_json_has_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_finds_its_own_file(tmp_path):
    bench = with_deferred(BENCH)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    for w in bench["workloads"]:
        cell = load_cell(w["name"], 1, 1.0, False, bench_path=path)
        assert (BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert cell.limits["checks"]
    for m in bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A cell over an existing configuration and traffic: a BENCHMARK.json
    entry and a limits file, no edit to any file already there."""
    w = dict(BENCH["workloads"][0], name="train.gru_flagship.kspon_copy")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [w])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    limits = BENCH_DIR / "limits" / f"{w['name']}.json"
    limits.write_text((BENCH_DIR / "limits" / f"{BENCH['workloads'][0]['name']}.json")
                      .read_text())
    try:
        cell = load_cell(w["name"], 5, 1.0, False, bench_path=path)
        assert cell.config["name"] == w["config"]
    finally:
        limits.unlink()
