"""The controls on the card: each cell's reference computed in fp8 (the
precision below the configurations' bf16) put in the program's place must
come out not correct, while the program on the same seed comes out
correct; and a training step that leaves out half its batch must fail.
These run the cells' calibration at full size on one seed each (a few
minutes on an H100); they skip without a card.

    python3 -m pytest benchmark/tests/test_bench_controls.py -m cuda
"""

import io
import json

import pytest

from benchmark.harness.common import ROOT, load_cell, load_json, with_deferred

BENCH = with_deferred(load_json(ROOT / "BENCHMARK.json"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _calibrate(name, seed, tmp_path):
    from benchmark.harness.common import load_driver, set_environment
    set_environment()
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(BENCH))
    cell = load_cell(name, seed, 30.0, False, bench_path=path)
    out = io.StringIO()
    load_driver(cell.traffic["driver"]).calibrate(cell, [seed], [seed], [seed], out)
    return cell, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["name"].startswith("train.")])
def test_training_control_and_half_batch_fail(card, tmp_path, name):
    cell, line = _calibrate(name, 2 ** 31 + 3, tmp_path)
    limits = cell.limits["checks"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    for what in ("control_fp8", "half_batch"):
        assert any(line[what][k] > v for k, v in limits.items()), (what, line)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if not w["name"].startswith("train.")])
def test_serving_control_fails(card, tmp_path, name):
    cell, line = _calibrate(name, 2 ** 31 + 5, tmp_path)
    limit = cell.limits["checks"]["served_gap"]
    assert line["readings"]["gap"] <= limit < line["readings"]["control"], line
