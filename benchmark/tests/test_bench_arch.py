"""The reference's parts, found by name, reproduce the readings the
benchmark's configurations gave before the parts were split out, bit for
bit: the parameter list, the weights drawn from a seed, three reference
training steps (losses, first-gradient and change norms of every leaf) and
the step FLOPs, at the rehearsal sizes on the CPU.

The pins (``arch_pins.json``) were written by ``python3
benchmark/tests/test_bench_arch.py`` on the tree before the split, with one
CPU thread; they hold on the CPU build they were written with.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.common import BENCH_DIR, deep_update, load_json  # noqa: E402

PINS = Path(__file__).with_name("arch_pins.json")
CONFIGS = ("gru_flagship", "conformer_l_stream")
SEED = 2 ** 31 + 23
#: (frames, labels) of each row of the batches whose step FLOPs are pinned
FLOP_BATCHES = (([51, 41], [6, 4]), ([64, 33, 17], [8, 5, 1]),
                ([2048, 1311, 256], [211, 140, 9]))


def _config(name, rehearsal=True):
    c = load_json(BENCH_DIR / "configs" / f"{name}.json")
    return deep_update(c, c["rehearsal"]) if rehearsal else c


def _masks(run, rows, gen):
    """Dropout and SpecAugment keep masks of one step in the layout the
    program's read-back gives, drawn from ``gen``: SpecAugment one band and
    one span inside every row, dropout at the configuration's rate on the
    input of every recurrent layer after the first."""
    model, audio = run["model"], run["data"]["audio"]
    T, B = 64, len(rows)
    U1 = max(len(r["labels"]) for r in rows) + 2
    out = {"dropout": [], "spec": []}
    if audio.get("spec_augment", False):
        keep = torch.ones((B, T, audio["n_mels"]), dtype=torch.bool)
        keep[:, :, 3:10] = False
        keep[:, 5:20, :] = False
        out["spec"].append(keep)
    tn, pn = model["transnet"], model["prednet"]
    width = (2 if tn.get("bidirectional") else 1) * tn["hidden_size"]
    for rate, n, shape in ((tn.get("dropout", 0.0), tn["num_layers"] - 1, (B, T, width)),
                           (pn.get("dropout", 0.0), pn["num_layers"] - 1,
                            (B, U1, pn["hidden_size"]))):
        for _ in range(n if rate > 0 else 0):
            out["dropout"].append(torch.rand(shape, generator=gen) >= rate)
    return out if out["dropout"] or out["spec"] else None


def _digest(params):
    h = hashlib.sha256()
    for name, t in params.items():
        h.update(name.encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def readings(name):
    """Everything pinned of configuration ``name``."""
    from benchmark.reference.model import param_specs, seeded_params
    from benchmark.reference.train import reference_steps
    from benchmark.roofline.counts import train_step_flops
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _config(name)
        run, w = cfg["run"], cfg["weights"]
        specs = param_specs(run["model"])
        params = seeded_params(specs, torch.Generator().manual_seed(SEED), "cpu",
                               blank_bias=w["blank_bias"], suppressed=w["suppressed"],
                               suppress_bias=w["suppress_bias"],
                               encoder_gain=w["encoder_gain"], joint_scale=w["joint_scale"])
        rng = np.random.RandomState(SEED % 2 ** 32)
        gen = torch.Generator().manual_seed(SEED + 1)
        batches, masks = [], []
        for _ in range(3):
            rows = [{"wav": (rng.randn(n) * 0.2).astype(np.float32),
                     "labels": rng.randint(4, 40, u)} for n, u in ((8000, 6), (6500, 4))]
            batches.append(rows)
            masks.append(_masks(run, rows, gen))
        ref = reference_steps(run, params, batches, "cpu",
                              masks=masks if any(m is not None for m in masks) else None)
        flops = {}
        for label, model in (("rehearsal", run["model"]),
                             ("full", _config(name, False)["run"]["model"])):
            flops[label] = [train_step_flops(model, f, u) for f, u in FLOP_BATCHES]
        return {"param_specs": [[n, list(s), k, f] for n, s, k, f in specs],
                "seeded_params_sha256": _digest(params),
                "losses": ref["losses"], "grad1": ref["grad1"], "change": ref["change"],
                "train_step_flops": flops}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pins():
    return load_json(PINS)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_parts_reproduce_the_pinned_readings(pins, name):
    got = json.loads(json.dumps(readings(name)))
    want = pins[name]
    assert got["param_specs"] == want["param_specs"]
    assert got["seeded_params_sha256"] == want["seeded_params_sha256"]
    assert got["train_step_flops"] == want["train_step_flops"]
    assert got["losses"] == want["losses"]
    assert got["grad1"] == want["grad1"]
    assert got["change"] == want["change"]


if __name__ == "__main__":
    PINS.write_text(json.dumps({n: readings(n) for n in CONFIGS}, indent=1) + "\n")
    print(f"wrote {PINS}")
