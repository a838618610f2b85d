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


TOY_ENCODER = '''"""A toy encoder: one linear layer, one dropout site after it."""
from benchmark.reference.augment import dropout
from benchmark.reference.layers import lin, linear_specs


def param_specs(tn):
    return linear_specs("encoder.proj", tn["input_size"], tn["output_size"])


def takes_gain(name):
    return name.endswith(".weight")


def dropout_sites(tn):
    return [tn["dropout"]] if tn.get("dropout", 0.0) > 0 else []


def encode(P, tn, feats, lengths, precision, remat, keeps):
    x = lin(feats, P, "encoder.proj", precision)
    return (dropout(x, keeps[0], tn["dropout"]) if keeps else x), lengths
'''

TOY_JOINT = '''"""A toy additive joint: fc(relu(enc_proj(enc) + dec_proj(dec)))."""
import torch

from benchmark.reference import loss
from benchmark.reference.layers import lin, linear_specs

OUTPUT = ("joint.fc.weight", "joint.fc.bias")


def param_specs(jn, enc_size, dec_size):
    return (linear_specs("joint.enc_proj", enc_size, jn["hidden_size"])
            + linear_specs("joint.dec_proj", dec_size, jn["hidden_size"])
            + linear_specs("joint.fc", jn["hidden_size"], jn["num_classes"]))


def dropout_sites(jn):
    return []


def lattice_logprobs(P, jn, enc, dec, labels, blank, precision, keeps):
    def chunk(e, d, labels, blank):
        h = torch.relu(e[:, :, None] + d[:, None])
        return loss.logprobs_of(lin(h, P, "joint.fc", precision), labels, blank)
    return loss.in_row_blocks(chunk, lin(enc, P, "joint.enc_proj", precision),
                              lin(dec, P, "joint.dec_proj", precision), labels, blank)
'''

TOY_ENCODER_FLOPS = '''from benchmark.roofline import counts


def step_flops(model, batch, t_frames, u_labels):
    tn = model["transnet"]
    fwd = 2 * batch * t_frames * tn["input_size"] * tn["output_size"]
    return 3.0 * (fwd + counts.prednet_joint_fwd(model, batch, t_frames, u_labels))


def decode_encoder(tn, frames, keys):
    return 2 * frames * tn["input_size"] * tn["output_size"], frames
'''

TOY_JOINT_FLOPS = '''def train_fwd(model, batch, t_enc, u1):
    J, V = model["jointnet"]["hidden_size"], model["jointnet"]["num_classes"]
    return 2 * batch * (t_enc * model["transnet"]["output_size"] * J
                        + u1 * model["prednet"]["output_size"] * J + t_enc * u1 * J * V)


def frame_flops(model, t_enc):
    J, V = model["jointnet"]["hidden_size"], model["jointnet"]["num_classes"]
    return t_enc * 2 * (model["transnet"]["output_size"] * J + J * V)


def label_flops(model):
    J, V = model["jointnet"]["hidden_size"], model["jointnet"]["num_classes"]
    return 2 * (model["prednet"]["output_size"] * J + J * V)
'''


def _toy_config(name, **sections):
    """A configuration file ``configs/<name>.json``: the flagship's at its
    rehearsal sizes with ``sections`` in place of its model's."""
    from benchmark.harness.common import deep_update
    flagship = load_json(BENCH_DIR / "configs" / "gru_flagship.json")
    run = deep_update(flagship["run"], flagship["rehearsal"]["run"])
    run["model"].update(sections)
    return {"name": name, "run": run, "weights": flagship["weights"]}


def _toy_cell(tmp_path, config, paths):
    """A BENCHMARK.json with a cell of ``config`` on the flagship's traffic,
    written with its configuration and limits files; ``paths`` collects what
    was written under the benchmark."""
    w = dict(BENCH["workloads"][0], name=f"train.{config['name']}.kspon",
             config=config["name"])
    c = dict(BENCH["configs"][0], name=config["name"],
             file=f"benchmark/configs/{config['name']}.json")
    bench = dict(BENCH, configs=BENCH["configs"] + [c], workloads=BENCH["workloads"] + [w])
    for path, text in ((ROOT / c["file"], json.dumps(config)),
                       (BENCH_DIR / "limits" / f"{w['name']}.json",
                        (BENCH_DIR / "limits" / f"{BENCH['workloads'][0]['name']}.json")
                        .read_text())):
        paths.append(path)
        path.write_text(text)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return w["name"], path


@pytest.fixture
def written():
    """Files a test writes under the benchmark, removed after it, with
    their modules."""
    import importlib
    paths = []
    yield paths
    for p in paths:
        p.unlink(missing_ok=True)
        if p.suffix == ".py":
            mod = ".".join(p.relative_to(ROOT).with_suffix("").parts)
            sys.modules.pop(mod, None)
    importlib.invalidate_caches()


def _write(written, rel, text):
    import importlib
    path = BENCH_DIR / rel
    assert not path.exists(), path
    written.append(path)
    path.write_text(text)
    importlib.invalidate_caches()


def test_a_new_architecture_needs_only_new_files_and_entries(tmp_path, written):
    """A toy encoder (one linear layer, one dropout site) and a toy
    additive ReLU joint arrive as new modules, their FLOP counts as new
    modules and the configuration as a new file: the reference, its
    weights, its dropout sites, its lattice and the step FLOPs follow, with
    no edit to any file already there."""
    import torch
    from benchmark.reference import augment
    from benchmark.reference.loss import logprobs_of, rnnt_nll
    from benchmark.reference.model import Reference, param_specs, seeded_params
    from benchmark.roofline.counts import train_step_flops
    tn = {"arch": "toy_linear_enc", "input_size": 80, "output_size": 24, "dropout": 0.25,
          "num_layers": 1}
    jn = {"combine": "toy_relu_add", "num_classes": 72, "hidden_size": 16}
    config = _toy_config("toy_arch", transnet=tn, jointnet=jn)
    _write(written, "reference/encoders/toy_linear_enc.py", TOY_ENCODER)
    _write(written, "reference/joints/toy_relu_add.py", TOY_JOINT)
    name, bench_path = _toy_cell(tmp_path, config, written)
    # the reference's parts are there, their FLOP modules not yet
    with pytest.raises(SystemExit, match="benchmark/roofline/encoders/toy_linear_enc.py"):
        load_cell(name, 1, 1.0, False, bench_path=bench_path)
    _write(written, "roofline/encoders/toy_linear_enc.py", TOY_ENCODER_FLOPS)
    _write(written, "roofline/joints/toy_relu_add.py", TOY_JOINT_FLOPS)
    model = load_cell(name, 1, 1.0, False, bench_path=bench_path).run_cfg["model"]

    specs = param_specs(model)
    assert [n for n, _, _, _ in specs][:2] == ["encoder.proj.weight", "encoder.proj.bias"]
    assert [n for n, _, _, _ in specs][-6:] == [
        "joint.enc_proj.weight", "joint.enc_proj.bias", "joint.dec_proj.weight",
        "joint.dec_proj.bias", "joint.fc.weight", "joint.fc.bias"]
    plain = seeded_params(specs, torch.Generator().manual_seed(4), "cpu")
    P = seeded_params(specs, torch.Generator().manual_seed(4), "cpu", encoder_gain=2.0,
                      joint_scale=0.5, blank_bias=0.6)
    assert torch.equal(P["encoder.proj.weight"], 2.0 * plain["encoder.proj.weight"])
    assert torch.equal(P["encoder.proj.bias"], plain["encoder.proj.bias"])
    assert torch.equal(P["joint.fc.weight"], 0.5 * plain["joint.fc.weight"])
    assert float(P["joint.fc.bias"][0] - plain["joint.fc.bias"][0]) == pytest.approx(0.6)

    B, T, U = 3, 9, 4
    g = torch.Generator().manual_seed(5)
    feats, lengths = torch.randn(B, T, 80, generator=g), torch.tensor([9, 7, 4])
    labels = torch.randint(4, 40, (B, U), generator=g)
    keep = torch.rand(B, T + 3, 24, generator=g) >= 0.25
    enc_sites, pred_sites, joint_sites = augment.sites(model)
    assert enc_sites == [0.25] and joint_sites == []
    masks = {"spec": [torch.ones(B, T + 3, 80, dtype=torch.bool)],
             "dropout": [keep] + [torch.ones(B, U + 1, 32, dtype=torch.bool)] * len(pred_sites)}
    _, enc_keep, pred_keep, _ = augment.split(masks, {"model": model, "data": config["run"]["data"]})
    P = {k: v.requires_grad_(True) for k, v in P.items()}
    ref = Reference(model, P)
    enc, elen = ref.encode(feats, lengths, enc_keep)
    assert bool((enc[~keep[:, :T]] == 0).all())
    dec = ref.predict(torch.cat([torch.zeros_like(labels[:, :1]), labels], 1),
                      torch.full((B,), U + 1), pred_keep)
    lpb, lpe = ref.lattice_logprobs(enc, dec, labels)
    with torch.no_grad():
        h = torch.relu((enc @ P["joint.enc_proj.weight"].t() + P["joint.enc_proj.bias"])[:, :, None]
                       + (dec @ P["joint.dec_proj.weight"].t() + P["joint.dec_proj.bias"])[:, None])
        want_b, want_e = logprobs_of(h @ P["joint.fc.weight"].t() + P["joint.fc.bias"], labels, 0)
    torch.testing.assert_close(lpb, want_b)
    torch.testing.assert_close(lpe, want_e)
    nll = rnnt_nll(lpb, lpe, elen, torch.full((B,), U)).mean()
    grads = torch.autograd.grad(nll, [P["encoder.proj.weight"], P["joint.dec_proj.weight"]])
    assert all(bool(torch.isfinite(gr).all()) and float(gr.abs().sum()) > 0 for gr in grads)
    with pytest.raises(NotImplementedError, match="factored"):
        ref.enc_factor(enc)

    frames, labels_n = [9, 7, 4], [4, 2, 1]
    J, V, Dd = 16, 72, model["prednet"]["output_size"]
    Hp, Lp = model["prednet"]["hidden_size"], model["prednet"]["num_layers"]
    want = sum(3.0 * (2 * t * 80 * 24 + Lp * 2 * (u + 1) * 4 * Hp * 2 * Hp
                      + 2 * (u + 1) * Hp * Dd
                      + 2 * (t * 24 * J + (u + 1) * Dd * J + t * (u + 1) * J * V))
               for t, u in zip(frames, labels_n))
    assert train_step_flops(model, frames, labels_n) == want


@pytest.mark.parametrize("section,key,directory", [("transnet", "arch", "encoders"),
                                                    ("prednet", "rnn_type", "prednets"),
                                                    ("jointnet", "combine", "joints")])
def test_a_part_without_its_module_fails_in_load_cell_naming_the_file(
        tmp_path, written, section, key, directory):
    model = load_json(BENCH_DIR / "configs" / "gru_flagship.json")["run"]["model"]
    config = _toy_config("missing_part", **{section: dict(model[section], **{key: "no_such_part"})})
    name, bench_path = _toy_cell(tmp_path, config, written)
    with pytest.raises(SystemExit,
                       match=f"benchmark/reference/{directory}/no_such_part.py"):
        load_cell(name, 1, 1.0, False, bench_path=bench_path)


PART_DIRS = {("reference", "encoders"), ("reference", "prednets"), ("reference", "joints"),
             ("roofline", "encoders"), ("roofline", "prednets"), ("roofline", "joints")}


def _part_names():
    names = {"rnn", "conformer", "gru", "lstm", "concat", "add", "stateless"}
    for pkg, d in PART_DIRS:
        names |= {p.stem for p in (BENCH_DIR / pkg / d).glob("*.py")} - {"__init__"}
    for c in with_deferred(BENCH)["configs"]:
        m = load_json(ROOT / c["file"])["run"]["model"]
        names |= {m["transnet"].get("arch", ""), m["prednet"].get("rnn_type", ""),
                  m["jointnet"].get("combine", ""), m["transnet"].get("rnn_type", "")}
    return names - {""}


def test_no_module_outside_the_parts_compares_a_part_name_to_a_literal():
    """Which encoder, prediction network or joint a model has is decided in
    the parts' own modules; elsewhere no comparison or dispatch table names
    one."""
    names = _part_names()

    def literal(node):
        if isinstance(node, ast.Constant):
            return node.value in names if isinstance(node.value, str) else False
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(literal(e) for e in node.elts)
        return False

    bad = []
    for p in _sources():
        rel = p.relative_to(BENCH_DIR).parts
        if rel[0] == "tests" or tuple(rel[:2]) in PART_DIRS:
            continue
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.Compare) and any(
                    literal(x) for x in [node.left] + node.comparators):
                bad.append((str(p.relative_to(ROOT)), node.lineno))
            elif isinstance(node, ast.Dict) and any(k is not None and literal(k)
                                                    for k in node.keys):
                bad.append((str(p.relative_to(ROOT)), node.lineno))
    assert not bad, bad
