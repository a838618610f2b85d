"""The port's model, stage and time axes (``rnntransducer_tpu_torch/parallel/``)
on the CPU: gloo worker ranks against the JAX package's functions on its
virtual-device meshes, from the same flax weights.

One module fixture starts every multi-process job at once: two worker
ranks (a script written under the fixture's directory, which imports no
JAX) through the wavefront, the pipeline, the vocab-sharded loss, the
Trainer's steps on each axis and a checkpoint round trip; four worker
ranks through each axis composed with the data axis and ZeRO-1; and the
train CLI under torchrun with ``--model_parallel 2``.  Meanwhile the test
process computes the JAX side in float32, without dropout, and the port's
single-process references.  The tests read what the jobs wrote.  Inputs
come from a numpy seed; tolerances are 1e-5 (relative for params)."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.ops.rnnt_loss import (factored_compact_lattice as jax_lattice,
                                             rnnt_loss_factored as jax_loss)
from rnntransducer_tpu.parallel.pipeline import make_stage_mesh, pipeline_encode
from rnntransducer_tpu.parallel.wavefront import make_time_mesh, wavefront_encode
from rnntransducer_tpu.train.optim import make_optimizer as jax_make_optimizer
from rnntransducer_tpu.train.state import TrainState as JaxTrainState
from rnntransducer_tpu.train.state import train_step as jax_train_step

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.parallel import mesh as pmesh
from rnntransducer_tpu_torch.parallel import pipeline as ppipe
from rnntransducer_tpu_torch.parallel import wavefront as pwave
from rnntransducer_tpu_torch.train import CheckpointManager, TrainState, train_step
from rnntransducer_tpu_torch.utils.weights import (random_flax_params,
                                                   state_dict_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
JOB_TIMEOUT_S = 240
# V = 57 splits 29 / 28 over two ranks (and holds the default graphemes)
B, T, U, F, H, V = 4, 16, 4, 8, 16, 57


def _model(rnn_type="gru", layers=2, bidirectional=True, dropout=0.0):
    return {
        "transnet": dict(input_size=F, hidden_size=H, output_size=12, num_layers=layers,
                         rnn_type=rnn_type, dropout=dropout, bidirectional=bidirectional),
        "prednet": dict(embedding_size=V, hidden_size=H, output_size=12, num_layers=1,
                        rnn_type="lstm", dropout=dropout),
        "jointnet": dict(num_classes=V)}


def _config(module, model, **train):
    kw = dict(precision="fp32", learning_rate=3e-3, max_steps=200,
              per_device_train_batch_size=B)
    kw.update(train)
    return module.Config.from_dict({
        "model": model,
        "data": {"audio": {"spec_augment": False}},
        "train": kw})


# the Trainer-level configs: a bidirectional GRU encoder (the model and stage
# axes, against the JAX single-device train_step) and a unidirectional LSTM
# one (the time axis)
BI = _model()
UNI = _model("lstm", layers=2, bidirectional=False)
# adafactor's fc factors: (V_ADA, 64 + 64), V_ADA split 129 / 128 (the
# second rank's rows alone would factor the other way round)
V_ADA = 257
ADA = dict(_model(), jointnet=dict(num_classes=V_ADA),
           transnet=dict(_model()["transnet"], output_size=64),
           prednet=dict(_model()["prednet"], output_size=64, embedding_size=V_ADA))
# the optimizer alone: fc-like leaves whose rows split over the model axis,
# factored with the rows largest, with the rows second largest, and a bias
ADA_LEAVES = {"rows_largest": (V_ADA, 128), "rows_second": (130, 256), "bias": (V_ADA,)}


def _flax(model, seed):
    return random_flax_params(pcfg.ModelConfig.from_dict(model),
                              torch.Generator().manual_seed(seed))


def _sd(model, flax):
    return state_dict_from_flax(flax, pcfg.ModelConfig.from_dict(model))


def _batch(seed=0, rows=B):
    rng = np.random.RandomState(seed)
    targets = rng.randint(1, V, size=(rows, U)).astype(np.int64)
    lengths = rng.randint(T // 2, T + 1, rows)
    lengths[0] = T
    return {"feats": rng.randn(rows, T, F).astype(np.float32),
            "feat_lengths": lengths.astype(np.int64),
            "text_in": np.concatenate([np.zeros((rows, 1), np.int64), targets], 1),
            "text_lengths": np.full((rows,), U + 1, np.int64),
            "targets": targets, "target_lengths": np.full((rows,), U, np.int64)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

_WORKER = r'''
import dataclasses, json, os, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
port, r, world, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from rnntransducer_tpu_torch import parallel
from rnntransducer_tpu_torch.config import Config, TransNetConfig
from rnntransducer_tpu_torch.parallel.mesh import make_mesh, MODEL_AXIS
from rnntransducer_tpu_torch.parallel.pipeline import pipeline_encode
from rnntransducer_tpu_torch.parallel.wavefront import wavefront_encode
from rnntransducer_tpu_torch.ops.rnnt_loss import factored_compact_lattice, rnnt_loss_factored
from rnntransducer_tpu_torch.train import CheckpointManager, TrainState, train_step

parallel.initialize("127.0.0.1:" + port, world, r, device="cpu", timeout_s=120)
out = {}


def load(name):
    return torch.load(os.path.join(root, name + ".pt"))


def save(name, obj):
    torch.save(obj, os.path.join(root, f"{name}.rank{r}.pt"))


def encoder_run(name, fn):
    case = load(name)
    params = {k: v.clone().requires_grad_() for k, v in case["sd"].items()}
    y, state = fn(params, TransNetConfig(**case["cfg"]), case["x"], case["lengths"],
                  case["M"])
    loss = (y * case["g"]).sum()
    if state is not None:
        loss = loss + (state.h * case["gh"]).sum()
        if state.c is not None:
            loss = loss + (state.c * case["gc"]).sum()
    loss.backward()
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in params.items()}
    save(name, {"out": y.detach(), "h": None if state is None else state.h.detach(),
                "c": None if state is None or state.c is None else state.c.detach(),
                "grads": grads})


def steps(name, cfg, sd, batch, mesh, n=2):
    state = TrainState.create(cfg, "cpu", state_dict=sd, mesh=mesh)
    losses = [float(train_step(state, batch)["loss"]) for _ in range(n)]
    whole = state.whole({k: v.detach() for k, v in state.model.state_dict().items()})
    if r == 0:
        torch.save({"params": whole, "losses": losses}, os.path.join(root, name + ".pt"))
    return state, losses


cfgs = {k: Config.from_json(os.path.join(root, k + ".json")) for k in ("bi", "uni", "ada")}
sds = {k: load("sd_" + k) for k in ("bi", "uni", "ada")}
batch = load("batch")
if world == 2:
    wave = make_mesh(sequence_parallel=2)
    for name in ("wave_gru", "wave_lstm"):
        encoder_run(name, lambda p, c, x, n, M: wavefront_encode(p, c, x, n, wave))
    pipe = make_mesh(pipeline_stages=2)

    def pipelined(p, c, x, n, M):
        y = pipeline_encode(p, c, x, n, pipe, M)
        return y, None
    for name in ("pipe_bi2", "pipe_uni4"):
        encoder_run(name, pipelined)
    # pipeline_encode leaves a layer's grads on its own stage: sum them
    for name in ("pipe_bi2", "pipe_uni4"):
        got = torch.load(os.path.join(root, f"{name}.rank{r}.pt"))
        for k, v in got["grads"].items():
            if k.startswith("rnn."):
                dist.all_reduce(v)
        save(name, got)

    # the vocab-sharded lattice, loss and joint: this rank's columns
    tp = make_mesh(model_parallel=2)
    shard = tp.vocab_shard(57)
    case = load("loss")
    A = case["A"][..., shard.start:shard.start + shard.size].clone().requires_grad_()
    C = case["C"][..., shard.start:shard.start + shard.size].clone().requires_grad_()
    bl, lb = factored_compact_lattice(A, C, case["labels"], 0, shard)
    loss = rnnt_loss_factored(A, C, case["labels"], case["t_len"], case["u_len"],
                              reduction="sum", shard=shard)
    loss.backward()
    from rnntransducer_tpu_torch.models.joint import JointNetwork
    from rnntransducer_tpu_torch.config import JointNetConfig
    joint = JointNetwork(JointNetConfig(num_classes=57), 12, 12)
    joint.load_state_dict({"fc.weight": case["w"], "fc.bias": case["b"]})
    joint.keep_vocab_rows(shard.start, shard.size)
    enc = case["enc"].clone().requires_grad_()
    dec = case["dec"].clone().requires_grad_()
    jA, jC = joint.factors(enc, dec, shard)
    jl = rnnt_loss_factored(jA, jC, case["labels"], case["t_len"], case["u_len"],
                            reduction="sum", shard=shard)
    jl.backward()
    save("loss", {"bl": bl.detach(), "lb": lb.detach(), "loss": loss.detach(),
                  "dA": A.grad, "dC": C.grad, "joint_loss": jl.detach(),
                  "dW": joint.fc.weight.grad, "db": joint.fc.bias.grad,
                  "denc": enc.grad, "ddec": dec.grad, "start": shard.start,
                  "size": shard.size})

    # the Trainer's steps on each axis, the whole batch on every rank
    steps("trainer_model", dataclasses.replace(cfgs["bi"], train=dataclasses.replace(
        cfgs["bi"].train, model_parallel=2)), sds["bi"], batch, tp)
    stage_cfg = dataclasses.replace(cfgs["bi"], train=dataclasses.replace(
        cfgs["bi"].train, pipeline_stages=2, pipeline_microbatches=2))
    steps("trainer_stage", stage_cfg, sds["bi"], batch, pipe)
    steps("trainer_time", dataclasses.replace(cfgs["uni"], train=dataclasses.replace(
        cfgs["uni"].train, sequence_parallel=2)), sds["uni"], batch, wave)
    # adafactor on the model axis: 2 steps, and a checkpoint of them
    state, _ = steps("trainer_adafactor", cfgs["ada"], sds["ada"], batch, tp)
    CheckpointManager(os.path.join(root, "ck_ada")).save(state.step, state)
    # the optimizer alone: each leaf's rows on this rank, 3 steps
    from rnntransducer_tpu_torch.train.optim import Adafactor
    leaves = load("ada_leaves")
    got = {}
    for name, case in leaves.items():
        sl = tp.vocab_shard(case["p"].shape[0])
        p = case["p"][sl.start:sl.start + sl.size].clone()
        opt = Adafactor([p], lr=0.01, weight_decay=1e-4, row_split={
            p: (case["p"].shape[0], lambda t: tp.all_reduce(t, MODEL_AXIS))})
        for g in case["g"]:
            p.grad = g[sl.start:sl.start + sl.size].clone()
            opt.step()
        got[name] = {"p": p, "state": {k: v for k, v in opt.state[p].items()
                                       if torch.is_tensor(v)}}
    save("ada_leaves", got)
    # dropout and SpecAugment on: the ranks of a row draw the same masks
    for name, cfg, mesh in (("model", cfgs["bi"], tp), ("stage", stage_cfg, pipe),
                            ("time", cfgs["uni"], wave)):
        m = cfg.model
        drop = dataclasses.replace(cfg, model=dataclasses.replace(
            m, transnet=dataclasses.replace(m.transnet, dropout=0.3),
            prednet=dataclasses.replace(m.prednet, dropout=0.3)),
            data=dataclasses.replace(cfg.data, audio=dataclasses.replace(
                cfg.data.audio, spec_augment=True)),
            train=dataclasses.replace(cfg.train, weight_noise_std=0.01,
                                      model_parallel=2 if name == "model" else 1,
                                      sequence_parallel=2 if name == "time" else 1))
        state = TrainState.create(drop, "cpu", state_dict=sds["uni" if name == "time"
                                                             else "bi"], mesh=mesh)
        loss = float(train_step(state, batch)["loss"])
        out["dropout_" + name] = {"loss": loss, "prednet": state.model.prednet.state_dict()[
            "rnn.fwd.0.w_hh"].sum().item()}

    # a data-parallel checkpoint of step 1 restored on the model axis, one
    # step, saved again
    state = TrainState.create(dataclasses.replace(cfgs["bi"], train=dataclasses.replace(
        cfgs["bi"].train, model_parallel=2)), "cpu", state_dict=sds["bi"], mesh=tp)
    CheckpointManager(os.path.join(root, "ck_dp")).restore(state)
    out["restored_step"] = state.step
    train_step(state, batch)
    CheckpointManager(os.path.join(root, "ck_tp")).save(state.step, state)
else:
    # each axis composed with a data axis of 2 and ZeRO-1: rows by data index
    for axis, kw, key in (("model", dict(model_parallel=2), "bi"),
                          ("stage", dict(pipeline_stages=2, pipeline_microbatches=2), "bi"),
                          ("time", dict(sequence_parallel=2), "uni")):
        cfg = dataclasses.replace(cfgs[key], train=dataclasses.replace(
            cfgs[key].train, shard_optimizer_state=True, per_device_train_batch_size=2,
            **kw))
        mesh = make_mesh(model_parallel=cfg.train.model_parallel,
                         pipeline_stages=cfg.train.pipeline_stages,
                         sequence_parallel=cfg.train.sequence_parallel)
        local = {k: v[mesh.data_index::2] for k, v in batch.items()}
        state, losses = steps("zero_" + axis, cfg, sds[key], local, mesh)
        out["zero_" + axis] = {"optimizer": type(state.optimizer).__name__,
                               "losses": losses, "coords": [mesh.index(a) for a in
                                                            mesh.axis_names]}
out["jax_imported"] = any(m.split(".")[0] in ("jax", "flax", "rnntransducer_tpu")
                          for m in sys.modules)
with open(os.path.join(root, f"w{world}.rank{r}.json"), "w") as f:
    json.dump(out, f)
parallel.shutdown()
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _popen(args, log):
    return subprocess.Popen(args, stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            env=_env(), cwd=REPO)


def _encoder_case(rng, model, M=0, zero_row=False):
    """Inputs, weights (port state dict and flax encoder tree) and output
    cotangents of one encoder check."""
    flax = _flax(model, int(rng.randint(1 << 30)))
    sd = _sd(model, flax)
    tn = model["transnet"]
    x = rng.randn(B, T, F).astype(np.float32)
    lengths = np.array([T, 5, 11, 0 if zero_row else 2], np.int64)
    g = rng.randn(B, T, 12).astype(np.float32)
    gh = rng.randn(tn["num_layers"], 1, B, tn["hidden_size"]).astype(np.float32)
    gc = rng.randn(*gh.shape).astype(np.float32)
    case = {"sd": {k[len("encoder."):]: v for k, v in sd.items()
                   if k.startswith("encoder.")},
            "cfg": tn, "x": torch.from_numpy(x), "lengths": torch.from_numpy(lengths),
            "g": torch.from_numpy(g), "gh": torch.from_numpy(gh),
            "gc": torch.from_numpy(gc), "M": M}
    return case, flax


def _jax_encoder(case, flax, model, fn, with_state):
    """The JAX function's outputs and its encoder grads, in the port's names."""
    cfg = jcfg.TransNetConfig(**model["transnet"])
    x, n = jnp.asarray(case["x"].numpy()), jnp.asarray(case["lengths"].numpy(), jnp.int32)
    g, gh, gc = (jnp.asarray(case[k].numpy()) for k in ("g", "gh", "gc"))
    enc = jax.tree_util.tree_map(jnp.asarray, flax["encoder"])

    def loss(p):
        y, state = fn(p, cfg, x, n)
        total = jnp.sum(y * g)
        if with_state:
            total = total + jnp.sum(state.h * gh)
            if state.c is not None:
                total = total + jnp.sum(state.c * gc)
        return total, (y, state)
    (_, (y, state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(enc)
    tree = dict(flax, encoder=jax.tree_util.tree_map(np.asarray, grads))
    named = _sd(model, tree)
    return {"out": np.asarray(y), "h": None if state is None else np.asarray(state.h),
            "c": None if state is None or state.c is None else np.asarray(state.c),
            "grads": {k[len("encoder."):]: v for k, v in named.items()
                      if k.startswith("encoder.")}}


def _jax_steps(cfg_dict, flax, batch, n=2):
    """``n`` JAX single-device train_steps from ``flax``: (params, losses)."""
    cfg = jcfg.Config.from_dict(cfg_dict)
    tx = jax_make_optimizer(cfg.train)
    params = jax.tree_util.tree_map(jnp.asarray, flax)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    losses = []
    for _ in range(n):
        state, metrics = jax_train_step(cfg, tx, state, jb)
        losses.append(float(metrics["loss"]))
    return jax.tree_util.tree_map(np.asarray, state.params), losses


def _port_steps(cfg, sd, batch, n=2):
    state = TrainState.create(cfg, "cpu", state_dict=sd)
    losses = [float(train_step(state, batch)["loss"]) for _ in range(n)]
    return state, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("model_parallel"))
    rng = np.random.RandomState(0)
    flax = {"bi": _flax(BI, 1), "uni": _flax(UNI, 2)}
    sds = {k: _sd(BI if k == "bi" else UNI, flax[k]) for k in flax}
    flax["ada"] = _flax(ADA, 4)
    sds["ada"] = _sd(ADA, flax["ada"])
    cfg_dicts = {"bi": _config(pcfg, BI).to_dict(), "uni": _config(pcfg, UNI).to_dict(),
                 "ada": _config(pcfg, ADA, optimizer="adafactor",
                                model_parallel=2).to_dict()}
    for k in ("bi", "uni", "ada"):
        pcfg.Config.from_dict(cfg_dicts[k]).to_json(os.path.join(root, k + ".json"))
        torch.save(sds[k], os.path.join(root, f"sd_{k}.pt"))
    batch = _batch(3)
    torch.save(_torch_batch(batch), os.path.join(root, "batch.pt"))
    cases = {}
    for name, model, M, zero in (("wave_gru", _model("gru", 3, False), 0, True),
                                 ("wave_lstm", _model("lstm", 3, False), 0, True),
                                 ("pipe_bi2", _model("gru", 2, True), 2, True),
                                 ("pipe_uni4", _model("lstm", 4, False), 4, False)):
        case, f = _encoder_case(rng, model, M, zero)
        torch.save(case, os.path.join(root, name + ".pt"))
        cases[name] = (case, f, model)
    # the loss: factors, labels and lengths; the joint's fc and inputs
    Bl, Tl, U1 = 3, 6, 5
    loss_case = {"A": torch.from_numpy(rng.randn(Bl, Tl, V).astype(np.float32)),
                 "C": torch.from_numpy(rng.randn(Bl, U1, V).astype(np.float32)),
                 "labels": torch.from_numpy(rng.randint(1, V, (Bl, U1 - 1))),
                 "t_len": torch.tensor([Tl, 4, 1]), "u_len": torch.tensor([U1 - 1, 2, 0]),
                 "w": torch.from_numpy(0.3 * rng.randn(V, 24).astype(np.float32)),
                 "b": torch.from_numpy(0.3 * rng.randn(V).astype(np.float32)),
                 "enc": torch.from_numpy(rng.randn(Bl, Tl, 12).astype(np.float32)),
                 "dec": torch.from_numpy(rng.randn(Bl, U1, 12).astype(np.float32))}
    torch.save(loss_case, os.path.join(root, "loss.pt"))
    ada_leaves = {name: {"p": torch.from_numpy(0.1 * rng.randn(*shape).astype(np.float32)),
                         "g": [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                               for _ in range(3)]}
                  for name, shape in ADA_LEAVES.items()}
    torch.save(ada_leaves, os.path.join(root, "ada_leaves.pt"))
    # a data-parallel checkpoint of step 1 for the model axis to restore
    bi_cfg = pcfg.Config.from_dict(cfg_dicts["bi"])
    dp, _ = _port_steps(bi_cfg, sds["bi"], _torch_batch(batch), n=1)
    CheckpointManager(os.path.join(root, "ck_dp")).save(1, dp)

    worker = os.path.join(root, "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    procs = {}
    for world in (2, 4):
        port = str(_free_port())
        for r in range(world):
            procs[f"w{world}.rank{r}"] = _popen(
                [sys.executable, worker, port, str(r), str(world), root],
                os.path.join(root, f"w{world}.rank{r}.log"))
    # the CLI's synthetic utterances: 80 mels, 1-8 s, up to 48 labels
    cli_cfg = _config(pcfg, dict(BI, transnet=dict(BI["transnet"], input_size=80)))
    cli_cfg = dataclasses.replace(cli_cfg, data=dataclasses.replace(
        cli_cfg.data, audio_buckets=(801,), label_buckets=(48,)))
    cli_cfg.to_json(os.path.join(root, "cli.json"))
    procs["torchrun"] = _popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "rnntransducer_tpu_torch.cli.train", "--device", "cpu",
         "--config", os.path.join(root, "cli.json"), "--model_parallel", "2",
         "--synthetic", "4", "--max_steps", "2", "--per_device_train_batch_size", "2",
         "--per_device_eval_batch_size", "2", "--checkpoint_dir",
         os.path.join(root, "cli")], os.path.join(root, "torchrun.log"))
    deadline = time.time() + JOB_TIMEOUT_S
    try:
        # meanwhile: the JAX side and the port's single-process references
        jax_out = {}
        for name, (case, f, model) in cases.items():
            if name.startswith("wave"):
                fn = (lambda p, c, x, n: wavefront_encode(p, c, x, n, make_time_mesh(
                    jax.devices()[:2])))
            else:
                M = case["M"]

                def fn(p, c, x, n, M=M):
                    return pipeline_encode(p, c, x, n, make_stage_mesh(jax.devices()[:2]),
                                           M), None
            jax_out[name] = _jax_encoder(case, f, model, fn, name.startswith("wave"))
        jax_out["steps_bi"] = _jax_steps(cfg_dicts["bi"], flax["bi"], batch)
        ada_single = dict(cfg_dicts["ada"], train=dict(cfg_dicts["ada"]["train"],
                                                       model_parallel=1))
        jax_out["steps_ada"] = _jax_steps(ada_single, flax["ada"], batch)
        jax_out["lattice"] = jax_lattice(*(jnp.asarray(loss_case[k].numpy())
                                           for k in ("A", "C", "labels")))
        jax_out["loss"] = _jax_loss_and_grads(loss_case)
        single = {"uni": _port_steps(pcfg.Config.from_dict(cfg_dicts["uni"]), sds["uni"],
                                     _torch_batch(batch))[0],
                  "bi": _port_steps(bi_cfg, sds["bi"], _torch_batch(batch))[0],
                  "ada": _port_steps(pcfg.Config.from_dict(ada_single), sds["ada"],
                                     _torch_batch(batch))[0]}
        rcs = {name: p.wait(timeout=max(deadline - time.time(), 1))
               for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    logs = {name: open(os.path.join(root, f"{name}.log")).read() for name in procs}
    for name, rc in rcs.items():
        assert rc == 0, f"{name} failed:\n{logs[name][-3000:]}"
    ranks = {w: [json.load(open(os.path.join(root, f"w{w}.rank{r}.json")))
                 for r in range(w)] for w in (2, 4)}
    return dict(root=root, jax=jax_out, single=single, ranks=ranks, sds=sds, flax=flax,
                batch=batch, cfg_dicts=cfg_dicts, logs=logs, loss_case=loss_case,
                ada_leaves=ada_leaves)


def _jax_loss_and_grads(case):
    """The JAX loss of the joint's factors: its value and grads for the fc
    (in torch's (V, De+Dd) layout), enc and dec; and for the factors A, C."""
    arr = {k: jnp.asarray(v.numpy()) for k, v in case.items()}
    labels = arr["labels"].astype(jnp.int32)
    t_len, u_len = arr["t_len"].astype(jnp.int32), arr["u_len"].astype(jnp.int32)

    def joint(w, b, enc, dec):
        A = jax.nn.gelu(enc, approximate=True) @ w[:, :12].T
        C = jax.nn.gelu(dec, approximate=True) @ w[:, 12:].T + b
        return jax_loss(A, C, labels, t_len, u_len, reduction="sum")

    def factored(A, C):
        return jax_loss(A, C, labels, t_len, u_len, reduction="sum")
    jl, jg = jax.value_and_grad(joint, argnums=(0, 1, 2, 3))(
        arr["w"], arr["b"], arr["enc"], arr["dec"])
    fl, fg = jax.value_and_grad(factored, argnums=(0, 1))(arr["A"], arr["C"])
    return {"joint_loss": float(jl), "dW": np.asarray(jg[0]), "db": np.asarray(jg[1]),
            "denc": np.asarray(jg[2]), "ddec": np.asarray(jg[3]), "loss": float(fl),
            "dA": np.asarray(fg[0]), "dC": np.asarray(fg[1])}


def _rank(runs, name, r):
    return torch.load(os.path.join(runs["root"], f"{name}.rank{r}.pt"))


def _close(got, want, atol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=TOL, err_msg=what)


def _max_rel(got, want):
    """max |got - want| over the params, relative to each one's largest |want|."""
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
                     / max(np.abs(np.asarray(want[k])).max(), 1e-30)) for k in want)


# ---------------------------------------------------------------------------
# the schedules against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["wave_gru", "wave_lstm", "pipe_bi2", "pipe_uni4"])
def test_schedule_matches_the_jax_function(runs, name):
    """``wavefront_encode`` (GRU and LSTM, 3 layers, time 2) and
    ``pipeline_encode`` (bidirectional GRU at M = 2, unidirectional LSTM at
    M = 4, stage 2) on ragged lengths with a zero-length row: outputs, final
    states and the encoder's param grads on both ranks equal the JAX
    functions on a 2-device mesh to 1e-5."""
    want = runs["jax"][name]
    for r in range(2):
        got = _rank(runs, name, r)
        _close(got["out"], want["out"], what=f"{name} rank {r} out")
        if want["h"] is not None:
            _close(got["h"], want["h"], what=f"{name} rank {r} h")
        if want["c"] is not None:
            _close(got["c"], want["c"], what=f"{name} rank {r} c")
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            _close(got["grads"][k], g, what=f"{name} rank {r} grad {k}")


# ---------------------------------------------------------------------------
# the model axis: the vocab-sharded lattice, loss and joint
# ---------------------------------------------------------------------------


def test_vocab_sharded_lattice_and_loss_match_jax(runs):
    """``factored_compact_lattice`` / ``rnnt_loss_factored`` on this rank's
    columns of V = 57 (29 / 28): bl, lb and the loss equal the JAX
    functions' on the whole V (JAX ``test_factored_loss_vocab_sharded_values``),
    and each rank's grads of A and C are its columns of the JAX grads."""
    bl, lb = (np.asarray(x) for x in runs["jax"]["lattice"])
    want = runs["jax"]["loss"]
    for r in range(2):
        got = _rank(runs, "loss", r)
        cols = slice(got["start"], got["start"] + got["size"])
        _close(got["bl"], bl, what="bl")
        _close(got["lb"], lb, what="lb")
        _close(got["loss"], want["loss"], what="loss")
        _close(got["dA"], want["dA"][..., cols], what=f"rank {r} dA")
        _close(got["dC"], want["dC"][..., cols], what=f"rank {r} dC")


def test_vocab_sharded_joint_grads_are_not_multiplied(runs):
    """The joint's factors on a vocab shard: the fc grads of each rank are
    its rows of the JAX grads (not k = 2 times them, which an all-reduce in
    the backward of the product's sum would give), and enc / dec get the
    whole grads on both ranks."""
    want = runs["jax"]["loss"]
    for r in range(2):
        got = _rank(runs, "loss", r)
        rows = slice(got["start"], got["start"] + got["size"])
        _close(got["joint_loss"], want["joint_loss"], what="joint loss")
        _close(got["dW"], want["dW"][rows], what=f"rank {r} dW")
        _close(got["db"], want["db"][rows], what=f"rank {r} db")
        ratio = float(np.abs(got["dW"].numpy()).sum() / np.abs(want["dW"][rows]).sum())
        assert abs(ratio - 1.0) < 1e-4, ratio
        _close(got["denc"], want["denc"], what=f"rank {r} denc")
        _close(got["ddec"], want["ddec"], what=f"rank {r} ddec")


# ---------------------------------------------------------------------------
# the Trainer's steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", ["model", "stage"])
def test_train_steps_match_the_jax_single_device_step(runs, axis):
    """2 train_steps at (data 1 x model 2) with V = 57 split 29 / 28, and at
    (data 1 x stage 2) with 2 microbatches, from the same flax weights and
    batch: the params (the fc gathered) equal the JAX single-device
    train_step's to 1e-5 relative, and so do the losses."""
    want_params, want_losses = runs["jax"]["steps_bi"]
    got = torch.load(os.path.join(runs["root"], f"trainer_{axis}.pt"))
    want = _sd(BI, want_params)
    assert _max_rel(got["params"], want) <= TOL
    for g, w in zip(got["losses"], want_losses):
        assert abs(g - w) <= TOL * abs(w), (g, w)


def _moments(state) -> dict:
    """The optimizer's tensors of ``state``, keyed by param name and entry."""
    names = [n for n, _ in state.model.named_parameters()]
    sd = state.optimizer.state_dict()["state"]
    return {f"{names[i]}.{k}": v for i, s in sd.items()
            for k, v in s.items() if torch.is_tensor(v) and v.dim()}


def test_adafactor_on_the_model_axis_matches_the_jax_step(runs):
    """adafactor at (data 1 x model 2) with a fc that factors ((257, 128),
    its rows split 129 / 128): the params after 2 train_steps (the fc
    gathered) equal the JAX single-device train_step's to 1e-5 relative,
    and so do the losses (GSPMD computes the row and column statistics and
    the update clipping over the whole fc).  The checkpoint of those steps
    restores in one process to the params and the factored statistics of
    one process's 2 steps."""
    want_params, want_losses = runs["jax"]["steps_ada"]
    got = torch.load(os.path.join(runs["root"], "trainer_adafactor.pt"))
    assert _max_rel(got["params"], _sd(ADA, want_params)) <= TOL
    for g, w in zip(got["losses"], want_losses):
        assert abs(g - w) <= TOL * abs(w), (g, w)
    want = runs["single"]["ada"]
    state = TrainState.create(want.cfg, "cpu", state_dict=runs["sds"]["ada"])
    CheckpointManager(os.path.join(runs["root"], "ck_ada")).restore(state)
    assert state.step == 2
    assert _max_rel(state.model.state_dict(), want.model.state_dict()) <= TOL
    got_m, want_m = _moments(state), _moments(want)
    assert set(got_m) == set(want_m)
    assert {tuple(got_m[f"joint.fc.weight.{k}"].shape) for k in ("v_row", "v_col")} == {
        (128,), (V_ADA,)}
    assert _max_rel(got_m, want_m) <= TOL


@pytest.mark.parametrize("leaf", sorted(ADA_LEAVES))
def test_adafactor_row_split_updates_the_whole_leafs_rows(runs, leaf):
    """``Adafactor(row_split=...)`` on each model rank's rows of a leaf
    factored with its rows the largest dim, the second largest (each rank's
    65 rows alone would not factor), or a bias: after 3 steps each rank's
    rows and statistics are the single process's update of the whole leaf,
    to 1e-6 relative."""
    from rnntransducer_tpu_torch.train.optim import Adafactor

    case = runs["ada_leaves"][leaf]
    p = case["p"].clone()
    opt = Adafactor([p], lr=0.01, weight_decay=1e-4)
    for g in case["g"]:
        p.grad = g.clone()
        opt.step()
    want = {k: v for k, v in opt.state[p].items() if torch.is_tensor(v)}
    sizes = pmesh.vocab_sizes(p.shape[0], 2)
    for r in range(2):
        got = _rank(runs, "ada_leaves", r)[leaf]
        rows = slice(sum(sizes[:r]), sum(sizes[:r + 1]))
        assert _max_rel({"p": got["p"]}, {"p": p[rows]}) <= 1e-6
        assert set(got["state"]) == set(want)
        for k, v in want.items():
            split = Adafactor.keeps_rows(k, tuple(p.shape))
            assert _max_rel({k: got["state"][k]}, {k: v[rows] if split else v}) <= 1e-6


def test_time_axis_train_steps_match_one_process(runs):
    """2 train_steps at (data 1 x time 2) of a unidirectional LSTM encoder
    equal one port process's steps on the same batch to 1e-5 relative."""
    got = torch.load(os.path.join(runs["root"], "trainer_time.pt"))
    want = runs["single"]["uni"].model.state_dict()
    assert _max_rel(got["params"], want) <= TOL


@pytest.mark.parametrize("axis", ["model", "stage", "time"])
def test_each_axis_composes_with_data_and_zero(runs, axis):
    """Four ranks: (data 2 x model 2), (data 2 x stage 2) and (data 2 x time
    2), ZeRO-1 on, each data index on its rows of the batch: the params after
    2 steps equal one process's at the global batch to 1e-5 relative; the
    optimizer is split over the data group."""
    got = torch.load(os.path.join(runs["root"], f"zero_{axis}.pt"))
    want = runs["single"]["uni" if axis == "time" else "bi"].model.state_dict()
    assert _max_rel(got["params"], want) <= TOL
    ranks = runs["ranks"][4]
    assert {r[f"zero_{axis}"]["optimizer"] for r in ranks} == {"ShardedOptimizer"}
    assert [r[f"zero_{axis}"]["coords"] for r in ranks] == [[0, 0], [0, 1], [1, 0],
                                                           [1, 1]]
    losses = {tuple(r[f"zero_{axis}"]["losses"]) for r in ranks}
    assert len(losses) == 1  # the data mean, on every rank


@pytest.mark.parametrize("axis", ["model", "stage", "time"])
def test_ranks_of_a_row_draw_the_same_masks(runs, axis):
    """Dropout, SpecAugment and weight noise on: the two ranks of a model,
    stage or time row compute the same rows, so they draw the same masks
    (generators keyed by the data index) and end the step with the same
    loss and prediction-network params."""
    a, b = (r[f"dropout_{axis}"] for r in runs["ranks"][2])
    assert a == b


def test_checkpoint_round_trip_data_to_model_to_data(runs):
    """A data-parallel checkpoint of step 1 restores on the model axis (each
    rank its rows of the fc and of its AdamW moments), trains a step and
    saves the single-device layout; one process restores that and holds the
    params and moments of two single-process steps to 1e-5 relative (JAX
    ``test_checkpoint_cross_topology_dp_to_tp``)."""
    assert {r["restored_step"] for r in runs["ranks"][2]} == {1}
    cfg = pcfg.Config.from_dict(runs["cfg_dicts"]["bi"])
    state = TrainState.create(cfg, "cpu", state_dict=runs["sds"]["bi"])
    CheckpointManager(os.path.join(runs["root"], "ck_tp")).restore(state)
    assert state.step == 2 and state.updates == 2
    want = runs["single"]["bi"]
    assert _max_rel(state.model.state_dict(), want.model.state_dict()) <= TOL
    got_m, want_m = _moments(state), _moments(want)
    assert set(got_m) == set(want_m)
    assert _max_rel(got_m, want_m) <= TOL
    train_step(state, _torch_batch(runs["batch"]))  # and it trains on
    assert state.step == 3


def test_cli_trains_on_the_model_axis(runs):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    rnntransducer_tpu_torch.cli.train --model_parallel 2``: two steps, and
    the checkpoint holds the whole fc."""
    payload = CheckpointManager(os.path.join(runs["root"], "cli")).load()
    assert payload["step"] == 2
    assert tuple(payload["params"]["joint.fc.weight"].shape) == (V, 24)
    assert all(not r["jax_imported"] for w in (2, 4) for r in runs["ranks"][w])


# ---------------------------------------------------------------------------
# the refusals, in one process
# ---------------------------------------------------------------------------


def _fake_mesh(**axes):
    shape = {"data": 1, **axes}
    return pmesh.Mesh(shape, dict.fromkeys(shape, 0), {}, {}, {})


def test_mesh_refusals_have_the_jax_texts():
    for kw, axes in ((dict(model_parallel=2), "model=2"),
                     (dict(pipeline_stages=2, model_parallel=3), "stage=2 x model=3"),
                     (dict(sequence_parallel=4), "time=4")):
        with pytest.raises(ValueError, match=f"^1 devices not divisible by {axes}$"):
            pmesh.make_mesh(**kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pmesh.make_mesh(pipeline_stages=2, sequence_parallel=2)
    assert pmesh.mesh_shape(2, 2, 1, world=8) == {"data": 2, "stage": 2, "model": 2}
    assert pmesh.mesh_shape(1, 1, 4, world=8) == {"data": 2, "time": 4}
    assert pmesh.vocab_sizes(57, 2) == [29, 28]


def test_schedule_refusals_have_the_jax_texts():
    """The JAX package's refusals, with its texts: the pipeline's L % D,
    B % M, input_size > dirs*H and time reduction; the wavefront's
    bidirectional encoder, time reduction and T % D; the parallel encode's
    Conformer and unfused loss path."""
    flax = _flax(_model("gru", 2, True), 5)
    sd = {k[len("encoder.rnn."):]: v for k, v in _sd(_model("gru", 2, True), flax).items()
          if k.startswith("encoder.rnn.")}
    x, n = torch.zeros(4, 16, F), torch.full((4,), 16)
    stage3 = _fake_mesh(stage=3)
    with pytest.raises(ValueError, match="num_layers=2 not divisible by stage-mesh width 3"):
        ppipe.pipeline_scan(sd, x, n, rnn_type="gru", num_layers=2, bidirectional=True,
                            mesh=stage3, num_microbatches=2)
    with pytest.raises(ValueError, match="batch 4 not divisible by num_microbatches 3"):
        ppipe.pipeline_scan(sd, x, n, rnn_type="gru", num_layers=2, bidirectional=True,
                            mesh=_fake_mesh(stage=2), num_microbatches=3)
    narrow = _model("gru", 2, False)
    narrow["transnet"]["hidden_size"] = 4
    nsd = {k[len("encoder.rnn."):]: v for k, v in _sd(narrow, _flax(narrow, 6)).items()
           if k.startswith("encoder.rnn.")}
    with pytest.raises(ValueError, match=r"input_size \(8\) <= dirs\*hidden \(4\)"):
        ppipe.pipeline_scan(nsd, x, n, rnn_type="gru", num_layers=2, bidirectional=False,
                            mesh=_fake_mesh(stage=2), num_microbatches=2)
    reduced = pcfg.TransNetConfig(**dict(_model()["transnet"], time_reduction_stride=2))
    with pytest.raises(ValueError, match="stage pipelining does not support time reduction"):
        ppipe.pipeline_encode({}, reduced, x, n, _fake_mesh(stage=2), 2)
    with pytest.raises(ValueError, match="needs a unidirectional encoder"):
        pwave.wavefront_encode({}, pcfg.TransNetConfig(**_model()["transnet"]), x, n,
                               _fake_mesh(time=2))
    uni_reduced = pcfg.TransNetConfig(**dict(_model("gru", 2, False)["transnet"],
                                             time_reduction_stride=2))
    with pytest.raises(ValueError, match="does not support time reduction"):
        pwave.wavefront_encode({}, uni_reduced, x, n, _fake_mesh(time=2))
    with pytest.raises(ValueError, match="T=16 not divisible by time-mesh width 3"):
        pwave.wavefront_scan(sd, x, n, rnn_type="gru", num_layers=2, mesh=_fake_mesh(time=3))
    assert pwave.pad_time_to_multiple(torch.zeros(2, 29, 3), 8).shape == (2, 32, 3)


def test_loss_fn_refusals_have_the_jax_texts():
    from rnntransducer_tpu_torch.train.state import loss_fn
    from rnntransducer_tpu_torch.models.transducer import build_model

    cfg = _config(pcfg, BI, pipeline_stages=2, joint_chunk_frames=0)
    model = build_model(cfg, "cpu", _sd(BI, _flax(BI, 1)), trainable=True)
    batch = _torch_batch(_batch(1))
    with pytest.raises(ValueError, match="need a factored or fused joint"):
        loss_fn(model, cfg, dict(model.named_parameters()), batch, None, True,
                mesh=_fake_mesh(stage=2))
    conformer = _config(pcfg, dict(BI, transnet=dict(BI["transnet"], arch="conformer",
                                                     hidden_size=16, attention_heads=2)),
                        sequence_parallel=2)
    with pytest.raises(ValueError, match="cover the RNN encoder family only"):
        loss_fn(build_model(conformer, "cpu", trainable=True), conformer, {}, batch, None,
                True, mesh=_fake_mesh(time=2))
    with pytest.raises(RuntimeError, match="needs a mesh with a 'stage' axis"):
        cfg2 = _config(pcfg, BI, pipeline_stages=2)
        loss_fn(model, cfg2, dict(model.named_parameters()), batch, None, True,
                mesh=_fake_mesh(time=2))


def test_optimizer_placement_on_the_model_axis():
    """The joint fc's moments keep their vocabulary placement (no ZeRO split
    of a model-sharded leaf, as the JAX package's TP rules), every other
    leaf splits as before; adafactor keeps its statistics whole and sums
    the fc's over the model group (``row_split`` on the two fc leaves, with
    the whole vocabulary's rows)."""
    from rnntransducer_tpu_torch.models.transducer import build_model
    from rnntransducer_tpu_torch.train.optim import Adafactor, make_train_optimizer

    cfg = _config(pcfg, BI, optimizer="adafactor", model_parallel=2)
    named = list(build_model(cfg, "cpu", _sd(BI, _flax(BI, 1)),
                             trainable=True).named_parameters())
    opt = make_train_optimizer(cfg.train, cfg.model, named, _fake_mesh(model=2))
    assert isinstance(opt, Adafactor)
    params = dict(named)
    assert {id(p) for p in opt.row_split} == {id(params[n]) for n in pmesh.TP_LEAVES}
    assert {rows for rows, _ in opt.row_split.values()} == {V}
    plain = pmesh.zero_split_dims(cfg.model, dict(named), 2, "adamw")
    sharded = pmesh.zero_split_dims(cfg.model, dict(named), 2, "adamw",
                                    vocab_sharded=True)
    assert plain["joint.fc.weight"] is not None  # its 24 columns split; V = 57 not
    assert all(sharded[name] is None for name in pmesh.TP_LEAVES)
    assert {k: v for k, v in plain.items() if k not in pmesh.TP_LEAVES} == {
        k: v for k, v in sharded.items() if k not in pmesh.TP_LEAVES}


def test_only_the_stage_axis_zero_fills_unreached_grads():
    """On a stage axis another stage's encoder layers get zero grads; any
    other leaf the loss does not reach is an error there, and on every
    other mesh the single device's autograd error stands."""
    from rnntransducer_tpu_torch.train.state import _grads

    names = ("encoder.rnn.fwd.1.w_hh", "joint.fc.bias", "prednet.x")
    leaves = [torch.ones(2, requires_grad=True) for _ in names]
    got = _grads((3 * leaves[1]).sum(), _fake_mesh(stage=2), names[:2], leaves[:2])
    assert [g.tolist() for g in got] == [[0.0, 0.0], [3.0, 3.0]]
    with pytest.raises(RuntimeError, match="does not reach"):
        _grads((3 * leaves[1]).sum(), _fake_mesh(stage=2), names, leaves)
    for mesh in (_fake_mesh(), _fake_mesh(model=2), _fake_mesh(time=2)):
        with pytest.raises(RuntimeError, match="not have been used in the graph"):
            _grads((3 * leaves[1]).sum(), mesh, names[:2], leaves[:2])
