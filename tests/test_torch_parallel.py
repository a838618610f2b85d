"""The port's data axis (``rnntransducer_tpu_torch/parallel/``) on the CPU:
real processes over gloo, against one port process at the global batch and
against the JAX Trainer on a one-device mesh from the same flax weights.

One module fixture runs every multi-process job once, all at the same time:
two worker ranks (a script written under the fixture's directory, which
imports no JAX) through a sequence of runs, the train CLI under torchrun
(on synthetic data, and on raw shards that rank 0 prepares), and the CLI
with explicit flags with one rank sent SIGTERM.  The tests read
what the jobs wrote.  Dropout, weight noise and SpecAugment are off in the
parity runs; tolerances are 1e-5 relative for losses (tests/
test_torch_trainer.py)."""

import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import jax
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.data import SyntheticAudioDataset as JaxSynthetic
from rnntransducer_tpu.parallel import distributed as jax_distributed
from rnntransducer_tpu.parallel import make_mesh, tree_shardings
from rnntransducer_tpu.parallel.mesh import DATA_AXIS as JAX_DATA_AXIS
from rnntransducer_tpu.parallel.mesh import _path_keys
from rnntransducer_tpu.train import Trainer as JaxTrainer
from rnntransducer_tpu.train.state import TrainState as JaxTrainState

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch import parallel
from rnntransducer_tpu_torch.data import SyntheticAudioDataset
from rnntransducer_tpu_torch.models.transducer import build_model
from rnntransducer_tpu_torch.train import TrainState, Trainer, loss_fn
from rnntransducer_tpu_torch.utils.weights import (flax_layout, random_flax_params,
                                                   state_dict_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
JOB_TIMEOUT_S = 300
DATA_KW = dict(min_sec=0.3, max_sec=1.2, min_labels=3, max_labels=10)
B = 2  # rows per rank; one process runs 2 * B


def _cfg(module, checkpoint_dir, **train):
    """tests/test_torch_trainer.py's ``_tiny_narrow``: tiny_config() at H=32,
    one layer, fp32, no dropout, no SpecAugment, one audio and one label
    bucket, 3 steps of 2B rows, a small learning rate so that the greedy
    decode emits labels."""
    cfg = module.tiny_config()
    m = cfg.model
    model = dataclasses.replace(
        m, transnet=dataclasses.replace(m.transnet, hidden_size=32, output_size=16,
                                        num_layers=1, dropout=0.0),
        prednet=dataclasses.replace(m.prednet, hidden_size=32, output_size=16,
                                    num_layers=1, dropout=0.0))
    data = dataclasses.replace(
        cfg.data, audio=dataclasses.replace(cfg.data.audio, spec_augment=False),
        audio_buckets=(128,), label_buckets=(16,))
    kw = dict(precision="fp32", max_steps=3, per_device_train_batch_size=2 * B,
              per_device_eval_batch_size=2 * B, log_every_steps=1, val_every_steps=100,
              checkpoint_dir=str(checkpoint_dir), learning_rate=1e-5, seed=5)
    kw.update(train)
    return dataclasses.replace(cfg, model=model, data=data,
                               train=dataclasses.replace(cfg.train, **kw))


def _datasets(audio):
    return (SyntheticAudioDataset(16, audio, seed=1, **DATA_KW),
            SyntheticAudioDataset(5, audio, seed=2, **DATA_KW))


def _logs(directory):
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(directory):
    return {r["step"]: r["loss"] for r in _logs(directory) if r.get("split") == "train"}


def _val(directory):
    return [r for r in _logs(directory) if r.get("split") == "val"][-1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fit_single(cfg, sd, resume=False):
    train_ds, val_ds = _datasets(cfg.data.audio)
    trainer = Trainer(cfg, train_ds, val_dataset=val_ds, device="cpu", state_dict=sd)
    trainer.fit(resume=resume)
    return trainer


# ---------------------------------------------------------------------------
# the worker: one rank of two, through every run the tests read
# ---------------------------------------------------------------------------

_WORKER = r'''
import dataclasses, json, os, shutil, sys
import torch

torch.set_num_threads(1)
port, r, root = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from rnntransducer_tpu_torch import parallel
from rnntransducer_tpu_torch.config import Config
from rnntransducer_tpu_torch.data import SyntheticAudioDataset
from rnntransducer_tpu_torch.parallel.distributed import host_all_gather, host_all_reduce
from rnntransducer_tpu_torch.train import TrainState, Trainer

topology = parallel.initialize("127.0.0.1:" + port, 2, r, device="cpu", timeout_s=120)
base = Config.from_json(os.path.join(root, "cfg.json"))
sd = torch.load(os.path.join(root, "init.pt"))
kw = dict(min_sec=0.3, max_sec=1.2, min_labels=3, max_labels=10)
mine = {"topology": topology}


def cfg_of(name, dropout=False, **train):
    cfg = base
    if dropout:
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, transnet=dataclasses.replace(m.transnet, dropout=0.2),
            prednet=dataclasses.replace(m.prednet, dropout=0.2)),
            data=dataclasses.replace(cfg.data, audio=dataclasses.replace(
                cfg.data.audio, spec_augment=True)))
        # a schedule that does not depend on max_steps, so a run stopped at
        # step 2 and resumed to 4 follows the uninterrupted run's
        train.update(lr_schedule="constant", warmup_ratio=0.0)
    train.setdefault("checkpoint_dir", os.path.join(root, name))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, per_device_train_batch_size=B, per_device_eval_batch_size=B, **train))


def fit(cfg, resume=False, val=True):
    train_ds = SyntheticAudioDataset(16, cfg.data.audio, seed=1, **kw)
    val_ds = SyntheticAudioDataset(5, cfg.data.audio, seed=2, **kw) if val else None
    trainer = Trainer(cfg, train_ds, val_dataset=val_ds, device="cpu", state_dict=sd)
    trainer.fit(resume=resume)
    return trainer


def save_params(trainer, name):
    if r == 0:
        torch.save(trainer.state.model.state_dict(), os.path.join(root, name + ".pt"))


def barrier():
    host_all_reduce([0.0])


B = int(sys.argv[4])
for opt in ("adamw", "lion", "sgd", "adafactor"):
    for zero in (False, True):
        name = f"{opt}_{'zero' if zero else 'rep'}"
        trainer = fit(cfg_of(name, optimizer=opt, shard_optimizer_state=zero,
                             learning_rate=1e-5 if opt == "adamw" else 1e-4),
                      val=opt == "adamw")
        save_params(trainer, name)
        opt_obj = trainer.state.optimizer
        mine[name] = {"optimizer": type(opt_obj).__name__,
                      "moment_bytes": parallel.moment_bytes(opt_obj),
                      "state_shapes": sorted(
                          [k, list(v.shape)] for st in opt_obj.state.values()
                          for k, v in st.items() if torch.is_tensor(v) and v.dim())}

# a ZeRO checkpoint at step 2, kept aside (for a W = 1 restore), then resumed
# to step 4 at W = 2
fit(cfg_of("ckpt", shard_optimizer_state=True, max_steps=2), val=False)
if r == 0:
    shutil.copytree(os.path.join(root, "ckpt"), os.path.join(root, "ckpt_at_2"))
barrier()
save_params(fit(cfg_of("ckpt", shard_optimizer_state=True, max_steps=4), resume=True,
                val=False), "ckpt")

# dropout and SpecAugment on: uninterrupted to 4, and 2 then resumed to 4
save_params(fit(cfg_of("dropout_whole", dropout=True, max_steps=4), val=False),
            "dropout_whole")
fit(cfg_of("dropout_resumed", dropout=True, max_steps=2), val=False)
save_params(fit(cfg_of("dropout_resumed", dropout=True, max_steps=4), resume=True,
                val=False), "dropout_resumed")

# a one-process checkpoint (written before the workers started) resumed at W = 2
save_params(fit(cfg_of("from_w1", shard_optimizer_state=True, max_steps=4,
                       checkpoint_dir=os.path.join(root, "w1")), resume=True, val=False),
            "from_w1")

# the two streams: weight noise shared, masks per rank
state = TrainState.create(cfg_of("streams", dropout=True), "cpu", state_dict=sd)
noise = torch.randn(4096, generator=state.noise_generator)
masks = torch.rand(4096, generator=state.generator) < 0.5
noises, maskss = host_all_gather(noise), host_all_gather(masks)
mine["noise_equal"] = bool(torch.equal(noises[0], noises[1]))
mine["mask_agreement"] = float((maskss[0] == maskss[1]).float().mean())
mine["mask_keep"] = float(masks.float().mean())

mine["jax_imported"] = any(m.split(".")[0] in ("jax", "flax", "rnntransducer_tpu")
                           for m in sys.modules)
with open(os.path.join(root, f"rank{r}.json"), "w") as f:
    json.dump(mine, f)
parallel.shutdown()
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _popen(args, log, **kw):
    return subprocess.Popen(args, stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            env=_env(), cwd=REPO, **kw)


def _cli_cfg(root):
    """The CLI's synthetic utterances are 1-8 s with up to 48 labels."""
    cfg = _cfg(pcfg, root, per_device_train_batch_size=B, per_device_eval_batch_size=B)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, audio_buckets=(400, 801), label_buckets=(48,)))
    path = os.path.join(root, "cli_config.json")
    cfg.to_json(path)
    return path


def _raw_corpus(root):
    """Raw PCM shards for the CLI's ``--hf_data_dirs``: a train split of 8
    synthetic utterances and a dev split of 3, no eval splits."""
    from datasets import Dataset
    for split, n, seed in (("train", 8, 1), ("dev", 3, 2)):
        ds = SyntheticAudioDataset(n, pcfg.AudioConfig(), seed=seed, as_waveform=True,
                                   **DATA_KW)
        items = [ds[i] for i in range(n)]
        Dataset.from_dict({"input_values": [it["wav"] for it in items],
                           "input_ids": [it["labels"].tolist() for it in items]}
                          ).save_to_disk(os.path.join(root, split, "0"))
    return root


def _sigterm_when_training(log_dir, proc, out, deadline):
    """SIGTERM ``proc`` (rank 1) once rank 0 has logged two train steps."""
    path = os.path.join(log_dir, "metrics.jsonl")
    while time.time() < deadline and proc.poll() is None:
        if os.path.exists(path):
            with open(path) as f:
                steps = [json.loads(line)["step"] for line in f
                         if '"split": "train"' in line]
            if steps and max(steps) >= 2:
                proc.send_signal(signal.SIGTERM)
                out["sent_after_step"] = max(steps)
                return
        time.sleep(0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    cfg = _cfg(pcfg, os.path.join(root, "single"))
    flax = random_flax_params(cfg.model, torch.Generator().manual_seed(7))
    sd = state_dict_from_flax(flax, cfg.model)
    torch.save(sd, os.path.join(root, "init.pt"))
    cfg.to_json(os.path.join(root, "cfg.json"))
    # a one-process checkpoint at step 2 for the workers to resume at W = 2,
    # and its copy for this process to resume alone
    w1 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_steps=2, checkpoint_dir=os.path.join(root, "w1")))
    _fit_single(w1, sd)
    shutil.copytree(os.path.join(root, "w1"), os.path.join(root, "w1_alone"))
    worker = os.path.join(root, "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)

    port = _free_port()
    procs = {f"rank{r}": _popen([sys.executable, worker, str(port), str(r), root,
                                 str(B)], os.path.join(root, f"rank{r}.log"))
             for r in range(2)}
    cli = [sys.executable, "-m", "rnntransducer_tpu_torch.cli.train", "--config",
           _cli_cfg(root), "--synthetic", "8", "--device", "cpu"]
    procs["torchrun"] = _popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port())] + cli[1:] + ["--max_steps", "2", "--checkpoint_dir",
                                         os.path.join(root, "torchrun")],
        os.path.join(root, "torchrun.log"))
    # the CLI on --hf_data_dirs under torchrun: rank 0 prepares, rank 1 waits
    procs["prepare"] = _popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "rnntransducer_tpu_torch.cli.train", "--config",
         os.path.join(root, "cfg.json"), "--device", "cpu", "--hf_data_dirs",
         _raw_corpus(os.path.join(root, "raw")), "--pl_data_dir",
         os.path.join(root, "logmel"), "--num_shards", "2", "--max_steps", "2",
         "--per_device_train_batch_size", str(B), "--per_device_eval_batch_size",
         str(B), "--checkpoint_dir", os.path.join(root, "prepare")],
        os.path.join(root, "prepare.log"))
    term_port = _free_port()
    for r in range(2):
        procs[f"term{r}"] = _popen(
            cli + ["--max_steps", "100000", "--checkpoint_dir",
                   os.path.join(root, "term"), "--coordinator_address",
                   f"127.0.0.1:{term_port}", "--num_processes", "2",
                   "--process_id", str(r)], os.path.join(root, f"term{r}.log"))
    deadline = time.time() + JOB_TIMEOUT_S
    sent = {}
    watcher = threading.Thread(target=_sigterm_when_training, daemon=True, args=(
        os.path.join(root, "term"), procs["term1"], sent, deadline))
    watcher.start()
    try:
        # meanwhile, in this process: one port process at 2B, the JAX
        # Trainer at 2B on one device, the one-process resume of w1
        torch.save(_fit_single(cfg, sd).state.model.state_dict(),
                   os.path.join(root, "single.pt"))
        _fit_single(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, max_steps=4, checkpoint_dir=os.path.join(root, "w1_alone"))),
            sd, resume=True)
        jax_cfg = _cfg(jcfg, os.path.join(root, "jax"))
        jtr = JaxTrainer(jax_cfg, JaxSynthetic(16, jax_cfg.data.audio, seed=1, **DATA_KW),
                         val_dataset=JaxSynthetic(5, jax_cfg.data.audio, seed=2, **DATA_KW),
                         mesh=make_mesh(devices=jax.devices()[:1]))
        jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                                    flax))
        jtr.fit()
        jtr.ckpt.close()
        rcs = {}
        for name, p in procs.items():
            rcs[name] = p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        watcher.join(timeout=5)
    logs = {name: open(os.path.join(root, f"{name}.log")).read() for name in procs}
    for name in ("rank0", "rank1"):
        assert rcs[name] == 0, f"{name} failed:\n{logs[name]}"
    # the W = 2 ZeRO checkpoint of step 2, resumed by one process to step 4
    _fit_single(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_steps=4, checkpoint_dir=os.path.join(root, "ckpt_at_2"))), sd,
        resume=True)
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(2)]
    return dict(root=root, rcs=rcs, logs=logs, ranks=ranks, sigterm=sent)


def _params(root, name):
    return torch.load(os.path.join(root, name + ".pt"))


def _max_rel(got, want):
    """max |got - want| over all params, relative to the largest |want|."""
    return max((got[k] - want[k]).abs().max().item() / want[k].abs().max().item()
               for k in want)


def _close_losses(got, want):
    assert sorted(got) == sorted(want)
    for s in want:
        assert abs(got[s] - want[s]) <= REL * abs(want[s]), (s, got[s], want[s])


# ---------------------------------------------------------------------------
# start-up and the data axis in one process
# ---------------------------------------------------------------------------


def test_initialize_without_arguments_or_environment_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    got = parallel.initialize()
    want = jax_distributed.initialize()
    assert set(got) == set(want)
    assert (got["process_index"], got["process_count"]) == (0, 1)
    assert (want["process_index"], want["process_count"]) == (0, 1)
    assert not parallel.is_initialized()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    parallel.shutdown()  # a no-op too
    with pytest.raises(ValueError, match="go together"):
        parallel.initialize("127.0.0.1:1", 2)


def test_local_rows_refuse_unequal_shares():
    idxs = np.arange(8)
    assert parallel.local_rows(idxs, 1, 4).tolist() == [1, 5]
    with pytest.raises(ValueError, match="does not split"):
        parallel.local_rows(np.arange(6), 0, 4)
    grads = [torch.ones(3)]
    assert parallel.all_reduce_mean(grads) is grads  # no process group


def _batches_as(trainer, ds, r, world, n=4):
    """_host_batches under a simulated place on the data axis (the port of
    tests/test_multihost_lockstep.py's ``_batches_as``)."""
    trainer.rank, trainer.world = r, world
    try:
        out = []
        for batch in trainer._host_batches(ds, epoch=0, batch_size=8):
            out.append(batch)
            if len(out) >= n:
                break
        return out
    finally:
        trainer.rank, trainer.world = 0, 1


def _lockstep_cfg(tmp_path):
    return _cfg(pcfg, tmp_path / "ckpt", per_device_train_batch_size=1)


def test_ranks_dispatch_identical_shapes_and_partition(tmp_path):
    """Every rank sees the same batch count and shapes, and interleaving the
    ranks' rows rebuilds the one-process batch (test_multihost_lockstep.py:73)."""
    cfg = dataclasses.replace(_lockstep_cfg(tmp_path), data=dataclasses.replace(
        _lockstep_cfg(tmp_path).data, audio_buckets=(64, 128), label_buckets=(16, 24)))
    ds = SyntheticAudioDataset(24, pcfg.AudioConfig(), seed=0, **DATA_KW)
    trainer = Trainer(cfg, ds, device="cpu")
    single = _batches_as(trainer, ds, 0, 1)
    p0, p1 = _batches_as(trainer, ds, 0, 2), _batches_as(trainer, ds, 1, 2)
    assert len(single) == len(p0) == len(p1) == 4
    for sb, b0, b1 in zip(single, p0, p1):
        for k in sb:
            assert b0[k].shape == b1[k].shape, k
            assert b0[k].shape[0] * 2 == sb[k].shape[0], k
            rebuilt = np.empty_like(sb[k])
            rebuilt[0::2], rebuilt[1::2] = b0[k], b1[k]
            np.testing.assert_array_equal(rebuilt, sb[k], err_msg=k)


@pytest.mark.parametrize("with_label_lengths", [True, False])
def test_label_bucket_comes_from_the_global_batch(tmp_path, with_label_lengths):
    """One long label in one rank's rows forces the wider label bucket on
    both ranks (test_multihost_lockstep.py:103); without label_lengths()
    every rank reads the global batch's labels."""
    cfg = dataclasses.replace(_lockstep_cfg(tmp_path), data=dataclasses.replace(
        _lockstep_cfg(tmp_path).data, audio_buckets=(64, 128), label_buckets=(16, 24)))
    base = SyntheticAudioDataset(8, pcfg.AudioConfig(), min_sec=0.3, max_sec=0.6,
                                 min_labels=3, max_labels=5, seed=1)
    rng = np.random.RandomState(0)

    class Spiked:
        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            item = dict(base[i])
            if i == 0:
                item["labels"] = rng.randint(1, 70, size=(20,)).astype(np.int32)
            return item

        def lengths(self):
            return base.lengths()

    if with_label_lengths:
        Spiked.label_lengths = lambda self: np.where(
            np.arange(len(base)) == 0, 20, base.label_lengths())
    ds = Spiked()
    trainer = Trainer(cfg, ds, device="cpu")
    shapes = [[b["targets"].shape for b in _batches_as(trainer, ds, r, 2, n=8)]
              for r in range(2)]
    assert shapes[0] == shapes[1]
    assert any(s[1] == 24 for s in shapes[0])


def _jax_zero_cfg(optimizer):
    """A 3-layer scanned GRU encoder whose out_proj is square (a tie the
    placement breaks in flax order) on tiny_config()'s prediction network."""
    d = dict(hidden_size=48, output_size=96, num_layers=3, dropout=0.0)
    out = []
    for module in (jcfg, pcfg):
        cfg = module.tiny_config()
        m = cfg.model
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(
                m, transnet=dataclasses.replace(m.transnet, rnn_type="gru",
                                                scan_layers=True, **d)),
            train=dataclasses.replace(cfg.train, optimizer=optimizer,
                                      shard_optimizer_state=True)))
    return out


@pytest.mark.parametrize("optimizer, world", [
    ("adamw", 2), ("adamw", 4), ("lion", 2), ("sgd", 4), ("adafactor", 2)])
def test_zero_placement_matches_the_jax_package(optimizer, world):
    """The ZeRO-1 rule splits the same moments on the same dims as the JAX
    package's ``tree_shardings(..., shard_opt_over_data=True)`` on a data
    mesh of ``world`` devices, mapped through utils/weights.py; adafactor's
    statistics stay whole."""
    jax_cfg, cfg = _jax_zero_cfg(optimizer)
    state = JaxTrainState.create(jax_cfg)
    shardings = tree_shardings(make_mesh(devices=jax.devices()[:world]), state,
                               shard_opt_over_data=True)
    layout = {}
    for path, key, index, transpose in flax_layout(cfg.model):
        layout.setdefault(path, []).append((key, index, transpose))
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        keys = _path_keys(path)
        moment = [i for i, k in enumerate(keys) if k in ("mu", "nu", "trace")]
        if keys[0] != "opt_state" or not moment:
            continue
        spec = tuple(sharding.spec)
        dim = spec.index(JAX_DATA_AXIS) if JAX_DATA_AXIS in spec else None
        for key, index, transpose in layout[keys[moment[0] + 1:]]:
            port = dim
            if dim is not None and index is not None:
                assert dim > 0, "the JAX rule split a stack's layer axis"
                port = dim - 1
            if dim is not None and transpose:
                port = 1 - port
            assert want.setdefault(key, port) == port
    model = build_model(cfg, "cpu", trainable=True)
    got = parallel.zero_split_dims(cfg.model, dict(model.named_parameters()), world,
                                   optimizer)
    if optimizer == "adafactor":
        assert not want and set(got.values()) == {None}
        return
    assert got == want
    assert sum(d is not None for d in got.values()) > len(got) // 2
    assert got["encoder.out_proj.weight"] == 1  # the tie, in flax order


def test_weight_noise_and_masks_draw_from_their_own_streams():
    """``loss_fn`` draws weight noise from the noise generator and masks from
    the mask generator: with only weight noise on, the loss depends on the
    noise stream alone; with only dropout on, on the mask stream alone."""
    cfg = _cfg(pcfg, "unused")
    ds = SyntheticAudioDataset(2, cfg.data.audio, seed=1, **DATA_KW)
    from rnntransducer_tpu_torch.data.collate import collate
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in collate(
        [ds[0], ds[1]], max_frames=128, max_labels=16,
        pad_id=cfg.data.text.pad_token_id).items()}

    def loss(c, mask_seed, noise_seed):
        model = build_model(c, "cpu", trainable=True)
        with torch.no_grad():
            return float(loss_fn(model, c, dict(model.named_parameters()), batch,
                                 torch.Generator().manual_seed(mask_seed), False,
                                 noise_generator=torch.Generator().manual_seed(noise_seed)))

    noisy = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               weight_noise_std=0.05))
    assert loss(noisy, 1, 3) == loss(noisy, 2, 3) != loss(noisy, 1, 4)
    m = cfg.model
    dropped = dataclasses.replace(
        cfg, model=dataclasses.replace(
            m, transnet=dataclasses.replace(m.transnet, dropout=0.3),
            prednet=dataclasses.replace(m.prednet, dropout=0.3)),
        data=dataclasses.replace(cfg.data, audio=dataclasses.replace(
            cfg.data.audio, spec_augment=True)))
    assert loss(dropped, 1, 3) == loss(dropped, 1, 4) != loss(dropped, 2, 3)
    # one process draws the masks it always drew: rank 0's seed is the seed
    state = TrainState.create(cfg, "cpu", seed=11)
    assert state.generator.initial_seed() == state.noise_generator.initial_seed() == 11


def test_preemption_follows_the_agreed_flag(tmp_path, monkeypatch):
    """A SIGTERM landing on a rank after its flag went into the agreement
    (here: while the all-reduce runs) does not stop that rank alone: every
    rank follows the agreed value, so none skips a collective the others
    make."""
    from rnntransducer_tpu_torch.parallel import distributed

    trainer = Trainer(_lockstep_cfg(tmp_path), _datasets(pcfg.AudioConfig())[0],
                      device="cpu")
    trainer._preempted = None

    def agreement_before_the_signal(values, op="sum"):
        trainer._preempted = "SIGTERM"
        return torch.zeros(1, dtype=torch.float64)

    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "host_all_reduce", agreement_before_the_signal)
    assert trainer._agree_preempted() is False
    monkeypatch.setattr(distributed, "host_all_reduce",
                        lambda values, op="sum": torch.tensor([float(signal.SIGTERM)]))
    trainer._preempted = None
    assert trainer._agree_preempted() is True and trainer._preempted == "SIGTERM"


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------


def test_workers_import_no_jax_and_report_their_topology(runs):
    for r, mine in enumerate(runs["ranks"]):
        assert not mine["jax_imported"]
        assert mine["topology"] == {"process_index": r, "process_count": 2,
                                    "local_devices": 1, "global_devices": 2}


def test_two_ranks_match_one_process_at_the_global_batch(runs):
    """W = 2 at B rows each: the per-step losses and the final params hold
    one port process at 2B rows."""
    root = runs["root"]
    _close_losses(_losses(os.path.join(root, "adamw_rep")),
                  _losses(os.path.join(root, "single")))
    single = _params(root, "single")
    assert _max_rel(_params(root, "adamw_rep"), single) <= REL
    # validation decodes each rank's rows and sums the counts
    got, want = _val(os.path.join(root, "adamw_rep")), _val(os.path.join(root, "single"))
    assert (got["val_wer"], got["val_cer"]) == (want["val_wer"], want["val_cer"])
    assert abs(got["val_loss"] - want["val_loss"]) <= REL * abs(want["val_loss"])


def test_two_ranks_match_the_jax_trainer(runs):
    """The W = 2 run's logged losses and validation loss hold the JAX
    Trainer's at per-device 2B on one device, from the same flax weights;
    validation WER and CER are equal."""
    root = runs["root"]
    got, want = os.path.join(root, "adamw_rep"), os.path.join(root, "jax")
    _close_losses(_losses(got), _losses(want))
    g, w = _val(got), _val(want)
    assert (g["val_wer"], g["val_cer"]) == (w["val_wer"], w["val_cer"])
    assert w["val_cer"] not in (0.0, 1.0)  # transcripts, not all blank
    assert abs(g["val_loss"] - w["val_loss"]) <= REL * abs(w["val_loss"])


@pytest.mark.parametrize("optimizer", ["adamw", "lion", "sgd"])
def test_zero_equals_replicated(runs, optimizer):
    """ZeRO-1 at W = 2 gives the replicated W = 2 run's params bit for bit
    and its losses, with about half the moment bytes on each rank."""
    root = runs["root"]
    rep, zero = _params(root, f"{optimizer}_rep"), _params(root, f"{optimizer}_zero")
    diff = max((rep[k] - zero[k]).abs().max().item() for k in rep)
    print(f"{optimizer}: max |ZeRO - replicated| = {diff}")
    assert diff == 0.0
    assert (_losses(os.path.join(root, f"{optimizer}_zero"))
            == _losses(os.path.join(root, f"{optimizer}_rep")))
    for mine in runs["ranks"]:
        assert mine[f"{optimizer}_zero"]["optimizer"] == "ShardedOptimizer"
        half = mine[f"{optimizer}_rep"]["moment_bytes"] / 2
        assert half <= mine[f"{optimizer}_zero"]["moment_bytes"] <= 1.05 * half


def test_adafactor_statistics_stay_whole_under_zero(runs):
    root = runs["root"]
    rep, zero = _params(root, "adafactor_rep"), _params(root, "adafactor_zero")
    assert all(torch.equal(rep[k], zero[k]) for k in rep)
    for mine in runs["ranks"]:
        assert mine["adafactor_zero"]["optimizer"] == "Adafactor"
        assert (mine["adafactor_zero"]["state_shapes"]
                == mine["adafactor_rep"]["state_shapes"])


def test_zero_checkpoint_restores_at_one_rank(runs):
    """The W = 2 ZeRO checkpoint of step 2 (the single-device layout) resumed
    by one process continues as the two ranks continue."""
    root = runs["root"]
    want = _losses(os.path.join(root, "ckpt"))
    got = _losses(os.path.join(root, "ckpt_at_2"))
    assert sorted(want) == [1, 2, 3, 4] and sorted(got) == [1, 2, 3, 4]
    _close_losses({s: got[s] for s in (3, 4)}, {s: want[s] for s in (3, 4)})
    state = torch.load(os.path.join(root, "ckpt", "4", "state.pt"))  # W = 2, ZeRO
    params = state["params"]
    for i, st in state["optimizer"]["state"].items():
        assert st["exp_avg"].shape == list(params.values())[i].shape
    assert len(state["generator"]) == 2


def test_one_rank_checkpoint_restores_at_two_ranks(runs):
    """A one-process checkpoint resumed by two ZeRO ranks continues as the
    one process continues."""
    root = runs["root"]
    got, want = _losses(os.path.join(root, "w1")), _losses(os.path.join(root, "w1_alone"))
    _close_losses({s: got[s] for s in (3, 4)}, {s: want[s] for s in (3, 4)})


def test_resume_with_dropout_equals_the_uninterrupted_run(runs):
    """Dropout and SpecAugment on at W = 2: a run stopped at step 2 and
    resumed continues as the uninterrupted run (every rank's mask generator
    is saved), to the bit."""
    root = runs["root"]
    whole, resumed = (_losses(os.path.join(root, "dropout_whole")),
                      _losses(os.path.join(root, "dropout_resumed")))
    assert sorted(whole) == [1, 2, 3, 4] and whole == resumed
    a, b = _params(root, "dropout_whole"), _params(root, "dropout_resumed")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_weight_noise_is_shared_and_masks_differ_across_ranks(runs):
    """4096 draws per rank: the noise streams are equal; the two ranks' keep
    masks (p = 0.5) agree about as often as independent ones (0.5, sd
    0.008), and each keeps about half."""
    r0, r1 = runs["ranks"]
    assert r0["noise_equal"] and r1["noise_equal"]
    assert abs(r0["mask_agreement"] - 0.5) < 0.04
    assert all(abs(m["mask_keep"] - 0.5) < 0.04 for m in (r0, r1))


# ---------------------------------------------------------------------------
# the train CLI across processes
# ---------------------------------------------------------------------------


def test_cli_under_torchrun(runs):
    """``python -m torch.distributed.run --nproc_per_node 2 -m ...cli.train
    --device cpu``: both ranks reach step 2 and exit 0; one checkpoint
    directory, one log."""
    root = runs["root"]
    out = runs["logs"]["torchrun"]
    assert runs["rcs"]["torchrun"] == 0, out
    for r in range(2):
        assert f"rank {r} of 2: done at step 2" in out, out
    ckpt = os.path.join(root, "torchrun")
    assert sorted(os.listdir(ckpt)) == ["2", "checkpoint_metrics.json", "config.json",
                                        "metrics.jsonl"]
    assert [r["step"] for r in _logs(ckpt) if r.get("split") == "train"] == [1, 2]


def test_cli_under_torchrun_prepares_on_rank_0_only(runs):
    """``--hf_data_dirs`` under torchrun with two ranks: rank 1 waits on the
    ``_PREPARED`` marker while rank 0 alone prepares (one "no source" line
    per missing split, one ledger entry per split), then both train to
    step 2 on the prepared shards."""
    from rnntransducer_tpu_torch.data import read_ledger
    root = runs["root"]
    out = runs["logs"]["prepare"]
    assert runs["rcs"]["prepare"] == 0, out
    for r in range(2):
        assert f"rank {r} of 2: done at step 2" in out, out
    logmel = os.path.join(root, "logmel")
    assert f"[prepare] process 1 waits on process 0 for {logmel}" in out, out
    assert "[prepare] process 0 waits" not in out
    for split in ("eval_clean", "eval_other"):
        assert out.count(f"[prepare] no source for split '{split}', skipping") == 1
    assert os.path.exists(os.path.join(logmel, "_PREPARED"))
    ledger = read_ledger(logmel)
    assert sorted(ledger) == ["dev", "train"]
    assert all(list(tasks) == ["logmel"] for tasks in ledger.values())
    assert sorted(os.listdir(os.path.join(logmel, "train"))) == ["0", "1", "_SUCCESS"]
    assert [r["step"] for r in _logs(os.path.join(root, "prepare"))
            if r.get("split") == "train"] == [1, 2]


def test_cli_sigterm_to_one_rank_stops_both_at_one_step(runs):
    """The CLI started by hand (``--coordinator_address --num_processes
    --process_id``): rank 1 is sent SIGTERM; both ranks stop at the same
    step, exit 0, and rank 0 checkpoints that step."""
    assert runs["sigterm"].get("sent_after_step", 0) >= 2
    steps = []
    for r in range(2):
        out = runs["logs"][f"term{r}"]
        assert runs["rcs"][f"term{r}"] == 0, out
        line = [x for x in out.splitlines() if f"rank {r} of 2: done at step" in x]
        assert line, out
        steps.append(int(line[0].split("done at step ")[1].split(";")[0]))
    assert steps[0] == steps[1] >= runs["sigterm"]["sent_after_step"]
    ckpt = os.path.join(runs["root"], "term")
    logs = _logs(ckpt)
    assert any(r.get("event") == "preempted" and r["step"] == steps[0] for r in logs)
    assert str(steps[0]) in os.listdir(ckpt)
