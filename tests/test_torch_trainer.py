"""The port's Trainer (train/loop.py) and train CLI (cli/train.py) on the
CPU: parity with the JAX package's Trainer from the same weights on the same
data, and mirrors of tests/test_trainer_loop.py (fit, validate, checkpoint,
resume, the data schedule, preemption, histograms, raw PCM)."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import jax
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.data import SyntheticAudioDataset as JaxSynthetic
from rnntransducer_tpu.parallel import make_mesh
from rnntransducer_tpu.train import Trainer as JaxTrainer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.cli import train as cli
from rnntransducer_tpu_torch.data import LengthBucketSampler, SyntheticAudioDataset
from rnntransducer_tpu_torch.train import Trainer
from rnntransducer_tpu_torch.utils.weights import random_flax_params, state_dict_from_flax


def _cfg(tmp_path, max_steps=4, module=pcfg, **train):
    """The JAX package's trainer-test config (tests/test_trainer_loop.py),
    in either package's config classes."""
    kw = dict(max_steps=max_steps, per_device_train_batch_size=1,
              per_device_eval_batch_size=2, precision="fp32", log_every_steps=1,
              val_every_steps=100, checkpoint_dir=str(tmp_path / "ckpt"),
              learning_rate=1e-3)
    kw.update(train)
    return module.Config(
        data=module.DataConfig(audio=module.AudioConfig(spec_augment=True),
                               audio_buckets=(64, 128), label_buckets=(16, 24)),
        model=module.ModelConfig(
            transnet=module.TransNetConfig(input_size=80, hidden_size=16,
                                           output_size=12, num_layers=1,
                                           rnn_type="gru", dropout=0.0,
                                           bidirectional=True),
            prednet=module.PredNetConfig(embedding_size=72, hidden_size=16,
                                         output_size=12, num_layers=1,
                                         rnn_type="lstm", dropout=0.0),
            jointnet=module.JointNetConfig(num_classes=72)),
        train=module.TrainConfig(**kw))


def _ds(n=12, seed=0, **kw):
    return SyntheticAudioDataset(n, pcfg.AudioConfig(), min_sec=0.3, max_sec=1.2,
                                 min_labels=3, max_labels=10, seed=seed, **kw)


def _logs(cfg):
    path = os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl")
    return [json.loads(line) for line in open(path)]


# ---------------------------------------------------------------------------
# parity with the JAX package's Trainer
# ---------------------------------------------------------------------------


def _tiny_narrow(module, tmp_path, name):
    """tiny_config() narrowed to H=32 and one layer, fp32, no dropout, no
    SpecAugment, one audio and one label bucket, 3 steps, batch 4; a small
    learning rate, so that the greedy decode still emits labels and WER /
    CER compare transcripts, not blanks."""
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
    train = dataclasses.replace(
        cfg.train, precision="fp32", max_steps=3, per_device_train_batch_size=4,
        per_device_eval_batch_size=3, log_every_steps=1, val_every_steps=100,
        checkpoint_dir=str(tmp_path / name), learning_rate=1e-5, seed=5)
    return dataclasses.replace(cfg, model=model, data=data, train=train)


def test_trainer_matches_the_jax_trainer(tmp_path):
    """Three fp32 steps from the same flax weights on the same synthetic data:
    the logged train losses and the validation loss agree to 1e-5 relative
    (one fp32 ulp of a loss near 344 is 3e-5), validation WER and CER are
    equal."""
    jax_cfg = _tiny_narrow(jcfg, tmp_path, "jax")
    cfg = _tiny_narrow(pcfg, tmp_path, "port")
    kw = dict(min_sec=0.3, max_sec=1.2, min_labels=3, max_labels=10)
    jtr = JaxTrainer(jax_cfg, JaxSynthetic(16, jax_cfg.data.audio, seed=1, **kw),
                     val_dataset=JaxSynthetic(5, jax_cfg.data.audio, seed=2, **kw),
                     mesh=make_mesh(devices=jax.devices()[:1]))
    # weights uniform in +-1/sqrt(fan-in), under which the decode emits labels
    flax = random_flax_params(cfg.model, torch.Generator().manual_seed(7))
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jax.numpy.asarray, flax))
    ptr = Trainer(cfg, SyntheticAudioDataset(16, cfg.data.audio, seed=1, **kw),
                  val_dataset=SyntheticAudioDataset(5, cfg.data.audio, seed=2, **kw),
                  device="cpu", state_dict=state_dict_from_flax(flax, cfg.model))
    jtr.fit()
    jtr.ckpt.close()
    ptr.fit()
    want = [r for r in _logs(jax_cfg) if r.get("split") in ("train", "val")]
    got = [r for r in _logs(cfg) if r.get("split") in ("train", "val")]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for g, w in zip(got[:3], want[:3]):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    assert abs(got[3]["val_loss"] - want[3]["val_loss"]) <= 1e-5 * abs(want[3]["val_loss"])
    assert (got[3]["val_wer"], got[3]["val_cer"]) == (want[3]["val_wer"], want[3]["val_cer"])
    assert want[3]["val_cer"] not in (0.0, 1.0)  # transcripts, not all blank


# ---------------------------------------------------------------------------
# mirrors of tests/test_trainer_loop.py
# ---------------------------------------------------------------------------


def test_fit_validate_checkpoint_resume(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, _ds(12), val_dataset=_ds(4, seed=9), device="cpu")
    state = trainer.fit()
    assert state.step == 4 and trainer.ckpt.latest_step() == 4
    val = trainer.validate(max_batches=1)
    assert np.isfinite(val["val_loss"]) and 0.0 <= val["val_cer"] <= 2.0
    logs = _logs(cfg)
    assert any(r.get("split") == "train" for r in logs)
    assert any(r.get("split") == "val" for r in logs)
    trainer2 = Trainer(_cfg(tmp_path, max_steps=6), _ds(12), device="cpu")
    assert trainer2.fit(resume=True).step == 6
    assert trainer2.restore_s and trainer2.ckpt.latest_step() == 6


class _RecordingDataset:
    """Records the index tuple of every batch fetched."""

    def __init__(self, base):
        self.base = base
        self.fetched = []
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.base)

    def lengths(self):
        return self.base.lengths()

    def label_lengths(self):
        return self.base.label_lengths()

    def __getitem__(self, i):
        return self.base[i]

    def get_batch(self, idxs):
        with self._lock:
            self.fetched.append(tuple(int(i) for i in idxs))
        return [self.base[int(i)] for i in idxs]


def test_resume_consumes_each_batch_once(tmp_path):
    """The batches trained across a run stopped mid-epoch and its resumed run
    are the deterministic schedule's first max_steps, each once."""
    cfg = _cfg(tmp_path, max_steps=3, feed_reader_threads=1)
    base = _ds(48)
    sampler = LengthBucketSampler(
        base.lengths(), cfg.data.audio_buckets, 1, seed=cfg.train.seed, shuffle=True,
        label_lengths=base.label_lengths(), max_label_length=cfg.data.label_buckets[-1])
    schedule, e = [], 0
    while len(schedule) < 7:
        schedule += [tuple(int(i) for i in idxs) for _, idxs, _ in sampler.epoch_batches(e)]
        e += 1
    assert len(sampler.epoch_batches(0)) > 3  # the first run stops mid-epoch
    ds_a = _RecordingDataset(_ds(48))
    tr_a = Trainer(cfg, ds_a, device="cpu")
    assert tr_a.fit().step == 3
    assert ds_a.fetched[:3] == schedule[:3]
    ds_b = _RecordingDataset(_ds(48))
    tr_b = Trainer(_cfg(tmp_path, max_steps=7, feed_reader_threads=1), ds_b, device="cpu")
    assert tr_b.fit(resume=True).step == 7
    assert ds_b.fetched[:4] == schedule[3:7]


def test_schedule_position_walks_epoch_boundaries(tmp_path):
    cfg = _cfg(tmp_path)
    ds = _ds(12)
    trainer = Trainer(cfg, ds, device="cpu")
    sampler = LengthBucketSampler(
        ds.lengths(), cfg.data.audio_buckets, trainer._global_batch(),
        seed=cfg.train.seed, shuffle=True, label_lengths=ds.label_lengths(),
        max_label_length=cfg.data.label_buckets[-1])
    step = 0
    for e in range(3):
        for off in range(len(sampler.epoch_batches(e))):
            assert trainer._schedule_position(step) == (e, off)
            step += 1
    assert trainer._schedule_position(0) == (0, 0)


def test_label_bucket_respects_actual_lengths(tmp_path):
    ds = SyntheticAudioDataset(4, pcfg.AudioConfig(), min_sec=0.3, max_sec=0.5,
                               min_labels=20, max_labels=22, seed=3)
    trainer = Trainer(_cfg(tmp_path, max_steps=1), ds, device="cpu")
    batch = next(iter(trainer._host_batches(ds, 0, 2)))
    assert batch["targets"].shape[1] == 24
    assert int(batch["target_lengths"].max()) >= 20


def test_fit_no_double_save_when_max_steps_hits_val_interval(tmp_path):
    cfg = _cfg(tmp_path, max_steps=4, val_every_steps=2)
    trainer = Trainer(cfg, _ds(8), val_dataset=_ds(2, seed=5), device="cpu")
    assert trainer.fit().step == 4
    assert trainer.ckpt.latest_step() == 4 and len(trainer.save_s) == 2
    assert [r["step"] for r in _logs(cfg) if r.get("split") == "val"] == [2, 4]


def test_beam_validation_and_mesh_options_raise(tmp_path):
    """The model, stage and time axes need ranks the world size divides: in
    one process they raise the JAX package's ``make_mesh`` error instead of
    running something else.  Beam validation decoding is ported and no
    longer raises; ZeRO-1 is ported, and in one process it is a no-op (the
    replicated optimizer), as on a one-device JAX mesh."""
    trainer = Trainer(_cfg(tmp_path, val_decoder="beam"), _ds(2), device="cpu")
    assert trainer.cfg.train.val_decoder == "beam"
    zero = Trainer(_cfg(tmp_path, shard_optimizer_state=True), _ds(2), device="cpu")
    assert type(zero.state.optimizer) is torch.optim.AdamW
    for kw, axis in ((dict(model_parallel=2), "model=2"),
                     (dict(pipeline_stages=2), "stage=2"),
                     (dict(sequence_parallel=2), "time=2")):
        with pytest.raises(ValueError, match=f"1 devices not divisible by {axis}"):
            Trainer(_cfg(tmp_path, **kw), _ds(2), device="cpu")


def test_beam_validation_matches_the_jax_trainer(tmp_path):
    """``val_decoder="beam"`` (batched beam at ``val_beam_width``) from the
    same flax weights on the same validation data: WER and CER equal to
    the JAX Trainer's, the loss to 1e-5 relative."""
    out = {}
    for name, module in (("jax", jcfg), ("port", pcfg)):
        cfg = _tiny_narrow(module, tmp_path, name)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, val_decoder="beam", val_beam_width=3))
        kw = dict(min_sec=0.3, max_sec=1.2, min_labels=3, max_labels=10)
        flax = random_flax_params(cfg.model, torch.Generator().manual_seed(7))
        if name == "jax":
            tr = JaxTrainer(cfg, JaxSynthetic(4, cfg.data.audio, seed=1, **kw),
                            val_dataset=JaxSynthetic(5, cfg.data.audio, seed=2, **kw),
                            mesh=make_mesh(devices=jax.devices()[:1]))
            tr.state = tr.state.replace(
                params=jax.tree_util.tree_map(jax.numpy.asarray, flax))
        else:
            tr = Trainer(cfg, SyntheticAudioDataset(4, cfg.data.audio, seed=1, **kw),
                         val_dataset=SyntheticAudioDataset(5, cfg.data.audio, seed=2,
                                                           **kw),
                         device="cpu", state_dict=state_dict_from_flax(flax, cfg.model))
        out[name] = tr.validate()
        if name == "jax":
            tr.ckpt.close()
    want, got = out["jax"], out["port"]
    assert (got["val_wer"], got["val_cer"]) == (want["val_wer"], want["val_cer"])
    assert want["val_cer"] not in (0.0, 1.0)  # transcripts, not all blank
    assert abs(got["val_loss"] - want["val_loss"]) <= 1e-5 * abs(want["val_loss"])


def test_overlong_labels_dropped_not_truncated(tmp_path):
    ds = SyntheticAudioDataset(10, pcfg.AudioConfig(), min_sec=0.3, max_sec=1.0,
                               min_labels=5, max_labels=40, seed=11)
    overlong = set(np.flatnonzero(ds.label_lengths() > 24).tolist())
    assert overlong
    trainer = Trainer(_cfg(tmp_path, max_steps=1), ds, device="cpu")
    seen = set()
    for batch in trainer._host_batches(ds, 0, 2, shuffle=False):
        assert batch["targets"].shape[1] <= 24
        for r in range(batch["targets"].shape[0]):
            u = int(batch["target_lengths"][r])
            for i in range(len(ds)):
                if (ds.label_lengths()[i] == u
                        and np.array_equal(ds[i]["labels"], batch["targets"][r, :u])):
                    seen.add(i)
    assert seen and not (seen & overlong)
    assert any(r.get("event") == "overlong_label_dropped" for r in _logs(trainer.cfg))


def test_overlong_labels_raise_without_label_lengths(tmp_path):
    class NoLabelLens:
        def __init__(self, base):
            self.base = base

        def __len__(self):
            return len(self.base)

        def lengths(self):
            return self.base.lengths()

        def __getitem__(self, i):
            return self.base[i]

    ds = NoLabelLens(SyntheticAudioDataset(4, pcfg.AudioConfig(), min_sec=0.3,
                                           max_sec=0.5, min_labels=30, max_labels=34,
                                           seed=13))
    trainer = Trainer(_cfg(tmp_path, max_steps=1), ds, device="cpu")
    with pytest.raises(ValueError, match="corrupt supervision"):
        next(iter(trainer._host_batches(ds, 0, 2)))


def test_watch_histograms_logged(tmp_path):
    cfg = _cfg(tmp_path, max_steps=2, watch_every_steps=1)
    trainer = Trainer(cfg, _ds(6), device="cpu")
    trainer.fit()
    recs = [json.loads(line) for line in
            open(os.path.join(cfg.train.checkpoint_dir, "histograms.jsonl"))]
    assert [r["step"] for r in recs] == [0, 1]
    rec = recs[0]
    assert set(rec) == {"step", "params", "grads"}
    assert rec["params"].keys() == rec["grads"].keys()
    h = rec["params"]["encoder/rnn/fwd_0/w_hh"]
    assert len(h["counts"]) == 64 and len(h["edges"]) == 65
    assert sum(h["counts"]) == 16 * 48
    assert sum(rec["grads"]["encoder/rnn/fwd_0/w_hh"]["counts"]) == 16 * 48


def test_preemption_flag_checkpoints_and_exits(tmp_path):
    cfg = _cfg(tmp_path, max_steps=500)
    trainer = Trainer(cfg, _ds(12), device="cpu")

    def preempt_soon():
        while trainer._host_step < 1:
            time.sleep(0.02)
        trainer._preempted = "SIGTERM"

    t = threading.Thread(target=preempt_soon, daemon=True)
    t.start()
    state = trainer.fit()
    t.join(timeout=5)
    stopped_at = state.step
    assert 1 <= stopped_at < 500 and trainer.ckpt.latest_step() == stopped_at
    assert any(r.get("event") == "preempted" for r in _logs(cfg))
    trainer2 = Trainer(_cfg(tmp_path, max_steps=stopped_at + 2), _ds(12), device="cpu")
    assert trainer2.fit(resume=True).step == stopped_at + 2


@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_fit_raw_pcm_waveform_dataset(tmp_path, transfer):
    """Raw PCM through the whole loop: waveform batches (int16 plus a scale
    per utterance, or float32), the log-mel frontend inside the step and at
    validation."""
    cfg = _cfg(tmp_path, max_steps=2, wav_transfer_dtype=transfer)
    trainer = Trainer(cfg, _ds(6, as_waveform=True),
                      val_dataset=_ds(2, seed=4, as_waveform=True), device="cpu")
    batch = next(iter(trainer._host_batches(trainer.train_ds, 0, 1)))
    assert batch["wav"].dtype == (np.int16 if transfer == "int16" else np.float32)
    assert ("wav_scale" in batch) == (transfer == "int16")
    assert batch["wav"].shape[1] in (64 * 160 - 1, 128 * 160 - 1)
    state = trainer.fit()
    assert state.step == 2
    val = [r for r in _logs(cfg) if r.get("split") == "val"]
    assert len(val) == 1 and np.isfinite(val[0]["val_loss"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_trains_on_synthetic_data_on_the_cpu(tmp_path):
    """``--synthetic 16 --max_steps 2 --device cpu``, on a narrow config: the
    run trains, validates, checkpoints, and ``--eval_only`` tests the best
    checkpoint."""
    cfg = _cfg(tmp_path)
    # the CLI's synthetic utterances are 1-8 s with up to 48 labels
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, audio_buckets=(400, 801), label_buckets=(48,)))
    path = tmp_path / "config.json"
    cfg.to_json(str(path))
    ckpt = str(tmp_path / "cli")
    args = ["--config", str(path), "--synthetic", "16", "--max_steps", "2",
            "--device", "cpu", "--per_device_train_batch_size", "4",
            "--checkpoint_dir", ckpt]
    state = cli.main(args)
    assert state.step == 2
    assert pcfg.Config.from_json(os.path.join(ckpt, "config.json")).train.max_steps == 2
    results = cli.main(args + ["--eval_only"])
    assert set(results) == {"synthetic"} and np.isfinite(results["synthetic"]["loss"])


@pytest.mark.parametrize("flags, match", [
    (["--model_parallel", "2"], "1 devices not divisible by model=2"),
    (["--model_parallel", "2", "--shard_optimizer_state"],
     "1 devices not divisible by model=2"),
    (["--loss_backend", "xla"], "one backend"),
    (["--loss_backend", "pallas"], "one backend"),
    (["--config", "PIPELINE_CONFIG"], "1 devices not divisible by stage=2"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, flags, match):
    """``PIPELINE_CONFIG`` stands for a config whose train.pipeline_stages
    is 2.  The loss backends are not ported; the model and stage axes are,
    and one process raises the JAX package's ``make_mesh`` error for them."""
    if "PIPELINE_CONFIG" in flags:
        cfg = _cfg(tmp_path)
        path = str(tmp_path / "pipeline.json")
        dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, pipeline_stages=2)).to_json(path)
        flags = [path if f == "PIPELINE_CONFIG" else f for f in flags]
    error = NotImplementedError if "backend" in match else ValueError
    with pytest.raises(error, match=match):
        cli.main(["--synthetic", "4", "--device", "cpu",
                  "--checkpoint_dir", str(tmp_path / "x")] + flags)


def _raw_corpus(root, splits):
    """Raw PCM shards of seeded synthetic utterances, each split its own
    seed (train in two shards)."""
    from datasets import Dataset
    for k, (split, n) in enumerate(splits.items()):
        items = [_ds(n, seed=10 + k, as_waveform=True)[i] for i in range(n)]
        ds = Dataset.from_dict({"input_values": [it["wav"] for it in items],
                                "input_ids": [it["labels"].tolist() for it in items]})
        shards = 2 if split == "train" else 1
        for i in range(shards):
            ds.shard(num_shards=shards, index=i).save_to_disk(
                os.path.join(root, split, str(i)))


def test_cli_prepares_raw_shards_and_trains(tmp_path, capsys):
    """``--hf_data_dirs raw --pl_data_dir logmel --device cpu``: the CLI
    prepares every split the raw root has (train in ``--num_shards``, the
    others in one), prints that eval_other has no source, writes the
    ``_PREPARED`` marker, and trains 2 steps whose losses equal a port
    Trainer's on log-mel shards the JAX package prepared from a copy of the
    same raw shards (1e-5 relative).  A second run prepares nothing."""
    import shutil

    from rnntransducer_tpu.data import prepare_logmel_dataset as jax_prepare

    from rnntransducer_tpu_torch.data import ArrowAudioDataset, read_ledger

    raw = str(tmp_path / "raw")
    _raw_corpus(raw, {"train": 8, "dev": 3, "eval_clean": 2})
    shutil.copytree(raw, tmp_path / "raw_jax")
    cfg = _cfg(tmp_path, max_steps=2, per_device_train_batch_size=2)
    path = str(tmp_path / "config.json")
    cfg.to_json(path)
    logmel = str(tmp_path / "logmel")
    args = ["--config", path, "--hf_data_dirs", raw, "--pl_data_dir", logmel,
            "--num_shards", "3", "--device", "cpu"]
    state = cli.main(args)
    assert state.step == 2
    out = capsys.readouterr().out
    assert "[prepare] no source for split 'eval_other', skipping" in out
    assert os.path.exists(os.path.join(logmel, "_PREPARED"))
    assert sorted(read_ledger(logmel)) == ["dev", "eval_clean", "train"]
    assert [len(os.listdir(os.path.join(logmel, s))) - 1
            for s in ("train", "dev", "eval_clean")] == [3, 1, 1]  # shards + _SUCCESS

    jax_logmel = str(tmp_path / "jax_logmel")
    jax_cfg = _cfg(tmp_path, module=jcfg)
    for split in ("train", "dev"):
        jax_prepare([str(tmp_path / "raw_jax")], jax_logmel, split, jax_cfg.data.audio,
                    num_shards=3 if split == "train" else 1)
    want_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "want")))
    Trainer(want_cfg, ArrowAudioDataset([jax_logmel], "train"),
            val_dataset=ArrowAudioDataset([jax_logmel], "dev"), device="cpu").fit()
    got = {r["step"]: r["loss"] for r in _logs(cfg) if r.get("split") == "train"}
    want = {r["step"]: r["loss"] for r in _logs(want_cfg) if r.get("split") == "train"}
    assert sorted(got) == sorted(want) == [1, 2]
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-5 * abs(want[s]), (s, got[s], want[s])

    stamp = os.path.getmtime(os.path.join(logmel, "postprocess_log.json"))
    shutil.rmtree(raw)             # the marker holds: nothing is read again
    results = cli.main(args + ["--eval_only"])
    assert os.path.getmtime(os.path.join(logmel, "postprocess_log.json")) == stamp
    assert set(results) == {"eval_clean"} and np.isfinite(results["eval_clean"]["loss"])


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--synthetic", "4", "--checkpoint_dir", str(tmp_path / "x")])
