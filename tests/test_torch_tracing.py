"""The port's spans (utils/profiling.py) on the CPU at a tiny size: off
without a profiler, one of each per train step under one, at the right
parents, with the step's numbers unchanged; the prefetcher's counters; the
Trainer's profile window writing the totals."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.data import SyntheticAudioDataset
from rnntransducer_tpu_torch.data.prefetch import DevicePrefetcher
from rnntransducer_tpu_torch.train import Trainer
from rnntransducer_tpu_torch.train import state as st
from rnntransducer_tpu_torch.utils import profiling

STEP = ["train/forward", "train/backward", "train/allreduce", "train/optimizer"]
FORWARD = ["train/frontend", "train/encoder", "train/prednet", "train/joint_loss"]
ROUTES = {"factored": {}, "fused": {"combine": "add"}, "unfused": {"chunk": 0}}


def _cfg(tmp_path=None, combine="concat", chunk=None, **train):
    jn = pcfg.JointNetConfig(num_classes=72, combine=combine)
    kw = dict(precision="fp32", per_device_train_batch_size=2, max_steps=3,
              log_every_steps=1, val_every_steps=100,
              checkpoint_dir=str(tmp_path / "ckpt") if tmp_path else "ckpt")
    if chunk is not None:
        kw["joint_chunk_frames"] = chunk
    kw.update(train)
    return pcfg.Config(
        data=pcfg.DataConfig(audio=pcfg.AudioConfig(spec_augment=True),
                             audio_buckets=(64,), label_buckets=(8,)),
        model=pcfg.ModelConfig(
            transnet=pcfg.TransNetConfig(input_size=80, hidden_size=16, output_size=12,
                                         num_layers=1, rnn_type="gru", dropout=0.1,
                                         bidirectional=True),
            prednet=pcfg.PredNetConfig(embedding_size=72, hidden_size=16, output_size=12,
                                       num_layers=1, rnn_type="lstm", dropout=0.0),
            jointnet=jn),
        train=pcfg.TrainConfig(**kw))


def _batch(seed=0, B=2, U=6):
    """A raw-PCM batch of the 64-frame bucket (int16 with its scale)."""
    g = np.random.default_rng(seed)
    S = 64 * 160 - 1
    return {"wav": torch.tensor(g.integers(-3000, 3000, (B, S)), dtype=torch.int16),
            "wav_scale": torch.full((B,), 1 / 32768, dtype=torch.float32),
            "wav_lengths": torch.tensor([S, S - 2000], dtype=torch.int32),
            "text_in": torch.tensor(np.c_[np.zeros((B, 1)), g.integers(4, 50, (B, U))],
                                    dtype=torch.int32),
            "text_lengths": torch.tensor([U + 1, U - 1], dtype=torch.int32),
            "targets": torch.tensor(g.integers(4, 50, (B, U)), dtype=torch.int32),
            "target_lengths": torch.tensor([U, U - 2], dtype=torch.int32)}


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_are_off_without_a_profiler():
    assert profiling.annotate("train/step") is profiling.annotate("data/prefetch_wait")
    profiling.count("data/batches")
    state = st.TrainState.create(_cfg(), "cpu", seed=1)
    st.train_step(state, _batch())
    assert profiling.recorded() == {} and profiling.spans() == []


def test_each_window_holds_its_own_spans():
    """A window, spans met with no profiler, a second window: the second
    record holds only its own spans; without the spans in between the
    record carries on."""
    with _recording():
        with profiling.annotate("a"):
            pass
        profiling.count("c", 2)
    with _recording():
        with profiling.annotate("b"):
            pass
    assert set(profiling.recorded()) == {"a", "b", "c"}
    with profiling.annotate("a"):  # off: marks the record stale
        pass
    with _recording():
        with profiling.annotate("b"):
            pass
    assert set(profiling.recorded()) == {"b"}
    assert profiling.recorded()["b"]["count"] == 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_train_step_records_each_span_once(route):
    state = st.TrainState.create(_cfg(**ROUTES[route]), "cpu", seed=1)
    with _recording() as prof:
        st.train_step(state, _batch())
    rows = profiling.spans()
    assert sorted(r["name"] for r in rows) == sorted(["train/step"] + STEP + FORWARD)
    parent = {r["name"]: r["parent"] for r in rows}
    assert parent["train/step"] is None
    assert all(parent[n] == "train/step" for n in STEP)
    assert all(parent[n] == "train/forward" for n in FORWARD)
    assert {r["step"] for r in rows} == {1}
    totals = profiling.recorded()
    for name, t in totals.items():
        assert t["count"] == 1
        # the CPU's device time is the host duration
        assert t["device_s"] == t["host_s"] > 0
        assert 0 <= t["self_device_s"] <= t["device_s"]
    children = sum(totals[n]["device_s"] for n in STEP)
    assert totals["train/step"]["self_device_s"] == pytest.approx(
        totals["train/step"]["device_s"] - children, abs=1e-9)
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(totals) <= ranges


@pytest.mark.parametrize("caller", ["eval_step", "watch_step"])
def test_other_callers_of_loss_fn_record_no_spans(caller):
    """The model parts' spans belong to train_step's forward: a validation
    or watch step inside a profiled window records none of them."""
    state = st.TrainState.create(_cfg(), "cpu", seed=1)
    with _recording():
        if caller == "eval_step":
            st.eval_step(state.cfg, state.model, _batch())
        else:
            st.watch_step(state, _batch(), bins=4)
        st.train_step(state, _batch())
    rows = profiling.spans()
    assert sorted(r["name"] for r in rows) == sorted(["train/step"] + STEP + FORWARD)
    assert {r["step"] for r in rows} == {1}


def test_recording_leaves_the_step_bit_equal():
    out = []
    for recording in (False, True):
        torch.manual_seed(0)
        state = st.TrainState.create(_cfg(), "cpu", seed=3)
        if recording:
            with _recording():
                m = st.train_step(state, _batch(1))
            assert "train/step" in profiling.recorded()
        else:
            m = st.train_step(state, _batch(1))
        out.append((m, {k: v.detach().clone() for k, v in state.model.named_parameters()}))
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_prefetcher_counts_its_batches():
    host = ({"x": np.full((2,), i, np.float32)} for i in range(5))
    with _recording():
        got = [int(b["x"][0]) for b in DevicePrefetcher(host, device="cpu")]
    assert got == list(range(5))
    totals = profiling.recorded()
    assert totals["data/batches"] == {"count": 5}
    # one wait for each batch and one for the end
    assert totals["data/prefetch_wait"]["count"] == 6
    assert totals.get("data/prefetch_empty", {"count": 0})["count"] <= 6


def test_trainer_profile_window_writes_the_spans(tmp_path):
    cfg = _cfg(tmp_path, max_steps=3)
    ds = SyntheticAudioDataset(8, cfg.data.audio, min_sec=0.3, max_sec=0.6,
                               min_labels=3, max_labels=6, seed=0)
    prof_dir = str(tmp_path / "profile")
    Trainer(cfg, ds, device="cpu", profile_dir=prof_dir, profile_steps=(1, 3)).fit()
    files = glob.glob(os.path.join(prof_dir, "spans_*.json"))
    assert len(files) == 1
    assert glob.glob(os.path.join(prof_dir, "trace_*.json"))
    totals = json.load(open(files[0]))
    assert totals["train/step"]["count"] == 2
    assert {"count", "host_s", "device_s", "self_device_s"} == set(totals["train/forward"])
    logs = [json.loads(line) for line in open(os.path.join(cfg.train.checkpoint_dir,
                                                           "metrics.jsonl"))]
    line = next(r for r in logs if r.get("event") == "profile_written")
    assert line["train/step_ms"] == pytest.approx(
        1e3 * totals["train/step"]["device_s"] / 2, abs=1e-3)
    # the window's second step waited for its batch inside it
    assert line["train/step_ms"] > 0 and line["data/prefetch_wait_ms"] >= 0
    # the window's record is cleared once logged
    assert profiling.recorded() == {}
