"""Checkpoints of the port (train/checkpoint.py): a save / restore round trip
of the whole TrainState, retention of the top k by val_cer plus the latest,
checkpoint averaging, decode params with the EMA shadow, and
Recognizer.from_checkpoint decoding as the live model does."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      average_checkpoint_params,
                                                      load_config,
                                                      load_decode_params)
from rnntransducer_tpu_torch.train.state import TrainState, train_step

from _torch_parity import model_dict


def _cfg(tmp_path, ema=0.0):
    d = model_dict(n_mels=80, vocab=72, layers=1, hidden=16, out=12)
    return pcfg.Config(model=pcfg.ModelConfig.from_dict(d),
                       train=pcfg.TrainConfig(precision="fp32", ema_decay=ema,
                                              checkpoint_dir=str(tmp_path / "ck"),
                                              learning_rate=1e-2, max_steps=50))


def _batch(seed=0, B=2, T=16, U=4):
    rng = np.random.RandomState(seed)
    targets = rng.randint(1, 72, (B, U))
    return {"feats": torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)),
            "feat_lengths": torch.tensor([T, T - 5]),
            "text_in": torch.from_numpy(np.concatenate([np.zeros((B, 1), int), targets], 1)),
            "text_lengths": torch.tensor([U + 1, U]),
            "targets": torch.from_numpy(targets),
            "target_lengths": torch.tensor([U, U - 1])}


def _trained(cfg, steps=2, seed=1):
    state = TrainState.create(cfg, "cpu", seed=seed)
    for i in range(steps):
        train_step(state, _batch(i))
    return state


def test_save_restore_round_trip(tmp_path):
    cfg = _cfg(tmp_path, ema=0.9)
    state = _trained(cfg)
    mgr = CheckpointManager(cfg.train.checkpoint_dir)
    mgr.save(state.step, state, metrics={"val_cer": 0.5}, config=cfg, wait=False)
    assert mgr.latest_step() == 2          # a save in flight counts
    mgr.wait()
    assert load_config(cfg.train.checkpoint_dir) == cfg
    fresh = TrainState.create(cfg, "cpu", seed=9)
    mgr.restore(fresh)
    assert (fresh.step, fresh.updates) == (state.step, state.updates)
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert all(torch.equal(state.ema[k], fresh.ema[k]) for k in state.ema)
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())
    # both go on identically: optimizer moments and the generator came back
    m1, m2 = train_step(state, _batch(5)), train_step(fresh, _batch(5))
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_retention_keeps_top_k_and_the_latest(tmp_path):
    cfg = _cfg(tmp_path)
    state = _trained(cfg, steps=0)
    mgr = CheckpointManager(cfg.train.checkpoint_dir, save_top_k=2)
    cers = {1: 0.9, 2: 0.2, 3: 0.5, 4: 0.1, 5: 0.8, 6: 0.95}
    for step, cer in cers.items():
        mgr.save(step, state, metrics={"val_cer": cer})
    # best two (4, 2) and the latest (6)
    assert mgr.all_steps() == [2, 4, 6]
    ledger = json.load(open(os.path.join(cfg.train.checkpoint_dir,
                                         "checkpoint_metrics.json")))
    assert sorted(map(int, ledger)) == [2, 4, 6]
    assert mgr.best_step() == 4 and mgr.best_or_latest_step() == 4
    # a step saved below the latest survives its own save
    mgr.save(3, state, metrics={"val_cer": 0.99})
    assert 3 in mgr.all_steps() and mgr.latest_step() == 6
    # no metrics: best_or_latest falls back to the latest
    other = CheckpointManager(str(tmp_path / "plain"))
    other.save(0, state)
    assert other.best_step() is None and other.best_or_latest_step() == 0


def test_average_checkpoint_params(tmp_path):
    cfg = _cfg(tmp_path)
    state = TrainState.create(cfg, "cpu")
    mgr = CheckpointManager(cfg.train.checkpoint_dir, save_top_k=3)
    saved = {}
    for step, cer in ((1, 0.3), (2, 0.1), (3, 0.2), (4, 0.9)):
        train_step(state, _batch(step))
        mgr.save(step, state, metrics={"val_cer": cer}, config=cfg)
        saved[step] = {k: v.clone() for k, v in state.model.state_dict().items()}
    params, used = average_checkpoint_params(cfg.train.checkpoint_dir, k=2)
    assert used == [2, 3]
    for k, v in params.items():
        assert torch.allclose(v, (saved[2][k] + saved[3][k]) / 2, atol=1e-7, rtol=0)
    params, used = average_checkpoint_params(cfg.train.checkpoint_dir, steps=[4])
    assert used == [4] and all(torch.equal(params[k], saved[4][k]) for k in params)
    with pytest.raises(ValueError, match="average_k must be >= 1"):
        average_checkpoint_params(cfg.train.checkpoint_dir, k=0)


def test_load_decode_params_with_ema(tmp_path):
    cfg = _cfg(tmp_path, ema=0.5)
    state = _trained(cfg, steps=3)
    mgr = CheckpointManager(cfg.train.checkpoint_dir)
    mgr.save(3, state, metrics={"val_cer": 0.4}, config=cfg)
    params, what = load_decode_params(cfg.train.checkpoint_dir)
    assert what == "step 3"
    assert all(torch.equal(params[k], v) for k, v in state.model.state_dict().items())
    ema, what = load_decode_params(cfg.train.checkpoint_dir, use_ema=True)
    assert what == "step 3 (EMA shadow)"
    assert all(torch.equal(ema[k], v) for k, v in state.ema.items())
    assert any(not torch.equal(ema[k], params[k]) for k in ema)
    with pytest.raises(ValueError, match="either use_ema or average_k"):
        load_decode_params(cfg.train.checkpoint_dir, use_ema=True, average_k=1)
    no_ema = _cfg(tmp_path / "b")
    CheckpointManager(no_ema.train.checkpoint_dir).save(
        1, _trained(no_ema, steps=1), config=no_ema)
    with pytest.raises(ValueError, match="no EMA shadow"):
        load_decode_params(no_ema.train.checkpoint_dir, use_ema=True)


def test_recognizer_from_checkpoint_decodes_as_the_live_model(tmp_path):
    cfg = _cfg(tmp_path)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, audio=dataclasses.replace(cfg.data.audio, spec_augment=False)))
    state = _trained(cfg, steps=2)
    CheckpointManager(cfg.train.checkpoint_dir).save(2, state, config=cfg)
    tok = GraphemeTokenizer.default(72)
    live = Recognizer(cfg, {k: v.detach() for k, v in state.model.state_dict().items()},
                      tok, device="cpu")
    restored = Recognizer.from_checkpoint(cfg.train.checkpoint_dir, device="cpu")
    rng = np.random.RandomState(3)
    waves = [rng.randn(n).astype(np.float32) * 0.1 for n in (3200, 2400, 4000)]
    assert restored.transcribe_batch(waves) == live.transcribe_batch(waves)
    for a, b in zip(live.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)
