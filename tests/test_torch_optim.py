"""Parity of the port's optimizers and LR schedules with the JAX package's
optax ones: schedules at every step of a 50-step run, AdamW, SGD,
adafactor and lion updates applied over several steps, clip_by_global_norm
on both sides of its threshold, and the optimizers' state through a
checkpoint.  Tolerances: the schedules to 1e-6 of the peak lr (optax
evaluates them in float32, whose cos near the end of a decay is off by
~1e-7 of the peak, large relative to the tiny lr there); params after the
AdamW / SGD updates to 1e-6 absolute, after adafactor / lion to 1e-6
relative plus 1e-7 absolute (see the test)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from rnntransducer_tpu.config import TrainConfig as JaxTrainConfig
from rnntransducer_tpu.train.optim import make_optimizer as jax_make_optimizer
from rnntransducer_tpu.train.optim import make_schedule as jax_make_schedule

from rnntransducer_tpu_torch.config import TrainConfig
from rnntransducer_tpu_torch.train import optim

from _torch_parity import close, t


def _cfgs(**kw):
    return TrainConfig(**kw), JaxTrainConfig(**kw)


@pytest.mark.parametrize("kind", ["onecycle", "cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup_ratio", [0.2, 0.0])
def test_schedules_match_optax_at_every_step(kind, warmup_ratio):
    cfg, jcfg = _cfgs(lr_schedule=kind, max_steps=50, learning_rate=3e-3,
                      warmup_ratio=warmup_ratio)
    got = np.array([optim.make_schedule(cfg)(s) for s in range(55)])
    want = np.array([float(jax_make_schedule(jcfg)(s)) for s in range(55)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * cfg.learning_rate)


def test_unknown_schedule_and_unported_optimizers_raise():
    """Unknown names raise; every optimizer the JAX package names builds
    (adafactor and lion are ported now, so nothing is left unported)."""
    with pytest.raises(ValueError, match="lr_schedule"):
        optim.make_schedule(TrainConfig(lr_schedule="step"))
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kind, cls in (("adamw", torch.optim.AdamW), ("sgd", torch.optim.SGD),
                      ("adafactor", optim.Adafactor), ("lion", optim.Lion)):
        assert isinstance(optim.make_optimizer(TrainConfig(optimizer=kind), p), cls)
    with pytest.raises(ValueError, match="optimizer"):
        optim.make_optimizer(TrainConfig(optimizer="adam"), p)


def _params_and_grads(seed, steps):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("kind,clip", [("adamw", None), ("adamw", 0.5), ("sgd", None)])
def test_optimizer_updates_match_optax(kind, clip):
    """The port's update loop (train_step's: lr = schedule(count) before
    each step, optional clip) against optax.update + apply_updates."""
    cfg, jcfg = _cfgs(optimizer=kind, lr_schedule="onecycle", max_steps=10,
                      learning_rate=1e-2, weight_decay=0.05, grad_clip_norm=clip)
    params, grads = _params_and_grads(3, 6)
    tx = jax_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = optim.make_optimizer(cfg, tp.values())
    schedule = optim.make_schedule(cfg)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [t(g[k]) for k in tp]
        if clip is not None:
            tg = optim.clip_by_global_norm(tg, clip)
        for p, gi in zip(tp.values(), tg):
            p.grad = gi
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for k in tp:
        close(tp[k], jp[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("scale", [1e-3, 1e2])
def test_clip_by_global_norm_matches_optax(scale):
    _, grads = _params_and_grads(4, 1)
    g = {k: v * scale for k, v in grads[0].items()}
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None)
    got = optim.clip_by_global_norm([t(g[k]) for k in g], 1.0)
    for k, gk in zip(g, got):
        close(gk, want[k], atol=1e-7, rtol=1e-6, err_msg=k)
    norm = optim.global_norm([t(v) for v in g.values()])
    close(norm, optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}),
          rtol=1e-6)


def test_adamw_defaults_match_optax():
    """torch.optim.AdamW as the port builds it has optax.adamw's betas, eps
    and decoupled decay of every param."""
    cfg = dataclasses.replace(TrainConfig(), weight_decay=0.25)
    opt = optim.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.25 and not group["amsgrad"]


def _factored_tree(seed, steps):
    """Params with factored leaves (both of the two largest dims >= 128,
    one of them 3-D) and unfactored ones (a dim below 128, a vector), and
    ``steps`` seeded gradients of mixed scale."""
    rng = np.random.RandomState(seed)
    shapes = {"w": (160, 128), "wt": (128, 200), "w3": (3, 130, 140),
              "narrow": (127, 300), "b": (130,), "small": (5, 3)}
    params = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


def _run_both(cfg, jcfg, params, grads, steps):
    """``steps`` updates through optax (the JAX package's make_optimizer)
    and the port's optimizer, as train_step drives it: (port params, jax
    params, the port optimizer)."""
    tx = jax_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = optim.make_optimizer(cfg, tp.values())
    schedule = optim.make_schedule(cfg)
    for step, g in enumerate(grads[:steps]):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [t(g[k]) for k in tp]
        if cfg.grad_clip_norm is not None:
            tg = optim.clip_by_global_norm(tg, cfg.grad_clip_norm)
        for p, gi in zip(tp.values(), tg):
            p.grad = gi
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    return tp, jp, opt


@pytest.mark.parametrize("kind", ["adafactor", "lion"])
@pytest.mark.parametrize("weight_decay,clip", [(0.0, None), (0.05, 0.5)])
def test_adafactor_and_lion_match_optax(kind, weight_decay, clip):
    """5 steps of the port's adafactor / lion against optax as the JAX
    package configures it, with and without weight decay (adafactor's is
    added after the lr scaling, lion's before), on factored and unfactored
    leaves."""
    cfg, jcfg = _cfgs(optimizer=kind, lr_schedule="onecycle", max_steps=10,
                      learning_rate=1e-2, weight_decay=weight_decay,
                      grad_clip_norm=clip)
    params, grads = _factored_tree(5, 5)
    tp, jp, opt = _run_both(cfg, jcfg, params, grads, 5)
    for k in tp:
        # 1e-6 relative, plus 1e-7 absolute (about one float32 ulp of the
        # O(1) params): a param the updates carry near zero keeps the
        # rounding of its earlier, larger values (5.6e-9 at a value of
        # 2.5e-5 with this seed), which no relative bound holds
        close(tp[k], jp[k], atol=1e-7, rtol=1e-6, err_msg=k)
    if kind == "adafactor":
        st = opt.state[tp["w3"]]
        # factored: the two largest dims (130, 140) -> row means over 140,
        # column means over 130
        assert st["v_row"].shape == (3, 130) and st["v_col"].shape == (3, 140)
        assert "v" in opt.state[tp["narrow"]] and "v" in opt.state[tp["b"]]


@pytest.mark.parametrize("kind", ["adafactor", "lion"])
def test_adafactor_and_lion_resume_from_a_checkpoint(kind, tmp_path):
    """The optimizer's state through ``CheckpointManager`` as
    ``Trainer.fit(resume=True)`` restores it: 3 train_steps, save, restore
    into a fresh TrainState, 2 more steps equal 5 steps straight, bit for
    bit.  The model's LSTM weights (128, 512) are factored by adafactor."""
    from rnntransducer_tpu_torch.config import Config, ModelConfig
    from rnntransducer_tpu_torch.train import TrainState, train_step
    from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager

    model = ModelConfig.from_dict({
        "transnet": dict(input_size=8, hidden_size=128, output_size=16,
                         num_layers=1, rnn_type="lstm", dropout=0.0,
                         bidirectional=False),
        "prednet": dict(embedding_size=11, hidden_size=16, output_size=16,
                        num_layers=1, rnn_type="lstm", dropout=0.0),
        "jointnet": dict(num_classes=11)})
    cfg = Config(model=model, train=TrainConfig(
        optimizer=kind, precision="fp32", max_steps=10, learning_rate=1e-2,
        weight_decay=0.05, grad_clip_norm=1.0, ema_decay=0.0))
    rng = np.random.RandomState(7)
    B, T, U = 2, 6, 3
    targets = rng.randint(1, 11, size=(B, U))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in {
        "feats": rng.randn(B, T, 8).astype(np.float32),
        "feat_lengths": np.array([T, T - 2]),
        "text_in": np.concatenate([np.zeros((B, 1), np.int64), targets], 1),
        "text_lengths": np.full((B,), U + 1), "targets": targets,
        "target_lengths": np.full((B,), U)}.items()}

    straight = TrainState.create(cfg, "cpu")
    for _ in range(5):
        train_step(straight, batch)
    state = TrainState.create(cfg, "cpu")
    for _ in range(3):
        train_step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state, {"val_cer": 1.0})
    resumed = mgr.restore(TrainState.create(cfg, "cpu"))
    if kind == "adafactor":
        w = resumed.params["encoder.rnn.fwd.0.w_hh"]
        assert resumed.optimizer.state[w]["v_row"].shape == (128,)
    assert resumed.step == 3 and resumed.optimizer.state
    for _ in range(2):
        train_step(resumed, batch)
    for name, p in straight.params.items():
        assert torch.equal(p, resumed.params[name]), name
