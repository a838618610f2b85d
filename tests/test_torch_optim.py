"""Parity of the port's optimizers and LR schedules with the JAX package's
optax ones: schedules at every step of a 50-step run, AdamW and SGD updates
applied over several steps, clip_by_global_norm on both sides of its
threshold.  Tolerances: the schedules to 1e-6 of the peak lr (optax
evaluates them in float32, whose cos near the end of a decay is off by
~1e-7 of the peak, large relative to the tiny lr there); params after the
updates to 1e-6 absolute."""

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
    with pytest.raises(ValueError, match="lr_schedule"):
        optim.make_schedule(TrainConfig(lr_schedule="step"))
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kind in ("adafactor", "lion"):
        with pytest.raises(NotImplementedError, match=kind):
            optim.make_optimizer(TrainConfig(optimizer=kind), p)
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
