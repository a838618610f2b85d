"""Parity of the port's Conformer (``models/conformer.py``) with the JAX
package's on the same weights (the flax params through the port's weight
bridge) and the same numpy-seeded inputs, at the sizes of
``tests/test_conformer.py`` (2 blocks, d=64, 4 heads, kernel 7): RoPE, the
depthwise conv and its hand-written backward, the encoder full-context and
chunked-causal at strides 1, 2 and 4 with ragged lengths, the three flax
param layouts, the fp32 train step and recomputed blocks (``remat``).
Each test names its tolerance.  Serving, evaluation, the Trainer and the
CLIs on a Conformer: ``test_torch_conformer_serve.py``; streaming:
``test_torch_conformer_stream.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.models import RNNTransducer as JaxTransducer
from rnntransducer_tpu.models import conformer as jconf
from rnntransducer_tpu.train.optim import make_optimizer as jax_make_optimizer
from rnntransducer_tpu.train.state import TrainState as JaxTrainState
from rnntransducer_tpu.train.state import loss_fn as jax_loss_fn
from rnntransducer_tpu.train.state import train_step as jax_train_step

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.models import conformer
from rnntransducer_tpu_torch.train import TrainState, loss_fn, train_step
from rnntransducer_tpu_torch.utils import weights

from _torch_parity import (close, conformer_dict, jax_apply, jax_model,
                           numpy_params, port_model, t)

# the encoder bound of tests/test_conformer.py:253-254
ENC_ATOL, ENC_RTOL = 2e-5, 1e-4
# loss and gradients: the north star's 1e-5
TOL = 1e-5


@pytest.mark.parametrize("hd,offset", [(16, 0), (15, 3), (8, 7)])
def test_rope_matches_jax(hd, offset):
    """The half-split rotation, offset positions, an odd head dim's last
    feature unrotated; 1e-6 absolute (sin / cos of float32 angles)."""
    x = np.random.RandomState(hd).randn(2, 3, 10, hd).astype(np.float32)
    want = jconf.rope(jnp.asarray(x), offset=offset)
    got = conformer.rope(t(x), offset=offset)
    close(got, want, atol=1e-6)
    if hd % 2:
        assert torch.equal(got[..., -1], t(x)[..., -1])


def test_depthwise_conv_matches_the_jax_vjp():
    """Forward against ``_dwconv_valid`` (1e-6 relative), dx and dk of the
    hand-written backward against the JAX custom VJP (the JAX package's
    own bounds: dx 1e-5 / 1e-6, dk 1e-5 / 1e-5)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 20, 8).astype(np.float32)
    k = rng.randn(5, 8).astype(np.float32)
    g = rng.randn(2, 16, 8).astype(np.float32)
    want = jconf._dwconv_valid(jnp.asarray(x), jnp.asarray(k))
    dx_w, dk_w = jax.grad(lambda a, b: jnp.sum(jconf._dwconv_valid(a, b) * g),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = t(x).requires_grad_(True)
    kt = t(k).requires_grad_(True)
    out = conformer.DepthwiseConv1dFunction.apply(xt, kt)
    dx, dk = torch.autograd.grad((out * t(g)).sum(), (xt, kt))
    close(out, want, atol=0.0, rtol=1e-6)
    close(dx, dx_w, atol=1e-6, rtol=1e-5)
    close(dk, dk_w, atol=1e-5, rtol=1e-5)
    # the plain version's autograd agrees with the hand-written backward
    ref = conformer.dwconv_valid_reference(xt, kt)
    rx, rk = torch.autograd.grad((ref * t(g)).sum(), (xt, kt))
    close(dx, rx.numpy(), atol=1e-6, rtol=1e-5)
    close(dk, rk.numpy(), atol=1e-5, rtol=1e-5)


def _feats(B=3, T=24, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 80).astype(np.float32),
            np.array([T, T - 7, T - 15][:B], np.int32))


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("chunk", [0, 4])
def test_encoder_matches_jax(stride, chunk):
    """Ragged batch, full context (chunk 0) and chunked-causal (chunk 4,
    left 2): outputs within 2e-5 / 1e-4; the zero state of each mode."""
    d = conformer_dict(stride=stride, chunk=chunk)
    jm, variables = jax_model(d)
    pm = port_model(d, variables)
    x, lengths = _feats(seed=stride + chunk)
    want, want_state = jax_apply(jm, variables, jnp.asarray(x), jnp.asarray(lengths),
                                 method="encode")
    with torch.no_grad():
        got, state = pm.encode(t(x), t(lengths))
    assert got.shape == want.shape
    close(got, want, atol=ENC_ATOL, rtol=ENC_RTOL)
    assert tuple(state.h.shape) == want_state.h.shape
    if chunk:
        assert tuple(state.c.shape) == want_state.c.shape
        assert not state.h.any() and not state.c.any()
    else:
        assert state.c is None and want_state.c is None


@pytest.mark.parametrize("group", [1, 2])
def test_scan_layouts_load_the_same_module(group):
    """The stacked ``blocks`` layout (group 1) and the grouped ``blocks/g{j}``
    layout (group 2), made by the JAX package's converter, load the same
    weights as the per-block layout (exactly); the port's converters equal
    the JAX package's; ``random_flax_params`` gives the tree a JAX
    ``scan_blocks`` model initialises; and the JAX scan model's encoder
    equals the port's (2e-5 / 1e-4)."""
    L = 4
    d = conformer_dict(layers=L, stride=2)
    jm, variables = jax_model(d)
    per_block = numpy_params(variables)
    want = weights.state_dict_from_flax(per_block, pcfg.ModelConfig.from_dict(d))
    ds = {**d, "transnet": {**d["transnet"], "scan_blocks": True,
                            "scan_block_group": group}}
    scan_cfg = pcfg.ModelConfig.from_dict(ds)
    stacked = dict(per_block, encoder=jax.tree_util.tree_map(
        np.asarray, jconf.stack_conformer_block_params(per_block["encoder"], L,
                                                       group=group)))
    got = weights.state_dict_from_flax(stacked, scan_cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mine = conformer.stack_conformer_block_params(per_block["encoder"], L, group=group)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(stacked["encoder"]))
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, stacked["encoder"])
    back = conformer.unstack_conformer_block_params(mine, L, group=group)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, per_block["encoder"])

    jscan = JaxTransducer(jcfg.ModelConfig.from_dict(ds))
    x, lengths = _feats(seed=5)
    init = jscan.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.array([8]),
                      jnp.zeros((1, 4), jnp.int32), jnp.array([4]))
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (np.shape(a), str(np.asarray(a).dtype)), tree)
    assert shapes(weights.random_flax_params(
        scan_cfg, torch.Generator().manual_seed(0))) == shapes(numpy_params(init))
    enc, _ = jscan.apply({"params": jax.tree_util.tree_map(jnp.asarray, stacked)},
                         jnp.asarray(x), jnp.asarray(lengths), method=jscan.encode)
    pm = port_model(d, variables)
    with torch.no_grad():
        close(pm.encode(t(x), t(lengths))[0], enc, atol=ENC_ATOL, rtol=ENC_RTOL)


def test_random_params_have_the_jax_layout():
    """The port's random Conformer weights come in the tree a JAX
    per-block model initialises (paths, shapes, dtypes)."""
    d = conformer_dict(stride=4, chunk=4)
    _, variables = jax_model(d)
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (np.shape(a), str(np.asarray(a).dtype)), tree)
    assert shapes(weights.random_flax_params(
        pcfg.ModelConfig.from_dict(d), torch.Generator().manual_seed(0))) == shapes(
            numpy_params(variables))


def _train_dict(d, **train):
    return {"model": d, "data": {"audio": {"spec_augment": False}},
            "train": {"precision": "fp32", "learning_rate": 1e-3, "max_steps": 10,
                      **train}}


def _batch(B=3, T=16, U=4, seed=0):
    rng = np.random.RandomState(seed)
    targets = rng.randint(1, 72, size=(B, U)).astype(np.int32)
    return {"feats": rng.randn(B, T, 80).astype(np.float32),
            "feat_lengths": np.array([T, T - 5, T - 9][:B], np.int32),
            "text_in": np.concatenate([np.zeros((B, 1), np.int32), targets], 1),
            "text_lengths": np.array([U + 1, U, 2][:B], np.int32),
            "targets": targets,
            "target_lengths": np.array([U, U - 1, 1][:B], np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("stride,chunk", [(2, 0), (2, 4)])
def test_three_train_steps_match_jax(stride, chunk):
    """fp32, the factored loss branch, three AdamW train_steps: before each,
    the loss (1e-5 relative) and every param's grad (within 1e-5 of that
    param's largest grad) at the JAX state's params; each step's loss and
    grad norm (1e-5 relative); the params after the three steps (1e-5)."""
    dd = _train_dict(conformer_dict(stride=stride, chunk=chunk))
    jc, pc = jcfg.Config.from_dict(dd), pcfg.Config.from_dict(dd)
    jstate = JaxTrainState.create(jc)
    bridge = lambda tree: weights.state_dict_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), pc.model)
    state = TrainState.create(pc, "cpu", state_dict=bridge(jstate.params))
    batch = _batch()
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tb = _torch_batch(batch)
    model = JaxTransducer(jc.model)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, jc, p, jb, jax.random.PRNGKey(0),
                              deterministic=True)))
    probe = TrainState.create(pc, "cpu", state_dict=bridge(jstate.params))
    tx = jax_make_optimizer(jc.train)
    for step in range(3):
        want, want_g = value_and_grad(jstate.params)
        probe.model.load_state_dict(bridge(jstate.params))
        params = probe.params
        got = loss_fn(probe.model, pc, params, tb, None, deterministic=True)
        grads = dict(zip(params, torch.autograd.grad(got, list(params.values()))))
        close(got, want, atol=0.0, rtol=TOL, err_msg=f"loss at {step}")
        want_g = bridge(want_g)
        assert set(want_g) == set(grads)
        for name, g in grads.items():
            scale = float(want_g[name].abs().max())
            close(g, want_g[name], atol=TOL * scale, err_msg=f"{name} at {step}")
        jstate, jm = jax_train_step(jc, tx, jstate, jb)
        m = train_step(state, tb)
        close(m["loss"], jm["loss"], atol=0.0, rtol=TOL, err_msg=f"loss {step}")
        close(m["grad_norm"], jm["grad_norm"], atol=0.0, rtol=TOL,
              err_msg=f"grad_norm {step}")
    for name, p in state.params.items():
        close(p, bridge(jstate.params)[name], atol=TOL, err_msg=name)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_remat_grads_equal_the_plain_blocks(precision):
    """``remat=True`` recomputes each block in the backward pass on the
    params the forward saw (the bf16 cast copies under bf16) and replays
    its dropout masks: with dropout 0.1 and the same generator seed the
    loss and every grad equal those without remat, bit for bit, and the
    generator ends where it would without remat."""
    out = []
    for remat in (False, True):
        d = conformer_dict(stride=2, chunk=4, dropout=0.1)
        d["transnet"]["remat"] = remat
        cfg = pcfg.Config.from_dict(_train_dict(d, precision=precision))
        state = TrainState.create(cfg, "cpu", seed=3)
        params = state.params
        loss = loss_fn(state.model, cfg, params, _torch_batch(_batch(seed=2)),
                       state.generator, deterministic=False)
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((loss, grads, state.generator.get_state(),
                    sum(int(g.abs().sum() > 0) for g in grads)))
    (l0, g0, s0, n0), (l1, g1, s1, _) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert n0 > len(g0) // 2  # the grads compared are not zeros
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
