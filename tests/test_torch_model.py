"""Parity of the port's model modules with the JAX package, with the JAX
model's own flax params carried over by the port's weight bridge:
encoder (every time-reduction branch), prediction network (recurrent and
stateless, full-sequence and step), joint (concat and add) and the
RNN-Transducer lattice."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.utils import weights

from _torch_parity import (close, jax_apply, jax_model, model_dict,
                           numpy_params, port_model, t)


def _feats(B=3, T=9, n_mels=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, n_mels).astype(np.float32),
            np.array([T, T - 3, 2][:B], np.int32))


@pytest.mark.parametrize("stride,reduce_at,scan_layers,use_pallas", [
    (1, 1, True, "interpret"), (1, 1, False, "off"), (2, 0, True, "off"),
    (2, 1, True, "off"), (2, 3, False, "off"),
])
def test_encoder_matches_jax(stride, reduce_at, scan_layers, use_pallas):
    d = model_dict(layers=3, stride=stride, reduce_at=reduce_at,
                   scan_layers=scan_layers, use_pallas=use_pallas)
    jm, variables = jax_model(d)
    pm = port_model(d, variables)
    x, lengths = _feats()
    want, want_state = jax_apply(jm, variables, jnp.asarray(x),
                                 jnp.asarray(lengths), method="encode")
    with torch.no_grad():
        got, got_state = pm.encode(t(x), t(lengths))
    assert got.shape == want.shape
    close(got, want)
    close(got_state.h, want_state.h)


def test_lstm_encoder_matches_jax():
    d = model_dict(rnn_type="lstm", layers=2)
    jm, variables = jax_model(d, seed=1)
    pm = port_model(d, variables)
    x, lengths = _feats(seed=1)
    want, want_state = jax_apply(jm, variables, jnp.asarray(x),
                                 jnp.asarray(lengths), method="encode")
    with torch.no_grad():
        got, got_state = pm.encode(t(x), t(lengths))
    close(got, want)
    close(got_state.c, want_state.c)


@pytest.mark.parametrize("pred_type,pred_layers", [("lstm", 2), ("gru", 1),
                                                   ("stateless", 1),
                                                   ("stateless", 2)])
def test_prednet_matches_jax(pred_type, pred_layers):
    d = model_dict(pred_type=pred_type, pred_layers=pred_layers)
    jm, variables = jax_model(d, seed=2)
    pm = port_model(d, variables)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, 11, size=(3, 5)).astype(np.int32)
    tokens[:, 0] = 0
    lengths = np.array([5, 3, 1], np.int32)
    want, want_state = jax_apply(jm, variables, jnp.asarray(tokens),
                                 jnp.asarray(lengths), method="predict")
    with torch.no_grad():
        got, got_state = pm.predict(t(tokens).long(), t(lengths))
    close(got, want)
    close(got_state.h, want_state.h)
    jstate, pstate = None, None
    for u in range(tokens.shape[1]):
        jout, jstate = jax_apply(jm, variables, jnp.asarray(tokens[:, u]),
                                 jstate, method="predict_step")
        with torch.no_grad():
            pout, pstate = pm.predict_step(t(tokens[:, u]).long(), pstate)
        close(pout, jout, err_msg=f"step {u}")
        close(pstate.h, jstate.h, err_msg=f"step {u}")


@pytest.mark.parametrize("combine", ["concat", "add"])
def test_joint_and_lattice_match_jax(combine):
    d = model_dict(combine=combine)
    jm, variables = jax_model(d, seed=3)
    pm = port_model(d, variables)
    x, lengths = _feats(seed=3)
    rng = np.random.RandomState(3)
    text = rng.randint(1, 11, size=(3, 4)).astype(np.int32)
    text[:, 0] = 0
    text_lengths = np.array([4, 2, 1], np.int32)
    want = jax_apply(jm, variables, jnp.asarray(x), jnp.asarray(lengths),
                     jnp.asarray(text), jnp.asarray(text_lengths))
    enc = rng.randn(3, 12).astype(np.float32)
    dec = rng.randn(3, 12).astype(np.float32)
    want_step = jax_apply(jm, variables, jnp.asarray(enc), jnp.asarray(dec),
                          method="joint_step")
    with torch.no_grad():
        got = pm(t(x), t(lengths), t(text).long(), t(text_lengths))
        got_step = pm.joint_step(t(enc), t(dec))
    assert got.shape == want.shape == (3, 9, 4, 11)
    close(got, want)
    close(got_step, want_step)
    if combine == "concat":
        encs = rng.randn(2, 5, 12).astype(np.float32)
        decs = rng.randn(2, 3, 12).astype(np.float32)
        wa, wc = jax_apply(jm, variables, jnp.asarray(encs), jnp.asarray(decs),
                           method="joint_factors")
        with torch.no_grad():
            ga, gc = pm.joint_factors(t(encs), t(decs))
        close(ga, wa)
        close(gc, wc)


@pytest.mark.parametrize("kw", [
    dict(), dict(scan_layers=False), dict(stride=2, reduce_at=1, layers=3),
    dict(pred_type="stateless", combine="add"),
])
def test_random_flax_params_has_the_jax_layout(kw):
    """The port's random weights come in exactly the flax tree the JAX model
    initialises (same paths, shapes and dtypes), so the bridge they go
    through is the one real checkpoints take."""
    d = model_dict(**kw)
    _, variables = jax_model(d)
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  numpy_params(variables))
    tree = weights.random_flax_params(pcfg.ModelConfig.from_dict(d),
                                      torch.Generator().manual_seed(0))
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), tree)
    assert got == want


def test_bridge_rejects_mismatched_params():
    d = model_dict()
    _, variables = jax_model(d)
    params = numpy_params(variables)
    wrong = pcfg.ModelConfig.from_dict(model_dict(hidden=8))
    with pytest.raises(ValueError, match="does not match"):
        weights.state_dict_from_flax(params, wrong)
    extra = dict(params, spare={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="spare/kernel"):
        weights.state_dict_from_flax(extra, pcfg.ModelConfig.from_dict(d))
    no_scan = pcfg.ModelConfig.from_dict(model_dict(scan_layers=False))
    with pytest.raises(KeyError, match="fwd_1"):
        weights.state_dict_from_flax(params, no_scan)


def test_bridge_save_load_roundtrip(tmp_path):
    d = model_dict()
    _, variables = jax_model(d)
    cfg = pcfg.Config(model=pcfg.ModelConfig.from_dict(d))
    sd = weights.state_dict_from_flax({"params": numpy_params(variables)}, cfg.model)
    weights.save(str(tmp_path / "bundle"), cfg, sd)
    cfg2, sd2 = weights.load(str(tmp_path / "bundle"))
    assert cfg2 == cfg
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
