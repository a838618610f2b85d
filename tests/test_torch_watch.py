"""Parameter and gradient histograms (train/state.py::watch_step and its
``histogram``) against ``jnp.histogram``: the counts equal, the edges within
1e-6 relative, named by the flax paths of the JAX package's params tree."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.train.state import TrainState, histogram, watch_step
from rnntransducer_tpu_torch.utils.weights import flax_layout

from _torch_parity import model_dict


def _check(counts, edges, x):
    want_c, want_e = jnp.histogram(jnp.asarray(x, jnp.float32), bins=64)
    assert counts.dtype == torch.int64 and counts.shape == (64,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c).astype(np.int64))
    want_e = np.asarray(want_e)
    assert np.abs(edges.numpy() - want_e).max() <= 1e-6 * np.abs(want_e).max()


@pytest.mark.parametrize("seed", range(6))
def test_histogram_equals_jnp_histogram(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rng.randint(1, 5000)).astype(np.float32) * 10.0 ** rng.randint(-4, 3)
    if seed == 1:
        x[:] = 0.25            # a flat tensor: range +-0.5
    if seed == 2:
        x = np.round(x * 4) / 4  # values on the edges
    _check(*histogram(torch.from_numpy(x)), x)


def test_watch_step_histograms_every_flax_leaf():
    d = model_dict(n_mels=80, vocab=72, layers=3, scan_layers=True)
    cfg = pcfg.Config(model=pcfg.ModelConfig.from_dict(d),
                      train=pcfg.TrainConfig(precision="fp32"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, audio=dataclasses.replace(cfg.data.audio, spec_augment=False)))
    state = TrainState.create(cfg, "cpu", seed=3)
    rng = np.random.RandomState(0)
    B, T, U = 2, 20, 5
    targets = rng.randint(1, 72, (B, U))
    batch = {"feats": torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)),
             "feat_lengths": torch.tensor([20, 13]),
             "text_in": torch.from_numpy(np.concatenate([np.zeros((B, 1), int), targets], 1)),
             "text_lengths": torch.tensor([U + 1, 4]),
             "targets": torch.from_numpy(targets), "target_lengths": torch.tensor([U, 3])}
    before = {k: v.detach().clone() for k, v in state.params.items()}
    hists = watch_step(state, batch)
    paths = {"/".join(p) for p, _, _, _ in flax_layout(cfg.model)}
    assert set(hists) == {"params", "grads"}
    assert set(hists["params"]) == set(hists["grads"]) == paths
    # a scanned stack's layers are one leaf, as in the flax tree
    assert "encoder/rnn/stack/fwd/w_hh" in paths
    stacked = torch.cat([state.params[f"encoder.rnn.fwd.{i}.w_hh"].reshape(-1)
                         for i in (1, 2)])
    _check(*hists["params"]["encoder/rnn/stack/fwd/w_hh"], stacked.detach().numpy())
    for name, (counts, edges) in hists["grads"].items():
        assert int(counts.sum()) == int(hists["params"][name][0].sum())
    # watching neither changes the params nor advances training's generator
    assert all(torch.equal(before[k], v) for k, v in state.params.items())
    assert state.step == 0
