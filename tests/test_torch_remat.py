"""``remat`` in the port: ``transnet.remat`` recomputes each RNN encoder
layer in the backward pass, ``jointnet.remat`` the unfused joint's lattice.

Against the same step without them: the loss and every grad bit for bit
(GRU and LSTM, bidirectional, with dropout drawn from a generator, in fp32
and under bf16's cast copies), the generator where it would be, the layer
scans run twice (once more in the backward) and fewer bytes saved for the
backward.  Against the JAX package's ``remat=True`` step on the same
weights and batch: loss and grads within 1e-5 (the loss tolerance of
``tests/test_rnnt_loss.py``)."""

import numpy as np
import jax
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.models import RNNTransducer as JaxTransducer
from rnntransducer_tpu.train.state import TrainState as JaxTrainState
from rnntransducer_tpu.train.state import loss_fn as jax_loss_fn

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.ops import rnn_kernels
from rnntransducer_tpu_torch.train import TrainState, loss_fn
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

from _torch_parity import close, model_dict

TOL = 1e-5
B, T, U, M, V = 4, 12, 4, 8, 11


def _config_dict(rnn_type, transnet_remat, joint_remat, dropout=0.0,
                 precision="fp32", combine="concat"):
    m = model_dict(rnn_type=rnn_type, layers=3, n_mels=M, vocab=V, combine=combine)
    m["transnet"].update(remat=transnet_remat, dropout=dropout)
    m["jointnet"]["remat"] = joint_remat
    return {"model": m, "data": {"audio": {"spec_augment": False}},
            "train": {"precision": precision, "joint_chunk_frames": 0,
                      "learning_rate": 1e-3, "max_steps": 10}}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    targets = rng.randint(1, V, size=(B, U)).astype(np.int32)
    return {"feats": rng.randn(B, T, M).astype(np.float32),
            "feat_lengths": np.array([12, 9, 5, 2], np.int32),
            "text_in": np.concatenate([np.zeros((B, 1), np.int32), targets], 1),
            "text_lengths": np.array([5, 4, 2, 1], np.int32),
            "targets": targets,
            "target_lengths": np.array([4, 3, 1, 0], np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _step(d, seed=3):
    """(loss, grads, generator state after, scans run, bytes saved for the
    backward) of one ``loss_fn`` and its grads; dropout draws from the
    state's generator when the config has any."""
    cfg = pcfg.Config.from_dict(d)
    state = TrainState.create(cfg, "cpu", seed=seed)
    scans = {"n": 0}
    kernels = {name: getattr(rnn_kernels, name) for name in ("gru_scan", "lstm_scan")}

    def counted(fn):
        def run(*args, **kwargs):
            scans["n"] += 1
            return fn(*args, **kwargs)
        return run

    saved = {"bytes": 0}

    def pack(x):
        saved["bytes"] += x.numel() * x.element_size()
        return x

    params = state.params
    for name, fn in kernels.items():
        setattr(rnn_kernels, name, counted(fn))
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss = loss_fn(state.model, cfg, params, _torch_batch(_batch(seed=2)),
                           state.generator, deterministic=False)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        for name, fn in kernels.items():
            setattr(rnn_kernels, name, fn)
    return (loss, dict(zip(params, grads)), state.generator.get_state(), scans["n"],
            saved["bytes"])


def _assert_bit_equal(plain, remat):
    (l0, g0, s0, _, _), (l1, g1, s1, _, _) = plain, remat
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert sum(int(g.abs().sum() > 0) for g in g0.values()) > len(g0) // 2
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_encoder_remat_grads_equal_the_plain_layers(rnn_type, precision):
    """``transnet.remat``: every encoder layer's scan runs again in the
    backward (3 layers x 2 directions more), the bytes kept for the
    backward drop, and the loss, the grads and the dropout generator come
    out bit for bit as without it."""
    plain = _step(_config_dict(rnn_type, False, False, dropout=0.2, precision=precision))
    remat = _step(_config_dict(rnn_type, True, False, dropout=0.2, precision=precision))
    _assert_bit_equal(plain, remat)
    # the scans: 3 encoder layers x 2 directions + 2 prediction-network layers
    assert plain[3] == 3 * 2 + 2
    assert remat[3] == plain[3] + 3 * 2
    assert remat[4] < plain[4]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_joint_remat_grads_equal_the_kept_lattice(precision):
    """``jointnet.remat`` on the unfused branch of the additive joint: its
    (B, T, U+1, hidden) lattice is not kept for the backward (the GELU's
    input and the fc's input: at least two lattices fewer bytes saved), and
    the grads are bit for bit those of the kept lattice.  (The concat joint
    goes through its rank factors and builds no such lattice.)"""
    plain = _step(_config_dict("gru", False, False, precision=precision, combine="add"))
    remat = _step(_config_dict("gru", False, True, precision=precision, combine="add"))
    _assert_bit_equal(plain, remat)
    assert plain[3] == remat[3]  # the scans do not run again
    hidden = model_dict()["jointnet"]["hidden_size"]
    item = 2 if precision == "bf16" else 4
    assert plain[4] - remat[4] >= 2 * B * T * (U + 1) * hidden * item


@pytest.mark.parametrize("rnn_type, combine", [("gru", "add"), ("lstm", "concat")])
def test_remat_grads_match_the_jax_remat_step(rnn_type, combine):
    """The port's step with both remats against the JAX package's
    ``remat=True`` step (``nn.remat`` of its RNN layers and joint) on the
    unfused branch, same weights and batch, dropout 0: loss and every grad
    within 1e-5."""
    d = _config_dict(rnn_type, True, True, combine=combine)
    jc, pc = jcfg.Config.from_dict(d), pcfg.Config.from_dict(d)
    assert jc.model.transnet.remat and jc.model.jointnet.remat
    jstate = JaxTrainState.create(jc)

    def bridge(tree):
        return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), pc.model)

    model = JaxTransducer(jc.model)
    jb = jax.tree_util.tree_map(jax.numpy.asarray, _batch(seed=2))
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, jc, p, jb, jax.random.PRNGKey(0),
                              deterministic=True)))(jstate.params)
    state = TrainState.create(pc, "cpu", state_dict=bridge(jstate.params))
    params = state.params
    got = loss_fn(state.model, pc, params, _torch_batch(_batch(seed=2)), None,
                  deterministic=True)
    grads = torch.autograd.grad(got, list(params.values()))
    close(got, want, atol=TOL, rtol=TOL)
    want_g = bridge(want_g)
    assert set(want_g) == set(params)
    for name, g in zip(params, grads):
        close(g, want_g[name], atol=TOL, rtol=TOL, err_msg=name)
