"""Parity of the port's LSTM scan, forward and backward, with the JAX package.

``lstm_scan_reference`` (the plain version the CUDA kernel K3 is held
against on the card) and the autograd LSTM (``LSTMScanFunction``: the plain
``lstm_scan_backward_reference`` on the CPU plus the off-loop weight GEMMs)
against ``rnn_pallas.lstm_scan`` and ``jax.grad`` through it in interpret
mode (the TPU kernels' own forward and backward), against autograd through
the plain forward loop, and through a whole model's ``loss_fn`` with an
LSTM encoder.  The kernels themselves run only on the card: their tests
carry the ``cuda`` marker.

Tolerances: fp32 at 1e-6 absolute plus 1e-6 relative against the Pallas
kernels (same contract, same order of operations up to the summation order
of the products and of db_hh, a sum of T*B terms near 1); 2e-5 against
autograd through the plain loop (the cells' parity tolerance: autodiff sums
in another order); 1e-5 for the loss and its grads (the JAX package's own).
bf16 at 4 bf16 ulps of each output's largest magnitude: both round the
outputs and the product operands to bf16 at the same places, and a one-ulp
flip of a rounded value feeds the carries.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.models import RNNTransducer as JaxTransducer
from rnntransducer_tpu.models.cells import RNNLayer as JaxRNNLayer
from rnntransducer_tpu.ops import rnn_pallas as rp
from rnntransducer_tpu.train.state import TrainState as JaxTrainState
from rnntransducer_tpu.train.state import loss_fn as jax_loss_fn

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.models.cells import RNNLayer
from rnntransducer_tpu_torch.ops import rnn_kernels
from rnntransducer_tpu_torch.train import TrainState, loss_fn
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

from _torch_parity import close, model_dict, t

H = 16
BF16_ULPS = 4 * 2.0 ** -8


def _inputs(T, B, seed):
    rng = np.random.RandomState(seed)
    xw = rng.randn(T, B, 4 * H).astype(np.float32)
    w = (rng.randn(H, 4 * H) * 0.4).astype(np.float32)
    b = (rng.randn(4 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.4).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.8).astype(np.float32)
    lengths = np.maximum(T - 3 * np.arange(B), 1).astype(np.float32)
    lengths[-1] = 1
    cot = tuple(rng.randn(*s).astype(np.float32) for s in ((T, B, H), (B, H), (B, H)))
    return (xw, w, b, h0, c0, lengths), cot


def _bf16_close(got, want, name):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    close(got, want, atol=BF16_ULPS * np.abs(want).max(), err_msg=name)


def _jax_scan(args, dtype):
    xw, w, b, h0, c0, lengths = [jnp.asarray(a) for a in args]
    return [a.astype(dtype) for a in (xw, w, b, h0, c0)] + [lengths]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [6, 12])
def test_lstm_scan_reference_matches_pallas(T, reverse):
    args, _ = _inputs(T, 4, seed=T + reverse)
    want = rp.lstm_scan(*_jax_scan(args, jnp.float32), reverse, True)
    got = rnn_kernels.lstm_scan_reference(*[t(a) for a in args], reverse)
    for name, g, w in zip(("h_all", "h_final", "c_final"), got, want):
        close(g, w, atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_reference_matches_pallas_bf16(reverse):
    args, _ = _inputs(8, 4, seed=20 + reverse)
    want = rp.lstm_scan(*_jax_scan(args, jnp.bfloat16), reverse, True)
    bf = [t(a).to(torch.bfloat16) for a in args[:5]]
    got = rnn_kernels.lstm_scan_reference(*bf, t(args[5]), reverse)
    for name, g, w in zip(("h_all", "h_final", "c_final"), got, want):
        assert g.dtype == torch.bfloat16, name
        _bf16_close(g, w, name)


def _jax_grads(args, cot, reverse, dtype):
    xw, w, b, h0, c0, lengths = _jax_scan(args, dtype)
    g_all, g_h, g_c = (jnp.asarray(c).astype(dtype).astype(jnp.float32) for c in cot)

    def f(xw, w, b, h0, c0):
        h_all, h_fin, c_fin = rp.lstm_scan(xw, w, b, h0, c0, lengths, reverse, True)
        return (jnp.sum(h_all.astype(jnp.float32) * g_all)
                + jnp.sum(h_fin.astype(jnp.float32) * g_h)
                + jnp.sum(c_fin.astype(jnp.float32) * g_c))

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(xw, w, b, h0, c0)


def _port_grads(args, cot, reverse, dtype, fn=None):
    leaves = [t(a).to(dtype).requires_grad_() for a in args[:5]]
    lengths = t(args[5])
    if fn is None:
        outs = rnn_kernels.LSTMScanFunction.apply(*leaves, lengths, reverse)
    else:
        outs = fn(*leaves, lengths, reverse)
    return torch.autograd.grad(outs, leaves, [t(c).to(dtype) for c in cot])


GRAD_NAMES = ("dxw", "dw_hh", "db_hh", "dh0", "dc0")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [4, 10])
def test_lstm_backward_matches_pallas_fp32(B, reverse):
    args, cot = _inputs(9, B, seed=B + reverse)
    want = _jax_grads(args, cot, reverse, jnp.float32)
    got = _port_grads(args, cot, reverse, torch.float32)
    for name, g, w in zip(GRAD_NAMES, got, want):
        close(g, w, atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_matches_pallas_bf16(reverse):
    args, cot = _inputs(8, 4, seed=7 + reverse)
    want = _jax_grads(args, cot, reverse, jnp.bfloat16)
    got = _port_grads(args, cot, reverse, torch.bfloat16)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == torch.bfloat16, name
        _bf16_close(g, w, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_function_matches_autograd_of_the_plain_loop(reverse):
    args, cot = _inputs(11, 5, seed=30 + reverse)
    want = _port_grads(args, cot, reverse, torch.float32,
                       fn=rnn_kernels.lstm_scan_reference)
    got = _port_grads(args, cot, reverse, torch.float32)
    for name, g, w in zip(GRAD_NAMES, got, want):
        close(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_xla_scan(reverse):
    """The port's LSTM layer (through ``LSTMScanFunction``) against autodiff
    of the JAX package's plain masked scan (``use_pallas="off"``), through
    the layer's input projection too."""
    T, B, D = 10, 5, 6
    rng = np.random.RandomState(11 + reverse)
    x = rng.randn(B, T, D).astype(np.float32)
    lengths = np.array([10, 7, 4, 2, 1], np.int32)
    gout = rng.randn(B, T, H).astype(np.float32)
    layer = JaxRNNLayer(D, H, "lstm", use_pallas="off", reverse=reverse)
    mask = jnp.arange(T)[None, :] < jnp.asarray(lengths)[:, None]
    variables = layer.init(jax.random.PRNGKey(3), jnp.asarray(x), mask)

    def f(params, x):
        out, (h, c) = layer.apply({"params": params}, x, mask)
        return jnp.sum(out * gout) + jnp.sum(h) + 2.0 * jnp.sum(c)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    port = RNNLayer(D, H, "lstm", reverse=reverse)
    port.load_state_dict({k: t(v) for k, v in variables["params"].items()})
    xt = t(x).requires_grad_()
    out, (h, c) = port(xt, t(lengths))
    ((out * t(gout)).sum() + h.sum() + 2.0 * c.sum()).backward()
    close(xt.grad, want_x)
    for name, p in port.named_parameters():
        close(p.grad, want_p[name], err_msg=name)


def test_lstm_wrappers_on_cpu_are_the_plain_versions():
    args, cot = _inputs(6, 3, seed=9)
    xw, w, b, h0, c0, lengths = [t(a) for a in args]
    before = (rnn_kernels.lstm_scan.launches, rnn_kernels.lstm_scan_backward.launches)
    fwd = rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths, True, with_carry=True)
    for got, want in zip(fwd, rnn_kernels.lstm_scan_reference(
            xw, w, b, h0, c0, lengths, True, with_carry=True)):
        assert torch.equal(got, want)
    h_all, c_all = fwd[:2]
    call = (xw, rnn_kernels.prev_all(h_all, h0, lengths, True),
            rnn_kernels.prev_all(c_all, c0, lengths, True), w, b, lengths,
            *[t(c) for c in cot], True)
    for got, want in zip(rnn_kernels.lstm_scan_backward(*call),
                         rnn_kernels.lstm_scan_backward_reference(*call)):
        assert torch.equal(got, want)
    assert (rnn_kernels.lstm_scan.launches,
            rnn_kernels.lstm_scan_backward.launches) == before


def test_lstm_carry_keeps_c_at_padded_steps():
    """c_all holds the carry (not zeroed), h_all zeros, past a row's length."""
    args, _ = _inputs(6, 3, seed=12)
    xw, w, b, h0, c0, _ = [t(a) for a in args]
    lengths = torch.tensor([6, 3, 0])
    h_all, c_all, h_fin, c_fin = rnn_kernels.lstm_scan_reference(
        xw, w, b, h0, c0, lengths, with_carry=True)
    assert torch.equal(c_all[3:, 1], c_all[2, 1].expand(3, H))
    assert not h_all[3:, 1].any() and not h_all[:, 2].any()
    assert torch.equal(c_all[:, 2], c0[2].expand(6, H))
    assert torch.equal(h_fin[2], h0[2]) and torch.equal(c_fin[1], c_all[2, 1])


def _config_dict():
    return {"model": model_dict(rnn_type="lstm", n_mels=8, vocab=11),
            "data": {"audio": {"spec_augment": False}},
            "train": {"precision": "fp32", "joint_chunk_frames": 256,
                      "learning_rate": 1e-3, "max_steps": 10}}


def test_loss_fn_with_lstm_encoder_matches_jax():
    """A model whose encoder and prediction network are both LSTMs: the loss
    and every param grad at 1e-5 in fp32."""
    d = _config_dict()
    jc, pc = jcfg.Config.from_dict(d), pcfg.Config.from_dict(d)
    jstate = JaxTrainState.create(jc)
    bridge = lambda tree: state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree), pc.model)
    state = TrainState.create(pc, "cpu", state_dict=bridge(jstate.params))
    rng = np.random.RandomState(0)
    B, T, U = 4, 12, 4
    targets = rng.randint(1, 11, size=(B, U)).astype(np.int32)
    batch = {"feats": rng.randn(B, T, 8).astype(np.float32),
             "feat_lengths": np.array([12, 9, 5, 1], np.int32),
             "text_in": np.concatenate([np.zeros((B, 1), np.int32), targets], 1),
             "text_lengths": np.array([5, 4, 2, 1], np.int32),
             "targets": targets, "target_lengths": np.array([4, 3, 1, 0], np.int32)}
    model = JaxTransducer(jc.model)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, jc, p, jb, jax.random.PRNGKey(0),
                              deterministic=True)))(jstate.params)
    params = state.params
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
          for k, v in batch.items()}
    got = loss_fn(state.model, pc, params, tb, None, deterministic=True)
    grads = torch.autograd.grad(got, list(params.values()))
    close(got, want, atol=1e-5, rtol=1e-5)
    want_g = bridge(want_g)
    assert set(want_g) == set(params)
    for (name, _), g in zip(params.items(), grads):
        close(g, want_g[name], atol=1e-5, rtol=1e-5, err_msg=name)


def test_lstm_chain_tiles_hold_each_blocks_rows():
    """The backward kernel's chain layout: block i, row jj holds W_hh[i*jt +
    jj, :], zero past the 4H columns and past H rows."""
    Hs, Kc, jt = 6, 64, 4
    w = torch.arange(Hs * 4 * Hs, dtype=torch.float32).view(Hs, 4 * Hs) + 1
    tiles = rnn_kernels._chain_tiles(w, Hs, Kc, jt)
    assert tiles.shape == (2, jt, Kc)
    flat = tiles.view(-1, Kc)
    assert torch.equal(flat[:Hs, :4 * Hs], w)
    assert not flat[Hs:].any() and not flat[:, 4 * Hs:].any()
    rec = rnn_kernels._tile_weights(w, Hs, Kc, jt)
    assert rec.shape == (2, 4 * jt, Kc)
    assert torch.equal(rec[1, 2 * jt + 1, :Hs], w[:, 2 * Hs + jt + 1])


def _cuda_inputs(T, B, dtype, reverse, seed):
    args, cot = _inputs(T, B, seed)
    xw, w, b, h0, c0, lengths = [t(a).to("cuda") for a in args]
    xw, w, b, h0, c0 = (a.to(dtype) for a in (xw, w, b, h0, c0))
    return (xw, w, b, h0, c0, lengths), [t(c).to("cuda", dtype) for c in cot]


@pytest.mark.cuda
def test_lstm_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, BF16_ULPS)):
        for reverse in (False, True):
            (xw, w, b, h0, c0, lengths), cot = _cuda_inputs(40, 5, dtype, reverse,
                                                            3 + reverse)
            fwd = rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths, reverse, True)
            ref = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths,
                                                  reverse, True)
            for g, r in zip(fwd, ref):
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * max(r.float().abs().max().item(), 1.0)
            call = (xw, rnn_kernels.prev_all(ref[0], h0, lengths, reverse),
                    rnn_kernels.prev_all(ref[1], c0, lengths, reverse), w, b,
                    lengths, *cot, reverse)
            for g, r in zip(rnn_kernels.lstm_scan_backward(*call),
                            rnn_kernels.lstm_scan_backward_reference(*call)):
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * max(r.float().abs().max().item(), 1.0)
