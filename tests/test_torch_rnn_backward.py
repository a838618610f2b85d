"""Parity of the port's GRU backward with the JAX package.

The port's autograd GRU (``GRUScanFunction``: ``gru_scan`` forward, the
plain ``gru_scan_backward_reference`` on the CPU plus the off-loop weight
GEMMs) against ``jax.grad`` through ``rnn_pallas.gru_scan`` in interpret
mode (the TPU kernel's own backward) and through the XLA scan.  The kernel
itself runs only on the card: its test carries the ``cuda`` marker.

Tolerances: fp32 at 1e-6 against the Pallas kernel (same contract, same
order of operations up to the GEMMs' summation order) and at 2e-5 against
the XLA scan (the cells' parity tolerance: autodiff of a plain scan sums in
another order).  bf16 at 4 bf16 ulps of each output's largest magnitude:
both round dxw, dnr and dhw to bf16 at the same places, and a one-ulp flip
of a rounded value feeds the dh chain.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.models.cells import RNNLayer as JaxRNNLayer
from rnntransducer_tpu.ops import rnn_pallas as rp

from rnntransducer_tpu_torch.ops import rnn_kernels

from _torch_parity import close, t

H = 16
BF16_ULPS = 4 * 2.0 ** -8


def _inputs(T, B, seed):
    rng = np.random.RandomState(seed)
    xw = rng.randn(T, B, 3 * H).astype(np.float32)
    w = (rng.randn(H, 3 * H) * 0.4).astype(np.float32)
    b = (rng.randn(3 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.4).astype(np.float32)
    lengths = np.maximum(T - 3 * np.arange(B), 1).astype(np.float32)
    lengths[-1] = 1
    g_all = rng.randn(T, B, H).astype(np.float32)
    g_fin = rng.randn(B, H).astype(np.float32)
    return (xw, w, b, h0, lengths), (g_all, g_fin)


def _jax_grads(args, cot, reverse, dtype, interpret=True):
    xw, w, b, h0, lengths = [jnp.asarray(a) for a in args]
    xw, w, b, h0 = (a.astype(dtype) for a in (xw, w, b, h0))
    g_all, g_fin = (jnp.asarray(c).astype(dtype) for c in cot)

    def f(xw, w, b, h0):
        h_all, h_fin = rp.gru_scan(xw, w, b, h0, lengths, reverse, interpret)
        return (jnp.sum(h_all.astype(jnp.float32) * g_all.astype(jnp.float32))
                + jnp.sum(h_fin.astype(jnp.float32) * g_fin.astype(jnp.float32)))

    return jax.grad(f, argnums=(0, 1, 2, 3))(xw, w, b, h0)


def _port_grads(args, cot, reverse, dtype):
    xw, w, b, h0 = [t(a).to(dtype).requires_grad_() for a in args[:4]]
    lengths = t(args[4])
    outs = rnn_kernels.GRUScanFunction.apply(xw, w, b, h0, lengths, reverse)
    cots = [t(c).to(dtype) for c in cot]
    return torch.autograd.grad(outs, (xw, w, b, h0), cots)


def _bf16_close(got, want, name):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = BF16_ULPS * np.abs(want).max()
    close(got, want, atol=tol, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [4, 10])
def test_gru_backward_matches_pallas_fp32(B, reverse):
    args, cot = _inputs(9, B, seed=B + reverse)
    want = _jax_grads(args, cot, reverse, jnp.float32)
    got = _port_grads(args, cot, reverse, torch.float32)
    for name, g, w in zip(("dxw", "dw_hh", "db_hh", "dh0"), got, want):
        close(g, w, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_matches_pallas_bf16(reverse):
    args, cot = _inputs(8, 4, seed=7 + reverse)
    want = _jax_grads(args, cot, reverse, jnp.bfloat16)
    got = _port_grads(args, cot, reverse, torch.bfloat16)
    for name, g, w in zip(("dxw", "dw_hh", "db_hh", "dh0"), got, want):
        assert g.dtype == torch.bfloat16, name
        _bf16_close(g, w, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_matches_xla_scan(reverse):
    """Against autodiff of the JAX package's plain masked scan
    (``use_pallas="off"``), through the layer's input projection too."""
    T, B, D = 10, 5, 6
    rng = np.random.RandomState(11 + reverse)
    x = rng.randn(B, T, D).astype(np.float32)
    lengths = np.array([10, 7, 4, 2, 1], np.int32)
    gout = rng.randn(B, T, H).astype(np.float32)
    layer = JaxRNNLayer(D, H, "gru", use_pallas="off", reverse=reverse)
    mask = jnp.arange(T)[None, :] < jnp.asarray(lengths)[:, None]
    variables = layer.init(jax.random.PRNGKey(3), jnp.asarray(x), mask)

    def f(params, x):
        out, _ = layer.apply({"params": params}, x, mask)
        return jnp.sum(out * gout)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))

    from rnntransducer_tpu_torch.models.cells import RNNLayer
    port = RNNLayer(D, H, "gru", reverse=reverse)
    port.load_state_dict({k: t(v) for k, v in variables["params"].items()})
    xt = t(x).requires_grad_()
    out, _ = port(xt, t(lengths))
    (out * t(gout)).sum().backward()
    close(xt.grad, want_x)
    for name, p in port.named_parameters():
        close(p.grad, want_p[name], err_msg=name)


def test_prev_all_reversed_masked_prefix_keeps_h0():
    """Reversed scan: a row's masked steps come first in processing order
    and leave the carry at h0, so their successors' predecessor is h0."""
    T, B = 5, 2
    h_all = torch.arange(1, T * B * H + 1, dtype=torch.float32).view(T, B, H)
    h0 = torch.full((B, H), -1.0)
    lengths = torch.tensor([5, 2])
    fwd = rnn_kernels.prev_all(h_all, h0, lengths, reverse=False)
    assert torch.equal(fwd[0], h0) and torch.equal(fwd[1:], h_all[:-1])
    rev = rnn_kernels.prev_all(h_all, h0, lengths, reverse=True)
    assert torch.equal(rev[:4, 0], h_all[1:, 0])
    assert torch.equal(rev[4, 0], h0[0])
    assert torch.equal(rev[0, 1], h_all[1, 1])
    assert torch.equal(rev[1:, 1], h0[1].expand(4, H))


def test_gru_function_counts_missing_cotangents_as_zeros():
    args, _ = _inputs(6, 3, seed=5)
    xw, w, b, h0 = [t(a).requires_grad_() for a in args[:4]]
    h_all, _ = rnn_kernels.GRUScanFunction.apply(xw, w, b, h0, t(args[4]), False)
    got = torch.autograd.grad(h_all.sum(), (xw, w, b, h0))
    want = _jax_grads(args, (np.ones((6, 3, H), np.float32),
                             np.zeros((3, H), np.float32)), False, jnp.float32)
    for g, w_ in zip(got, want):
        close(g, w_, atol=1e-6)


def test_gru_backward_on_cpu_is_the_plain_version():
    args, cot = _inputs(6, 3, seed=9)
    xw, w, b, h0, lengths = [t(a) for a in args]
    h_all, _ = rnn_kernels.gru_scan(xw, w, b, h0, lengths)
    hp = rnn_kernels.prev_all(h_all, h0, lengths)
    call = (xw, hp, w, b, lengths, t(cot[0]), t(cot[1]))
    before = rnn_kernels.gru_scan_backward.launches
    for got, want in zip(rnn_kernels.gru_scan_backward(*call),
                         rnn_kernels.gru_scan_backward_reference(*call)):
        assert torch.equal(got, want)
    assert rnn_kernels.gru_scan_backward.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_function_equals_two_scan_functions(dtype):
    """GRUPairScanFunction (both directions, one paired backward) gives the
    outputs and grads of two GRUScanFunction applications bit for bit, ragged
    lengths (T, 7, 4, 2, 1) and missing cotangents included."""
    T, B = 10, 5
    lengths = t(np.array([10, 7, 4, 2, 1], np.int32))
    leaves = []
    for seed in (21, 22):
        args, _ = _inputs(T, B, seed)
        leaves.append([t(a).to(dtype).requires_grad_() for a in args[:4]])
    rng = np.random.RandomState(23)
    g_f = t(rng.randn(T, B, H).astype(np.float32)).to(dtype)
    g_b = t(rng.randn(T, B, H).astype(np.float32)).to(dtype)
    g_fin = t(rng.randn(B, H).astype(np.float32)).to(dtype)
    pair = rnn_kernels.GRUPairScanFunction.apply(*leaves[0], *leaves[1], lengths)
    one = (rnn_kernels.GRUScanFunction.apply(*leaves[0], lengths, False)
           + rnn_kernels.GRUScanFunction.apply(*leaves[1], lengths, True))
    for a, b in zip(pair, one):
        assert torch.equal(a, b)

    def grads(outs):
        # no cotangent for the forward direction's final state
        loss = ((outs[0].float() * g_f.float()).sum() + (outs[2].float() * g_b.float()).sum()
                + (outs[3].float() * g_fin.float()).sum())
        return torch.autograd.grad(loss, leaves[0] + leaves[1])

    for name, g, w in zip(("dxw", "dw_hh", "db_hh", "dh0") * 2, grads(pair), grads(one)):
        assert g.dtype == dtype and torch.equal(g, w), name


@pytest.mark.parametrize("remat", [False, True])
def test_bidirectional_stack_grads_unchanged_through_the_pair(monkeypatch, remat):
    """A bidirectional GRU StackedRNN's outputs, final state and loss grads
    (input and every weight) are the same bit for bit whether its layers run
    their directions one by one or as pairs, with inter-layer dropout and
    ragged lengths (0 included); under ``remat`` each pair is recomputed in
    the backward as one unit."""
    from rnntransducer_tpu_torch.models.cells import StackedRNN

    def run(paired):
        torch.manual_seed(1)
        rnn = StackedRNN(12, H, 3, "gru", bidirectional=True, dropout=0.2,
                         remat=remat and paired)
        for p in rnn.parameters():
            torch.nn.init.uniform_(p, -0.3, 0.3)
        x = torch.randn(4, 9, 12, requires_grad=True)
        taken = []

        def applies(x, hidden):
            taken.append(paired)
            return paired
        monkeypatch.setattr(rnn_kernels, "gru_pair_applies", applies)
        out, state = rnn(x, torch.tensor([9, 6, 2, 0]), generator=torch.Generator().manual_seed(5))
        loss = (out ** 2).sum() + (state.h * torch.linspace(-1, 1, H)).sum()
        assert taken == [paired] * 3
        return (out, state.h) + torch.autograd.grad(loss, [x] + list(rnn.parameters()))

    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gru_backward_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, BF16_ULPS)):
        for reverse in (False, True):
            args, cot = _inputs(40, 5, seed=3 + reverse)
            xw, w, b, h0, lengths = [t(a).to("cuda") for a in args]
            xw, w, b, h0 = (a.to(dtype) for a in (xw, w, b, h0))
            h_all, _ = rnn_kernels.gru_scan(xw, w, b, h0, lengths, reverse)
            hp = rnn_kernels.prev_all(h_all, h0, lengths, reverse)
            call = (xw, hp, w, b, lengths, t(cot[0]).to("cuda", dtype),
                    t(cot[1]).to("cuda", dtype), reverse)
            got = rnn_kernels.gru_scan_backward(*call)
            want = rnn_kernels.gru_scan_backward_reference(*call)
            for g, r in zip(got, want):
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * max(r.float().abs().max().item(), 1.0)
