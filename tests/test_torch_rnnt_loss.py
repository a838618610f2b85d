"""Parity of the port's RNN-T loss with the JAX package and the NumPy oracle.

``sweep_reference`` (the plain version the port's sweep kernel is held
against on the card) against the Pallas kernel in interpret mode and the
XLA tier; the losses and their logits gradients (unfused, factored, fused;
FastEmit; full and ragged lengths) against the JAX functions and
``rnnt_numpy`` at the JAX package's own tolerance, 1e-5.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.ops import rnnt_numpy
from rnntransducer_tpu.ops.rnnt_pallas import sweep_pallas

from rnntransducer_tpu_torch.ops import rnnt_kernels, rnnt_loss as pl

from _torch_parity import close, t

# the JAX package's ops/__init__ exports the function under the module's name
jl = importlib.import_module("rnntransducer_tpu.ops.rnnt_loss")
TOL = 1e-5


def _case(B, T, U, V, full, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    labels = rng.randint(1, V, size=(B, U)).astype(np.int32)
    if full:
        t_len = np.full((B,), T, np.int32)
        u_len = np.full((B,), U, np.int32)
    else:
        t_len = rng.randint(max(1, T // 2), T + 1, size=(B,)).astype(np.int32)
        u_len = rng.randint(0, U + 1, size=(B,)).astype(np.int32)
        t_len[0], u_len[0] = T, U
    return logits, labels, t_len, u_len


def _edges(N, T, U1, seed):
    rng = np.random.RandomState(seed)
    lp = rng.randn(N, T, U1, 6).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return lp[..., 0], lp[..., 3]


# T = 300 is no multiple of the Pallas kernel's 128 lanes; T = 9000 is above
# the 8192 steps the port's earlier kernel took
@pytest.mark.parametrize("N,T,U1", [(3, 7, 4), (2, 24, 6), (1, 1, 1), (4, 130, 3),
                                    (2, 300, 5), (2, 9000, 5)])
def test_sweep_reference_matches_pallas_and_xla(N, T, U1):
    be, le = _edges(N, T, U1, seed=T)
    got = rnnt_kernels.sweep_reference(t(be), t(le))
    want_pallas = sweep_pallas(jnp.asarray(be), jnp.asarray(le), interpret=True)
    want_xla = jl._sweep(jnp.asarray(be), jnp.asarray(le))
    # alpha grows like T+U log-probs: relative to max(|alpha|, 1)
    scale = max(1.0, float(np.abs(np.asarray(want_xla)).max()))
    close(got, want_pallas, atol=TOL * scale)
    close(got, want_xla, atol=TOL * scale)


@pytest.mark.parametrize("N,T,U1,chunk", [(2, 300, 5, 128), (3, 1030, 11, 512),
                                          (2, 9000, 5, 512), (1, 7, 1, 3),
                                          (2, 24, 9, 5)])
def test_chunked_sweep_matches_the_plain_sweep(N, T, U1, chunk):
    """The kernel's decomposition (T in chunks, each column's running sum
    and running logsumexp carried between chunks) computes the plain sweep,
    also with -1e30 fills."""
    be, le = _edges(N, T, U1, seed=T + U1)
    le[:, T // 2:, -1] = pl.NEG
    got = rnnt_kernels.sweep_chunked_reference(t(be), t(le), chunk)
    want = rnnt_kernels.sweep_reference(t(be), t(le))
    assert got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    close(got, want.numpy(), atol=TOL * scale)


def test_sweep_on_cpu_is_the_plain_version_and_neg_safe():
    be, le = _edges(2, 9, 4, seed=1)
    be[:, -1] = pl.NEG          # the flipped lattice's shifted fills
    le[:, :, -1] = pl.NEG
    before = rnnt_kernels.sweep.launches
    got = rnnt_kernels.sweep(t(be), t(le))
    assert torch.equal(got, rnnt_kernels.sweep_reference(t(be), t(le)))
    assert rnnt_kernels.sweep.launches == before
    assert torch.isfinite(got).all()
    want = jl._sweep(jnp.asarray(be), jnp.asarray(le))
    close(got, want, atol=TOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _port_loss_and_grad(fn, logits, *args, **kw):
    lg = t(logits).requires_grad_()
    loss = fn(lg, *[t(a) for a in args], **kw)
    (g,) = torch.autograd.grad(loss.sum(), lg)
    return loss.detach(), g


@pytest.mark.parametrize("shape,full,lam", [
    ((2, 5, 3, 7), True, 0.0),
    ((3, 8, 4, 11), False, 0.0),
    ((3, 8, 4, 11), False, 0.01),
    ((1, 1, 0, 5), True, 0.0),
    ((2, 12, 6, 11), False, 0.5),
])
def test_rnnt_loss_matches_jax_and_oracle(shape, full, lam):
    logits, labels, t_len, u_len = _case(*shape, full, seed=sum(shape))
    got_l, got_g = _port_loss_and_grad(pl.rnnt_loss, logits, labels, t_len, u_len,
                                       reduction="none", fastemit_lambda=lam)
    f = lambda lg: jl.rnnt_loss(lg, jnp.asarray(labels), jnp.asarray(t_len),
                                jnp.asarray(u_len), reduction="none",
                                fastemit_lambda=lam)
    want_l, vjp = jax.vjp(f, jnp.asarray(logits))
    (want_g,) = vjp(jnp.ones_like(want_l))
    close(got_l, want_l, atol=TOL, rtol=TOL)
    close(got_g, want_g, atol=TOL, rtol=TOL)
    oracle_l, oracle_g = rnnt_numpy.rnnt_loss(logits, labels, t_len, u_len,
                                              reduction="sum", fastemit_lambda=lam)
    close(got_l.sum(), oracle_l, atol=TOL, rtol=TOL)
    close(got_g, oracle_g, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_rnnt_loss_reductions(reduction):
    logits, labels, t_len, u_len = _case(2, 6, 3, 7, False, seed=4)
    got = pl.rnnt_loss(t(logits), t(labels), t(t_len), t(u_len), reduction=reduction)
    want = jl.rnnt_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(t_len),
                        jnp.asarray(u_len), reduction=reduction)
    close(got, want, atol=TOL, rtol=TOL)


def _factors(B, T, U, V, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    A = (rng.randn(B, T, V) * scale).astype(np.float32)
    C = (rng.randn(B, U + 1, V) * scale).astype(np.float32)
    labels = rng.randint(1, V, size=(B, U)).astype(np.int32)
    t_len = np.array([T] + [max(1, T - 2 * i) for i in range(1, B)], np.int32)
    u_len = np.array([U] + [max(0, U - i) for i in range(1, B)], np.int32)
    return A, C, labels, t_len, u_len


@pytest.mark.parametrize("lam", [0.0, 0.02])
def test_rnnt_loss_factored_matches_jax(lam):
    A, C, labels, t_len, u_len = _factors(3, 9, 4, 11, seed=5)
    At, Ct = t(A).requires_grad_(), t(C).requires_grad_()
    got = pl.rnnt_loss_factored(At, Ct, t(labels), t(t_len), t(u_len),
                                fastemit_lambda=lam)
    gA, gC = torch.autograd.grad(got, (At, Ct))
    f = lambda a, c: jl.rnnt_loss_factored(a, c, jnp.asarray(labels),
                                           jnp.asarray(t_len), jnp.asarray(u_len),
                                           fastemit_lambda=lam)
    want, (wA, wC) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A),
                                                           jnp.asarray(C))
    close(got, want, atol=TOL, rtol=TOL)
    close(gA, wA, atol=TOL, rtol=TOL)
    close(gC, wC, atol=TOL, rtol=TOL)
    # the factored lattice is the unfused one: logits = A[:, :, None] + C[:, None]
    want_u = pl.rnnt_loss(t(A)[:, :, None] + t(C)[:, None], t(labels), t(t_len),
                          t(u_len), fastemit_lambda=lam)
    close(got, want_u, atol=TOL, rtol=TOL)


def test_factored_lattice_extreme_scales_match_jax():
    """Anti-aligned factor peaks push the stabilized product toward fp32
    underflow; both floor it at the fp32 tiny (``tests/test_rnnt_loss.py``)."""
    B, T, U1, V = 1, 4, 3, 8
    A = np.full((B, T, V), -60.0, np.float32)
    C = np.full((B, U1, V), -60.0, np.float32)
    A[..., 0], C[..., 0] = 60.0, -120.0
    C[..., 1], A[..., 1] = 60.0, -120.0
    labels = np.full((B, U1 - 1), 2, np.int32)
    At, Ct = t(A).requires_grad_(), t(C).requires_grad_()
    bl, lb = pl.factored_compact_lattice(At, Ct, t(labels))
    gA, gC = torch.autograd.grad(bl.sum() + lb.sum(), (At, Ct))

    def f(a, c):
        jbl, jlb = jl.factored_compact_lattice(a, c, jnp.asarray(labels))
        return jnp.sum(jbl) + jnp.sum(jlb), (jbl, jlb)

    (_, (wbl, wlb)), (wA, wC) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(A), jnp.asarray(C))
    for got in (bl, lb, gA, gC):
        assert torch.isfinite(got).all()
    close(bl, wbl, atol=TOL, rtol=TOL)
    close(lb, wlb, atol=TOL, rtol=TOL)
    close(gA, wA, atol=TOL, rtol=TOL)
    close(gC, wC, atol=TOL, rtol=TOL)


def test_factored_gemms_ignore_the_global_tf32_flag(monkeypatch):
    """Forward and backward GEMMs run with TF32 off, and the flag is
    restored after each."""
    m = torch.backends.cuda.matmul
    seen = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b: seen.append(m.allow_tf32) or bmm(a, b))
    saved = m.allow_tf32
    m.allow_tf32 = True
    try:
        A, C, labels, _, _ = _factors(2, 5, 3, 7, seed=6)
        At = t(A).requires_grad_()
        bl, _ = pl.factored_compact_lattice(At, t(C), t(labels))
        torch.autograd.grad(bl.sum(), At)
        assert m.allow_tf32 is True
    finally:
        m.allow_tf32 = saved
    assert len(seen) == 3 and not any(seen)  # S, a_lab, dS @ EC


@pytest.mark.parametrize("chunk", [4, 64])
def test_rnnt_loss_fused_matches_jax(chunk):
    rng = np.random.RandomState(8)
    B, T, U, De, Dd, V = 2, 10, 3, 5, 4, 9
    enc = rng.randn(B, T, De).astype(np.float32)
    dec = rng.randn(B, U + 1, Dd).astype(np.float32)
    w = (rng.randn(De + Dd, V) * 0.5).astype(np.float32)
    labels = rng.randint(1, V, size=(B, U)).astype(np.int32)
    t_len, u_len = np.array([10, 7], np.int32), np.array([3, 1], np.int32)

    def jax_joint(e, d, w):
        e4 = jnp.broadcast_to(e[:, :, None], e.shape[:2] + (d.shape[1], De))
        d4 = jnp.broadcast_to(d[:, None], (e.shape[0], e.shape[1]) + d.shape[1:])
        return jnp.tanh(jnp.concatenate([e4, d4], -1)) @ w

    def jf(e, d, w):
        return jl.rnnt_loss_fused(lambda a, b: jax_joint(a, b, w), e, d,
                                  jnp.asarray(labels), jnp.asarray(t_len),
                                  jnp.asarray(u_len), chunk_frames=chunk,
                                  fastemit_lambda=0.1)

    want, wgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(w))
    et, dt, wt = (t(a).requires_grad_() for a in (enc, dec, w))

    def port_joint(e, d):
        e4 = e[:, :, None].expand(*e.shape[:2], d.shape[1], De)
        d4 = d[:, None].expand(e.shape[0], e.shape[1], *d.shape[1:])
        return torch.tanh(torch.cat([e4, d4], -1)) @ wt

    got = pl.rnnt_loss_fused(port_joint, et, dt, t(labels), t(t_len), t(u_len),
                             chunk_frames=chunk, fastemit_lambda=0.1)
    ggrads = torch.autograd.grad(got, (et, dt, wt))
    close(got, want, atol=TOL, rtol=TOL)
    for g, w_ in zip(ggrads, wgrads):
        close(g, w_, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_sweep_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for N, T, U1 in ((5, 37, 4), (3, 1100, 6), (2, 9000, 5), (2, 300, 20)):
        be, le = (t(a).cuda() for a in _edges(N, T, U1, seed=N))
        got = rnnt_kernels.sweep(be, le)
        want = rnnt_kernels.sweep_reference(be, le)
        err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        assert err <= TOL, (N, T, U1, err)
