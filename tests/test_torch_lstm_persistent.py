"""The persistent LSTM kernels' pieces that run without a card.

The kernels themselves (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) run only
on the card (the ``cuda`` test below and ``chip_smoke.py``).  Here: the
layouts the wrappers hand them, the co-residency limit and the route it
chooses (a stand-in library records which export a call reaches), the plain
mirrors of the backward's two pieces (the off-chain gates GEMM and the
chain) against numpy and against ``jax.grad`` through
``rnn_pallas.lstm_scan`` in interpret mode.

Tolerances: the gates GEMM at 1e-6 against numpy in float64 (fp32 sums of
H=16 terms); the decomposed backward at 1e-6 absolute in fp32 against the
Pallas kernel and against the undecomposed plain backward.
"""

import contextlib
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.ops import rnn_pallas as rp

from rnntransducer_tpu_torch.ops import rnn_kernels

from _torch_parity import close, t

H = 16
SMEM_LIMIT = 232448    # 227 KB, the shared memory one block may use


def _inputs(T, B, seed, hidden=H):
    rng = np.random.RandomState(seed)
    xw = rng.randn(T, B, 4 * hidden).astype(np.float32)
    w = (rng.randn(hidden, 4 * hidden) * 0.4).astype(np.float32)
    b = (rng.randn(4 * hidden) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, hidden) * 0.4).astype(np.float32)
    c0 = (rng.randn(B, hidden) * 0.8).astype(np.float32)
    lengths = np.maximum(T - 3 * np.arange(B), 1).astype(np.float32)
    lengths[-1] = 1
    cot = tuple(rng.randn(*s).astype(np.float32)
                for s in ((T, B, hidden), (B, hidden), (B, hidden)))
    return (xw, w, b, h0, c0, lengths), cot


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jt", [8, 4])
def test_forward_tiles_hold_each_blocks_gate_rows(jt):
    """Block i of the forward holds 4 jt rows: row q*jt + jj is the gate-q
    column of unit j = jt i + jj, transposed so K runs along it, zero for
    k >= H and for j >= H."""
    Hs = 12
    Hk = rnn_kernels._padded(Hs)
    w = torch.arange(Hs * 4 * Hs, dtype=torch.float32).view(Hs, 4 * Hs) + 1
    tiles = rnn_kernels._tile_weights(w, Hs, Hk, jt)
    nb = -(-Hs // jt)
    assert tiles.shape == (nb, 4 * jt, Hk)
    for i in range(nb):
        for q in range(4):
            for jj in range(jt):
                row = tiles[i, q * jt + jj]
                j = i * jt + jj
                if j < Hs:
                    assert torch.equal(row[:Hs], w[:, q * Hs + j])
                else:
                    assert not row.any()
                assert not row[Hs:].any()


def test_tile_width_by_hidden_size():
    """4 units per block while ceil(H / 4) blocks fit 132 SMs, else 8."""
    for Hs in (1, 16, 320, 527, 528):
        assert rnn_kernels.lstm_tile_width(Hs) == 4
    for Hs in (529, 640, 1024, 1056, 2048):
        assert rnn_kernels.lstm_tile_width(Hs) == 8


@pytest.mark.parametrize("jt", [8, 4])
def test_chain_tiles_hold_each_blocks_rows(jt):
    """Block i of the backward's chain holds 8 rows: rows jj < jt are
    W_hh[jt i + jj, :] padded to Kc with zeros, the rest zero (the MMA's
    8-wide n-tile); rows j >= H are zero."""
    Hs = 12
    Kc = rnn_kernels._padded(4 * Hs)
    w = torch.arange(Hs * 4 * Hs, dtype=torch.float32).view(Hs, 4 * Hs) + 1
    tiles = rnn_kernels._lstm_chain_tiles(w, Hs, Kc, jt)
    nb = -(-Hs // jt)
    assert tiles.shape == (nb, 8, Kc) and tiles.is_contiguous()
    for i in range(nb):
        for r in range(8):
            row, j = tiles[i, r], i * jt + r
            if r < jt and j < Hs:
                assert torch.equal(row[:4 * Hs], w[j])
                assert not row[4 * Hs:].any()
            else:
                assert not row.any()


# ---------------------------------------------------------------------------
# the co-residency limit and the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hs", [320, 1024, 1056])
def test_shared_memory_per_block(Hs, dtype):
    """The wrappers' mirror of rnn_persistent.cuh::slice_smem: forward 4 JT
    rows of Hk, backward 8 chain rows of Kc, bf16 rows padded by 32 values,
    plus the 128-row fp32 dot buffer; each within 227 KB."""
    e, pad = (2, 32) if dtype == torch.bfloat16 else (4, 0)
    jt = rnn_kernels.lstm_tile_width(Hs)
    Hk, Kc = rnn_kernels._padded(Hs), rnn_kernels._padded(4 * Hs)
    fwd = rnn_kernels.lstm_smem_bytes(Hs, dtype)
    bwd = rnn_kernels.lstm_smem_bytes(Hs, dtype, backward=True)
    assert fwd == e * 4 * jt * (Hk + pad) + 4 * 128 * 4 * jt
    assert bwd == e * 8 * (Kc + pad) + 4 * 128 * 8
    assert fwd <= SMEM_LIMIT and bwd <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 64, 100])
def test_coresidency_limit(B, dtype):
    """One block per SM on 132 SMs: H=320, 1024 and 1056 fit in both dtypes
    at every B, H=1057 does not and takes the per-step kernels."""
    assert rnn_kernels.lstm_max_hidden(B, dtype) == 1056
    for Hs in (1, 8, 320, 1000, 1024, 1056):
        assert rnn_kernels.lstm_fits(Hs, B, dtype)
        assert rnn_kernels.lstm_route(Hs, B, dtype) == "persistent"
    for Hs in (1057, 1064, 2048):
        assert not rnn_kernels.lstm_fits(Hs, B, dtype)
        assert rnn_kernels.lstm_route(Hs, B, dtype) == "per_step"


class _StandInLibrary:
    """Records each export a wrapper calls and returns success; launches
    nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def export(*args):
            self.calls.append((name, args))
            return 0
        return export


@pytest.fixture
def stand_in(monkeypatch):
    """The LSTM libraries replaced by a recorder, and torch.cuda's device
    and stream calls by no-ops, so the CUDA wrappers' routing runs on CPU
    tensors."""
    lib = _StandInLibrary()
    monkeypatch.setattr(rnn_kernels.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("Hs, route", [(16, "persistent"), (1057, "per_step")])
def test_route_is_chosen_from_the_shape(stand_in, Hs, route):
    """The wrappers pick the export from (H, B, dtype) alone before any
    launch: the persistent scan (1 + 2 launches counted) or, above the
    limit, the per-step kernels (T + T + 1), never both."""
    T, B = 3, 2
    (xw, w, b, h0, c0, lengths), cot = _inputs(T, B, seed=5, hidden=Hs)
    xw, w, b, h0, c0, lengths = (t(a) for a in (xw, w, b, h0, c0, lengths))
    seq = torch.zeros(T, B, Hs)
    before = (rnn_kernels.lstm_scan.launches, rnn_kernels.lstm_scan_backward.launches)
    rnn_kernels._lstm_scan_cuda(xw, w, b, h0, c0, lengths, False)
    rnn_kernels._lstm_scan_backward_cuda(xw, seq, seq, w, b, lengths, seq, h0, c0, True)
    names = [name for name, _ in stand_in.calls]
    counted = (rnn_kernels.lstm_scan.launches - before[0],
               rnn_kernels.lstm_scan_backward.launches - before[1])
    if route == "persistent":
        assert names == ["lstm_scan_fwd", "lstm_scan_bwd"]
        assert counted == (1, 2)
        fwd_args, bwd_args = stand_in.calls[0][1], stand_in.calls[1][1]
        jt = rnn_kernels.lstm_tile_width(Hs)
        assert fwd_args[12:17] == (T, B, Hs, 64, jt)         # T, B, H, Hk, jt
        assert bwd_args[16:22] == (T, B, Hs, 64, 64, jt)     # ..., Kc, jt
    else:
        assert names == ["lstm_scan_fwd_step", "lstm_scan_bwd_step"]
        assert counted == (T, T + 1)


# ---------------------------------------------------------------------------
# the plain mirrors of the backward's two pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gates_reference_matches_numpy(dtype):
    """hw = h_prev @ W_hh + b_hh in fp32, (T, B, 4H), from operands rounded
    to W's dtype, against numpy in float64 on the same rounded operands."""
    rng = np.random.RandomState(6)
    h_prev = torch.from_numpy(rng.randn(5, 3, H).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(H, 4 * H).astype(np.float32) * 0.4).to(dtype)
    b = torch.from_numpy(rng.randn(4 * H).astype(np.float32) * 0.1).to(dtype)
    got = rnn_kernels.lstm_bwd_gates_reference(h_prev, w, b)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 4 * H)
    want = (h_prev.double().numpy() @ w.double().numpy()) + b.double().numpy()
    close(got, want, atol=1e-6)


def _jax_grads(args, cot, reverse):
    xw, w, b, h0, c0, lengths = [jnp.asarray(a) for a in args]
    g_all, g_h, g_c = (jnp.asarray(c) for c in cot)

    def f(xw, w, b, h0, c0):
        h_all, h_fin, c_fin = rp.lstm_scan(xw, w, b, h0, c0, lengths, reverse, True)
        return jnp.sum(h_all * g_all) + jnp.sum(h_fin * g_h) + jnp.sum(c_fin * g_c)

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(xw, w, b, h0, c0)


def _decomposed(args, cot, reverse):
    """The kernel's decomposition with plain pieces: the hoisted gates,
    then the chain, then the off-loop weight GEMMs."""
    xw, w, b, h0, c0, lengths = [t(a) for a in args]
    h_all, c_all, _, _ = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths,
                                                         reverse, with_carry=True)
    h_prev = rnn_kernels.prev_all(h_all, h0, lengths, reverse)
    c_prev = rnn_kernels.prev_all(c_all, c0, lengths, reverse)
    hw = rnn_kernels.lstm_bwd_gates_reference(h_prev, w, b)
    g = [t(c) for c in cot]
    dxw, dh0, dc0 = rnn_kernels.lstm_bwd_chain_reference(xw, hw, c_prev, w, lengths,
                                                         *g, reverse)
    dw, db = rnn_kernels.lstm_weight_grads(h_prev, dxw, w.dtype)
    return (dxw, dw, db, dh0, dc0), (xw, h_prev, c_prev, w, b, lengths, *g)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [4, 10])
def test_decomposed_backward_matches_pallas_fp32(B, reverse):
    """Hoisted gates plus chain give dxw, dW_hh, db_hh, dh0 and dc0 of
    jax.grad through the Pallas kernel in interpret mode."""
    args, cot = _inputs(9, B, seed=50 + B + reverse)
    want = _jax_grads(args, cot, reverse)
    got, _ = _decomposed(args, cot, reverse)
    for name, g, w in zip(("dxw", "dw_hh", "db_hh", "dh0", "dc0"), got, want):
        close(g, w, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_chain_reference_matches_the_plain_backward(reverse):
    """The chain mirror gives the undecomposed plain backward's dxw, dh0 and
    dc0, ragged lengths (1 and T) included."""
    args, cot = _inputs(7, 5, seed=61 + reverse)
    (dxw, _, _, dh0, dc0), call = _decomposed(args, cot, reverse)
    xw, h_prev, c_prev, w, b, lengths, g_all, g_h, g_c = call
    want = rnn_kernels.lstm_scan_backward_reference(xw, h_prev, c_prev, w, b, lengths,
                                                    g_all, g_h, g_c, reverse)
    for name, g, r in zip(("dxw", "dh0", "dc0"), (dxw, dh0, dc0), want):
        close(g, r, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_persistent_kernels_match_plain_versions_on_the_card():
    """Both routes, B=100 (two 64-row chunks) included, against the plain
    versions: fp32 1e-5, bf16 4 ulps of each output's largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4 * 2.0 ** -8)):
        for Hs, B, reverse in ((H, 5, False), (H, 100, True), (1057, 3, False)):
            args, cot = _inputs(12, B, seed=70 + B + reverse, hidden=Hs)
            xw, w, b, h0, c0, lengths = [t(a).to("cuda") for a in args]
            xw, w, b, h0, c0 = (a.to(dtype) for a in (xw, w, b, h0, c0))
            fwd = rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths, reverse, True)
            ref = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths, reverse,
                                                  True)
            for g, r in zip(fwd, ref):
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * max(r.float().abs().max().item(), 1.0)
            call = (xw, rnn_kernels.prev_all(ref[0], h0, lengths, reverse),
                    rnn_kernels.prev_all(ref[1], c0, lengths, reverse), w, b, lengths,
                    *[t(c).to("cuda", dtype) for c in cot], reverse)
            for g, r in zip(rnn_kernels.lstm_scan_backward(*call),
                            rnn_kernels.lstm_scan_backward_reference(*call)):
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * max(r.float().abs().max().item(), 1.0)
