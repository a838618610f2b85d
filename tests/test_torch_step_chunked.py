"""The per-step recurrent kernels above their whole-slice limits (route
"step_chunked", csrc/step_stream.cuh): the route is chosen from the shape
before any launch, the wrappers reach the streamed exports with the per-step
launch counts, and the plain mirror of the streamed arithmetic (every
recurrent product summed over K in chunks) matches the plain version at
2e-5.  The kernels themselves run only on the card (the `cuda` test)."""

import numpy as np
import pytest
import torch

from rnntransducer_tpu_torch.ops import rnn_kernels

from test_torch_lstm_persistent import stand_in  # noqa: F401 (fixture)

SMEM_LIMIT = 232448     # the shared memory an H100 block may opt in to

# the whole-slice per-step limits on an H100 (fp32, bf16), forward / backward
LIMITS = {("gru", False): (2304, 4672), ("gru", True): (1152, 2304),
          ("lstm", False): (3520, 7104), ("lstm", True): (1760, 3520)}


@pytest.mark.parametrize("cell, backward", sorted(LIMITS))
def test_route_is_step_chunked_only_above_the_whole_slice_limit(cell, backward):
    route = rnn_kernels.gru_route if cell == "gru" else rnn_kernels.lstm_route
    for dtype, top in zip((torch.float32, torch.bfloat16), LIMITS[(cell, backward)]):
        assert rnn_kernels.step_max_hidden(cell, dtype, backward) == top
        assert route(1024, 64, dtype, backward=backward) == "persistent"
        assert route(1057, 64, dtype, backward=backward) == "per_step"
        assert route(top, 8, dtype, backward=backward) == "per_step"
        assert route(top + 1, 8, dtype, backward=backward) == "step_chunked"
        assert route(4 * top, 8, dtype, backward=backward) == "step_chunked"
        # the streamed block's shared memory does not grow with H
        assert rnn_kernels.step_chunked_smem_bytes(cell, dtype, backward) <= SMEM_LIMIT // 2


def test_wide_layers_take_the_routes_they_should():
    """fp32 GRU H=1280 and LSTM H=2048 (He et al. 2019's streaming RNN-T)
    stream only backward; bf16 GRU H=4800 streams forward; bf16 LSTM H=3584
    streams backward."""
    f32, b16 = torch.float32, torch.bfloat16
    r = rnn_kernels
    assert (r.gru_route(1280, 8, f32), r.gru_route(1280, 8, f32, backward=True)) == (
        "per_step", "step_chunked")
    assert (r.lstm_route(2048, 8, f32), r.lstm_route(2048, 8, f32, backward=True)) == (
        "per_step", "step_chunked")
    assert r.gru_route(4800, 8, b16) == "step_chunked"
    assert r.lstm_route(3584, 8, b16, backward=True) == "step_chunked"
    # a card with less shared memory streams from a lower H
    assert r.lstm_route(2048, 8, f32, smem=101376) == "step_chunked"


def test_lstm_wrappers_reach_the_streamed_exports(stand_in):  # noqa: F811
    """Above the whole-slice limit the LSTM wrappers call the streamed
    per-step exports, T forward and T + 1 backward launches counted; fp32
    H=2048 streams only its backward."""
    T, B, Hs = 3, 2, 2048
    xw = torch.zeros(T, B, 4 * Hs)
    w, b = torch.zeros(Hs, 4 * Hs), torch.zeros(4 * Hs)
    h0 = c0 = torch.zeros(B, Hs)
    lengths = torch.tensor([3, 1])
    seq = torch.zeros(T, B, Hs)
    before = (rnn_kernels.lstm_scan.launches, rnn_kernels.lstm_scan_backward.launches)
    rnn_kernels._lstm_scan_cuda(xw, w, b, h0, c0, lengths, False)
    rnn_kernels._lstm_scan_backward_cuda(xw, seq, seq, w, b, lengths, seq, h0, c0, True)
    assert [n for n, _ in stand_in.calls] == ["lstm_scan_fwd_step",
                                               "lstm_scan_bwd_step_chunked"]
    assert (rnn_kernels.lstm_scan.launches - before[0],
            rnn_kernels.lstm_scan_backward.launches - before[1]) == (T, T + 1)


def _gru(T, B, H, seed):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(H)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(T, B, 3 * H), rng.uniform(-s, s, (H, 3 * H)), rng.uniform(-s, s, 3 * H),
        rng.randn(B, H) * 0.5)] + [torch.tensor([T, T - 2, 1][:B])]


def _lstm(T, B, H, seed):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(H)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(T, B, 4 * H), rng.uniform(-s, s, (H, 4 * H)), rng.uniform(-s, s, 4 * H),
        rng.randn(B, H) * 0.5, rng.randn(B, H) * 0.5)] + [torch.tensor([T, T - 2, 1][:B])]


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("H, chunk", [(200, 64), (300, 256)])
@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_mirror_matches_the_plain_version(H, chunk, reverse):
    """GRU and LSTM, forward and backward: products summed over K in chunks
    of ``chunk`` values against the plain products, at 2e-5."""
    T, B = 5, 3
    mirror = rnn_kernels.step_chunked_reference
    xw, w, b, h0, lengths = _gru(T, B, H, seed=H)
    fwd = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths, reverse)
    assert _max_err(mirror("gru", False, xw, w, b, h0, lengths, reverse, chunk=chunk),
                    fwd) <= 2e-5
    h_prev = rnn_kernels.prev_all(fwd[0], h0, lengths, reverse)
    g_all, g_fin = torch.randn(T, B, H), torch.randn(B, H)
    args = (xw, h_prev, w, b, lengths, g_all, g_fin, reverse)
    assert _max_err(mirror("gru", True, *args, chunk=chunk),
                    rnn_kernels.gru_scan_backward_reference(*args)) <= 2e-5

    xw, w, b, h0, c0, lengths = _lstm(T, B, H, seed=H + 1)
    fwd = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths, reverse, True)
    got = mirror("lstm", False, xw, w, b, h0, c0, lengths, reverse, True, chunk=chunk)
    assert _max_err(got, fwd) <= 2e-5
    h_prev = rnn_kernels.prev_all(fwd[0], h0, lengths, reverse)
    c_prev = rnn_kernels.prev_all(fwd[1], c0, lengths, reverse)
    args = (xw, h_prev, c_prev, w, b, lengths, torch.randn(T, B, H), torch.randn(B, H),
            torch.randn(B, H), reverse)
    assert _max_err(mirror("lstm", True, *args, chunk=chunk),
                    rnn_kernels.lstm_scan_backward_reference(*args)) <= 2e-5


def test_chunked_product_splits_k_at_chunk_edges():
    a, w = torch.randn(4, 300).double(), torch.randn(300, 7).double()
    assert torch.allclose(rnn_kernels._product(a, w, 64), a @ w, atol=1e-12, rtol=0)
    assert torch.equal(rnn_kernels._product(a, w), a @ w)


@pytest.mark.cuda
def test_streamed_kernels_match_plain_versions_on_the_card():
    """The widths chip_smoke.py checks, at T=6, B=3 on the streamed route,
    against the plain versions: fp32 1e-5, bf16 4 ulps of each output's
    largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell, dtype, H in (("gru", torch.float32, 1280), ("lstm", torch.float32, 2048),
                           ("gru", torch.bfloat16, 4800), ("lstm", torch.bfloat16, 3584)):
        tol = 1e-5 if dtype == torch.float32 else 4 * 2.0 ** -8
        T, B = 6, 3
        if cell == "gru":
            xw, w, b, h0, lengths = [a.to("cuda") for a in _gru(T, B, H, 0)]
            xw, w, b, h0 = (a.to(dtype) for a in (xw, w, b, h0))
            got = rnn_kernels.gru_scan(xw, w, b, h0, lengths)
            want = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths)
            h_prev = rnn_kernels.prev_all(want[0], h0, lengths)
            args = (xw, h_prev, w, b, lengths, torch.randn_like(h_prev),
                    torch.randn_like(h0))
            gb, wb = (rnn_kernels.gru_scan_backward(*args),
                      rnn_kernels.gru_scan_backward_reference(*args))
        else:
            xw, w, b, h0, c0, lengths = [a.to("cuda") for a in _lstm(T, B, H, 0)]
            xw, w, b, h0, c0 = (a.to(dtype) for a in (xw, w, b, h0, c0))
            got = rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths, False, True)
            want = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths, False, True)
            h_prev = rnn_kernels.prev_all(want[0], h0, lengths)
            c_prev = rnn_kernels.prev_all(want[1], c0, lengths)
            args = (xw, h_prev, c_prev, w, b, lengths, torch.randn_like(h_prev),
                    torch.randn_like(h0), torch.randn_like(c0))
            gb, wb = (rnn_kernels.lstm_scan_backward(*args),
                      rnn_kernels.lstm_scan_backward_reference(*args))
        for g, r in list(zip(got, want)) + list(zip(gb, wb)):
            scale = r.float().abs().max().clamp_min(1e-30)
            assert ((g.float() - r.float()).abs().max() / scale).item() <= tol
