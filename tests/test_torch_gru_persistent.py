"""The persistent GRU kernels' pieces that run without a card.

The kernels themselves (``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``) run only
on the card (the ``cuda`` tests below and in ``test_torch_gru_pair_card.py``,
and ``chip_smoke.py``).  Here: the layouts the wrappers hand them, the
co-residency limits (the single scans' and the paired backward's), the
routes the callers take to the paired and the single backward, the plain
mirrors of the backward's two pieces (the off-chain gates GEMM and the
chain) against numpy and against ``jax.grad`` through
``rnn_pallas.gru_scan`` in interpret mode, and the launch counts
``chip_smoke.py`` expects.

Tolerances: the gates GEMM at 1e-6 against numpy in float64 (fp32 sums of
H=16 terms); the decomposed backward at 1e-6 in fp32 against the Pallas
kernel, as ``test_torch_rnn_backward.py`` holds the undecomposed one.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rnntransducer_tpu.ops import rnn_pallas as rp

from rnntransducer_tpu_torch.config import base_config, tiny_config
from rnntransducer_tpu_torch.models.cells import StackedRNN
from rnntransducer_tpu_torch.ops import device, rnn_kernels
from rnntransducer_tpu_torch.parallel import mesh as pmesh
from rnntransducer_tpu_torch.parallel.pipeline import pipeline_scan
from rnntransducer_tpu_torch.parallel.wavefront import wavefront_scan
from rnntransducer_tpu_torch.utils import profiling

from _torch_parity import close, t
# the kernel libraries replaced by a recorder, so the CUDA wrappers'
# routing runs on CPU tensors
from test_torch_lstm_persistent import stand_in  # noqa: F401

H = 16
SMEM_LIMIT = 232448    # 227 KB, the shared memory one block may use


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


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def test_gemm_operands_pad_h_prev_and_transpose_w():
    """The gates GEMM takes h_prev as (T, B, Hk) and W_hh^T as (3H, Hk),
    both zero in the K padding."""
    Hs, Hk = 12, 64
    h_prev = torch.randn(3, 2, Hs)
    w = torch.arange(Hs * 3 * Hs, dtype=torch.float32).view(Hs, 3 * Hs)
    hp, w_t = rnn_kernels._gemm_operands(h_prev, w, Hk)
    assert hp.shape == (3, 2, Hk) and w_t.shape == (3 * Hs, Hk)
    assert hp.is_contiguous() and w_t.is_contiguous()
    assert torch.equal(hp[..., :Hs], h_prev) and not hp[..., Hs:].any()
    assert torch.equal(w_t[:, :Hs], w.t()) and not w_t[:, Hs:].any()
    # an unpadded H keeps h_prev as it is
    hp, _ = rnn_kernels._gemm_operands(torch.randn(2, 2, 64), torch.zeros(64, 192), 64)
    assert hp.shape == (2, 2, 64)


def test_gru_chain_tiles_hold_each_blocks_rows():
    """Block i of the chain holds the 8 rows j = 8 i + jj of W_hh, each
    padded to Kc with zeros; rows j >= H are zero."""
    Hs, jt = 12, rnn_kernels._TILE_WIDTH
    Kc = rnn_kernels._padded(3 * Hs)
    w = torch.arange(Hs * 3 * Hs, dtype=torch.float32).view(Hs, 3 * Hs) + 1
    tiles = rnn_kernels._chain_tiles(w, Hs, Kc, jt)
    assert tiles.shape == (2, jt, Kc)
    for i in range(2):
        for jj in range(jt):
            j = i * jt + jj
            row = tiles[i, jj]
            if j < Hs:
                assert torch.equal(row[:3 * Hs], w[j])
            else:
                assert not row.any()
            assert not row[3 * Hs:].any()


# ---------------------------------------------------------------------------
# the co-residency limit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_memory_per_block(dtype):
    """The wrappers' mirror of rnn_persistent.cuh::slice_smem at H=1024:
    24 rows of 1024 (forward) and 8 rows of 3072 (backward), bf16 rows
    padded by 32 values, plus the 128-row fp32 dot buffer."""
    e, pad = (2, 32) if dtype == torch.bfloat16 else (4, 0)
    assert rnn_kernels.gru_smem_bytes(1024, dtype) == e * 24 * (1024 + pad) + 4 * 128 * 24
    assert (rnn_kernels.gru_smem_bytes(1024, dtype, backward=True)
            == e * 8 * (3072 + pad) + 4 * 128 * 8)
    # H = 1000 pads K to 1024 and 3008
    assert rnn_kernels.gru_smem_bytes(1000, dtype) == rnn_kernels.gru_smem_bytes(1024, dtype)
    assert (rnn_kernels.gru_smem_bytes(1000, dtype, True)
            == e * 8 * (3008 + pad) + 4 * 128 * 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 64, 100])
def test_coresidency_limit(B, dtype):
    """One 8-unit block per SM on 132 SMs: H=1024 (the flagship) and
    H=1056 fit in both dtypes at every B, H=1057 does not."""
    assert rnn_kernels.gru_max_hidden(B, dtype) == 1056
    for H_ in (1, 8, 320, 1000, 1024, 1056):
        assert rnn_kernels.gru_fits(H_, B, dtype)
    for H_ in (1057, 1064, 2048, 4096):
        assert not rnn_kernels.gru_fits(H_, B, dtype)


@pytest.mark.parametrize("backward", [False, True])
def test_wrappers_raise_above_the_limit(backward, stand_in):
    """Above the persistent limit the wrappers take the per-step kernels;
    above the per-step block's whole-slice limit (its W_hh slices in 227 KB
    of shared memory: fp32 H <= 2304 forward, <= 1152 backward) they no
    longer raise: they take the streamed per-step kernels (route
    ``"step_chunked"``, the same T / T + 1 launches), whose block needs the
    same shared memory at every H."""
    dtype = torch.float32
    top = rnn_kernels.step_max_hidden("gru", dtype, backward)
    assert top == (1152 if backward else 2304)
    assert rnn_kernels.step_smem_bytes("gru", top, dtype, backward) <= SMEM_LIMIT
    assert rnn_kernels.step_smem_bytes("gru", top + 1, dtype, backward) > SMEM_LIMIT
    assert rnn_kernels.step_chunked_smem_bytes("gru", dtype, backward) <= SMEM_LIMIT
    Hs, T, B = top + 1, 2, 3
    xw = torch.zeros(T, B, 3 * Hs)
    w = torch.zeros(Hs, 3 * Hs)
    b = torch.zeros(3 * Hs)
    h0 = torch.zeros(B, Hs)
    lengths = torch.tensor([2, 1, 2])
    assert rnn_kernels.gru_route(Hs, B, dtype, backward=backward) == "step_chunked"
    assert rnn_kernels.gru_route(top, B, dtype, backward=backward) == "per_step"
    before = (rnn_kernels.gru_scan.launches, rnn_kernels.gru_scan_backward.launches)
    if backward:
        seq = torch.zeros(T, B, Hs)
        rnn_kernels._gru_scan_backward_cuda(xw, seq, w, b, lengths, seq, h0, False)
    else:
        rnn_kernels._gru_scan_cuda(xw, w, b, h0, lengths, False)
    name = "gru_scan_bwd_step_chunked" if backward else "gru_scan_fwd_step_chunked"
    assert [n for n, _ in stand_in.calls] == [name]
    counted = (rnn_kernels.gru_scan.launches - before[0],
               rnn_kernels.gru_scan_backward.launches - before[1])
    assert counted == ((0, T + 1) if backward else (T, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_step_limits(dtype):
    """The per-step blocks' shared memory (csrc/gru_*.cu per_step::step_smem)
    and the largest H each takes in 227 KB: forward 24 rows of Hk, backward
    also 8 rows of Kc, plus 64-row fp32 dot buffers."""
    e = 2 if dtype == torch.bfloat16 else 4
    assert rnn_kernels.step_smem_bytes("gru", 1057, dtype) == e * 24 * 1088 + 4 * 64 * 24
    assert (rnn_kernels.step_smem_bytes("gru", 1057, dtype, backward=True)
            == e * (8 * 3200 + 24 * 1088) + 4 * 64 * 32)
    want = {torch.float32: (2304, 1152), torch.bfloat16: (4672, 2304)}[dtype]
    assert (rnn_kernels.step_max_hidden("gru", dtype),
            rnn_kernels.step_max_hidden("gru", dtype, backward=True)) == want
    # a card with less shared memory takes less
    assert rnn_kernels.step_max_hidden("gru", dtype, smem=101376) < want[0]


@pytest.mark.parametrize("Hs, route", [(1056, "persistent"), (1057, "per_step")])
def test_route_is_chosen_from_the_shape(stand_in, Hs, route):
    """On a card of 132 SMs the wrappers pick the export from (H, B, dtype)
    alone before any launch: the persistent scans (1 + 2 launches counted)
    up to H=1056, the per-step kernels (T + T + 1) from H=1057, never
    both."""
    T, B = 3, 2
    xw = torch.zeros(T, B, 3 * Hs)
    w = torch.zeros(Hs, 3 * Hs)
    b = torch.zeros(3 * Hs)
    h0 = torch.zeros(B, Hs)
    lengths = torch.tensor([3, 1])
    seq = torch.zeros(T, B, Hs)
    assert rnn_kernels.gru_route(Hs, B, torch.float32, sms=132) == route
    before = (rnn_kernels.gru_scan.launches, rnn_kernels.gru_scan_backward.launches)
    rnn_kernels._gru_scan_cuda(xw, w, b, h0, lengths, False)
    rnn_kernels._gru_scan_backward_cuda(xw, seq, w, b, lengths, seq, h0, True)
    names = [name for name, _ in stand_in.calls]
    counted = (rnn_kernels.gru_scan.launches - before[0],
               rnn_kernels.gru_scan_backward.launches - before[1])
    Hk = rnn_kernels._padded(Hs)
    if route == "persistent":
        assert names == ["gru_scan_fwd", "gru_scan_bwd"]
        assert counted == (1, 2)
        assert stand_in.calls[0][1][9:14] == (T, B, Hs, Hk, 8)    # T, B, H, Hk, jt
    else:
        assert names == ["gru_scan_fwd_step", "gru_scan_bwd_step"]
        assert counted == (T, T + 1)
        fwd, bwd = stand_in.calls[0][1], stand_in.calls[1][1]
        assert fwd[8:13] == (T, B, Hs, Hk, 8)
        assert bwd[14:20] == (T, B, Hs, Hk, rnn_kernels._padded(3 * Hs), 8)


@pytest.mark.parametrize("sms", [132, 114])
def test_routes_follow_the_cards_sm_count(sms):
    """The persistent grids hold one block per SM, so the limits move with
    the card: 8 units per block give H <= 8 * SMs to both GRU and LSTM
    (1056 on an H100 SXM, 912 on an H100 PCIe's 114 SMs), and the LSTM
    takes 4-unit blocks up to H = 4 * SMs."""
    for dtype in (torch.float32, torch.bfloat16):
        top = 8 * sms
        assert rnn_kernels.gru_max_hidden(64, dtype, sms=sms) == top
        assert rnn_kernels.lstm_max_hidden(64, dtype, sms=sms) == top
        for route in (rnn_kernels.gru_route, rnn_kernels.lstm_route):
            assert route(top, 64, dtype, sms=sms) == "persistent"
            assert route(top + 1, 64, dtype, sms=sms) == "per_step"
    assert rnn_kernels.lstm_tile_width(4 * sms, sms=sms) == 4
    assert rnn_kernels.lstm_tile_width(4 * sms + 1, sms=sms) == 8
    # H = 1000 is persistent on the SXM card and per-step on the PCIe one
    assert (rnn_kernels.gru_route(1000, 64, torch.bfloat16, sms=sms)
            == ("persistent" if sms == 132 else "per_step"))


def test_limits_read_the_named_device(monkeypatch):
    """A CUDA device's limits come from its properties, read once per
    device; without a device (or on the CPU) they are the H100 SXM's."""
    assert rnn_kernels.device_limits() == (132, 232448)
    assert rnn_kernels.device_limits("cpu") == (132, 232448)
    reads = []

    def props(index):
        reads.append(index)
        return types.SimpleNamespace(multi_processor_count=114,
                                     shared_memory_per_block_optin=232448)
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(rnn_kernels, "_reported_blocks", lambda *a: 1 << 20)
    device._cuda_limits.cache_clear()
    try:
        assert rnn_kernels.device_limits("cuda:3") == (114, 232448)
        assert rnn_kernels.device_limits("cuda:3") == (114, 232448)
        assert reads == [3]
        assert rnn_kernels.gru_route(912, 8, torch.bfloat16, "cuda:3") == "persistent"
        assert rnn_kernels.gru_route(913, 8, torch.bfloat16, "cuda:3") == "per_step"
        assert rnn_kernels.lstm_tile_width(457, "cuda:3") == 8
        # on a card, sms= and smem= only lower its own limits
        assert rnn_kernels.gru_max_hidden(8, torch.bfloat16, "cuda:3", sms=132) == 912
        assert rnn_kernels.gru_max_hidden(8, torch.bfloat16, "cuda:3", sms=100) == 800
    finally:
        device._cuda_limits.cache_clear()


def test_gates_gemm_wrapper_runs_only_on_the_card():
    with pytest.raises(ValueError, match="runs on cuda"):
        rnn_kernels.gru_bwd_gates(torch.zeros(2, 2, 8), torch.zeros(8, 24),
                                  torch.zeros(24))


# ---------------------------------------------------------------------------
# the paired backward: its limit, its export, and who takes it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_limit_on_a_card_of_132_sms(dtype):
    """2 ceil(H / 16) blocks of 16 chain rows of Kc each (bf16 rows padded
    by 32 values) plus the 128-row dot buffer: H=1024 fits in both dtypes,
    and H=1057, the first whose 2 ceil(H / 16) = 134 blocks exceed 132 SMs,
    does not."""
    e, pad = (2, 32) if dtype == torch.bfloat16 else (4, 0)
    assert rnn_kernels.gru_pair_smem_bytes(1024, dtype) == e * 16 * (3072 + pad) + 4 * 128 * 16
    assert rnn_kernels.gru_pair_smem_bytes(1056, dtype) <= SMEM_LIMIT
    assert rnn_kernels.gru_pair_fits(1024, 64, dtype, sms=132)
    first = next(h for h in range(1, 4096) if 2 * -(-h // 16) > 132)
    assert first == 1057
    assert rnn_kernels.gru_pair_fits(first - 1, 64, dtype, sms=132)
    assert not rnn_kernels.gru_pair_fits(first, 64, dtype, sms=132)
    # fewer SMs, or less shared memory than a block's slice, refuse it
    assert not rnn_kernels.gru_pair_fits(1024, 64, dtype, sms=127)
    assert not rnn_kernels.gru_pair_fits(
        1024, 64, dtype, smem=rnn_kernels.gru_pair_smem_bytes(1024, dtype) - 1)
    # the route is a card's: never on the CPU
    assert not rnn_kernels.gru_pair_applies(torch.zeros(2, 3, 4, dtype=dtype), 16)


def test_pair_chain_tiles_hold_sixteen_rows_a_block():
    """A paired block holds the 16 rows j = 16 i + jj of its direction's W_hh,
    padded to Kc; rows j >= H are zero."""
    Hs, jt = 20, rnn_kernels._PAIR_TILE_WIDTH
    Kc = rnn_kernels._padded(3 * Hs)
    w = torch.arange(Hs * 3 * Hs, dtype=torch.float32).view(Hs, 3 * Hs) + 1
    tiles = rnn_kernels._chain_tiles(w, Hs, Kc, jt)
    assert tiles.shape == (2, 16, Kc)
    for j in range(32):
        row = tiles[j // 16, j % 16]
        assert torch.equal(row[:3 * Hs], w[j]) if j < Hs else not row.any()
        assert not row[3 * Hs:].any()


def _direction(T, B, Hs, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g).to(dtype)  # noqa: E731
    return (r(T, B, 3 * Hs), r(T, B, Hs), r(Hs, 3 * Hs), r(3 * Hs), r(T, B, Hs), r(B, Hs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_wrapper_calls_the_pair_export_once(stand_in, dtype):
    """One call of the pair export, 2 launches counted on the pair's own
    wrapper and none on the single scan's: both directions' 12 buffers,
    direction-major, each in gru_scan_bwd's order (xw, h_prev, g_hall, W_hh^T,
    the 16-row chain tiles, b_hh, then the scratch and the outputs), the
    shared lengths, two barrier counters, and (T, B, H, Hk, Kc, 16, dtype)."""
    T, B, Hs = 3, 2, 40
    fwd, bwd = _direction(T, B, Hs, 1, dtype), _direction(T, B, Hs, 2, dtype)
    lengths = torch.tensor([3, 1])
    before = (rnn_kernels.gru_scan_backward.launches,
              rnn_kernels.gru_scan_backward_pair.launches)
    outs = rnn_kernels._gru_scan_backward_pair_cuda(fwd, bwd, lengths)
    assert [n for n, _ in stand_in.calls] == ["gru_scan_bwd_pair"]
    assert (rnn_kernels.gru_scan_backward.launches - before[0],
            rnn_kernels.gru_scan_backward_pair.launches - before[1]) == (0, 2)
    args = stand_in.calls[0][1]
    ptrs = list(args[0])
    assert len(ptrs) == 24
    Hk, Kc = rnn_kernels._padded(Hs), rnn_kernels._padded(3 * Hs)
    assert args[3:] == (T, B, Hs, Hk, Kc, 16, rnn_kernels._DTYPE_CODES[dtype], 0)
    for d, (xw, _, _, b, g_all, _), out in zip((0, 12), (fwd, bwd), outs):
        assert ptrs[d + 0] == xw.data_ptr() and ptrs[d + 2] == g_all.data_ptr()
        assert ptrs[d + 5] == b.data_ptr()
        assert ptrs[d + 9:d + 12] == [o.data_ptr() for o in out]
        assert [tuple(o.shape) for o in out] == [(T, B, 3 * Hs), (T, B, Hs), (B, Hs)]
    assert len(set(ptrs)) == 24


def test_pair_wrapper_refuses_what_does_not_fit(stand_in):
    T, B = 2, 2
    fwd, bwd = _direction(T, B, 16, 1), _direction(T, B, 16, 2)
    with pytest.raises(ValueError, match="directions differ"):
        rnn_kernels._gru_scan_backward_pair_cuda(fwd, _direction(T, B, 24, 2),
                                                 torch.tensor([2, 1]))
    big = 1057
    with pytest.raises(ValueError, match="does not fit"):
        rnn_kernels._gru_scan_backward_pair_cuda(_direction(1, 1, big, 1),
                                                 _direction(1, 1, big, 2), torch.tensor([1]))
    assert stand_in.calls == []


@pytest.fixture
def card_routes(stand_in, monkeypatch):
    """The GRU wrappers' CPU branches sent down their CUDA routes into the
    stand-in library, and the pair's route taken from the shape alone, as
    on an H100 SXM: a step on CPU tensors calls the exports a card would."""
    monkeypatch.setattr(rnn_kernels, "gru_scan_reference", rnn_kernels._gru_scan_cuda)
    monkeypatch.setattr(rnn_kernels, "gru_scan_backward_reference",
                        rnn_kernels._gru_scan_backward_cuda)
    monkeypatch.setattr(rnn_kernels, "gru_scan_backward_pair_reference",
                        rnn_kernels._gru_scan_backward_pair_cuda)
    monkeypatch.setattr(rnn_kernels, "gru_pair_applies",
                        lambda x, H: rnn_kernels.gru_pair_fits(H, x.shape[0], x.dtype))
    profiling.reset()
    yield stand_in
    profiling.reset()


def _stack_step(rnn, B=4, T=6):
    x = torch.randn(B, T, rnn.fwd[0].w_ih.shape[0], requires_grad=True)
    out, _ = rnn(x, torch.tensor([T, T - 1, 2, 1][:B]))
    out.sum().backward()


def test_flagship_shaped_step_runs_eight_pairs(card_routes):
    """The flagship's 8 bidirectional GRU layers (H=16 here) take the paired
    backward: under a profiler the counters read 8 pairs and no single scan,
    and the stand-in saw 16 forward scans and 8 pair calls."""
    rnn = StackedRNN(80, 16, 8, "gru", bidirectional=True)
    with profile(activities=[ProfilerActivity.CPU]):
        _stack_step(rnn)
    counts = profiling.recorded()
    assert counts["kernels/gru_bwd_pair"] == {"count": 8}
    assert "kernels/gru_bwd_single" not in counts
    names = [n for n, _ in card_routes.calls]
    assert names.count("gru_scan_fwd") == 16 and names.count("gru_scan_bwd_pair") == 8
    assert "gru_scan_bwd" not in names


@pytest.mark.parametrize("caller", ["unidirectional", "pipeline", "wavefront",
                                    "no_grad_inputs", "too_wide"])
def test_other_callers_keep_the_single_backward(card_routes, caller):
    """A unidirectional stack, the pipeline and the wavefront (which scan one
    direction at a time), a bidirectional stack whose grads nobody records,
    and an H above the pair's limit call gru_scan_bwd, never the pair; the
    single counter reads each scan it ran."""
    H, L = 16, 2
    with profile(activities=[ProfilerActivity.CPU]):
        if caller == "unidirectional":
            _stack_step(StackedRNN(12, H, L, "gru"))
            singles = L
        elif caller in ("pipeline", "wavefront"):
            bi = caller == "pipeline"
            rnn = StackedRNN(2 * H if bi else 12, H, L, "gru", bidirectional=bi)
            params = dict(rnn.named_parameters())
            x = torch.randn(4, 6, rnn.fwd[0].w_ih.shape[0], requires_grad=True)
            lengths = torch.tensor([6, 5, 2, 1])
            if bi:
                out = pipeline_scan(params, x, lengths, rnn_type="gru", num_layers=L,
                                    bidirectional=True, num_microbatches=1,
                                    mesh=pmesh.Mesh({"stage": 1}, {"stage": 0}, {}, {}, {}))
            else:
                out, _ = wavefront_scan(params, x, lengths, rnn_type="gru", num_layers=L,
                                        mesh=pmesh.Mesh({"time": 1}, {"time": 0}, {}, {}, {}))
            out.sum().backward()
            singles = 2 * L if bi else L
        elif caller == "no_grad_inputs":
            rnn = StackedRNN(12, H, L, "gru", bidirectional=True).requires_grad_(False)
            x = torch.randn(4, 6, 12)
            with torch.no_grad():
                rnn(x)
            singles = 0
        else:
            assert not rnn_kernels.gru_pair_fits(1057, 1, torch.float32)
            rnn = StackedRNN(12, 1057, 1, "gru", bidirectional=True)
            _stack_step(rnn, B=1, T=2)
            singles = 2
    names = [n for n, _ in card_routes.calls]
    assert "gru_scan_bwd_pair" not in names
    assert names.count("gru_scan_bwd") + names.count("gru_scan_bwd_step") == singles
    counts = profiling.recorded()
    assert "kernels/gru_bwd_pair" not in counts
    assert counts.get("kernels/gru_bwd_single", {"count": 0}) == {"count": singles}


# ---------------------------------------------------------------------------
# the plain mirrors of the backward's two pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gates_reference_matches_numpy(dtype):
    """hw = h_prev @ W_hh + b_hh in fp32, from operands rounded to W's
    dtype, against numpy in float64 on the same rounded operands."""
    rng = np.random.RandomState(4)
    h_prev = torch.from_numpy(rng.randn(5, 3, H).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(H, 3 * H).astype(np.float32) * 0.4).to(dtype)
    b = torch.from_numpy(rng.randn(3 * H).astype(np.float32) * 0.1).to(dtype)
    got = rnn_kernels.gru_bwd_gates_reference(h_prev, w, b)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 3 * H)
    want = (h_prev.double().numpy() @ w.double().numpy()) + b.double().numpy()
    close(got, want, atol=1e-6)


def _jax_grads(args, cot, reverse):
    xw, w, b, h0, lengths = [jnp.asarray(a) for a in args]
    g_all, g_fin = (jnp.asarray(c) for c in cot)

    def f(xw, w, b, h0):
        h_all, h_fin = rp.gru_scan(xw, w, b, h0, lengths, reverse, True)
        return jnp.sum(h_all * g_all) + jnp.sum(h_fin * g_fin)

    return jax.grad(f, argnums=(0, 1, 2, 3))(xw, w, b, h0)


def _decomposed(args, cot, reverse):
    """The kernel's decomposition with plain pieces: the hoisted gates,
    then the chain, then the off-loop weight GEMMs."""
    xw, w, b, h0, lengths = [t(a) for a in args]
    h_all, _ = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths, reverse)
    h_prev = rnn_kernels.prev_all(h_all, h0, lengths, reverse)
    hw = rnn_kernels.gru_bwd_gates_reference(h_prev, w, b)
    dxw, dnr, dh0 = rnn_kernels.gru_bwd_chain_reference(
        xw, hw, h_prev, w, lengths, t(cot[0]), t(cot[1]), reverse)
    dw, db = rnn_kernels.gru_weight_grads(h_prev, dxw, dnr, w.dtype)
    return (dxw, dw, db, dh0), (xw, h_prev, w, b, lengths) + tuple(t(c) for c in cot)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [4, 10])
def test_decomposed_backward_matches_pallas_fp32(B, reverse):
    """Hoisted gates plus chain give dxw, dW_hh (so dnr), db_hh and dh0 of
    jax.grad through the Pallas kernel in interpret mode."""
    args, cot = _inputs(9, B, seed=20 + B + reverse)
    want = _jax_grads(args, cot, reverse)
    got, _ = _decomposed(args, cot, reverse)
    for name, g, w in zip(("dxw", "dw_hh", "db_hh", "dh0"), got, want):
        close(g, w, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_chain_reference_matches_the_plain_backward(reverse):
    """The chain mirror gives the undecomposed plain backward's dxw, dnr and
    dh0, ragged lengths (1 and T) included."""
    args, cot = _inputs(7, 5, seed=31 + reverse)
    (dxw, _, _, dh0), call = _decomposed(args, cot, reverse)
    xw, h_prev, w, b, lengths, g_all, g_fin = call
    want = rnn_kernels.gru_scan_backward_reference(xw, h_prev, w, b, lengths,
                                                   g_all, g_fin, reverse)
    hw = rnn_kernels.gru_bwd_gates_reference(h_prev, w, b)
    got = rnn_kernels.gru_bwd_chain_reference(xw, hw, h_prev, w, lengths, g_all,
                                              g_fin, reverse)
    for name, g, r in zip(("dxw", "dnr", "dh0"), got, want):
        close(g, r, atol=1e-6, err_msg=name)
    close(dxw, want[0], atol=1e-6)
    close(dh0, want[2], atol=1e-6)


# ---------------------------------------------------------------------------
# launch counts on the main paths
# ---------------------------------------------------------------------------


def test_step_launches_of_the_main_paths():
    """Per train_step: 16 GRU scans of base_config and its 2 LSTM prednet
    scans, and tiny_config's 4 encoder scans plus 1 prednet scan, at 1
    forward and 2 backward launches each (all persistent); an LSTM above
    the persistent limit launches per step (T and T + 1)."""
    import chip_smoke
    assert chip_smoke.scan_launches("gru", 512) == (1, 2)
    assert chip_smoke.scan_launches("lstm", 49) == (1, 2)
    assert chip_smoke.scan_launches("lstm", 49, hidden=1057) == (49, 50)
    assert chip_smoke.scan_launches("lstm", 512, hidden=2048,
                                    dtype=torch.float32) == (512, 513)
    base = chip_smoke.step_launches(base_config(), 512, 48)
    # the 8 bidirectional layers' backward scans run as 8 pairs, 2 launches each
    assert base == {"gru_fwd": 16, "gru_bwd": 16, "lstm_fwd": 2, "lstm_bwd": 4,
                    "rnnt_sweep": 1, "logmel": 0}
    assert chip_smoke.step_launches(base_config(), 512, 48, raw_pcm=True)["logmel"] == 1
    tiny = chip_smoke.step_launches(tiny_config(), 512, 48)
    assert tiny == {"gru_fwd": 0, "gru_bwd": 0, "lstm_fwd": 5, "lstm_bwd": 10,
                    "rnnt_sweep": 1, "logmel": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_persistent_kernels_match_plain_versions_on_the_card():
    """Both kernels at small sizes, B=100 (two 64-row chunks) included,
    and the gates GEMM alone, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4 * 2.0 ** -8)):
        for B, reverse in ((5, False), (100, True)):
            args, cot = _inputs(12, B, seed=40 + B + reverse)
            xw, w, b, h0, lengths = [t(a).to("cuda") for a in args]
            xw, w, b, h0 = (a.to(dtype) for a in (xw, w, b, h0))
            got = rnn_kernels.gru_scan(xw, w, b, h0, lengths, reverse)
            want = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths, reverse)
            for g, r in zip(got, want):
                assert (g.float() - r.float()).abs().max().item() <= 2e-2
            h_prev = rnn_kernels.prev_all(want[0], h0, lengths, reverse)
            hw = rnn_kernels.gru_bwd_gates(h_prev, w, b)
            hw_ref = rnn_kernels.gru_bwd_gates_reference(h_prev, w, b)
            assert (hw - hw_ref).abs().max().item() <= 1e-5 * hw_ref.abs().max().item()
            call = (xw, h_prev, w, b, lengths, t(cot[0]).to("cuda", dtype),
                    t(cot[1]).to("cuda", dtype), reverse)
            for g, r in zip(rnn_kernels.gru_scan_backward(*call),
                            rnn_kernels.gru_scan_backward_reference(*call)):
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * max(r.float().abs().max().item(), 1.0)
