"""The six kernels as registered torch ops (ops/library.py):
``torch.library.opcheck`` of each op on CPU inputs (schema, fake
implementation, no alias of an input, traced dispatch), at the shapes a
path gives it and at T == 0 where the plain versions hand back their carry;
the CPU op equals the kernel's plain version; and the wrappers take the op
route only while a tracer runs: a program exported on the CPU holds the op
nodes, eager calls on the CPU run the plain versions directly."""

import numpy as np
import pytest
import torch
from torch.library import opcheck

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.frontend import fused_frontend
from rnntransducer_tpu_torch.ops import library, rnn_kernels, rnnt_kernels

OPS = torch.ops.rnntransducer_tpu_torch


def _args(name, T=5, B=3, H=8):
    g = torch.Generator().manual_seed(len(name) + T)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    lengths = torch.tensor([T, min(2, T), 0])[:B]
    return {
        "gru_scan": (r(T, B, 3 * H), r(H, 3 * H), r(3 * H), r(B, H), lengths, True),
        "gru_scan_backward": (r(T, B, 3 * H), r(T, B, H), r(H, 3 * H), r(3 * H),
                              lengths, r(T, B, H), r(B, H), False),
        "lstm_scan": (r(T, B, 4 * H), r(H, 4 * H), r(4 * H), r(B, H), r(B, H),
                      lengths, False),
        "lstm_scan_backward": (r(T, B, 4 * H), r(T, B, H), r(T, B, H), r(H, 4 * H),
                               r(4 * H), lengths, r(T, B, H), r(B, H), r(B, H), True),
        "rnnt_sweep": (r(2, T, 4), r(2, T, 4)),
        "logmel_rows": (r(7, 400), 16000, 0.025, "hann", 80, False),
    }[name]


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(name):
    opcheck(getattr(OPS, name).default, _args(name))


@pytest.mark.parametrize("name", ["gru_scan", "gru_scan_backward", "lstm_scan",
                                  "lstm_scan_backward"])
def test_opcheck_with_no_steps(name):
    """At T == 0 the plain versions return their initial carry itself; the
    op returns a copy (an op may not alias its input)."""
    args = _args(name, T=0)
    opcheck(getattr(OPS, name).default, args)
    outs = getattr(OPS, name)(*args)
    inputs = [a for a in args if isinstance(a, torch.Tensor)]
    for o in outs:
        assert all(o.untyped_storage().data_ptr() != i.untyped_storage().data_ptr()
                   or o.numel() == 0 for i in inputs)


def _plain(name, args):
    if name == "gru_scan":
        return rnn_kernels.gru_scan_reference(*args)
    if name == "gru_scan_backward":
        return rnn_kernels.gru_scan_backward_reference(*args)
    if name == "lstm_scan":
        return rnn_kernels.lstm_scan_reference(*args, True)
    if name == "lstm_scan_backward":
        return rnn_kernels.lstm_scan_backward_reference(*args)
    if name == "rnnt_sweep":
        return (rnnt_kernels.sweep_reference(*args),)
    cfg = AudioConfig()
    rows = args[0]
    return (fused_frontend.mel_reference(fused_frontend.dft_power_reference(rows, cfg),
                                         cfg),)


@pytest.mark.parametrize("name", library.OPS)
def test_cpu_op_is_the_plain_version(name):
    args = _args(name)
    got = getattr(OPS, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = _plain(name, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _Scans(torch.nn.Module):
    def forward(self, xg, wg, bg, xl, wl, bl, h0, lengths):
        h_all, h_fin = rnn_kernels.gru_scan(xg, wg, bg, h0, lengths)
        c_all, _, c_fin = rnn_kernels.lstm_scan(xl, wl, bl, h0, h0, lengths, True)
        return h_all + c_all, h_fin + c_fin


def test_wrappers_take_the_op_route_only_while_tracing(monkeypatch):
    """A program exported on the CPU holds the op nodes (so that, moved to
    the card, it reaches the kernels), runs the plain versions on the CPU
    and equals the eager wrappers, which call no op."""
    args = (_args("gru_scan")[:3] + _args("lstm_scan")[:3]
            + (_args("gru_scan")[3], _args("gru_scan")[4]))
    with torch.no_grad():
        program = torch.export.export(_Scans(), args)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"rnntransducer_tpu_torch.gru_scan.default",
            "rnntransducer_tpu_torch.lstm_scan.default"} <= targets
    assert not any("addmm" in x or "sigmoid" in x for x in targets)

    got = program.module()(*args)

    def refuse(*a, **k):
        raise AssertionError("an eager wrapper dispatched through the op")

    monkeypatch.setattr(library, "tracing", lambda x: False)
    for name in ("gru_scan", "lstm_scan"):
        monkeypatch.setattr(OPS, name, refuse, raising=False)
    want = _Scans()(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not library.tracing(torch.zeros(1))
    assert not library.tracing(torch.zeros(1, device="meta"))


def test_sweep_and_logmel_trace_to_their_ops():
    class M(torch.nn.Module):
        def forward(self, be, le, wav):
            feats, _ = fused_frontend.logmel_fused(wav, AudioConfig())
            return rnnt_kernels.sweep(be, le), feats

    rng = np.random.RandomState(0)
    args = (torch.from_numpy(rng.randn(2, 6, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(2, 6, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(2, 1600).astype(np.float32)))
    with torch.no_grad():
        program = torch.export.export(M(), args)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"rnntransducer_tpu_torch.rnnt_sweep.default",
            "rnntransducer_tpu_torch.logmel_rows.default"} <= targets
    got = program.module()(*args)
    want = M()(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
