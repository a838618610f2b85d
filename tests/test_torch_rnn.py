"""Parity of the port's GRU scan and stacked RNN with the JAX package.

``gru_scan_reference`` (the plain version the port's CUDA kernel is held
against on the card) against the Pallas kernel ``rnn_pallas.gru_scan`` run
in interpret mode, at the kernel tests' own tolerance; the port's
``StackedRNN`` against the JAX ``StackedRNN`` through the kernel
("interpret") and through the XLA scan ("off")."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import jax

from rnntransducer_tpu.models.cells import StackedRNN as JaxStackedRNN
from rnntransducer_tpu.ops import rnn_pallas as rp

from rnntransducer_tpu_torch.models.cells import StackedRNN
from rnntransducer_tpu_torch.ops import rnn_kernels
from rnntransducer_tpu_torch.utils.weights import _stack_entries

from _torch_parity import close, jax_apply, t

B, H = 4, 16


def _gru_inputs(T, seed):
    rng = np.random.RandomState(seed)
    xw = rng.randn(T, B, 3 * H).astype(np.float32)
    w = (rng.randn(H, 3 * H) * 0.4).astype(np.float32)
    b = (rng.randn(3 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.4).astype(np.float32)
    lengths = np.array([T, max(T - 3, 1), 2, 1], np.float32)
    return xw, w, b, h0, lengths


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [6, 12])
def test_gru_scan_reference_matches_pallas(T, reverse):
    xw, w, b, h0, lengths = _gru_inputs(T, seed=T + reverse)
    want_all, want_fin = rp.gru_scan(jnp.asarray(xw), jnp.asarray(w),
                                     jnp.asarray(b), jnp.asarray(h0),
                                     jnp.asarray(lengths), reverse, True)
    got_all, got_fin = rnn_kernels.gru_scan_reference(
        t(xw), t(w), t(b), t(h0), t(lengths), reverse)
    close(got_all, want_all, atol=1e-6)
    close(got_fin, want_fin, atol=1e-6)


def test_gru_scan_on_cpu_is_the_plain_version():
    xw, w, b, h0, lengths = _gru_inputs(6, seed=3)
    args = (t(xw), t(w), t(b), t(h0), t(lengths).to(torch.int64))
    before = rnn_kernels.gru_scan.launches
    for got, want in zip(rnn_kernels.gru_scan(*args, True),
                         rnn_kernels.gru_scan_reference(*args, True)):
        assert torch.equal(got, want)
    assert rnn_kernels.gru_scan.launches == before  # no kernel on the CPU


def test_gru_scan_reference_bf16_contract():
    """bf16 inputs: fp32 carry, h rounded to bf16 for the product, outputs
    in bf16 -- equal to the fp32 walk on bf16-exact values to bf16 rounding."""
    xw, w, b, h0, lengths = _gru_inputs(6, seed=4)
    bf = [t(a).to(torch.bfloat16) for a in (xw, w, b, h0)]
    got_all, got_fin = rnn_kernels.gru_scan_reference(*bf, t(lengths))
    assert got_all.dtype == got_fin.dtype == torch.bfloat16
    want_all, _ = rnn_kernels.gru_scan_reference(*[a.float() for a in bf],
                                                 t(lengths))
    close(got_all, want_all, atol=2e-2)


def _port_stack(params, num_layers, bidirectional, scan, rnn_type):
    rnn = StackedRNN(8, H, num_layers, rnn_type, bidirectional)
    sd = {}
    for path, key, index, _ in _stack_entries((), "", num_layers, bidirectional,
                                              scan):
        node = params
        for part in path:
            node = node[part]
        arr = np.asarray(node)
        sd[key.lstrip(".")] = t(arr if index is None else arr[index])
    rnn.load_state_dict(sd)
    return rnn


@pytest.mark.parametrize("rnn_type,use_pallas,scan_layers", [
    ("gru", "interpret", True), ("gru", "interpret", False),
    ("gru", "off", True), ("gru", "off", False),
    ("lstm", "interpret", True), ("lstm", "interpret", False),
    ("lstm", "off", True), ("lstm", "off", False),
])
def test_stacked_rnn_matches_jax(rnn_type, use_pallas, scan_layers):
    T, L = 7, 3
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, 8).astype(np.float32)
    lengths = np.array([7, 5, 3, 1], np.int32)
    def stack(path):
        return JaxStackedRNN(8, H, num_layers=L, rnn_type=rnn_type,
                             bidirectional=True, scan_layers=scan_layers,
                             use_pallas=path)

    # the params do not depend on the call path; the XLA scan inits faster
    variables = stack("off").init(jax.random.PRNGKey(6), jnp.asarray(x),
                                  jnp.asarray(lengths))
    want_out, want_state = jax_apply(stack(use_pallas), variables,
                                     jnp.asarray(x), jnp.asarray(lengths))
    rnn = _port_stack(variables["params"], L, True, scan_layers, rnn_type)
    with torch.no_grad():
        got_out, got_state = rnn(t(x), t(lengths))
    close(got_out, want_out)
    close(got_state.h, want_state.h)
    if rnn_type == "lstm":
        close(got_state.c, want_state.c)


def test_stacked_rnn_step_matches_jax():
    """Unidirectional single-step decode mode with a carried state."""
    rng = np.random.RandomState(7)
    jrnn = JaxStackedRNN(8, H, num_layers=2, rnn_type="lstm")
    x0 = rng.randn(B, 8).astype(np.float32)
    variables = jrnn.init(jax.random.PRNGKey(8), jnp.asarray(x0)[:, None],
                          jnp.full((B,), 1, jnp.int32))
    rnn = _port_stack(variables["params"], 2, False, False, "lstm")
    jstate, pstate = None, None
    for step in range(3):
        x = rng.randn(B, 8).astype(np.float32)
        jout, jstate = jax_apply(jrnn, variables, jnp.asarray(x), jstate,
                                 method="step")
        with torch.no_grad():
            pout, pstate = rnn.step(t(x), pstate)
        close(pout, jout, err_msg=f"step {step}")
        close(pstate.c, jstate.c, err_msg=f"step {step}")
