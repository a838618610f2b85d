"""Shared helpers for the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``): one config dict builds the model
in both packages, the flax params go through the port's weight bridge, and
inputs are made with numpy from a seed."""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.models import RNNTransducer as JaxTransducer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.models.transducer import build_model
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

# parity tolerance of the RNN cells (tests/test_cells_torch_parity.py)
ATOL = 2e-5


def model_dict(rnn_type="gru", layers=2, hidden=16, out=12, n_mels=8,
               bidirectional=True, stride=1, reduce_at=1, scan_layers=True,
               use_pallas="off", pred_type="lstm", pred_layers=2,
               combine="concat", vocab=11):
    return {
        "transnet": dict(input_size=n_mels, hidden_size=hidden, output_size=out,
                         num_layers=layers, rnn_type=rnn_type, dropout=0.0,
                         bidirectional=bidirectional, scan_layers=scan_layers,
                         use_pallas_cells=use_pallas,
                         time_reduction_stride=stride,
                         time_reduction_layer=reduce_at),
        "prednet": dict(embedding_size=vocab, hidden_size=hidden, output_size=out,
                        num_layers=pred_layers, rnn_type=pred_type, dropout=0.0),
        "jointnet": dict(num_classes=vocab, combine=combine, hidden_size=10),
    }


def conformer_dict(stride=1, chunk=0, left=2, layers=2, d=64, heads=4, kernel=7,
                   dropout=0.0):
    """The Conformer of ``tests/test_conformer.py``: ``_cfg`` (chunk=0,
    full context, bidirectional) or ``_scfg`` (chunk > 0, chunked-causal),
    on ``tiny_config()``'s prediction network and joint, as a config dict."""
    m = dataclasses.asdict(jcfg.tiny_config().model)
    m["transnet"].update(
        arch="conformer", hidden_size=d, output_size=48, num_layers=layers,
        attention_heads=heads, conv_kernel_size=kernel,
        time_reduction_stride=stride, dropout=dropout, bidirectional=chunk == 0,
        attention_chunk=chunk, attention_left_chunks=left)
    return m


@functools.lru_cache(maxsize=None)
def _jax_model(key, seed):
    return _init_jax_model(json.loads(key), seed)


def jax_model(d, seed=0):
    """(flax module, variables) for the config dict ``d``; initialised once
    per (config, seed) in a test process."""
    return _jax_model(json.dumps(d, sort_keys=True), seed)


def _init_jax_model(d, seed):
    cfg = jcfg.ModelConfig.from_dict(d)
    # the params do not depend on the cells' call path: initialise through
    # the XLA scan, which is much faster than the Pallas kernel in interpret mode
    init_cfg = jcfg.ModelConfig.from_dict(with_cell_path(d, "off"))
    n_mels = cfg.transnet.input_size
    variables = JaxTransducer(init_cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, n_mels)), jnp.array([8]),
        jnp.zeros((1, 4), jnp.int32), jnp.array([4]))
    return JaxTransducer(cfg), variables


def with_cell_path(d, use_pallas):
    """A copy of the config dict ``d`` whose RNN cells take ``use_pallas``."""
    return {**d, "transnet": {**d["transnet"], "use_pallas_cells": use_pallas}}


_JITTED = {}


def jax_apply(model, variables, *args, method=None):
    """``model.apply(variables, *args, method=method)`` compiled once per
    (module, method): on the CPU one XLA compile costs far less than running
    the module op by op."""
    key = (id(model), method)
    if key not in _JITTED:
        _JITTED[key] = (model, jax.jit(functools.partial(model.apply, method=method)))
    return _JITTED[key][1](variables, *args)


def numpy_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(d, variables):
    cfg = pcfg.ModelConfig.from_dict(d)
    sd = state_dict_from_flax(numpy_params(variables), cfg)
    return build_model(cfg, "cpu", state_dict=sd)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL, rtol=0.0, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)
