"""Params bundles (``params.msgpack`` + ``config.json`` + ``export.json``)
across the two packages, on the same weights: the JAX package's
``serve.export_params`` read by the port's ``Recognizer.from_params``, and
the port's ``export_params`` (from a ``CheckpointManager`` checkpoint) read
by the JAX package's ``Recognizer.from_params``.  Greedy and
``beam_batched`` transcripts must be equal, the trees must equal flax's
``msgpack_restore`` leaf for leaf, and the port's file must be byte-equal to
the JAX package's for the same weights."""

import json
import os

import numpy as np
import jax
import pytest
import torch
from flax import serialization

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.serve import Recognizer as JaxRecognizer
from rnntransducer_tpu.serve import export_params as jax_export_params
from rnntransducer_tpu.train import CheckpointManager as JaxCheckpointManager
from rnntransducer_tpu.train import TrainState as JaxTrainState

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.serve import Recognizer, export_params
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils import flax_msgpack, weights

from _torch_parity import jax_model, model_dict, numpy_params, port_model

D = model_dict(n_mels=80, vocab=72, layers=2)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{"jax": the JAX package's bundle, "port": the port's}, of one set of
    weights, the JAX one at step 2 and the port's at step 5."""
    tmp = tmp_path_factory.mktemp("bundles")
    _, variables = jax_model(D, seed=4)
    jc = jcfg.Config(model=jcfg.ModelConfig.from_dict(D))
    state = JaxTrainState.create(jc).replace(params=variables["params"])
    mgr = JaxCheckpointManager(str(tmp / "jax_ckpt"))
    mgr.save(2, state, config=jc)
    mgr.close()
    pc = pcfg.Config(model=pcfg.ModelConfig.from_dict(D))
    pstate = TrainState.create(pc, "cpu",
                               state_dict=port_model(D, variables).state_dict())
    pmgr = CheckpointManager(str(tmp / "port_ckpt"))
    pmgr.save(5, pstate, config=pc)
    pmgr.close()
    return {"jax": jax_export_params(str(tmp / "jax_ckpt"), str(tmp / "jax")),
            "port": export_params(str(tmp / "port_ckpt"), str(tmp / "port")),
            "params": numpy_params(variables)}


def _waves():
    rng = np.random.RandomState(6)
    return [(rng.randn(n) * 0.3).astype(np.float32) for n in (4000, 2500, 1601)]


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_equals_flax_leaf_for_leaf(bundles, writer):
    data = open(os.path.join(bundles[writer], "params.msgpack"), "rb").read()
    mine, theirs = _leaves(flax_msgpack.loads(data)), _leaves(
        serialization.msgpack_restore(data))
    want = _leaves(bundles["params"])
    assert len(mine) == len(theirs) == len(want) > 10
    for (pm, m), (pt, t), (pw, w) in zip(mine, theirs, want):
        assert pm == pt == pw
        assert m.dtype == t.dtype == w.dtype and m.shape == t.shape
        np.testing.assert_array_equal(m, t)
        np.testing.assert_array_equal(m, w)


def test_port_bundle_is_byte_equal_to_the_jax_bundle(bundles):
    read = lambda w, f: open(os.path.join(bundles[w], f), "rb").read()  # noqa: E731
    assert read("port", "params.msgpack") == read("jax", "params.msgpack")
    assert read("port", "params.msgpack") == serialization.msgpack_serialize(
        weights.flax_from_state_dict(weights.state_dict_from_flax(
            bundles["params"], pcfg.ModelConfig.from_dict(D)),
            pcfg.ModelConfig.from_dict(D)))
    assert json.loads(read("port", "export.json")) == {"step": 5}
    assert json.loads(read("jax", "export.json")) == {"step": 2}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("decoder", ["greedy", "beam_batched"])
def test_either_package_reads_either_bundle(bundles, writer, decoder):
    kw = dict(decoder=decoder, beam_width=3)
    waves = _waves()
    jrec = JaxRecognizer.from_params(bundles[writer], **kw)
    prec = Recognizer.from_params(bundles[writer], device="cpu", **kw)
    want = jrec.transcribe_batch(waves)
    assert any(want)  # the comparison has text
    assert prec.transcribe_batch(waves) == want


def test_port_export_picks_the_checkpoint_step(tmp_path, bundles):
    """``step=`` names a checkpoint; no checkpoint raises; a flax tree whose
    layout the config does not give is refused by the inverse bridge."""
    ckpt = os.path.join(os.path.dirname(bundles["port"]), "port_ckpt")
    out = export_params(ckpt, str(tmp_path / "at5"), step=5)
    assert json.load(open(os.path.join(out, "export.json"))) == {"step": 5}
    with pytest.raises(FileNotFoundError):
        export_params(ckpt, str(tmp_path / "none"), step=7)
    cfg = pcfg.ModelConfig.from_dict(D)
    sd = weights.state_dict_from_flax(bundles["params"], cfg)
    sd.pop("joint.fc.bias")
    with pytest.raises(ValueError, match="lacks"):
        weights.flax_from_state_dict(sd, cfg)
    sd = weights.state_dict_from_flax(bundles["params"], cfg)
    sd["joint.fc.weight"] = sd["joint.fc.weight"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        weights.flax_from_state_dict(sd, cfg)


def test_codec_refuses_what_flax_writes_beyond_a_params_tree():
    scalar = serialization.msgpack_serialize({"x": np.float32(1.0)})
    with pytest.raises(ValueError, match="ext type"):
        flax_msgpack.loads(scalar)
    chunked = serialization.msgpack_serialize(
        {"x": {"__msgpack_chunked_array__": True, "shape": {"0": np.zeros(1)}}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.loads(chunked)
    with pytest.raises(ValueError, match="maps and numpy arrays"):
        flax_msgpack.dumps({"x": 1.0})
    assert flax_msgpack.loads(flax_msgpack.dumps({"x": np.zeros((0, 3))}))["x"].shape == (0, 3)
    torch_free = flax_msgpack.loads(serialization.msgpack_serialize(
        {"b": np.arange(6, dtype=np.int32).reshape(2, 3), "a": {"c": np.ones(2, np.float16)}}))
    assert list(torch_free) == ["a", "b"] and torch_free["a"]["c"].dtype == np.float16
