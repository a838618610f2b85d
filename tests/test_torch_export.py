"""Deployment bundles of the port (utils/export.py) against the JAX
package's (``rnntransducer_tpu/utils/export.py``, platforms ("cpu",)) on the
same weights, the cases of ``tests/test_export_bundle.py``: logmel and wav
greedy bundles, a beam bundle, a streaming bundle on a unidirectional LSTM,
a Conformer offline greedy bundle, and the refusals.  Tokens and lengths
must be exactly equal, as ``tests/test_torch_greedy.py`` holds the live
decoders; the live port decoders (now loops over the functional frame
steps the programs run in a ``while_loop``) must equal them too.  The
programs hold the registered kernels' op nodes, and a bundle transcribes
after the checkpoint it came from is gone, with no model built."""

import json
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode.beam_batched import (
    batched_beam_decode as jax_beam_decode)
from rnntransducer_tpu.utils import export as jax_export

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
from rnntransducer_tpu_torch.decode.greedy import greedy_decode
from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
from rnntransducer_tpu_torch.models import transducer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils import export

from _torch_parity import (conformer_dict, jax_model, model_dict, numpy_params,
                           port_model, t)

GRU = model_dict(n_mels=80, vocab=72, layers=2)
FRAMES = (16, 32)


def _configs(d):
    return (jcfg.Config(model=jcfg.ModelConfig.from_dict(d)),
            pcfg.Config(model=pcfg.ModelConfig.from_dict(d)))


def _both(tmp, d, seed=4, **kw):
    """(JAX ExportedTranscriber, port ExportedTranscriber, port model) of
    bundles exported from the same weights with the same arguments."""
    _, variables = jax_model(d, seed=seed)
    jc, pc = _configs(d)
    params = numpy_params(variables)
    jb = jax_export.export_transcriber(jc, variables["params"], str(tmp / "jax"),
                                       platforms=("cpu",), **kw)
    pb = export.export_transcriber(pc, params, str(tmp / "port"),
                                   platforms=("cpu",), **kw)
    return (jax_export.ExportedTranscriber(jb),
            export.ExportedTranscriber(pb, device="cpu"), port_model(d, variables))


def _program_ops(path):
    """The targets of every call in the program at ``path``, while_loop
    bodies included."""
    program = torch.export.load(path)
    return {str(n.target) for m in program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"}


def _feats(seed, lengths, frames, batch):
    rng = np.random.RandomState(seed)
    x = np.zeros((batch, frames, 80), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.randn(n, 80)
    return x, np.asarray(list(lengths) + [1] * (batch - len(lengths)), np.int32)


@pytest.fixture(scope="module")
def logmel(tmp_path_factory):
    return _both(tmp_path_factory.mktemp("logmel"), GRU, batch=2,
                 frame_buckets=FRAMES, input_kind="logmel", max_output_len=32)


def test_logmel_bundle_equals_jax_and_the_live_decoder(logmel):
    jt, pt, pm = logmel
    assert sorted(p["frames"] for p in pt.manifest["programs"]) == list(FRAMES)
    assert set(pt.manifest) == set(jt.manifest)
    for frames, lengths in ((16, (16, 9)), (32, (20, 31))):
        x, n = _feats(frames, lengths, frames, 2)
        got_tok, got_len = pt.transcribe_tokens(x, n)
        want_tok, want_len = jt.transcribe_tokens(x, n)
        assert int(want_len.sum()) > 0  # the comparison has tokens
        np.testing.assert_array_equal(got_len, want_len)
        np.testing.assert_array_equal(got_tok, want_tok)
        live_tok, live_len = greedy_decode(pm, t(x), t(n), max_output_len=32)
        np.testing.assert_array_equal(live_tok.numpy(), want_tok)
        np.testing.assert_array_equal(live_len.numpy(), want_len)
    feats = [np.random.RandomState(3).randn(n, 80).astype(np.float32)
             for n in (20, 9, 31)]
    assert pt.transcribe_batch(feats) == jt.transcribe_batch(feats)
    ops = _program_ops(os.path.join(pt.dir, "greedy_b2_t32.pt2"))
    assert "rnntransducer_tpu_torch.gru_scan.default" in ops
    assert "while_loop" in ops


def test_wav_bundle_equals_jax(tmp_path):
    jt, pt, _ = _both(tmp_path, GRU, batch=1, frame_buckets=(48,),
                      input_kind="wav", max_output_len=32)
    hop = pt.manifest["hop_length"]
    rng = np.random.RandomState(1)
    waves = [(rng.randn(n) * 0.3).astype(np.float32) for n in (40 * hop, 13 * hop + 7)]
    for w in waves:
        x = np.zeros((1, 48 * hop - 1), np.float32)
        x[0, :len(w)] = w
        got = pt.transcribe_tokens(x, np.asarray([len(w)], np.int32))
        want = jt.transcribe_tokens(x, np.asarray([len(w)], np.int32))
        assert int(want[1].sum()) > 0
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
    assert pt.transcribe_batch(waves) == jt.transcribe_batch(waves)


def test_beam_bundle_equals_jax_and_the_live_beam(tmp_path):
    jt, pt, pm = _both(tmp_path, GRU, batch=2, frame_buckets=(32,),
                       input_kind="logmel", decoder="beam", beam_width=3,
                       max_output_len=32)
    assert (pt.manifest["decoder"], pt.manifest["beam_width"]) == ("beam", 3)
    x, n = _feats(5, (24, 30), 32, 2)
    got_tok, got_len = pt.transcribe_tokens(x, n)
    want_tok, want_len = jt.transcribe_tokens(x, n)
    assert int(want_len.sum()) > 0
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got_tok, want_tok)
    live_tok, live_len, _ = batched_beam_decode(pm, t(x), t(n), beam_width=3,
                                                max_output_len=32)
    np.testing.assert_array_equal(live_tok[:, 0].numpy(), want_tok)
    np.testing.assert_array_equal(live_len[:, 0].numpy(), want_len)
    jm, variables = jax_model(GRU, seed=4)
    jtok, jlen, _ = jax_beam_decode(jm, variables, jnp.asarray(x), jnp.asarray(n),
                                    blank_id=0, beam_width=3, max_output_len=32)
    np.testing.assert_array_equal(np.asarray(jtok)[:, 0], want_tok)
    np.testing.assert_array_equal(np.asarray(jlen)[:, 0], want_len)


def test_streaming_bundle_equals_jax_and_the_live_session(tmp_path):
    d = model_dict(rnn_type="lstm", n_mels=80, vocab=72, layers=2,
                   bidirectional=False, stride=2, reduce_at=1)
    _, variables = jax_model(d, seed=6)
    jc, pc = _configs(d)
    kw = dict(batch=1, frame_buckets=(16,), input_kind="logmel", platforms=("cpu",),
              max_output_len=64, streaming_chunk_frames=16)
    jb = jax_export.export_transcriber(jc, variables["params"], str(tmp_path / "j"), **kw)
    pb = export.export_transcriber(pc, numpy_params(variables), str(tmp_path / "p"), **kw)
    ops = _program_ops(os.path.join(pb, "stream_greedy_t16.pt2"))
    assert "rnntransducer_tpu_torch.lstm_scan.default" in ops
    hop = pc.data.audio.hop_length
    wav = (np.random.RandomState(7).randn(45 * hop) * 0.3).astype(np.float32)
    live = StreamingRecognizer(port_model(d, variables), pc.data.audio,
                               chunk_frames=16, max_output_len=64)
    got, want, ref = [], [], []
    sess = export.ExportedStreamingSession(pb, device="cpu")
    jsess = jax_export.ExportedStreamingSession(jb)
    for i in range(0, len(wav), 4000):  # uneven PCM chunking
        got.extend(sess.feed(wav[i:i + 4000]))
        want.extend(jsess.feed(wav[i:i + 4000]))
        ref.extend(live.feed(wav[i:i + 4000]))
    got.extend(sess.flush())
    want.extend(jsess.flush())
    ref.extend(live.flush())
    assert want and got == want == ref == sess.tokens
    assert sess.text() == jsess.text()


def test_conformer_bundle_equals_jax(tmp_path):
    d = conformer_dict(stride=2)
    jt, pt, _ = _both(tmp_path, d, batch=2, frame_buckets=(24,),
                      input_kind="logmel", max_output_len=32)
    x, n = _feats(8, (24, 13), 24, 2)
    got_tok, got_len = pt.transcribe_tokens(x, n)
    want_tok, want_len = jt.transcribe_tokens(x, n)
    assert int(want_len.sum()) > 0
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got_tok, want_tok)


def test_loaders_refuse_what_they_cannot_run(logmel, tmp_path, monkeypatch):
    jt, pt, _ = logmel
    with pytest.raises(ValueError, match="largest exported bucket"):
        pt.transcribe_batch([np.zeros((100, 80), np.float32)])
    # a JAX bundle: its programs are jax.export programs
    with pytest.raises(ValueError, match=r"\.jaxexp"):
        export.ExportedTranscriber(jt.dir, device="cpu")
    # a bundle exported for the CPU alone does not run on the card
    with pytest.raises(ValueError, match="exported for"):
        export.ExportedTranscriber(pt.dir, device="cuda")
    # the loader runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.ExportedTranscriber(pt.dir)
    bad = str(tmp_path / "bad")
    shutil.copytree(pt.dir, bad)
    m = json.load(open(os.path.join(bad, "bundle.json")))
    m["format_version"] = 999
    json.dump(m, open(os.path.join(bad, "bundle.json"), "w"))
    with pytest.raises(ValueError, match="unsupported bundle format"):
        export.ExportedTranscriber(bad, device="cpu")
    with pytest.raises(ValueError, match="no streaming program"):
        export.ExportedStreamingSession(pt.dir, device="cpu")


def test_streaming_export_refusals(tmp_path):
    _, variables = jax_model(GRU, seed=4)
    _, pc = _configs(GRU)
    params = numpy_params(variables)
    with pytest.raises(ValueError, match="unidirectional"):
        export.export_transcriber(pc, params, str(tmp_path / "x"), frame_buckets=(16,),
                                  input_kind="logmel", platforms=("cpu",),
                                  streaming_chunk_frames=8)
    d = model_dict(n_mels=80, vocab=72, bidirectional=False, stride=2)
    _, v2 = jax_model(d, seed=4)
    with pytest.raises(ValueError, match="multiple of time_reduction_stride"):
        export.export_transcriber(_configs(d)[1], numpy_params(v2), str(tmp_path / "y"),
                                  frame_buckets=(16,), input_kind="logmel",
                                  platforms=("cpu",), streaming_chunk_frames=7)
    with pytest.raises(ValueError, match="platforms"):
        export.export_transcriber(pc, params, str(tmp_path / "z"), platforms=("tpu",))


def test_bundle_from_a_checkpoint_needs_no_model(tmp_path, monkeypatch):
    """The CLI exports from a checkpoint; with the checkpoint and its config
    deleted and model building made to raise, the bundle still transcribes,
    as the live decoder on the checkpoint's weights does."""
    _, pc = _configs(GRU)
    _, variables = jax_model(GRU, seed=4)
    state = TrainState.create(pc, "cpu", state_dict=port_model(GRU, variables).state_dict())
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(3, state, config=pc)
    mgr.close()
    out = str(tmp_path / "bundle")
    export.main(["--checkpoint_dir", ckpt, "--out_dir", out, "--batch", "2",
                 "--frame_buckets", "32", "--input_kind", "logmel",
                 "--platforms", "cpu", "--max_output_len", "32"])
    shutil.rmtree(ckpt)

    def refuse(*a, **k):
        raise AssertionError("a bundle must not build a model")

    monkeypatch.setattr(transducer, "build_model", refuse)
    x, n = _feats(11, (30, 12), 32, 2)
    got_tok, got_len = export.ExportedTranscriber(out, device="cpu").transcribe_tokens(x, n)
    monkeypatch.undo()
    want_tok, want_len = greedy_decode(port_model(GRU, variables), t(x), t(n),
                                       max_output_len=32)
    assert int(want_len.sum()) > 0
    np.testing.assert_array_equal(got_tok, want_tok.numpy())
    np.testing.assert_array_equal(got_len, want_len.numpy())
