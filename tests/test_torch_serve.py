"""Greedy decoding and the serving API of the port against the JAX package
on a tiny bidirectional-GRU model with the same weights: tokens, lengths,
emission times and transcripts must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode import greedy_decode as jax_greedy
from rnntransducer_tpu.decode.greedy import (
    greedy_decode_with_times as jax_greedy_times)
from rnntransducer_tpu.serve import Recognizer as JaxRecognizer
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.decode import greedy_decode, greedy_decode_with_times
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.utils import weights

from _torch_parity import jax_model, model_dict, numpy_params, port_model, t


@pytest.mark.parametrize("max_symbols,stride", [(3, 1), (1, 1), (3, 2)])
def test_greedy_decode_matches_jax(max_symbols, stride):
    d = model_dict(stride=stride, reduce_at=1, layers=2)
    jm, variables = jax_model(d, seed=4)
    pm = port_model(d, variables)
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 12, 8).astype(np.float32)
    lengths = np.array([12, 7, 3], np.int32)
    want_tok, want_len, want_times = jax_greedy_times(
        jm, variables, jnp.asarray(feats), jnp.asarray(lengths), blank_id=0,
        max_symbols=max_symbols, max_output_len=32)
    got_tok, got_len, got_times = greedy_decode_with_times(
        pm, t(feats), t(lengths), blank_id=0, max_symbols=max_symbols,
        max_output_len=32)
    assert got_len.tolist() == np.asarray(want_len).tolist()
    assert int(np.asarray(want_len).sum()) > 0  # the comparison has tokens
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_times.numpy(), np.asarray(want_times))
    tok, length = greedy_decode(pm, t(feats), t(lengths),
                                max_symbols=max_symbols, max_output_len=32)
    want_tok2, want_len2 = jax_greedy(jm, variables, jnp.asarray(feats),
                                      jnp.asarray(lengths),
                                      max_symbols=max_symbols, max_output_len=32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok2))
    np.testing.assert_array_equal(length.numpy(), np.asarray(want_len2))


def _recognizers(tmp_path=None):
    d = model_dict(n_mels=80, vocab=72, layers=2)
    _, variables = jax_model(d, seed=5)
    jrec = JaxRecognizer(jcfg.Config(model=jcfg.ModelConfig.from_dict(d)),
                         variables["params"], JaxTokenizer.default(72),
                         decoder="greedy")
    cfg = pcfg.Config(model=pcfg.ModelConfig.from_dict(d))
    prec = Recognizer(cfg, numpy_params(variables), GraphemeTokenizer.default(72),
                      device="cpu")
    return jrec, prec, cfg, numpy_params(variables)


def _waves():
    rng = np.random.RandomState(6)
    return [(rng.randn(n) * 0.3).astype(np.float32) for n in (4000, 2500, 1601)]


def test_recognizer_transcripts_match_jax(tmp_path):
    jrec, prec, cfg, params = _recognizers()
    waves = _waves()
    want = jrec.transcribe_batch(waves)
    assert any(want)  # the comparison has text
    assert prec.transcribe_batch(waves) == want
    assert prec.transcribe(waves[1]) == jrec.transcribe(waves[1])
    assert (prec.transcribe_with_timestamps(waves[0])
            == jrec.transcribe_with_timestamps(waves[0]))
    # a converted bundle serves the same text on a machine without flax
    weights.save(str(tmp_path / "bundle"), cfg,
                 weights.state_dict_from_flax(params, cfg.model))
    again = Recognizer.from_torch_params(str(tmp_path / "bundle"), device="cpu")
    assert again.transcribe_batch(waves) == want
    bf16 = Recognizer.from_flax_params(cfg, params, device="cpu", precision="bf16")
    assert next(bf16.model.parameters()).dtype == torch.bfloat16
    assert len(bf16.transcribe_batch(waves)) == len(waves)


def test_recognizer_refuses_what_is_not_ported():
    d = model_dict(n_mels=80, vocab=72)
    _, variables = jax_model(d)
    cfg = pcfg.Config(model=pcfg.ModelConfig.from_dict(d))
    params = numpy_params(variables)
    tok = GraphemeTokenizer.default(72)
    for kw in (dict(decoder="beam_batched"), dict(lm_path="lm.arpa"),
               dict(hotwords=["ㄱ"])):
        with pytest.raises(NotImplementedError, match="not ported"):
            Recognizer(cfg, params, tok, device="cpu", **kw)
    rec = Recognizer(cfg, params, tok, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        rec.stream()
