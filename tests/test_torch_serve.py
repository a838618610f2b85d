"""Greedy decoding and the serving API of the port against the JAX package
on tiny models with the same weights: tokens, lengths, emission times and
transcripts must be equal, for the default device beam, the greedy
decoder, LM / hotword fusion through the host beam, an on-device char LM
and streaming sessions."""

import textwrap

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
                      decoder="greedy", device="cpu")
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
    again = Recognizer.from_torch_params(str(tmp_path / "bundle"), decoder="greedy",
                                         device="cpu")
    assert again.transcribe_batch(waves) == want
    bf16 = Recognizer.from_flax_params(cfg, params, device="cpu", precision="bf16")
    assert next(bf16.model.parameters()).dtype == torch.bfloat16
    assert len(bf16.transcribe_batch(waves)) == len(waves)


def test_recognizer_refuses_what_is_not_ported():
    """Every decoder and fusion option of the JAX Recognizer is ported; what
    is still refused are the contradictory options, with the JAX package's
    ValueErrors, and the Conformer's streaming state."""
    d = model_dict(n_mels=80, vocab=72)
    _, variables = jax_model(d)
    cfg = pcfg.Config(model=pcfg.ModelConfig.from_dict(d))
    params = numpy_params(variables)
    tok = GraphemeTokenizer.default(72)
    with pytest.raises(ValueError, match="requires a beam decoder"):
        Recognizer(cfg, params, tok, device="cpu", decoder="greedy", hotwords=["ㄱ"])
    rec = Recognizer(cfg, params, tok, device="cpu")
    assert (rec.decoder, rec.beam_width, rec.fused) == ("beam_batched", 5, False)
    with pytest.raises(ValueError, match="unidirectional"):
        rec.stream()


# a word bigram and a char trigram over the default vocabulary's graphemes
WORD_ARPA = textwrap.dedent(r"""
\data\
ngram 1=5
ngram 2=2

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.8    ㄱㅏ    -0.3
-1.1    ㄴㅏ    -0.2
-2.0    <unk>

\2-grams:
-0.4    <s> ㄱㅏ
-0.6    ㄱㅏ ㄴㅏ

\end\
""").strip()
CHAR_ARPA = textwrap.dedent(r"""
\data\
ngram 1=5
ngram 2=2
ngram 3=1

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.4    ㄱ    -0.3
-0.7    ㅏ    -0.2
-0.9    |    -0.2

\2-grams:
-0.2    ㄱ ㅏ    -0.4
-0.5    ㅏ |

\3-grams:
-0.1    ㄱ ㅏ |

\end\
""").strip()


@pytest.fixture(scope="module")
def lm_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_lm")
    (d / "word.arpa").write_text(WORD_ARPA)
    (d / "char.arpa").write_text(CHAR_ARPA)
    return str(d / "word.arpa"), str(d / "char.arpa")


def _pair(d, seed, **kw):
    """The JAX and the port Recognizer on the same weights and options."""
    _, variables = jax_model(d, seed=seed)
    jrec = JaxRecognizer(jcfg.Config(model=jcfg.ModelConfig.from_dict(d)),
                         variables["params"], JaxTokenizer.default(72), **kw)
    prec = Recognizer(pcfg.Config(model=pcfg.ModelConfig.from_dict(d)),
                      numpy_params(variables), GraphemeTokenizer.default(72),
                      device="cpu", **kw)
    return jrec, prec


@pytest.mark.parametrize("kw", [{}, dict(beam_width=3, max_output_len=64)])
def test_recognizer_default_beam_matches_jax(kw):
    """Recognizer(cfg, params, tok) decodes with the device beam at
    cfg.inference.beam_width in both packages."""
    jrec, prec = _pair(model_dict(n_mels=80, vocab=72, layers=2), 5, **kw)
    assert prec.decoder == jrec.decoder == "beam_batched"
    assert prec.beam_width == jrec.beam_width
    waves = _waves()
    want = jrec.transcribe_batch(waves)
    assert any(want)
    assert prec.transcribe_batch(waves) == want


@pytest.mark.parametrize("fusion", ["lm", "hotwords", "device_lm"])
def test_recognizer_fusion_routes_match_jax(lm_paths, fusion):
    """LM / hotwords route through the host A/B beam, a device char LM
    through the device beam: the texts equal the JAX Recognizer's."""
    kw = {"lm": dict(lm_path=lm_paths[0], lm_weight=0.8),
          "hotwords": dict(hotwords=["ㄱㅏ"], hotword_weight=3.0),
          "device_lm": dict(device_lm_path=lm_paths[1], device_lm_weight=1.0)}[fusion]
    jrec, prec = _pair(model_dict(n_mels=80, vocab=72, layers=1), 5, beam_width=3,
                       **kw)
    assert prec.fused == jrec.fused == (fusion != "device_lm")
    waves = _waves()[:2]
    want = jrec.transcribe_batch(waves)
    assert any(want)
    assert prec.transcribe_batch(waves) == want


@pytest.mark.parametrize("decoder, fusion", [("greedy", None), ("beam_batched", None),
                                             ("beam", "lm")])
def test_recognizer_stream_matches_jax(lm_paths, decoder, fusion):
    d = model_dict(rnn_type="lstm", layers=2, bidirectional=False, n_mels=80,
                   vocab=72)
    kw = dict(lm_path=lm_paths[0], hotwords=["ㄴㅏ"]) if fusion else {}
    jrec, prec = _pair(d, 8, decoder=decoder, beam_width=3, **kw)
    wav = _waves()[0]
    texts = []
    for rec in (jrec, prec):
        session = rec.stream(chunk_frames=16)
        for s in range(0, len(wav), 1600):
            session.feed(wav[s:s + 1600])
        session.flush()
        texts.append(rec.tokenizer.decode(session.tokens, group_tokens=False))
    assert texts[1] == texts[0] and texts[0]
