"""On-device LM fusion of the port (decode/device_lm.py,
decode/device_word_lm.py) against the JAX package: the char and word tables
built from the same ARPA files to 1e-6, and the batched beam fused with
each (with the word LM's end-of-stream settling) on the same weights and
inputs, tokens exactly and scores to 1e-5 relative."""

import textwrap

import numpy as np
import jax.numpy as jnp
import pytest

from rnntransducer_tpu.decode.beam_batched import batched_beam_decode as jax_beam
from rnntransducer_tpu.decode.device_lm import DeviceCharLM as JaxCharLM
from rnntransducer_tpu.decode.device_lm import build_char_lm_table as jax_char_table
from rnntransducer_tpu.decode.device_word_lm import build_device_word_lm as jax_word_lm
from rnntransducer_tpu.decode.ngram_lm import NGramLM as JaxNGramLM
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM, build_char_lm_table
from rnntransducer_tpu_torch.decode.device_word_lm import build_device_word_lm
from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer

from _torch_parity import jax_model, model_dict, port_model, t

# a char trigram over a / b / c (tests/test_device_lm.py's)
CHAR_ARPA = textwrap.dedent(r"""
\data\
ngram 1=5
ngram 2=3
ngram 3=2

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.4    a    -0.3
-0.7    b    -0.2
-1.1    c    -0.1

\2-grams:
-0.2    a b    -0.4
-0.5    b a    -0.3
-0.9    b c

\3-grams:
-0.1    a b a
-0.6    b a b

\end\
""").strip()
CHAR_VOCAB = {"<pad>": 0, "<unk>": 1, "<s>": 2, "</s>": 3, "|": 4,
              "a": 5, "b": 6, "c": 7}

# a word bigram over a lexicon of c / a / t / s (tests/test_device_word_lm.py's)
WORD_ARPA = textwrap.dedent(r"""
\data\
ngram 1=7
ngram 2=4

\1-grams:
-1.0    <s>    -0.5
-1.1    </s>
-0.6    cat    -0.3
-1.2    ca    -0.2
-1.4    tas    -0.2
-0.9    sat    -0.4
-2.0    <unk>

\2-grams:
-0.3    <s> cat
-0.4    cat tas
-0.9    tas sat
-0.5    sat cat

\end\
""").strip()
WORD_VOCAB = {"<pad>": 0, "<unk>": 1, "|": 2, "c": 3, "a": 4, "t": 5, "s": 6}
WORDS = ["cat", "ca", "tas", "sat"]
SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    d = tmp_path_factory.mktemp("device_lm")
    (d / "char.arpa").write_text(CHAR_ARPA)
    (d / "word.arpa").write_text(WORD_ARPA)
    return {"char": str(d / "char.arpa"), "word": str(d / "word.arpa")}


def _beam_inputs(vocab, seed):
    d = model_dict(rnn_type="lstm", layers=1, bidirectional=False, vocab=vocab)
    jm, variables = jax_model(d, seed=seed)
    rng = np.random.RandomState(seed)
    feats = (rng.randn(2, 16, 8) * 2).astype(np.float32)
    return jm, variables, port_model(d, variables), feats, np.array([16, 11], np.int32)


def _assert_same(got, want):
    (gt, gl, gs), (wt, wl, ws) = got, [np.asarray(x) for x in want]
    assert int(wl[:, 0].sum()) > 0  # the comparison has tokens
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_array_equal(gt.numpy(), wt)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=SCORE_RTOL, atol=0.0)


@pytest.mark.parametrize("max_order", [None, 2])
def test_char_table_matches_jax(arpa, max_order):
    got = build_char_lm_table(NGramLM.load(arpa["char"]), GraphemeTokenizer(CHAR_VOCAB),
                              max_order=max_order)
    want = jax_char_table(JaxNGramLM.load(arpa["char"]), JaxTokenizer(CHAR_VOCAB),
                          max_order=max_order)
    assert got.shape == want.shape == (8,) * (max_order or 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0.0)
    lm = DeviceCharLM.load(arpa["char"], GraphemeTokenizer(CHAR_VOCAB), weight=0.7)
    assert (lm.order, lm.context, lm.weight) == (3, 2, 0.7)
    assert lm.to("cpu") is lm


def test_word_tables_match_jax(arpa):
    got = build_device_word_lm(NGramLM.load(arpa["word"], weight=0.7, beta=0.25),
                               GraphemeTokenizer(WORD_VOCAB), WORDS)
    want = jax_word_lm(JaxNGramLM.load(arpa["word"], weight=0.7, beta=0.25),
                       JaxTokenizer(WORD_VOCAB), WORDS)
    for name in ("trie_next", "node_word", "next_state"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("rows", "eos_col"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-6,
                                   rtol=0.0, err_msg=name)
    assert (got.n_words, got.start_state, got.delimiter_id) == (
        want.n_words, want.start_state, want.delimiter_id)


@pytest.mark.parametrize("weight", [0.0, 1.5])
def test_beam_with_char_lm_matches_jax(arpa, weight):
    jm, variables, pm, feats, lengths = _beam_inputs(vocab=8, seed=11)
    jlm = JaxCharLM.load(arpa["char"], JaxTokenizer(CHAR_VOCAB), weight=weight)
    plm = DeviceCharLM.load(arpa["char"], GraphemeTokenizer(CHAR_VOCAB), weight=weight)
    want = jax_beam(jm, variables, jnp.asarray(feats), jnp.asarray(lengths),
                    beam_width=4, max_output_len=24, device_lm=jlm)
    got = batched_beam_decode(pm, t(feats), t(lengths), beam_width=4,
                              max_output_len=24, device_lm=plm)
    _assert_same(got, want)
    if weight == 0.0:  # fusion at weight 0 changes nothing
        plain = batched_beam_decode(pm, t(feats), t(lengths), beam_width=4,
                                    max_output_len=24)
        assert all((a == b).all() for a, b in zip(got[:2], plain[:2]))


def test_beam_with_word_lm_matches_jax(arpa):
    jm, variables, pm, feats, lengths = _beam_inputs(vocab=7, seed=12)
    jlm = jax_word_lm(JaxNGramLM.load(arpa["word"], weight=2.0, beta=0.5),
                      JaxTokenizer(WORD_VOCAB), WORDS)
    plm = build_device_word_lm(NGramLM.load(arpa["word"], weight=2.0, beta=0.5),
                               GraphemeTokenizer(WORD_VOCAB), WORDS)
    kw = dict(beam_width=4, max_output_len=24, merge_duplicates=True)
    want = jax_beam(jm, variables, jnp.asarray(feats), jnp.asarray(lengths),
                    word_lm=jlm, **kw)
    got = batched_beam_decode(pm, t(feats), t(lengths), word_lm=plm, **kw)
    _assert_same(got, want)
