"""The port's host A/B beam search (decode/beam.py), n-gram LM
(decode/ngram_lm.py, the native scorer built into build/native/) and
hotwords against the JAX package: LM scores on an ARPA file and on kenlm
probing / trie binaries to 1e-6; the beam with improved pruning on and off,
LM, hotwords and n-best on the same weights and inputs, tokens exactly and
hypothesis scores to 1e-5 relative; a session resumed over two chunks and
the multilane pump against the offline decode."""

import itertools
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.decode.beam import BeamSearchDecoder as JaxBeam
from rnntransducer_tpu.decode.hotwords import HotwordScorer as JaxHotwords
from rnntransducer_tpu.decode.ngram_lm import NGramLM as JaxNGramLM
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer
from rnntransducer_tpu.utils.kenlm_binary import write_probing_binary, write_trie_binary

from rnntransducer_tpu_torch.decode import ngram_lm
from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
from rnntransducer_tpu_torch.decode.hotwords import HotwordScorer
from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer

from _torch_parity import jax_apply, jax_model, model_dict, port_model, t

ARPA = textwrap.dedent(r"""
\data\
ngram 1=7
ngram 2=4

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.6    the    -0.3
-1.2    cat    -0.2
-1.4    dog    -0.2
-0.9    sat    -0.4
-2.0    <unk>

\2-grams:
-0.3    <s> the
-0.4    the cat
-0.9    the dog
-0.5    cat sat

\end\
""").strip()
WORDS = ["<s>", "</s>", "the", "cat", "dog", "sat", "<unk>", "zebra"]
VOCAB = {"<pad>": 0, "<unk>": 1, "c": 2, "a": 3, "|": 4, "t": 5}
D = model_dict(rnn_type="lstm", layers=1, bidirectional=False, vocab=6)
SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("beam_lm")
    (d / "lm.arpa").write_text(ARPA)
    write_probing_binary(ARPA, str(d / "lm.bin"))
    write_trie_binary(ARPA, str(d / "lm.trie"))
    return {k: str(d / f"lm.{k}") for k in ("arpa", "bin", "trie")}


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model(D, seed=1)
    return jm, variables, port_model(D, variables)


@pytest.mark.parametrize("fmt", ["arpa", "bin", "trie"])
def test_ngram_scores_match_jax(lm_files, fmt):
    got = NGramLM.load(lm_files[fmt], weight=0.7, beta=0.3)
    want = JaxNGramLM.load(lm_files[fmt], weight=0.7, beta=0.3)
    assert got.order == want.order == 2
    for ctx in itertools.chain([()], itertools.product(WORDS, repeat=1)):
        for w in WORDS:
            cg = tuple(got.word_id(x) for x in ctx)
            cw = tuple(want.word_id(x) for x in ctx)
            np.testing.assert_allclose(got.raw_score(cg, got.word_id(w)),
                                       want.raw_score(cw, want.word_id(w)),
                                       atol=1e-6, err_msg=f"P({w} | {ctx})")
    sg, sw = got.get_start_state(), want.get_start_state()
    for w in ("the", "cat", "zebra", "sat"):
        (a, sg), (b, sw) = got.score(sg, w), want.score(sw, w)
        assert abs(a - b) <= 1e-6, w
    assert abs(got.score(sg, "the", is_last_word=True)[0]
               - want.score(sw, "the", is_last_word=True)[0]) <= 1e-6
    for p in ("ca", "th", "zz", "", "abcdefghij"):
        assert got.has_prefix(p) == want.has_prefix(p)
        assert abs(got.score_partial_token(p) - want.score_partial_token(p)) <= 1e-6


def test_ngram_library_builds_under_build_and_raises(monkeypatch, tmp_path):
    """The port compiles its own copy of the native scorer under
    build/native/ (never under native/), and a failed build raises."""
    path = ngram_lm._library_path()
    assert path.parent.parts[-2:] == ("build", "native")
    assert path.name.startswith("libngram_lm-") and path.exists()
    monkeypatch.setattr(ngram_lm, "_BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="cannot build the n-gram LM"):
        ngram_lm._build(tmp_path / "b" / "lib.so")


def test_hotword_scorer_matches_jax():
    words, weight = ["cat", "the cat", "at"], 2.5
    got, want = HotwordScorer(words, weight), JaxHotwords(words, weight)
    for text in ("", "cat", "the cat sat", "at cat", "scat", "cat at"):
        assert got.score(text) == want.score(text), text
    for tok in ("", "c", "ca", "th", "x", "the c"):
        assert got.score_partial_token(tok) == want.score_partial_token(tok)
        assert (tok in got) == (tok in want)
    assert HotwordScorer.build_scorer(["foo", "bar"], 1.0).score("foo bar") == 6.0
    assert not HotwordScorer.build_scorer(None)


def _feats(seed, T=10):
    rng = np.random.RandomState(seed)
    return rng.randn(1, T, 8).astype(np.float32) * 2


def _encs(jm, variables, pm, feats):
    n = np.array([feats.shape[1]], np.int32)
    jenc = np.asarray(jax_apply(jm, variables, jnp.asarray(feats), jnp.asarray(n),
                                method=jm.encode)[0][0])
    with torch.inference_mode():
        penc = pm.encode(t(feats), t(n))[0][0]
    return jenc, penc


def _snapshot(session):
    return sorted((tuple(h.y_star), h.asr_score, h.lm_score) for h in session.B_hyps)


def _assert_same_sessions(got, want):
    g, w = _snapshot(got), _snapshot(want)
    assert [x[0] for x in g] == [x[0] for x in w]
    np.testing.assert_allclose([x[1:] for x in g], [x[1:] for x in w],
                               rtol=SCORE_RTOL, atol=0.0)


@pytest.mark.parametrize("improved, fusion, kw", [
    (True, "none", {}), (False, "none", {}), (True, "lm", {}),
    (True, "lm+hotwords", {}), (False, "hotwords", {}),
    (True, "lm", dict(merge_duplicates=True, length_norm_alpha=0.6)),
])
def test_host_beam_matches_jax(models, lm_files, improved, fusion, kw):
    jm, variables, pm = models
    fuse = {}
    if "lm" in fusion:
        fuse["lm"] = (NGramLM.load(lm_files["arpa"], weight=0.5),
                      JaxNGramLM.load(lm_files["arpa"], weight=0.5))
    if "hotwords" in fusion:
        fuse["hotwords"] = (["cat", "at"],) * 2
        fuse["hotword_weight"] = (3.0,) * 2
    common = dict(blank_id=0, beam_width=4, improved=improved, **kw)
    port = BeamSearchDecoder(pm, tokenizer=GraphemeTokenizer(VOCAB), **common,
                             **{k: v[0] for k, v in fuse.items()})
    ref = JaxBeam(jm, variables, tokenizer=JaxTokenizer(VOCAB), **common,
                  **{k: v[1] for k, v in fuse.items()})
    feats = _feats(seed=2)
    n = np.array([feats.shape[1]], np.int32)
    want = ref.decode(jnp.asarray(feats), jnp.asarray(n), n_best=3)
    got = port.decode(t(feats), t(n), n_best=3)
    assert got == want and any(want)
    jenc, penc = _encs(jm, variables, pm, feats)
    s_got, s_want = port.open_session(), ref.open_session()
    port.decode_frames(s_got, penc)
    ref.decode_frames(s_want, jenc)
    _assert_same_sessions(s_got, s_want)
    assert port.current_best(s_got) == ref.current_best(s_want)


def test_resumed_session_and_multilane_equal_offline(models, lm_files):
    _, _, pm = models
    dec = BeamSearchDecoder(pm, blank_id=0, tokenizer=GraphemeTokenizer(VOCAB),
                            beam_width=3, lm=NGramLM.load(lm_files["arpa"], weight=0.5),
                            hotwords=["cat"], hotword_weight=2.0)
    encs = []
    for seed, T in ((3, 12), (4, 5), (5, 1), (6, 9)):
        feats = _feats(seed, T)
        with torch.inference_mode():
            encs.append(pm.encode(t(feats), torch.tensor([T]))[0][0])
    offline = []
    for e in encs:
        s = dec.open_session()
        dec.decode_frames(s, e)
        offline.append(s)
    chunked = dec.open_session()
    dec.decode_frames(chunked, encs[0][:7].numpy())  # host frames are taken too
    dec.decode_frames(chunked, encs[0][7:])
    assert _snapshot(chunked) == _snapshot(offline[0])
    assert dec.finalize(chunked, 2) == dec.finalize(offline[0], 2)
    pumped = [dec.open_session() for _ in encs]
    dec.decode_frames_multilane(list(zip(pumped, encs)))
    for a, b in zip(pumped, offline):
        # a wider device call may round its rows differently (the matmul's
        # blocking depends on the row count): tokens exactly, scores 1e-5
        _assert_same_sessions(a, b)
        assert dec.finalize(a) == dec.finalize(b)


def test_host_beam_refusals(models):
    _, _, pm = models
    with pytest.raises(ValueError, match="requires a tokenizer"):
        BeamSearchDecoder(pm, hotwords=["x"])
    tok = GraphemeTokenizer({"<pad>": 0, "<unk>": 1, "a": 2})  # no delimiter
    with pytest.raises(ValueError, match="word-delimiter"):
        BeamSearchDecoder(pm, tokenizer=tok, lm=object())


@pytest.mark.cuda
def test_host_beam_on_the_card_matches_the_cpu(models, lm_files):
    """The host beam scoring its waves on CUDA against the CPU, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pm = models
    feats = _feats(seed=2)
    n = torch.tensor([feats.shape[1]])
    kw = dict(blank_id=0, beam_width=4, tokenizer=GraphemeTokenizer(VOCAB),
              hotwords=["cat"])
    want = BeamSearchDecoder(pm, lm=NGramLM.load(lm_files["arpa"]), **kw).decode(
        t(feats), n, n_best=3)
    card = pm.to("cuda")
    try:
        got = BeamSearchDecoder(card, lm=NGramLM.load(lm_files["arpa"]), **kw).decode(
            t(feats).cuda(), n.cuda(), n_best=3)
    finally:
        pm.to("cpu")
    assert got == want
