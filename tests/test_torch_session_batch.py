"""Continuous batching in the port (decode/session_batch.py) against the JAX
package's ``BatchedStreamingRunner`` and against independent port
``StreamingRecognizer`` sessions, on a unidirectional-LSTM model with the
same weights: tokens exactly (partials and finals), timestamps exactly,
beam scores within 1e-5 relative, for greedy lanes, beam lanes, beam lanes
with the device char LM or word LM, and host-fused lanes (n-gram LM +
hotwords).  Idle lanes leave the state bit-identical, slots recycle, the
slot limit raises, concurrent feeds stay exact, warmup leaves the state as
it was, and a mesh keeps the JAX runner's refusals (the sharded lanes are
``test_torch_lane_sharding.py``'s)."""

import textwrap
import threading

import numpy as np
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode.device_lm import DeviceCharLM as JaxCharLM
from rnntransducer_tpu.decode.device_word_lm import (
    build_device_word_lm as jax_word_lm)
from rnntransducer_tpu.decode.ngram_lm import NGramLM as JaxNGramLM
from rnntransducer_tpu.decode.session_batch import (
    BatchedStreamingRunner as JaxRunner)
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.decode import BatchedStreamingRunner, StreamingRecognizer
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
from rnntransducer_tpu_torch.decode.device_word_lm import build_device_word_lm
from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer

from _torch_parity import jax_model, model_dict, port_model

D = model_dict(rnn_type="lstm", layers=2, bidirectional=False, n_mels=80,
               vocab=7, hidden=16)
VOCAB = {"<pad>": 0, "<unk>": 1, "a": 2, "t": 3, "i": 4, "o": 5, "|": 6}
WORDS = ["at", "it", "to"]
WORD_ARPA = textwrap.dedent(r"""
\data\
ngram 1=6
ngram 2=2

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.8    at    -0.3
-1.1    it    -0.2
-1.3    to    -0.2
-2.0    <unk>

\2-grams:
-0.4    <s> at
-0.6    at it

\end\
""").strip()
CHAR_ARPA = textwrap.dedent(r"""
\data\
ngram 1=4
ngram 2=2

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.4    a    -0.3
-0.7    t    -0.2

\2-grams:
-0.2    a t
-0.5    t a

\end\
""").strip()
AUDIO = dict(normalize=False)
KW = dict(chunk_frames=16, max_symbols=2, max_output_len=128)
PIECE = 1600
SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model(D, seed=7)
    return jm, variables, port_model(D, variables)


@pytest.fixture(scope="module")
def lm_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("session_lm")
    (d / "word.arpa").write_text(WORD_ARPA)
    (d / "char.arpa").write_text(CHAR_ARPA)
    return str(d / "word.arpa"), str(d / "char.arpa")


def _wavs(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rng.randint(4000, 12000)) * 2).astype(np.float32)
            for _ in range(n)]


def _fusion_kw(fusion, lm_paths):
    """(JAX kwargs, port kwargs) of a fusion mode."""
    if fusion is None:
        return {}, {}
    if fusion == "device_lm":
        return ({"device_lm": JaxCharLM.load(lm_paths[1], JaxTokenizer(VOCAB),
                                             weight=1.0)},
                {"device_lm": DeviceCharLM.load(lm_paths[1], GraphemeTokenizer(VOCAB),
                                                weight=1.0)})
    if fusion == "word_lm":
        return ({"word_lm": jax_word_lm(JaxNGramLM.load(lm_paths[0], weight=2.0,
                                                        beta=0.5),
                                        JaxTokenizer(VOCAB), WORDS)},
                {"word_lm": build_device_word_lm(NGramLM.load(lm_paths[0], weight=2.0,
                                                              beta=0.5),
                                                 GraphemeTokenizer(VOCAB), WORDS)})
    return tuple(dict(lm=lm_cls.load(lm_paths[0], weight=0.8, beta=0.5),
                      hotwords=["at"], hotword_weight=2.0, tokenizer=tok(VOCAB))
                 for lm_cls, tok in ((JaxNGramLM, JaxTokenizer),
                                     (NGramLM, GraphemeTokenizer)))


def _interleaved(runner, wavs, poll=False):
    """Sessions fed in staggered rounds (session i starts at round i):
    (tokens returned by feed + flush, partials after each feed if ``poll``,
    timestamps of greedy lanes)."""
    sessions = [runner.open() for _ in wavs]
    got = [[] for _ in wavs]
    partials = [[] for _ in wavs]
    pos = [0] * len(wavs)
    rounds = 0
    while any(p < len(w) for p, w in zip(pos, wavs)):
        for i, s in enumerate(sessions):
            if rounds >= i and pos[i] < len(wavs[i]):
                got[i] += s.feed(wavs[i][pos[i]:pos[i] + PIECE])
                if poll:
                    partials[i].append(list(s.tokens))
                pos[i] += PIECE
        rounds += 1
    times = []
    for i, s in enumerate(sessions):
        got[i] += s.flush()
        if runner.decoder == "greedy":
            times.append(s.timestamps)
    return got, partials, times


def _independent(pm, wav, decoder, **kw):
    rec = StreamingRecognizer(pm, pcfg.AudioConfig(**AUDIO), normalize="none",
                              decoder=decoder, beam_width=3, **KW, **kw)
    fed = []
    for s in range(0, len(wav), PIECE):
        fed += rec.feed(wav[s:s + PIECE])
    return fed + rec.flush()


@pytest.mark.parametrize("decoder, fusion", [
    ("greedy", None), ("beam", None), ("beam", "device_lm"), ("beam", "word_lm"),
    ("beam", "lm+hotwords")])
def test_batched_lanes_match_jax_and_independent_sessions(models, lm_paths,
                                                          decoder, fusion):
    jm, variables, pm = models
    jkw, pkw = _fusion_kw(fusion, lm_paths)
    wavs = _wavs(3, seed=1 + len(str(fusion)))
    poll = fusion == "lm+hotwords"
    common = dict(max_sessions=4, decoder=decoder, beam_width=3, **KW)
    ref = JaxRunner(jm, variables, jcfg.AudioConfig(**AUDIO), **common, **jkw)
    want, want_partials, want_times = _interleaved(ref, wavs, poll)
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), **common, **pkw)
    got, got_partials, got_times = _interleaved(runner, wavs, poll)
    assert got == want and got_partials == want_partials
    assert all(got)  # every lane has tokens to compare
    assert len(got_times) == len(want_times)
    for g, w in zip(got_times, want_times):
        np.testing.assert_allclose(g, w, atol=1e-9, rtol=0.0)
    if fusion != "word_lm":  # streaming sessions have no word-LM fusion
        assert got == [_independent(pm, w, decoder, **pkw) for w in wavs]
    if runner._carry is not None and decoder == "beam":
        # the released lanes keep their last carry: the beam scores
        np.testing.assert_allclose(runner._carry.scores.numpy(),
                                   np.asarray(ref._carry.scores),
                                   rtol=SCORE_RTOL, atol=0.0)


def _snapshot(runner):
    """Copies of every tensor of the runner's persistent state."""
    leaves = [runner._enc_state.h, runner._enc_state.c]
    carry = runner._carry
    for leaf in carry:
        leaves += list(leaf) if isinstance(leaf, tuple) else [leaf]
    return [None if x is None else x.clone() for x in leaves]


def _same(a, b):
    return len(a) == len(b) and all(
        (x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_idle_lanes_are_noops_and_slots_recycle(models, decoder):
    """An all-idle tick leaves every lane's encoder state and carry
    bit-identical (mid-stream, with live lanes); a session ticking alone
    equals its independent session, and a freed slot serves a second
    session as a fresh one."""
    _, _, pm = models
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=4,
                                    decoder=decoder, beam_width=3, **KW)
    wav1, wav2 = _wavs(2, seed=9)
    s = runner.open()
    s.feed(wav1[:6000])
    before = _snapshot(runner)
    runner._enc_state, runner._carry = runner._step(*runner._idle_inputs())
    assert _same(_snapshot(runner), before)
    assert before[0].abs().sum() > 0  # the lane really holds a state
    s.feed(wav1[6000:])
    assert s.flush() is not None
    for wav in (wav1, wav2):
        sess = runner.open()
        assert sess.slot == s.slot  # the freed slot is reused
        got = []
        for i in range(0, len(wav), 2000):
            got += sess.feed(wav[i:i + 2000])
        fin = sess.flush()
        got = fin if decoder == "beam" else got + fin
        # the independent session takes other pieces: the features do not
        # depend on them without normalisation
        want = _independent(pm, wav, decoder)
        assert got == want and got


def test_slot_exhaustion_raises(models):
    _, _, pm = models
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=2,
                                    **KW)
    a, b = runner.open(), runner.open()
    with pytest.raises(RuntimeError, match="slots in use"):
        runner.open()
    a.flush()
    c = runner.open()
    assert c.slot == a.slot
    b.abort()
    assert b.flush() == [] and sorted(runner._free) == [b.slot]
    with pytest.raises(ValueError, match="closed"):
        b.feed(np.zeros(160, np.float32))
    c.flush()


def test_concurrent_feeds_are_exact(models):
    """One thread per session, feed-with-drain and partial polls without
    coordination, a short switch interval: the tokens equal independent
    sessions (the tick runs without the state lock; buffer appends take
    it)."""
    import sys

    _, _, pm = models
    n = 6
    wavs = _wavs(n, seed=13)
    want = [_independent(pm, w, "greedy") for w in wavs]
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=n,
                                    **KW)
    got = [None] * n
    errors = []

    def client(i):
        try:
            sess = runner.open(normalize="none")
            out = []
            for s in range(0, len(wavs[i]), PIECE):
                out += sess.feed(wavs[i][s:s + PIECE])
                sess.tokens  # a partial poll under load
            got[i] = out + sess.flush()
        except Exception as e:  # surfaced through errors
            errors.append((i, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert got == want


@pytest.mark.parametrize("decoder, fusion", [("greedy", None), ("beam", "word_lm"),
                                             ("beam", "lm+hotwords")])
def test_warmup_leaves_the_state_unchanged(models, lm_paths, decoder, fusion):
    _, _, pm = models
    _, pkw = _fusion_kw(fusion, lm_paths)
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=3,
                                    decoder=decoder, beam_width=3, **KW, **pkw)
    wav = _wavs(1, seed=17)[0]
    s = runner.open()
    got = s.feed(wav[:5000])
    before = [runner._enc_state.h.clone(), runner._enc_state.c.clone()]
    carry = None if runner._carry is None else _snapshot(runner)
    mirror = runner.slot_tokens(s.slot)
    runner.warmup()
    assert torch.equal(runner._enc_state.h, before[0])
    assert torch.equal(runner._enc_state.c, before[1])
    assert carry is None or _same(_snapshot(runner), carry)
    assert all(np.array_equal(a, b) for a, b in zip(runner.slot_tokens(s.slot), mirror))
    got += s.feed(wav[5000:])
    fin = s.flush()
    got = fin if decoder == "beam" else got + fin
    assert got
    if fusion != "word_lm":
        assert got == _independent(pm, wav, decoder, **pkw)


def test_refusals(models, lm_paths):
    """The JAX package's argument checks, the mesh's two among them: lanes
    that do not divide evenly across its devices, and host fusion with a
    mesh."""
    _, _, pm = models
    audio = pcfg.AudioConfig(**AUDIO)
    cpus = [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="divide evenly"):
        BatchedStreamingRunner(pm, audio, max_sessions=6, mesh=cpus)
    _, fused = _fusion_kw("lm+hotwords", lm_paths)
    with pytest.raises(ValueError, match="lane sharding is unsupported"):
        BatchedStreamingRunner(pm, audio, decoder="beam", mesh=cpus, **fused)
    with pytest.raises(ValueError, match="requires decoder='beam'"):
        BatchedStreamingRunner(pm, audio, **fused)
    _, dlm = _fusion_kw("device_lm", lm_paths)
    with pytest.raises(ValueError, match="mutually exclusive"):
        BatchedStreamingRunner(pm, audio, decoder="beam", **dlm, **fused)
    with pytest.raises(ValueError, match="requires decoder='beam'"):
        BatchedStreamingRunner(pm, audio, **dlm)
    with pytest.raises(ValueError, match="unknown decoder"):
        BatchedStreamingRunner(pm, audio, decoder="beam_batched")
    bidi = model_dict(rnn_type="lstm", layers=1, bidirectional=True, n_mels=80, vocab=7)
    with pytest.raises(ValueError, match="unidirectional"):
        BatchedStreamingRunner(port_model(bidi, jax_model(bidi)[1]), audio)
    runner = BatchedStreamingRunner(pm, audio, precision="bf16", **KW)
    assert next(runner.model.parameters()).dtype == torch.bfloat16
    assert next(pm.parameters()).dtype == torch.float32
    assert runner._enc_state.h.dtype == torch.bfloat16
