"""The streaming (chunked-causal) Conformer in the port against the JAX
package on the same weights, at the sizes of ``tests/test_conformer.py``
(``_scfg``: 2 blocks, d=64, 4 heads, kernel 7): the carried block cache
chunk by chunk (outputs, h and c) and against the offline masked forward,
``StreamingRecognizer`` against offline greedy, and the batched runner
against the JAX runner (lockstep traffic) and against independent JAX
sessions (staggered traffic, lanes idle mid-stream).  An idle lane keeps
its cache in the port's runner, where the JAX runner's slides it; slots
recycle; the chunk-size checks raise.  Encoder bound 2e-5 / 1e-4
(``test_conformer.py:253-254``), tokens exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode.greedy import greedy_decode as jax_greedy
from rnntransducer_tpu.decode.session_batch import (
    BatchedStreamingRunner as JaxRunner)
from rnntransducer_tpu.decode.session_batch import (
    _batched_chunk_step as jax_chunk_step)
from rnntransducer_tpu.decode.streaming import StreamingRecognizer as JaxStreaming
from rnntransducer_tpu.decode.streaming import (
    _zero_encoder_state as jax_zero_state)
from rnntransducer_tpu.frontend import LogMelFrontend as JaxFrontend

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.decode import BatchedStreamingRunner, StreamingRecognizer
from rnntransducer_tpu_torch.decode.greedy import greedy_decode
from rnntransducer_tpu_torch.decode.streaming import _zero_encoder_state
from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
from rnntransducer_tpu_torch.models.cells import RNNState

from _torch_parity import close, conformer_dict, jax_apply, jax_model, port_model, t

ENC_ATOL, ENC_RTOL = 2e-5, 1e-4
AUDIO = dict(normalize=False)
PIECE = 1600
# chunk 8 at stride 2: one 16-frame feed chunk is one attention chunk
D = conformer_dict(chunk=8, left=2, stride=2)
CHUNK = 16
KW = dict(chunk_frames=CHUNK, max_output_len=128)


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model(D, seed=0)  # weights whose greedy decode emits
    return jm, variables, port_model(D, variables)


@pytest.mark.parametrize("chunk,left,stride,kernel", [
    (4, 2, 2, 7), (4, 0, 1, 7), (8, 1, 2, 1)])
def test_streaming_encode_matches_jax_chunk_by_chunk(chunk, left, stride, kernel):
    """Chunk by chunk from the zero cache, a ragged batch (one row runs out
    and is fed length-0 chunks): each chunk's output and the carried h and
    c equal the JAX ``_stream``'s; the chunks together equal the port's
    offline masked forward.  left=0 gives an empty window, kernel 1 an
    empty conv tail."""
    d = conformer_dict(chunk=chunk, left=left, stride=stride, kernel=kernel)
    jm, variables = jax_model(d)
    pm = port_model(d, variables)
    cf = chunk * stride
    T = -(-40 // cf) * cf  # whole chunks; the rows are 40 and 23 frames long
    feats = np.random.RandomState(3).randn(2, T, 80).astype(np.float32)
    lengths = np.array([40, 23])
    jstate = jax_zero_state(jm, variables, batch=2)
    state = _zero_encoder_state(pm, batch=2)
    assert state.h.data_ptr() != state.c.data_ptr()
    assert tuple(state.h.shape) == jstate.h.shape
    assert tuple(state.c.shape) == jstate.c.shape
    outs = []
    with torch.no_grad():
        for c0 in range(0, T, cf):
            n_valid = np.clip(lengths - c0, 0, cf)
            want, jstate = jax_apply(jm, variables, jnp.asarray(feats[:, c0:c0 + cf]),
                                     jnp.asarray(n_valid), jstate, method="encode")
            got, state = pm.encode(t(feats[:, c0:c0 + cf]), t(n_valid), state)
            close(got, want, atol=ENC_ATOL, rtol=ENC_RTOL, err_msg=f"chunk at {c0}")
            close(state.h, jstate.h, atol=ENC_ATOL, rtol=ENC_RTOL)
            close(state.c, jstate.c, atol=ENC_ATOL, rtol=ENC_RTOL)
            outs.append(got)
        offline, _ = pm.encode(t(feats), t(lengths))
    close(torch.cat(outs, dim=1), offline.numpy(), atol=ENC_ATOL, rtol=ENC_RTOL)


def test_streaming_recognizer_matches_offline_greedy(models):
    """A wav-in ``StreamingRecognizer`` session equals offline greedy on
    the same model token for token, and the JAX offline greedy
    (``test_conformer.py:298``)."""
    jm, variables, pm = models
    wav = (np.random.RandomState(9).randn(12000) * 2).astype(np.float32)
    jfeats, jlens = JaxFrontend(jcfg.AudioConfig(**AUDIO))(jnp.asarray(wav[None]))
    toks, lens = jax_greedy(jm, variables, jfeats, jlens, max_output_len=128)
    want = [int(x) for x in np.asarray(toks)[0, :int(lens[0])]]
    feats, flens = LogMelFrontend(pcfg.AudioConfig(**AUDIO))(t(wav[None]))
    ptoks, plens = greedy_decode(pm, feats, flens, max_output_len=128)
    assert ptoks[0, :int(plens[0])].tolist() == want and want
    rec = StreamingRecognizer(pm, pcfg.AudioConfig(**AUDIO), normalize="none", **KW)
    out = []
    for s in range(0, len(wav), PIECE):
        out += rec.feed(wav[s:s + PIECE])
    out += rec.flush()
    assert out == want


def _wavs(lengths, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 2).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_runner_matches_the_jax_runner_in_lockstep(models, decoder):
    """Lanes fed in lockstep (every lane fills its chunk in the same tick,
    none idles): the partials after every round equal the JAX runner's; the
    first lane's final too (the JAX runner's other lanes idle during its
    final tick); every lane's final equals an independent port session."""
    jm, variables, pm = models
    wavs = _wavs([12800] * 3, seed=2)
    common = dict(max_sessions=3, decoder=decoder, beam_width=3, **KW)
    runners = (JaxRunner(jm, variables, jcfg.AudioConfig(**AUDIO), **common),
               BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), **common))
    partials, finals = [], []
    for runner in runners:
        sessions = [runner.open() for _ in wavs]
        seen = []
        for s0 in range(0, len(wavs[0]), PIECE):
            for sess, w in zip(sessions, wavs):
                sess.feed(w[s0:s0 + PIECE], drain=False)
            runner.drain()
            seen.append([list(sess.tokens) for sess in sessions])
        partials.append(seen)
        finals.append([sess.flush() for sess in sessions])
    assert partials[1] == partials[0] and any(partials[0][-1])
    assert finals[1][0] == finals[0][0]
    for i, (w, got) in enumerate(zip(wavs, finals[1])):
        rec = StreamingRecognizer(pm, pcfg.AudioConfig(**AUDIO), normalize="none",
                                  decoder=decoder, beam_width=3, **KW)
        fed = []
        for s0 in range(0, len(w), PIECE):
            fed += rec.feed(w[s0:s0 + PIECE])
        fed += rec.flush()
        # fed without drain, a lane's flush() returns all its tokens
        assert got == (fed if decoder == "greedy" else rec.tokens)


def test_staggered_lanes_equal_independent_jax_sessions(models):
    """Sessions started one round apart and fed 100 ms pieces: a tick takes
    the lanes whose 16-frame chunk is full, so open lanes idle mid-stream
    (checked).  Every lane's tokens equal an independent JAX
    ``StreamingRecognizer`` fed the same audio."""
    jm, variables, pm = models
    wavs = _wavs([9000, 12000, 7000], seed=5)
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=3,
                                    **KW)
    ticks = []
    step = runner._step

    def recording_step(feats, n_valid, group=None):
        ticks.append((n_valid.tolist(), sorted(runner._live)))
        return step(feats, n_valid, group)

    runner._step = recording_step
    sessions, got, pos, rounds = [], [[] for _ in wavs], [0] * len(wavs), 0
    while any(p < len(w) for p, w in zip(pos, wavs)):
        if rounds < len(wavs):
            sessions.append(runner.open())
        for i, s in enumerate(sessions):
            if pos[i] < len(wavs[i]):
                got[i] += s.feed(wavs[i][pos[i]:pos[i] + PIECE])
                pos[i] += PIECE
        rounds += 1
    for i, s in enumerate(sessions):
        got[i] += s.flush()
    # a lane idled in a tick and ticked again after it
    idled = [any(nv[slot] == 0 and slot in live and any(
        later[slot] > 0 for later, _ in ticks[k + 1:])
        for k, (nv, live) in enumerate(ticks)) for slot in range(3)]
    assert any(idled)
    for w, g in zip(wavs, got):
        rec = JaxStreaming(jm, variables, jcfg.AudioConfig(**AUDIO), normalize="none",
                           **KW)
        want = []
        for s0 in range(0, len(w), PIECE):
            want += rec.feed(w[s0:s0 + PIECE])
        want += rec.flush()
        assert [int(x) for x in g] == [int(x) for x in want] and want


def test_an_idle_tick_keeps_the_cache_where_the_jax_runner_slides_it(models):
    """After two real chunks in lane 0, one all-idle tick: the port's
    runner leaves h and c bit-identical; the JAX runner's cache changes
    (its encoder slides every lane's window by a chunk and rebuilds the
    conv tail from the empty chunk, ``conformer.py:312-314,263-264``),
    breaking the no-op promise of its ``session_batch.py:14-19``."""
    jm, variables, pm = models
    wav = _wavs([2 * CHUNK * 160], seed=8)[0]
    jr = JaxRunner(jm, variables, jcfg.AudioConfig(**AUDIO), max_sessions=2, **KW)
    pr = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=2, **KW)
    for runner in (jr, pr):
        runner.open().feed(wav)
    before = pr._enc_state.h.clone(), pr._enc_state.c.clone()
    assert before[0].abs().sum() > 0  # lane 0 holds a cache
    pr._enc_state, pr._carry = pr._step(*pr._idle_inputs())
    assert torch.equal(pr._enc_state.h, before[0])
    assert torch.equal(pr._enc_state.c, before[1])
    feats = jnp.zeros((2, CHUNK, 80), jnp.float32)
    new, _ = jax_chunk_step(jm, variables, feats, jnp.zeros((2,), jnp.int32),
                            jr._enc_state, jr._carry, 0, 3)
    assert float(jnp.abs(new.h - jr._enc_state.h).max()) > 0.1
    assert float(jnp.abs(new.c - jr._enc_state.c).max()) > 0.1


def test_a_reused_slot_starts_from_a_clean_cache(models):
    """A freed slot serves a second session of the same audio with the same
    tokens (the reset zeroes h and c, each from its own slice), and the JAX
    runner's slot reuse gives them too."""
    jm, variables, pm = models
    wav = (np.random.RandomState(11).randn(6400) * 2).astype(np.float32)
    out = []
    for runner in (JaxRunner(jm, variables, jcfg.AudioConfig(**AUDIO), max_sessions=2,
                             **KW),
                   BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=2,
                                          **KW)):
        got = []
        for _ in range(2):
            s = runner.open(normalize="none")
            s.feed(wav)
            got.append([int(x) for x in s.flush()])
        assert got[0] == got[1] and got[0]
        out.append(got)
    assert out[1] == out[0]


def test_chunk_size_and_context_checks_raise(models):
    _, _, pm = models
    audio = pcfg.AudioConfig(**AUDIO)
    for bad in (8, 32):
        with pytest.raises(ValueError, match="attention_chunk"):
            StreamingRecognizer(pm, audio, chunk_frames=bad)
        with pytest.raises(ValueError, match="attention_chunk"):
            BatchedStreamingRunner(pm, audio, chunk_frames=bad)
    state = _zero_encoder_state(pm, batch=1)
    with torch.no_grad(), pytest.raises(ValueError, match="exactly one attention chunk"):
        pm.encode(torch.zeros(1, 2 * CHUNK, 80), torch.tensor([2 * CHUNK]), state)
    full = port_model(conformer_dict(stride=2), jax_model(conformer_dict(stride=2))[1])
    with pytest.raises(ValueError, match="unidirectional"):
        StreamingRecognizer(full, audio, chunk_frames=CHUNK)
    with torch.no_grad(), pytest.raises(ValueError, match="full-context"):
        full.encode(torch.zeros(1, 8, 80), torch.tensor([8]),
                    RNNState(torch.zeros(0, 1, 1, 0), None))
