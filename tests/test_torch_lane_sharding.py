"""Lane sharding of continuous batching in the port: ``BatchedStreamingRunner(
mesh=lane_devices([...]))`` splits its lanes into one group per device, each
with its own model copy and state.  On the CPU the devices are CPU entries
(2 and 4 groups).  Against the port's unsharded runner and the JAX
package's runner on the same weights and waves (as
``tests/test_session_batch.py::test_mesh_sharded_lanes_match_unsharded``):
tokens, greedy timestamps and beam partials exactly, beam scores within
1e-5 relative, for
greedy lanes, beam lanes, and beam lanes with the device char LM or word LM.
Every group's all-idle tick and ``warmup()`` leave its state bit-identical;
``StreamingServer(mesh=...)`` serves two clients and ``serve_socket
--shard_sessions --device cpu`` starts, serves and drains."""

import dataclasses
import signal
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode.device_lm import DeviceCharLM as JaxCharLM
from rnntransducer_tpu.decode.device_word_lm import build_device_word_lm as jax_word_lm
from rnntransducer_tpu.decode.ngram_lm import NGramLM as JaxNGramLM
from rnntransducer_tpu.decode.session_batch import BatchedStreamingRunner as JaxRunner
from rnntransducer_tpu.serve import Recognizer as JaxRecognizer
from rnntransducer_tpu.serve_socket import StreamingServer as JaxServer
from rnntransducer_tpu.serve_socket import stream_wav as jax_stream_wav
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.decode import BatchedStreamingRunner
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
from rnntransducer_tpu_torch.decode.device_word_lm import build_device_word_lm
from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.parallel import lane_devices
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.serve_socket import StreamingServer, stream_wav
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

from _torch_parity import jax_model, model_dict, numpy_params, port_model

REPO = __file__.rsplit("/tests/", 1)[0]
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
KW = dict(chunk_frames=16, max_symbols=2, max_output_len=128, beam_width=3)
LANES = 4
PIECE = 1600
SCORE_RTOL = 1e-5
CASES = [("greedy", None), ("beam", None), ("beam", "device_lm"), ("beam", "word_lm")]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("lane_sharding")
    (d / "word.arpa").write_text(WORD_ARPA)
    (d / "char.arpa").write_text(CHAR_ARPA)
    jm, variables = jax_model(D, seed=7)
    return {"jax": jm, "variables": variables, "port": port_model(D, variables),
            "dir": d, "refs": {}}


def _fusion_kw(fusion, d):
    """(JAX kwargs, port kwargs) of a fusion mode."""
    if fusion == "device_lm":
        path = str(d / "char.arpa")
        return ({"device_lm": JaxCharLM.load(path, JaxTokenizer(VOCAB), weight=1.0)},
                {"device_lm": DeviceCharLM.load(path, GraphemeTokenizer(VOCAB), weight=1.0)})
    if fusion == "word_lm":
        path = str(d / "word.arpa")
        return ({"word_lm": jax_word_lm(JaxNGramLM.load(path, weight=2.0, beta=0.5),
                                        JaxTokenizer(VOCAB), WORDS)},
                {"word_lm": build_device_word_lm(NGramLM.load(path, weight=2.0, beta=0.5),
                                                 GraphemeTokenizer(VOCAB), WORDS)})
    return {}, {}


def _wavs(seed):
    """One wave per lane: 4-8 tones of random pitch and loudness (silence
    among them), so that every lane decodes tokens of its own (white noise
    gives every lane the same few)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(LANES):
        segs = []
        for _ in range(rng.randint(4, 9)):
            n = rng.randint(800, 3200)
            tone = np.sin(2 * np.pi * rng.uniform(80, 7000) * np.arange(n) / 16000)
            segs.append(rng.choice([0.0, 0.01, 0.3, 1.0]) * tone + 1e-3 * rng.randn(n))
        out.append(np.concatenate(segs).astype(np.float32))
    return out


def _lockstep(runner, wavs):
    """Lane i starts at round i (idle lanes ride along until then); each
    round every started lane buffers its next piece and one drain serves
    them all.  Returns (tokens per lane, per lane its greedy timestamps or
    its beam partials after every round)."""
    beam = runner.decoder == "beam"
    sessions = [runner.open(normalize="none") for _ in wavs]
    got = [[] for _ in wavs]
    extra = [[] for _ in wavs]
    rounds = max(-(-len(w) // PIECE) + i for i, w in enumerate(wavs))
    for r in range(rounds):
        for i, s in enumerate(sessions):
            c = (r - i) * PIECE
            if 0 <= c < len(wavs[i]):
                s.feed(wavs[i][c:c + PIECE], drain=False)
        runner.drain()
        for i, s in enumerate(sessions):
            if beam:
                extra[i].append([int(t) for t in s.tokens])
            else:
                got[i] += s._new_tokens()
    for i, s in enumerate(sessions):
        fin = s.flush()
        got[i] = list(fin) if beam else got[i] + list(fin)
        if not beam:
            extra[i] = s.timestamps
    return [[int(t) for t in g] for g in got], extra


def _scores(runner):
    """The beam scores of every lane, in slot order."""
    return torch.cat([g.carry.scores for g in runner._groups]).numpy()


def _references(setup, decoder, fusion):
    """(JAX runner, port unsharded runner) outputs and beam scores on the
    case's waves, computed once per case."""
    key = (decoder, fusion)
    if key not in setup["refs"]:
        jkw, pkw = _fusion_kw(fusion, setup["dir"])
        wavs = _wavs(seed=3 + len(str(fusion)))
        common = dict(max_sessions=LANES, decoder=decoder, **KW)
        jr = JaxRunner(setup["jax"], setup["variables"], jcfg.AudioConfig(**AUDIO),
                       **common, **jkw)
        pr = BatchedStreamingRunner(setup["port"], pcfg.AudioConfig(**AUDIO), **common,
                                    **pkw)
        setup["refs"][key] = (wavs, _lockstep(jr, wavs), _lockstep(pr, wavs),
                              None if decoder == "greedy" else _scores(pr))
    return setup["refs"][key]


@pytest.mark.parametrize("decoder, fusion", CASES)
@pytest.mark.parametrize("groups", [2, 4])
def test_sharded_lanes_match_the_unsharded_and_jax_runners(setup, groups, decoder, fusion):
    wavs, want_jax, want, want_scores = _references(setup, decoder, fusion)
    _, pkw = _fusion_kw(fusion, setup["dir"])
    runner = BatchedStreamingRunner(setup["port"], pcfg.AudioConfig(**AUDIO),
                                    max_sessions=LANES, decoder=decoder,
                                    mesh=lane_devices(["cpu"] * groups), **KW, **pkw)
    runner.warmup()
    assert [(g.lo, g.hi) for g in runner._groups] == [
        (i * LANES // groups, (i + 1) * LANES // groups) for i in range(groups)]
    models = [g.model for g in runner._groups]
    assert len({id(m) for m in models + [setup["port"]]}) == groups + 1  # copies
    got = _lockstep(runner, wavs)
    assert got == want == want_jax
    # every lane has tokens, and the lanes' outputs differ: a lane read from
    # another lane's row would show
    assert all(got[0]) and len({repr(lane) for lane in zip(*got)}) == LANES
    if decoder == "beam":
        np.testing.assert_allclose(_scores(runner), want_scores, rtol=SCORE_RTOL, atol=0.0)


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_idle_ticks_and_warmup_leave_every_group_unchanged(setup, decoder):
    """Mid-stream, an all-idle tick in every group and then ``warmup()``
    leave every group's encoder state and carry, and the host mirror, as
    they were; the lanes then finish as the unsharded runner's."""
    wavs, _, want, _ = _references(setup, decoder, None)
    runner = BatchedStreamingRunner(setup["port"], pcfg.AudioConfig(**AUDIO),
                                    max_sessions=LANES, decoder=decoder,
                                    mesh=["cpu", "cpu"], **KW)
    sessions = [runner.open() for _ in range(2)]
    for s, w in zip(sessions, wavs):
        s.feed(w[:4000])
    assert {runner._group(s.slot).lo for s in sessions} == {LANES // 2}  # one group

    def snapshot():
        out = []
        for g in runner._groups:
            out += [g.enc_state.h, g.enc_state.c]
            for leaf in g.carry:
                out += list(leaf) if isinstance(leaf, tuple) else [leaf]
        return [x.clone() for x in out if x is not None]

    before = snapshot()
    mirror = [runner.slot_tokens(s.slot) for s in sessions]
    assert before[2].abs().sum() > 0  # the live group really holds a state
    for g in runner._groups:
        g.enc_state, g.carry = runner._step(*runner._idle_inputs(g), g)
    runner.warmup()
    after = snapshot()
    assert len(after) == len(before) and all(torch.equal(a, b) for a, b in zip(after, before))
    for (t0, n0), (t1, n1) in zip(mirror, [runner.slot_tokens(s.slot) for s in sessions]):
        assert n0 == n1 and np.array_equal(t0, t1)
    for s in sessions:
        s.abort()


def test_groups_hold_their_own_cast_copies_and_tables(setup):
    """After the ``precision`` cast each group holds a model copy of its
    own (the caller's model untouched), and its own reference to the LM
    tables; a slot's session lands in the group of ``slot // lanes``."""
    _, pkw = _fusion_kw("device_lm", setup["dir"])
    pm = setup["port"]
    runner = BatchedStreamingRunner(pm, pcfg.AudioConfig(**AUDIO), max_sessions=LANES,
                                    decoder="beam", precision="bf16", mesh=["cpu"] * 2,
                                    **KW, **pkw)
    assert next(pm.parameters()).dtype == torch.float32
    ptrs = set()
    for g in runner._groups:
        w = next(g.model.parameters())
        assert w.dtype == torch.bfloat16 and g.enc_state.h.dtype == torch.bfloat16
        ptrs.add(w.data_ptr())
        assert torch.equal(g.lm_table, pkw["device_lm"].table)
    assert len(ptrs) == 2 and next(pm.parameters()).data_ptr() not in ptrs
    for _ in range(LANES):
        s = runner.open()
        g = runner._group(s.slot)
        assert g.lo <= s.slot < g.hi and g is runner._groups[s.slot // (LANES // 2)]


def test_lane_devices():
    assert lane_devices(["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="no device"):
        lane_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass the devices"):
            lane_devices()
    else:
        assert lane_devices() == [torch.device("cuda", i)
                                  for i in range(torch.cuda.device_count())]


def _configs():
    return (jcfg.Config(model=jcfg.ModelConfig.from_dict(D),
                        data=jcfg.DataConfig(audio=jcfg.AudioConfig(**AUDIO))),
            pcfg.Config(model=pcfg.ModelConfig.from_dict(D),
                        data=pcfg.DataConfig(audio=pcfg.AudioConfig(**AUDIO))))


def _serve(server, client, wavs):
    out = [None] * len(wavs)

    def run(i):
        out[i] = client("127.0.0.1", server.port, wavs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(wavs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def test_sharded_server_serves_two_clients(setup):
    """``StreamingServer(batch_sessions=2, mesh=[cpu, cpu])``: one lane per
    group; two concurrent clients get the JAX server's partials and
    finals."""
    jc, pc = _configs()
    kw = dict(decoder="greedy", max_output_len=128)
    jrec = JaxRecognizer(jc, setup["variables"]["params"], JaxTokenizer(VOCAB), **kw)
    prec = Recognizer(pc, numpy_params(setup["variables"]), GraphemeTokenizer(VOCAB),
                      device="cpu", **kw)
    wavs = _wavs(seed=11)[:2]
    skw = dict(port=0, chunk_frames=16, batch_sessions=2, normalize="none")
    with JaxServer(jrec, **skw) as server:
        want = _serve(server, jax_stream_wav, wavs)
    with StreamingServer(prec, mesh=lane_devices(["cpu", "cpu"]), **skw) as server:
        assert len(server._runner._groups) == 2
        got = _serve(server, stream_wav, wavs)
    assert got == want and all(f["tokens"] for _, f in got)


def test_cli_shard_sessions_starts_serves_and_drains(setup, tmp_path):
    """``python -m rnntransducer_tpu_torch.serve_socket --batch_sessions 2
    --shard_sessions --device cpu``: one CPU lane group; a client's final
    equals an in-process server's; SIGTERM drains and exits 0."""
    _, pc = _configs()
    GraphemeTokenizer(VOCAB).save(str(tmp_path / "vocab.json"))
    pc = dataclasses.replace(pc, vocab_path=str(tmp_path / "vocab.json"))
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(1, TrainState.create(pc, "cpu", state_dict=state_dict_from_flax(
        numpy_params(setup["variables"]), pc.model)), config=pc)
    mgr.close()
    wav = _wavs(seed=12)[0]
    rec = Recognizer.from_checkpoint(ckpt, decoder="greedy", device="cpu")
    with StreamingServer(rec, port=0, batch_sessions=2) as server:
        want = stream_wav("127.0.0.1", server.port, wav)
    p = subprocess.Popen(
        [sys.executable, "-m", "rnntransducer_tpu_torch.serve_socket",
         "--checkpoint_dir", ckpt, "--port", "0", "--device", "cpu",
         "--batch_sessions", "2", "--shard_sessions"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()  # after warmup + bind
        assert "streaming on" in line and "1 lane groups" in line, line + p.stderr.read()
        assert stream_wav("127.0.0.1", int(line.split(":")[1].split()[0]), wav) == want
        p.send_signal(signal.SIGTERM)
        stdout, stderr = p.communicate(timeout=60)
        assert p.returncode == 0, stderr[-2000:]
        assert "drained: all sessions finished" in stdout, stdout
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
