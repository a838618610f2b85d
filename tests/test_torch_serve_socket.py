"""The port's TCP streaming server (serve_socket.py) against the JAX
package's on the same weights and audio, on the CPU: per-connection
sessions (greedy, beam), batched sessions (greedy, beam) and LM + hotword
fusion give the JAX server's partials and finals; an abnormal client frees
its batched slot; drain() waits for sessions in flight and reports a
timeout; the CLI drains on SIGTERM and exits 0; the mesh options keep the
JAX runner's refusals."""

import dataclasses
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.serve import Recognizer as JaxRecognizer
from rnntransducer_tpu.serve_socket import StreamingServer as JaxServer
from rnntransducer_tpu.serve_socket import stream_wav as jax_stream_wav
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.serve_socket import StreamingServer, stream_wav
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

from _torch_parity import jax_model, model_dict, numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = model_dict(rnn_type="lstm", layers=2, bidirectional=False, n_mels=80,
               vocab=7, hidden=16)
VOCAB = {"<pad>": 0, "<unk>": 1, "a": 2, "t": 3, "i": 4, "o": 5, "|": 6}
ARPA = textwrap.dedent(r"""
\data\
ngram 1=6

\1-grams:
-1.0    <s>
-1.0    </s>
-0.8    at
-1.1    it
-1.3    to
-2.0    <unk>

\end\
""").strip()
CHUNK = 16


def _configs():
    audio = dict(normalize=False)
    return (jcfg.Config(model=jcfg.ModelConfig.from_dict(D),
                        data=jcfg.DataConfig(audio=jcfg.AudioConfig(**audio))),
            pcfg.Config(model=pcfg.ModelConfig.from_dict(D),
                        data=pcfg.DataConfig(audio=pcfg.AudioConfig(**audio))))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    _, variables = jax_model(D, seed=7)
    d = tmp_path_factory.mktemp("serve_socket")
    (d / "lm.arpa").write_text(ARPA)
    return variables, str(d / "lm.arpa"), d


def _recognizers(setup, decoder, fused=False):
    variables, lm_path, _ = setup
    jc, pc = _configs()
    kw = dict(decoder=decoder, beam_width=3, max_output_len=128)
    if fused:
        kw.update(lm_path=lm_path, lm_weight=0.5, hotwords=["at"], hotword_weight=2.0)
    return (JaxRecognizer(jc, variables["params"], JaxTokenizer(VOCAB), **kw),
            Recognizer(pc, numpy_params(variables), GraphemeTokenizer(VOCAB),
                       device="cpu", **kw))


def _wavs(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n_s) * 0.5).astype(np.float32)
            for n_s in rng.randint(6000, 11000, size=n)]


def _serve_all(server_cls, client, rec, wavs, concurrent=False, **kw):
    """Every wav through a server of ``rec``: [(partials, final), ...]."""
    with server_cls(rec, port=0, chunk_frames=CHUNK, **kw) as server:
        if not concurrent:
            return [client("127.0.0.1", server.port, w) for w in wavs]
        out = [None] * len(wavs)

        def run(i):
            out[i] = client("127.0.0.1", server.port, wavs[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        return out


@pytest.mark.parametrize("decoder, batch, fused", [
    ("greedy", 0, False), ("beam", 0, False), ("greedy", 3, False),
    ("beam", 3, False), ("beam", 0, True), ("beam", 2, True)])
def test_server_matches_the_jax_server(setup, decoder, batch, fused):
    """Partials and finals (tokens, text, greedy times) equal the JAX
    server's for the same wavs; batched connections run at once, then again
    one after another on the freed slots."""
    jrec, prec = _recognizers(setup, decoder, fused)
    wavs = _wavs(batch or 2, seed=3 + batch)
    kw = dict(batch_sessions=batch, normalize="none")
    want = _serve_all(JaxServer, jax_stream_wav, jrec, wavs, **kw)
    got = _serve_all(StreamingServer, stream_wav, prec, wavs, concurrent=batch > 0, **kw)
    assert got == want
    assert any(f["tokens"] for _, f in got)  # the comparison has tokens
    if batch:
        assert _serve_all(StreamingServer, stream_wav, prec, wavs, **kw) == want


def test_abnormal_disconnect_frees_the_batched_slot(setup):
    """A client that vanishes mid-stream, or sends an odd payload, must not
    keep its slot: with one slot, a clean connection is served after."""
    _, prec = _recognizers(setup, "greedy")
    wav = _wavs(1, seed=5)[0]
    with StreamingServer(prec, port=0, chunk_frames=CHUNK, batch_sessions=1,
                         normalize="none") as server:
        for k, attempt in enumerate(("disconnect", "odd_payload")):
            with socket.socket() as s:
                s.connect(("127.0.0.1", server.port))
                chunk = np.clip(wav[:1600] * 32768, -32768, 32767).astype("<i2").tobytes()
                if attempt == "odd_payload":
                    chunk = chunk[:-1]
                s.sendall(struct.pack("<i", len(chunk)) + chunk)
                reply = json.loads(s.makefile("rb").readline())
                assert ("partial" if attempt == "disconnect" else "error") in reply
            deadline = time.time() + 30
            while time.time() < deadline and server._conns_done < k + 1:
                time.sleep(0.02)
            assert server._conns_done == k + 1, attempt
            assert len(server._runner._free) == 1, attempt
        _, final = stream_wav("127.0.0.1", server.port, wav)
        assert final["tokens"]


def test_drain_waits_for_sessions_in_flight_and_reports_a_timeout(setup):
    _, prec = _recognizers(setup, "greedy")
    wav = _wavs(1, seed=8)[0]
    pcm16 = np.clip(wav * 32768.0, -32768, 32767).astype("<i2")
    server = StreamingServer(prec, port=0, chunk_frames=CHUNK, normalize="none").start()
    started = threading.Event()
    out = {}

    def slow_client():
        with socket.socket() as s:
            s.connect(("127.0.0.1", server.port))
            f = s.makefile("rb")
            for i in range(0, len(pcm16), 1600):
                chunk = pcm16[i:i + 1600].tobytes()
                s.sendall(struct.pack("<i", len(chunk)) + chunk)
                json.loads(f.readline())
                started.set()
                time.sleep(0.05)  # stay in flight across the drain call
            s.sendall(struct.pack("<i", 0))
            out["final"] = json.loads(f.readline())

    t = threading.Thread(target=slow_client)
    t.start()
    assert started.wait(60)
    assert server.drain(timeout=60) is True
    t.join(60)
    assert not t.is_alive() and isinstance(out["final"]["final"], str)
    with pytest.raises(OSError):  # the listener is gone
        with socket.socket() as s:
            s.settimeout(2)
            s.connect(("127.0.0.1", server.port))
            s.sendall(struct.pack("<i", 0))
            if not s.recv(1):
                raise ConnectionResetError("closed")

    server = StreamingServer(prec, port=0, chunk_frames=CHUNK, normalize="none",
                             warmup=False).start()
    release = threading.Event()

    def stalled_client():
        with socket.socket() as s:
            s.connect(("127.0.0.1", server.port))
            s.sendall(struct.pack("<i", 3200))  # promise a chunk, send none
            release.wait(30)

    t = threading.Thread(target=stalled_client)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline and server._conns_started < 1:
        time.sleep(0.02)
    assert server.drain(timeout=0.3) is False
    release.set()
    t.join(30)
    assert not t.is_alive()


def test_cli_drains_on_sigterm_and_exits_0(setup):
    """``python -m rnntransducer_tpu_torch.serve_socket --device cpu`` on a
    checkpoint of the port: SIGTERM mid-session drains (the client gets its
    final, the one an in-process Recognizer's server gives) and exits 0."""
    variables, _, tmp = setup
    _, pc = _configs()
    GraphemeTokenizer(VOCAB).save(str(tmp / "vocab.json"))
    pc = dataclasses.replace(pc, vocab_path=str(tmp / "vocab.json"))
    ckpt = str(tmp / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(1, TrainState.create(pc, "cpu", state_dict=state_dict_from_flax(
        numpy_params(variables), pc.model)), config=pc)
    mgr.close()
    wav = _wavs(1, seed=12)[0]
    rec = Recognizer.from_checkpoint(ckpt, decoder="greedy", device="cpu")
    with StreamingServer(rec, port=0, batch_sessions=2) as server:
        want = stream_wav("127.0.0.1", server.port, wav)[1]
    p = subprocess.Popen(
        [sys.executable, "-m", "rnntransducer_tpu_torch.serve_socket",
         "--checkpoint_dir", ckpt, "--port", "0", "--device", "cpu",
         "--batch_sessions", "2", "--average_k", "1", "--drain_timeout", "60"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()  # after warmup + bind
        assert "streaming on" in line, line + p.stderr.read()
        port = int(line.split(":")[1].split()[0])
        pcm16 = np.clip(wav * 32768.0, -32768, 32767).astype("<i2")
        started = threading.Event()
        out = {}

        def slow_client():
            with socket.socket() as s:
                s.connect(("127.0.0.1", port))
                f = s.makefile("rb")
                for i in range(0, len(pcm16), 1600):
                    chunk = pcm16[i:i + 1600].tobytes()
                    s.sendall(struct.pack("<i", len(chunk)) + chunk)
                    json.loads(f.readline())
                    started.set()
                    time.sleep(0.05)
                s.sendall(struct.pack("<i", 0))
                out["final"] = json.loads(f.readline())

        t = threading.Thread(target=slow_client)
        t.start()
        assert started.wait(60)
        p.send_signal(signal.SIGTERM)  # mid-session
        t.join(60)
        assert not t.is_alive()
        assert out["final"] == want
        stdout, stderr = p.communicate(timeout=60)
        assert p.returncode == 0, stderr[-2000:]
        assert "drained: all sessions finished" in stdout, stdout
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_mesh_options_raise(setup):
    """The mesh reaches the batched runner, which keeps the JAX runner's
    refusals; without batched sessions it is ignored, as in the JAX server
    (the sharded server is ``test_torch_lane_sharding.py``'s)."""
    _, prec = _recognizers(setup, "greedy")
    cpus = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="divide evenly"):
        StreamingServer(prec, batch_sessions=3, mesh=cpus, warmup=False)
    _, fused = _recognizers(setup, "beam", fused=True)
    with pytest.raises(ValueError, match="lane sharding is unsupported"):
        StreamingServer(fused, batch_sessions=2, mesh=cpus, warmup=False)
    assert StreamingServer(prec, mesh=cpus, warmup=False)._runner is None
    bidi_cfg = pcfg.Config(model=pcfg.ModelConfig.from_dict(
        model_dict(rnn_type="lstm", layers=1, bidirectional=True, n_mels=80, vocab=7)))
    _, v = jax_model(model_dict(rnn_type="lstm", layers=1, bidirectional=True,
                                n_mels=80, vocab=7))
    bidi = Recognizer(bidi_cfg, numpy_params(v), GraphemeTokenizer(VOCAB),
                      decoder="greedy", device="cpu")
    with StreamingServer(bidi, port=0, warmup=False) as server:
        with pytest.raises(RuntimeError, match="unidirectional"):
            stream_wav("127.0.0.1", server.port, _wavs(1, seed=1)[0])
