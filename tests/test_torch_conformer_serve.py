"""A Conformer through the port's serving, evaluation and training entry
points on the CPU, against the JAX package on the same weights and inputs
(the sizes of ``tests/test_conformer.py``): the offline Recognizer (greedy
and the default device beam), ``evaluate_corpus``, the Trainer, the
inference / evaluation / train CLIs on a Conformer checkpoint, and the TCP
server with batched lanes of the streaming Conformer.  Transcripts and
CER / WER exactly; the Trainer's losses within 1e-5 relative."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.eval import evaluate_corpus as jax_evaluate
from rnntransducer_tpu.serve import Recognizer as JaxRecognizer
from rnntransducer_tpu.serve_socket import StreamingServer as JaxServer
from rnntransducer_tpu.serve_socket import stream_wav as jax_stream_wav
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.cli import evaluate as evaluate_cli
from rnntransducer_tpu_torch.cli import infer as infer_cli
from rnntransducer_tpu_torch.cli import train as train_cli
from rnntransducer_tpu_torch.eval import evaluate_corpus, load_manifest_items
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.serve_socket import StreamingServer, stream_wav
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils import weights
from rnntransducer_tpu_torch.utils.audio_io import read_wav, write_wav

from _torch_parity import conformer_dict, jax_model, numpy_params, port_model

TOL = 1e-5
# the streaming Conformer of the checkpoint, the server and the CLIs: one
# chunk of 64 feature frames (the inference CLI's, as inference.py's) is one
# 16-frame attention chunk at stride 4
STREAM = conformer_dict(stride=4, chunk=16, left=1)
CHUNK_FRAMES = 64
def _waves():
    rng = np.random.RandomState(6)
    return [(rng.randn(n) * 0.3).astype(np.float32) for n in (4000, 2500, 1601)]


@pytest.mark.parametrize("decoder,chunk", [("greedy", 0), ("beam_batched", 0),
                                           ("greedy", 4)])
def test_recognizer_matches_jax(decoder, chunk):
    """The offline Recognizer on a Conformer: the same transcripts as the
    JAX Recognizer (greedy and the default device beam)."""
    d = conformer_dict(stride=2, chunk=chunk)
    _, variables = jax_model(d, seed=4)
    kw = dict(decoder=decoder, beam_width=3)
    jrec = JaxRecognizer(jcfg.Config(model=jcfg.ModelConfig.from_dict(d)),
                         variables["params"], JaxTokenizer.default(72), **kw)
    prec = Recognizer(pcfg.Config(model=pcfg.ModelConfig.from_dict(d)),
                      numpy_params(variables), GraphemeTokenizer.default(72),
                      device="cpu", **kw)
    waves = _waves()
    want = jrec.transcribe_batch(waves)
    assert any(want)  # the comparison has text
    assert prec.transcribe_batch(waves) == want


def test_evaluate_corpus_matches_jax():
    """``evaluate_corpus`` on a Conformer (length-sorted, bucket-padded
    batches): hyps, per-utterance and corpus CER / WER equal."""
    d = conformer_dict(stride=2)
    jm, variables = jax_model(d, seed=2)
    pm = port_model(d, variables)
    rng = np.random.RandomState(3)
    items = [{"feats": (rng.randn(int(rng.randint(8, 40)), 80)).astype(np.float32),
              "labels": rng.randint(5, 40, size=(int(rng.randint(1, 5)),)).astype(np.int32)}
             for _ in range(5)]
    kw = dict(decoder="greedy", batch_size=2, frame_bucket=16)
    want = jax_evaluate(jm, variables, JaxTokenizer.default(72), jcfg.AudioConfig(),
                        items, **kw)
    got = evaluate_corpus(pm, GraphemeTokenizer.default(72), pcfg.AudioConfig(),
                          items, **kw)
    assert any(r["hyp"] for r in want.per_utt)
    assert got.per_utt == want.per_utt
    assert (got.cer, got.wer, got.n_utts) == (want.cer, want.wer, want.n_utts)


def test_trainer_matches_the_jax_trainer(tmp_path):
    """Three fp32 Trainer steps on a Conformer from the same weights on the
    same synthetic data: the logged train losses and the validation loss
    within 1e-5 relative, validation WER and CER equal."""
    from rnntransducer_tpu.data import SyntheticAudioDataset as JaxSynthetic
    from rnntransducer_tpu.parallel import make_mesh
    from rnntransducer_tpu.train import Trainer as JaxTrainer
    from test_torch_trainer import _logs, _tiny_narrow

    from rnntransducer_tpu_torch.data import SyntheticAudioDataset
    from rnntransducer_tpu_torch.train import Trainer

    def config(module, name):
        cfg = _tiny_narrow(module, tmp_path, name)
        tn = module.TransNetConfig(**{**conformer_dict(stride=4, layers=1, d=32)[
            "transnet"]})
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                  transnet=tn))

    jax_cfg, cfg = config(jcfg, "jax"), config(pcfg, "port")
    kw = dict(min_sec=0.3, max_sec=1.2, min_labels=3, max_labels=10)
    jtr = JaxTrainer(jax_cfg, JaxSynthetic(16, jax_cfg.data.audio, seed=1, **kw),
                     val_dataset=JaxSynthetic(5, jax_cfg.data.audio, seed=2, **kw),
                     mesh=make_mesh(devices=jax.devices()[:1]))
    flax = weights.random_flax_params(cfg.model, torch.Generator().manual_seed(7))
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, flax))
    ptr = Trainer(cfg, SyntheticAudioDataset(16, cfg.data.audio, seed=1, **kw),
                  val_dataset=SyntheticAudioDataset(5, cfg.data.audio, seed=2, **kw),
                  device="cpu", state_dict=weights.state_dict_from_flax(flax, cfg.model))
    jtr.fit()
    jtr.ckpt.close()
    ptr.fit()
    want = [r for r in _logs(jax_cfg) if r.get("split") in ("train", "val")]
    got = [r for r in _logs(cfg) if r.get("split") in ("train", "val")]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for g, w in zip(got[:3], want[:3]):
        assert abs(g["loss"] - w["loss"]) <= TOL * abs(w["loss"])
    assert abs(got[3]["val_loss"] - want[3]["val_loss"]) <= TOL * abs(want[3]["val_loss"])
    assert (got[3]["val_wer"], got[3]["val_cer"]) == (want[3]["val_wer"], want[3]["val_cer"])


@pytest.fixture(scope="module")
def stream_ckpt(tmp_path_factory):
    """A checkpoint of the streaming Conformer written by CheckpointManager
    (its config names the one-chunk feed), and two WAV files."""
    tmp = tmp_path_factory.mktemp("conformer_ckpt")
    cfg = pcfg.Config(
        model=pcfg.ModelConfig.from_dict(STREAM),
        data=pcfg.DataConfig(audio=pcfg.AudioConfig(normalize=False)),
        train=pcfg.TrainConfig(precision="fp32", checkpoint_dir=str(tmp / "ckpt")),
        inference=pcfg.InferenceConfig(beam_width=3,
                                       streaming_chunk_frames=CHUNK_FRAMES))
    _, variables = jax_model(STREAM, seed=3)
    sd = weights.state_dict_from_flax(numpy_params(variables), cfg.model)
    mgr = CheckpointManager(cfg.train.checkpoint_dir)
    mgr.save(1, TrainState.create(cfg, "cpu", state_dict=sd), config=cfg)
    mgr.close()
    rng = np.random.RandomState(0)
    wavs = []
    for i, n in enumerate((16000, 12800)):
        path = str(tmp / f"u{i}.wav")
        write_wav(path, rng.randn(n) * 0.3)
        wavs.append(path)
    return {"dir": cfg.train.checkpoint_dir, "wavs": wavs, "tmp": tmp,
            "variables": variables}


def _texts(lines):
    return [line.split("\t")[1] for line in lines if line.count("\t") == 1]


def test_infer_and_evaluate_clis_on_a_conformer_checkpoint(stream_ckpt, capsys):
    """``cli.infer`` offline (greedy, the device beam) and ``--stream``
    print what ``Recognizer.from_checkpoint`` gives; ``cli.evaluate``'s
    hyps equal ``evaluate_corpus`` on the checkpoint's model."""
    ck = stream_ckpt
    run = lambda *f: infer_cli.main(  # noqa: E731
        ["--checkpoint_dir", ck["dir"], "--wav", *ck["wavs"], "--device", "cpu", *f])
    rec = lambda **kw: Recognizer.from_checkpoint(  # noqa: E731
        ck["dir"], device="cpu", compose_hangul=False, **kw)
    for decoder in ("greedy", "beam_batched"):
        want = rec(decoder=decoder).transcribe_batch(ck["wavs"])
        assert _texts(run("--decoder", decoder)) == want and any(want)
    r = rec(decoder="greedy")
    want = []
    for path in ck["wavs"]:
        wav = read_wav(path)
        session = r.stream()
        for s in range(0, len(wav), 1600):
            session.feed(wav[s:s + 1600])
        session.flush()
        want.append(r.tokenizer.decode(session.tokens, group_tokens=False))
    assert _texts(run("--stream", "--decoder", "greedy")) == want
    assert want == r.transcribe_batch(ck["wavs"])  # streaming = offline
    capsys.readouterr()

    manifest = ck["tmp"] / "eval.tsv"
    manifest.write_text("".join(f"{p}\t가나\n" for p in ck["wavs"]), encoding="utf-8")
    dump = str(ck["tmp"] / "per_utt.jsonl")
    summary = evaluate_cli.main(["--checkpoint_dir", ck["dir"], "--manifest",
                                 str(manifest), "--decoder", "greedy", "--dump", dump,
                                 "--batch_size", "2", "--device", "cpu"])
    assert summary["n_utts"] == 2
    hyps = [json.loads(line)["hyp"] for line in open(dump, encoding="utf-8")]
    tok = GraphemeTokenizer.default(72)
    items, ids = load_manifest_items(str(manifest), tok, 16000)
    res = evaluate_corpus(r.model, tok, pcfg.AudioConfig(normalize=False), items,
                          ids=ids, batch_size=2,
                          max_symbols=pcfg.TrainConfig().greedy_max_symbols)
    assert hyps == [u["hyp"] for u in res.per_utt]


def test_train_cli_takes_a_conformer_config(tmp_path):
    """``cli.train --config conformer.json``: a Conformer trains, validates,
    checkpoints with its config, and ``--eval_only`` tests the checkpoint."""
    cfg = pcfg.Config(
        model=pcfg.ModelConfig.from_dict(conformer_dict(stride=4, layers=1, d=32)),
        data=pcfg.DataConfig(audio_buckets=(400, 801), label_buckets=(48,)),
        train=pcfg.TrainConfig(precision="fp32", val_every_steps=100))
    path = tmp_path / "conformer.json"
    cfg.to_json(str(path))
    ckpt = str(tmp_path / "cli")
    args = ["--config", str(path), "--synthetic", "8", "--max_steps", "2",
            "--device", "cpu", "--per_device_train_batch_size", "4",
            "--checkpoint_dir", ckpt, "--optimizer", "adafactor"]
    state = train_cli.main(args)
    assert state.step == 2
    saved = pcfg.Config.from_json(str(tmp_path / "cli" / "config.json"))
    assert saved.model == cfg.model and saved.train.optimizer == "adafactor"
    results = train_cli.main(args + ["--eval_only"])
    assert np.isfinite(results["synthetic"]["loss"])


def test_server_batched_lanes_equal_the_jax_sessions(stream_ckpt):
    """The TCP server with 3 batched lanes of the streaming Conformer and 3
    concurrent clients (their chunks land in different ticks, so lanes
    idle mid-stream) gives the finals of the JAX server's per-connection
    sessions, which stream each client alone."""
    import threading

    variables = stream_ckpt["variables"]
    audio = dict(normalize=False)
    kw = dict(decoder="greedy", max_output_len=128)
    jrec = JaxRecognizer(jcfg.Config(model=jcfg.ModelConfig.from_dict(STREAM),
                                     data=jcfg.DataConfig(audio=jcfg.AudioConfig(**audio))),
                         variables["params"], JaxTokenizer.default(72), **kw)
    prec = Recognizer(pcfg.Config(model=pcfg.ModelConfig.from_dict(STREAM),
                                  data=pcfg.DataConfig(audio=pcfg.AudioConfig(**audio))),
                      numpy_params(variables), GraphemeTokenizer.default(72),
                      device="cpu", **kw)
    rng = np.random.RandomState(4)
    wavs = [(rng.randn(n) * 0.5).astype(np.float32) for n in (24000, 17000, 30000)]
    with JaxServer(jrec, port=0, chunk_frames=CHUNK_FRAMES, batch_sessions=0,
                   normalize="none") as server:
        want = [jax_stream_wav("127.0.0.1", server.port, w)[1] for w in wavs]
    got = [None] * len(wavs)
    with StreamingServer(prec, port=0, chunk_frames=CHUNK_FRAMES, batch_sessions=3,
                         normalize="none") as server:
        def run(i):
            # a different feed size per client: their chunks fill at
            # different times
            got[i] = stream_wav("127.0.0.1", server.port, wavs[i],
                                chunk_samples=(1600, 1100, 2300)[i])[1]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got == want  # tokens, text and times of every final
    assert all(w["tokens"] for w in want)
