"""Import of the original PyTorch(-Lightning) checkpoints into the port
(utils/torch_import.py): the reference-layout torch model of
``tests/test_torch_checkpoint_import.py`` is imported by the port; its
lattice logits are within 1e-4 of that torch model and within 1e-5 of the
JAX package's import of the same state_dict; greedy tokens equal the JAX
import's and the torch model's own greedy loop; Lightning prefixes and
.ckpt files load the same tensors; shape mismatches raise; a converted
checkpoint restores through ``Recognizer.from_checkpoint``, both CLIs, the
socket server and ``Trainer.fit(resume=True)``; without CUDA the
conversion raises unless asked for the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode import greedy_decode as jax_greedy
from rnntransducer_tpu.models import RNNTransducer as JaxTransducer
from rnntransducer_tpu.utils.torch_import import (
    params_from_torch_state_dict as jax_import)

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.cli import evaluate as eval_cli
from rnntransducer_tpu_torch.cli import infer as infer_cli
from rnntransducer_tpu_torch.data.dataset import SyntheticAudioDataset
from rnntransducer_tpu_torch.decode import greedy_decode
from rnntransducer_tpu_torch.models.transducer import build_model
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.serve_socket import StreamingServer, stream_wav
from rnntransducer_tpu_torch.train import Trainer
from rnntransducer_tpu_torch.utils.audio_io import write_wav
from rnntransducer_tpu_torch.utils.torch_import import (convert_to_checkpoint,
                                                        load_torch_checkpoint,
                                                        main,
                                                        params_from_torch_state_dict)

from test_torch_checkpoint_import import V, _batch, _TorchRNNT

LOGIT_TOL = 1e-4     # against the torch model (test_torch_checkpoint_import.py)
JAX_TOL = 1e-5       # against the JAX package's import


def _model_dict(enc_type, scan_layers, n_mels=8, vocab=V, bidir=True, layers=3):
    return {
        "transnet": dict(input_size=n_mels, hidden_size=16, output_size=12,
                         num_layers=layers, rnn_type=enc_type, dropout=0.0,
                         bidirectional=bidir, scan_layers=scan_layers),
        "prednet": dict(embedding_size=vocab, hidden_size=16, output_size=12,
                        num_layers=2, rnn_type="lstm", dropout=0.0),
        "jointnet": dict(num_classes=vocab)}


def _reference(d, seed):
    """The reference-layout torch model for the config dict ``d``."""
    torch.manual_seed(seed)
    t, p = d["transnet"], d["prednet"]
    return _TorchRNNT(
        dict(input_size=t["input_size"], hidden=16, out=12, layers=t["num_layers"],
             rnn_type=t["rnn_type"], bidir=t["bidirectional"]),
        dict(vocab=p["embedding_size"], hidden=16, out=12, layers=2, rnn_type="lstm"),
        num_classes=d["jointnet"]["num_classes"])


def _port(d, sd):
    return build_model(pcfg.ModelConfig.from_dict(d), "cpu",
                       state_dict=params_from_torch_state_dict(sd, pcfg.ModelConfig.from_dict(d)))


def _jax(d, sd):
    cfg = jcfg.ModelConfig.from_dict(d)
    return JaxTransducer(cfg), jax_import(sd, cfg)


@pytest.mark.parametrize("enc_type, scan_layers", [("gru", True), ("lstm", False)])
def test_lattice_logits_match_torch_and_jax(enc_type, scan_layers):
    d = _model_dict(enc_type, scan_layers)
    tm = _reference(d, seed=0)
    pm = _port(d, tm.state_dict())
    jm, params = _jax(d, tm.state_dict())
    feats, lengths, text_in = _batch()
    with torch.no_grad():
        want = tm(torch.from_numpy(feats), lengths, torch.from_numpy(text_in)).numpy()
    text_lengths = np.full((3,), text_in.shape[1])
    with torch.inference_mode():
        got = pm(torch.from_numpy(feats), torch.from_numpy(lengths),
                 torch.from_numpy(text_in), torch.from_numpy(text_lengths)).numpy()
    jax_logits = np.asarray(jm.apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(text_in, jnp.int32), jnp.asarray(text_lengths, jnp.int32)))
    assert got.shape == want.shape == jax_logits.shape
    # rows past each utterance's length are masked in the packages, not in
    # torch's pad_packed output
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(got[b, :L], want[b, :L], atol=LOGIT_TOL, rtol=0.0)
    np.testing.assert_allclose(got, jax_logits, atol=JAX_TOL, rtol=0.0)


def test_greedy_tokens_match_jax_and_the_torch_loop():
    """Greedy tokens of the imported port model equal the JAX import's and a
    torch loop of the reference's recognize_greedy on the torch model."""
    d = _model_dict("gru", True)
    tm = _reference(d, seed=3)
    pm = _port(d, tm.state_dict())
    jm, params = _jax(d, tm.state_dict())
    B, T = 2, 10
    feats = np.random.RandomState(4).randn(B, T, 8).astype(np.float32)
    lengths = np.full((B,), T, np.int64)
    toks, lens = greedy_decode(pm, torch.from_numpy(feats), torch.from_numpy(lengths),
                               max_symbols=3, max_output_len=32)
    jt, jl = jax_greedy(jm, {"params": params}, jnp.asarray(feats),
                        jnp.asarray(lengths, jnp.int32), max_symbols=3,
                        max_output_len=32)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
    with torch.no_grad():
        enc = tm.encoder(torch.from_numpy(feats))
        for b in range(B):
            dec_out, hidden = tm.decoder(torch.zeros((1, 1), dtype=torch.long))
            out, last = [], 0
            for t in range(T):
                for _ in range(3):
                    tok = int(tm.joint(enc[b:b + 1, t], dec_out[:, 0]).argmax(-1))
                    if tok == 0:
                        break
                    if tok != last:
                        out.append(tok)
                        last = tok
                    dec_out, hidden = tm.decoder(torch.tensor([[tok]]), hidden)
            assert out == toks[b, :lens[b]].tolist() and out, b


def test_lightning_prefix_ckpt_file_and_mismatches(tmp_path):
    d = _model_dict("gru", True)
    cfg = pcfg.ModelConfig.from_dict(d)
    tm = _reference(d, seed=5)
    sd = tm.state_dict()
    bare = params_from_torch_state_dict(sd, cfg)
    wrapped = {f"jointnet.{k}": v for k, v in sd.items()}
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": wrapped, "epoch": 7}, path)
    for other in (params_from_torch_state_dict(wrapped, cfg),
                  load_torch_checkpoint(str(path), cfg)):
        assert other.keys() == bare.keys()
        assert all(torch.equal(other[k], bare[k]) for k in bare)
    # one class more than the checkpoint's vocabulary: the joint fc differs
    bad = pcfg.ModelConfig.from_dict(_model_dict("gru", True, vocab=V + 1))
    with pytest.raises(ValueError, match="does not match"):
        params_from_torch_state_dict(sd, bad)
    with pytest.raises(KeyError, match="weight_ih_l3"):
        params_from_torch_state_dict(sd, pcfg.ModelConfig.from_dict(
            _model_dict("gru", True, layers=4)))
    with pytest.raises(KeyError, match="not an RNNTransducer"):
        params_from_torch_state_dict({"fc.weight": sd["fc.weight"]}, cfg)


def _serving_config(tmp_path):
    """A streamable reference model over 80 mels and the default 72-grapheme
    vocabulary, with a train section for a resumed fit."""
    d = _model_dict("lstm", False, n_mels=80, vocab=72, bidir=False, layers=2)
    return pcfg.Config(
        model=pcfg.ModelConfig.from_dict(d),
        data=pcfg.DataConfig(audio=pcfg.AudioConfig(normalize=False, spec_augment=False),
                             audio_buckets=(64, 128), label_buckets=(16, 24)),
        train=pcfg.TrainConfig(max_steps=1, per_device_train_batch_size=2,
                               precision="fp32", log_every_steps=1,
                               val_every_steps=100,
                               checkpoint_dir=str(tmp_path / "ckpt"))), d


def test_converted_checkpoint_restores_everywhere(tmp_path, monkeypatch):
    cfg, d = _serving_config(tmp_path)
    tm = _reference(d, seed=8)
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {f"jointnet.{k}": v for k, v in tm.state_dict().items()}},
               ckpt)
    cfg_path = str(tmp_path / "config.json")
    cfg.to_json(cfg_path)
    out = str(tmp_path / "ckpt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_to_checkpoint(str(ckpt), cfg, out)
    main(["--torch_ckpt", str(ckpt), "--config", cfg_path, "--out_dir", out,
          "--device", "cpu"])

    rng = np.random.RandomState(9)
    waves = [(rng.randn(n) * 0.5).astype(np.float32) for n in (7000, 5600)]
    rec = Recognizer.from_checkpoint(out, decoder="greedy", device="cpu")
    by_hand = Recognizer(cfg, load_torch_checkpoint(str(ckpt), cfg.model),
                         rec.tokenizer, decoder="greedy", device="cpu")
    want = by_hand.transcribe_batch(waves)
    assert rec.transcribe_batch(waves) == want and any(want)

    paths = []
    for i, w in enumerate(waves):
        paths.append(str(tmp_path / f"w{i}.wav"))
        write_wav(paths[-1], w)
    lines = infer_cli.main(["--checkpoint_dir", out, "--wav", *paths,
                            "--decoder", "greedy", "--device", "cpu"])
    from_files = by_hand.transcribe_batch(paths)
    assert lines == [f"{p}\t{t}" for p, t in zip(paths, from_files)]
    manifest = tmp_path / "eval.tsv"
    manifest.write_text("".join(f"{p}\t가\n" for p in paths), encoding="utf-8")
    summary = eval_cli.main(["--checkpoint_dir", out, "--manifest", str(manifest),
                             "--device", "cpu"])
    assert summary["n_utts"] == 2 and summary["params"] == "step 0"

    with StreamingServer(rec, port=0, chunk_frames=16) as server:
        _, final = stream_wav("127.0.0.1", server.port, waves[0])
    session = by_hand.stream(chunk_frames=16)
    for s in range(0, len(waves[0]), 1600):
        q = np.clip(waves[0][s:s + 1600] * 32768.0, -32768, 32767).astype("<i2")
        session.feed(q.astype(np.float32) / 32768.0)
    session.flush()
    assert final["tokens"] == session.tokens

    ds = SyntheticAudioDataset(4, cfg.data.audio, min_sec=0.3, max_sec=0.6,
                               min_labels=3, max_labels=8, seed=0)
    trainer = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=out)), ds, device="cpu")
    state = trainer.fit(resume=True)
    assert trainer.restore_s and state.step == 1
    assert trainer.ckpt.latest_step() == 1
