"""The port's inference CLI (``python -m rnntransducer_tpu_torch.cli.infer``)
on a checkpoint written by the port's CheckpointManager, on the CPU: each
decoder and ``--stream`` print the transcripts the port's decoders give;
the flag checks of the JAX package's ``inference.py`` are mirrored; without
CUDA it raises unless ``--device cpu``."""

import dataclasses
import textwrap

import numpy as np
import pytest
import torch

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.cli import infer as cli
from rnntransducer_tpu_torch.serve import Recognizer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils.audio_io import read_wav, write_wav
from rnntransducer_tpu_torch.utils.weights import random_flax_params, state_dict_from_flax

ARPA = textwrap.dedent(r"""
\data\
ngram 1=4
ngram 2=1

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.8    ㄱㅏ    -0.3
-2.0    <unk>

\2-grams:
-0.4    <s> ㄱㅏ

\end\
""").strip()
CHAR_ARPA = "\\data\\\nngram 1=2\nngram 2=1\n\n\\1-grams:\n-0.4 ㄱ -0.3\n-0.7 ㅏ\n\n" \
            "\\2-grams:\n-0.2 ㄱ ㅏ\n\n\\end\\\n"


def _config(tmp_path):
    m = pcfg.ModelConfig(
        transnet=pcfg.TransNetConfig(input_size=80, hidden_size=16, output_size=12,
                                     num_layers=1, rnn_type="lstm", dropout=0.0,
                                     bidirectional=False),
        prednet=pcfg.PredNetConfig(embedding_size=72, hidden_size=16, output_size=12,
                                   num_layers=1, rnn_type="lstm", dropout=0.0),
        jointnet=pcfg.JointNetConfig(num_classes=72))
    return pcfg.Config(model=m, train=pcfg.TrainConfig(
        precision="fp32", checkpoint_dir=str(tmp_path / "ckpt")),
        inference=pcfg.InferenceConfig(beam_width=3))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("infer_cli")
    cfg = _config(tmp)
    sd = state_dict_from_flax(
        random_flax_params(cfg.model, torch.Generator().manual_seed(3)), cfg.model)
    mgr = CheckpointManager(cfg.train.checkpoint_dir)
    mgr.save(1, TrainState.create(cfg, "cpu", state_dict=sd), config=cfg)
    mgr.close()
    rng = np.random.RandomState(0)
    wavs = []
    for i, n in enumerate((9600, 6400)):
        path = str(tmp / f"u{i}.wav")
        write_wav(path, rng.randn(n) * 0.3)
        wavs.append(path)
    (tmp / "lm.arpa").write_text(ARPA)
    (tmp / "char.arpa").write_text(CHAR_ARPA)
    return {"ckpt": cfg.train.checkpoint_dir, "wavs": wavs, "lm": str(tmp / "lm.arpa"),
            "char": str(tmp / "char.arpa")}


def _run(setup, *flags):
    return cli.main(["--checkpoint_dir", setup["ckpt"], "--wav", *setup["wavs"],
                     "--device", "cpu", *flags])


def _texts(lines):
    return [line.split("\t")[1] for line in lines if line.count("\t") == 1]


def _recognizer(setup, **kw):
    # the CLI prints the tokenizer's text, without composing Hangul jamo
    return Recognizer.from_checkpoint(setup["ckpt"], device="cpu",
                                      compose_hangul=False, **kw)


@pytest.mark.parametrize("decoder", ["greedy", "beam_batched"])
def test_cli_offline_equals_the_recognizer(setup, decoder):
    got = _texts(_run(setup, "--decoder", decoder))
    want = _recognizer(setup, decoder=decoder).transcribe_batch(setup["wavs"])
    assert got == want and any(got)


def test_cli_host_beam_with_lm_hotwords_and_nbest(setup):
    lines = _run(setup, "--decoder", "beam", "--lm_path", setup["lm"],
                 "--hotwords", "ㄱㅏ", "--nbest", "2")
    want = _recognizer(setup, lm_path=setup["lm"], hotwords=["ㄱㅏ"]).transcribe_batch(
        setup["wavs"])
    assert _texts(lines) == want and any(want)
    assert sum("\tnbest[" in line for line in lines) == 4
    plain = _texts(_run(setup))  # the default decoder: the host beam
    assert len(plain) == 2


def test_cli_greedy_timestamps_and_device_lm(setup):
    lines = _run(setup, "--decoder", "greedy", "--timestamps")
    assert sum("\ttimes\t" in line for line in lines) == 2
    got = _texts(_run(setup, "--decoder", "beam_batched", "--device_lm", setup["char"],
                      "--device_lm_weight", "0.0"))
    assert got == _texts(_run(setup, "--decoder", "beam_batched"))


@pytest.mark.parametrize("decoder", ["greedy", "beam_batched", "beam"])
def test_cli_stream_equals_the_recognizer_stream(setup, decoder):
    extra = ["--lm_path", setup["lm"], "--hotwords", "ㄱㅏ"] if decoder == "beam" else []
    got = _texts(_run(setup, "--stream", "--decoder", decoder, "--chunk_ms", "200",
                      *extra))
    kw = dict(lm_path=setup["lm"], hotwords=["ㄱㅏ"]) if decoder == "beam" else {}
    rec = _recognizer(setup, decoder=decoder, **kw)
    want = []
    for path in setup["wavs"]:
        wav = read_wav(path)
        session = rec.stream()
        for s in range(0, len(wav), 3200):
            session.feed(wav[s:s + 3200])
        session.flush()
        want.append(rec.tokenizer.decode(session.tokens, group_tokens=False))
    assert got == want and any(want)


@pytest.mark.parametrize("flags, match", [
    (["--decoder", "greedy", "--lm_path", "x.arpa"], "no shallow fusion"),
    (["--decoder", "beam_batched", "--hotwords", "a"], "no shallow fusion"),
    (["--decoder", "beam", "--timestamps"], "--timestamps requires"),
    (["--decoder", "greedy", "--timestamps", "--stream"], "--timestamps requires"),
    (["--decoder", "greedy", "--nbest", "2"], "--nbest requires"),
    (["--stream", "--nbest", "2"], "--nbest requires"),
    (["--device_lm", "c.arpa", "--lm_path", "x.arpa"], "mutually exclusive"),
    (["--decoder", "greedy", "--device_lm", "c.arpa"], "requires a beam decoder"),
    (["--decoder", "beam", "--device_lm", "c.arpa"], "use --decoder beam_batched"),
])
def test_cli_flag_checks(setup, flags, match):
    with pytest.raises(SystemExit, match=match):
        _run(setup, *flags)


def test_cli_checks_the_persisted_inference_config(setup, tmp_path):
    """A checkpoint-persisted lm_path is checked after the merge; --lm_path ''
    overrides it."""
    import shutil
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(setup["ckpt"], ckpt)
    cfg = pcfg.Config.from_json(f"{ckpt}/config.json")
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, lm_path=setup["lm"]))
    cfg.to_json(f"{ckpt}/config.json")
    args = ["--checkpoint_dir", ckpt, "--wav", setup["wavs"][0], "--device", "cpu",
            "--decoder", "beam_batched"]
    with pytest.raises(SystemExit, match="has no LM/hotword fusion"):
        cli.main(args)
    assert len(_texts(cli.main(args + ["--lm_path", ""]))) == 1
    with pytest.raises(SystemExit, match="either step or average_k"):
        cli.main(args + ["--lm_path", "", "--step", "1", "--average_k", "1"])


def test_cli_defaults_to_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--checkpoint_dir", setup["ckpt"], "--wav", setup["wavs"][0]])
    assert len(_texts(_run(setup, "--decoder", "greedy", "--precision", "bf16"))) == 2
