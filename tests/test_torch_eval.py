"""Corpus evaluation in the port (eval.py, cli/evaluate.py) against the JAX
package's ``evaluate_corpus`` on the same weights and items, on the CPU:
hypotheses, CER and WER equal for greedy, the device beam (with and
without a char LM), the host beam with an n-gram LM and hotwords, and the
oracle n-best; self-decoding scores 0 in input order; wav items equal
feature items; the argument checks; Arrow waveform items; the CLI end to
end on a checkpoint of the port."""

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode.device_lm import DeviceCharLM as JaxCharLM
from rnntransducer_tpu.decode.ngram_lm import NGramLM as JaxNGramLM
from rnntransducer_tpu.eval import evaluate_corpus as jax_evaluate
from rnntransducer_tpu.eval import load_dataset_items as jax_dataset_items
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.cli import evaluate as cli
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.eval import (evaluate_corpus, load_dataset_items,
                                          load_manifest_items, write_per_utt_jsonl)
from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.state import TrainState
from rnntransducer_tpu_torch.utils.audio_io import write_wav

from _torch_parity import jax_model, model_dict, port_model

# the build_default_vocab layout cut to its first 8 entries, as
# tests/test_evaluate.py
VOCAB = {"<pad>": 0, "<unk>": 1, "<s>": 2, "</s>": 3, "|": 4, "a": 5, "b": 6,
         "c": 7}
FEATS = model_dict(rnn_type="lstm", layers=1, bidirectional=False, n_mels=6,
                   vocab=8, hidden=12, out=8)
WAVS = model_dict(rnn_type="lstm", layers=1, bidirectional=True, n_mels=80,
                  vocab=8, hidden=12, out=8)
WORD_ARPA = textwrap.dedent(r"""
\data\
ngram 1=5

\1-grams:
-1.0    <s>
-1.0    </s>
-0.8    ab
-1.1    ca
-2.0    <unk>

\end\
""").strip()


def _pair(d, seed):
    jm, variables = jax_model(d, seed=seed)
    return jm, variables, port_model(d, variables)


def _feat_items(n, seed):
    rng = np.random.RandomState(seed)
    return [{"feats": (rng.randn(int(rng.randint(8, 40)), 6) * 2).astype(np.float32),
             "labels": rng.randint(4, 8, size=(int(rng.randint(1, 5)),)).astype(np.int32)}
            for _ in range(n)]


def _both(d, seed, items, audio=None, jkw=None, pkw=None, **kw):
    """(JAX result, port result) on the same weights and items."""
    jm, variables, pm = _pair(d, seed)
    audio = audio or {}
    want = jax_evaluate(jm, variables, JaxTokenizer(VOCAB), jcfg.AudioConfig(**audio),
                        items, **kw, **(jkw or {}))
    got = evaluate_corpus(pm, GraphemeTokenizer(VOCAB), pcfg.AudioConfig(**audio),
                          items, **kw, **(pkw or {}))
    return want, got


def _same(got, want):
    """Hyps, references, per-utterance and corpus CER / WER equal."""
    assert got.per_utt == want.per_utt
    assert (got.cer, got.wer, got.n_utts, got.oracle_cer) == (
        want.cer, want.wer, want.n_utts, want.oracle_cer)
    assert got.audio_seconds == pytest.approx(want.audio_seconds, abs=1e-9)


@pytest.mark.parametrize("decoder", ["greedy", "beam_batched", "beam"])
def test_self_decode_scores_zero_and_matches_jax(decoder):
    """The port's hyps fed back as references score CER == WER == 0, with
    the records in input order despite the length-sorted batches; hyps,
    CER and WER equal the JAX package's."""
    items = _feat_items(7, seed=3)
    kw = dict(decoder=decoder, batch_size=3, frame_bucket=16, beam_width=3)
    want, first = _both(FEATS, 1, items, **kw)
    _same(first, want)
    assert any(r["hyp"] for r in first.per_utt)
    tok = GraphemeTokenizer(VOCAB)
    items2 = [dict(it, labels=np.asarray(tok.encode(r["hyp"]), np.int32))
              for it, r in zip(items, first.per_utt)]
    pm = _pair(FEATS, 1)[2]
    again = evaluate_corpus(pm, tok, pcfg.AudioConfig(), items2, **kw)
    assert again.cer == 0.0 and again.wer == 0.0
    for rec, rec2, it in zip(first.per_utt, again.per_utt, items):
        assert rec2["ref"] == rec["hyp"] == rec2["hyp"] and rec2["cer"] == 0.0
        assert rec["audio_sec"] == pytest.approx(
            len(it["feats"]) * pcfg.AudioConfig().window_stride_sec, abs=1e-6)
    assert first.rtf > 0 and set(first.summary()) >= {"cer", "wer", "rtf"}


def test_wav_items_equal_feats_items_and_jax():
    """Raw-PCM items through the log-mel frontend equal the same
    utterances' precomputed features, and the JAX package's wav items."""
    acfg = pcfg.AudioConfig(normalize=False)
    rng = np.random.RandomState(7)
    frontend = LogMelFrontend(acfg)
    wav_items, feat_items = [], []
    for i in range(3):
        wav = (rng.randn(3200 + 1600 * i) * 0.3).astype(np.float32)
        labels = rng.randint(4, 8, size=(3,)).astype(np.int32)
        feats, lens = frontend(torch.from_numpy(wav[None]))
        wav_items.append({"wav": wav, "labels": labels})
        feat_items.append({"feats": feats[0, :int(lens[0])].numpy(), "labels": labels})
    kw = dict(decoder="beam_batched", beam_width=2, batch_size=2, frame_bucket=8)
    want, a = _both(WAVS, 2, wav_items, audio=dict(normalize=False), **kw)
    _same(a, want)
    b = evaluate_corpus(_pair(WAVS, 2)[2], GraphemeTokenizer(VOCAB), acfg,
                        feat_items, **kw)
    assert [r["hyp"] for r in a.per_utt] == [r["hyp"] for r in b.per_utt]


def test_host_beam_with_lm_and_hotwords_and_oracle(tmp_path):
    """The host beam with a word LM and hotwords, and the oracle n-best of
    both beams: equal to the JAX package's; oracle <= top-1."""
    path = tmp_path / "word.arpa"
    path.write_text(WORD_ARPA)
    items = _feat_items(4, seed=10)
    fusion = dict(hotwords=["ab"], hotword_weight=2.0)
    want, got = _both(FEATS, 4, items[:3], decoder="beam", beam_width=2,
                      frame_bucket=16, oracle_nbest=True,
                      jkw=dict(lm=JaxNGramLM.load(str(path), weight=0.5), **fusion),
                      pkw=dict(lm=NGramLM.load(str(path), weight=0.5), **fusion))
    _same(got, want)
    want, got = _both(FEATS, 9, items, decoder="beam_batched", beam_width=4,
                      frame_bucket=16, oracle_nbest=True)
    _same(got, want)
    assert got.oracle_cer is not None and got.oracle_cer <= got.cer + 1e-9
    for r in got.per_utt:
        assert "oracle_hyp" in r and r["oracle_cer"] <= r["cer"] + 1e-9
    assert "oracle_cer" in got.summary()


def test_device_lm_changes_hyps_as_in_jax():
    """A strongly biased char LM changes the device beam's hypotheses, the
    same way in both packages."""
    table = (np.random.RandomState(1).randn(8, 8, 8) * 3).astype(np.float32)
    items = _feat_items(3, seed=8)
    kw = dict(decoder="beam_batched", beam_width=3, frame_bucket=16)
    want, fused = _both(FEATS, 6, items, jkw=dict(device_lm=JaxCharLM(table, weight=1.0)),
                        pkw=dict(device_lm=DeviceCharLM(table, weight=1.0)), **kw)
    _same(fused, want)
    plain = evaluate_corpus(_pair(FEATS, 6)[2], GraphemeTokenizer(VOCAB),
                            pcfg.AudioConfig(), items, **kw)
    assert [r["hyp"] for r in plain.per_utt] != [r["hyp"] for r in fused.per_utt]


def test_argument_checks():
    pm = _pair(FEATS, 0)[2]
    tok, acfg = GraphemeTokenizer(VOCAB), pcfg.AudioConfig()
    items = _feat_items(1, seed=0)
    for kw, match in ((dict(decoder="greedy", device_lm=object()), "beam_batched"),
                      (dict(decoder="beam", word_lm=object()), "beam_batched"),
                      (dict(decoder="greedy", hotwords=["ab"]), "decoder='beam'"),
                      (dict(decoder="greedy", oracle_nbest=True), "n-best"),
                      (dict(decoder="viterbi"), "unknown decoder"),
                      (dict(ids=["a", "b"]), "2 ids for 1 items")):
        with pytest.raises(ValueError, match=match):
            evaluate_corpus(pm, tok, acfg, items, **kw)
    with pytest.raises(ValueError, match="empty"):
        evaluate_corpus(pm, tok, acfg, [])


def test_arrow_waveform_items(tmp_path):
    """load_dataset_items tells raw-PCM rows from their shape; the items
    equal the JAX loader's (the shards written by the JAX package)."""
    from rnntransducer_tpu.data.dataset import save_waveform_dataset

    rng = np.random.RandomState(0)
    rows = [{"wav": rng.randn(3200).astype(np.float32),
             "labels": np.array([5, 6], np.int32)} for _ in range(3)]
    root = str(tmp_path / "ds")
    save_waveform_dataset(rows, root, "eval_clean", pcfg.AudioConfig().hop_length)
    items, ids = load_dataset_items([root], "eval_clean", pcfg.AudioConfig(), max_utts=2)
    want, want_ids = jax_dataset_items([root], "eval_clean", jcfg.AudioConfig(),
                                       max_utts=2)
    assert ids == want_ids and len(items) == 2
    for it, w in zip(items, want):
        assert set(it) == set(w) == {"wav", "labels"}
        np.testing.assert_array_equal(it["wav"], w["wav"])
        np.testing.assert_array_equal(it["labels"], w["labels"])


def test_cli_end_to_end(tmp_path, capsys, monkeypatch):
    """The CLI on a checkpoint of the port and a TSV manifest (one row
    malformed): one JSON summary line, the per-utterance dump, the
    evaluate_corpus result; without CUDA and --device it raises."""
    cfg = pcfg.tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model,
        transnet=dataclasses.replace(cfg.model.transnet, hidden_size=16, output_size=16),
        prednet=dataclasses.replace(cfg.model.prednet, hidden_size=16, output_size=16)))
    ckpt = str(tmp_path / "ckpts")
    mgr = CheckpointManager(ckpt, save_top_k=1)
    state = TrainState.create(cfg, "cpu")
    mgr.save(1, state, metrics={"val_cer": 0.4}, config=cfg)
    mgr.close()
    rng = np.random.RandomState(3)
    manifest = str(tmp_path / "eval.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        for i in range(2):
            p = str(tmp_path / f"u{i}.wav")
            write_wav(p, rng.randn(3200).astype(np.float32) * 0.1,
                      cfg.data.audio.sample_rate)
            f.write(f"{p}\t가나\n")
        f.write(f"{tmp_path / 'missing.wav'}\t가\n")
    dump = str(tmp_path / "per_utt.jsonl")
    flags = ["--checkpoint_dir", ckpt, "--manifest", manifest, "--decoder", "greedy",
             "--batch_size", "2", "--frame_bucket", "32", "--dump", dump]
    summary = cli.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("[skip] line 3") for line in out)
    assert json.loads(out[-1]) == summary
    assert summary["n_utts"] == 2 and summary["decoder"] == "greedy"
    assert summary["params"] == "step 1" and summary["rtf"] > 0
    recs = [json.loads(line) for line in open(dump, encoding="utf-8")]
    assert len(recs) == 2 and all(r["ref"] for r in recs)
    tok = GraphemeTokenizer.default(cfg.model.jointnet.num_classes)
    items, ids = load_manifest_items(manifest, tok, cfg.data.audio.sample_rate)
    res = evaluate_corpus(state.model.eval(), tok, cfg.data.audio, items, ids=ids,
                          batch_size=2, frame_bucket=32,
                          max_symbols=cfg.train.greedy_max_symbols)
    assert [r["hyp"] for r in res.per_utt] == [r["hyp"] for r in recs]
    write_per_utt_jsonl(res, str(tmp_path / "again.jsonl"))
    assert open(tmp_path / "again.jsonl", encoding="utf-8").read() == open(
        dump, encoding="utf-8").read()
    for bad, match in ((["--decoder", "greedy", "--oracle_nbest"], "beam decoder"),
                       (["--decoder", "greedy", "--device_lm", "x"], "beam_batched"),
                       (["--decoder", "beam_batched", "--hotwords", "x"], "decoder beam")):
        with pytest.raises(SystemExit, match=match):
            cli.main(flags[:4] + bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(flags)
