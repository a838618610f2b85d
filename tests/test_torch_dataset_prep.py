"""The port's data preparation against the JAX package's on the CPU: the
ledger, ``prepare_logmel_dataset`` and ``save_waveform_dataset`` (shards
equal column by column, features exactly), the hard and confusable
testbeds (bit-equal per seed), and the manifest and tokenizer tools against
the JAX package's scripts, run as subprocesses.

``Dataset.map`` writes cache files beside its source shards, so each
package prepares from its own copy of the raw shards under ``tmp_path``."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.data import dataset as jds

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.data import dataset as pds
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.utils.audio_io import read_wav, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTBEDS = ("HardPatternedWaveformDataset", "ConfusableWaveformDataset")


def _without_time(ledger):
    return {split: {task: {k: v for k, v in entry.items() if k != "time"}
                    for task, entry in tasks.items()}
            for split, tasks in ledger.items()}


def _shards(root, split):
    """Every shard of root/<split> as (columns dict, arrow schema)."""
    from datasets import load_from_disk
    out = []
    for d in pds.shard_dirs(str(root), split):
        ds = load_from_disk(d)
        out.append(({c: ds[c] for c in ds.column_names}, ds.data.schema))
    return out


def _assert_same_shards(got_root, want_root, split):
    got, want = _shards(got_root, split), _shards(want_root, split)
    assert len(got) == len(want) > 0
    for (gcols, gschema), (wcols, wschema) in zip(got, want):
        assert gschema == wschema
        assert sorted(gcols) == sorted(wcols)
        for c in wcols:
            assert len(gcols[c]) == len(wcols[c])
            for g, w in zip(gcols[c], wcols[c]):
                g, w = np.asarray(g), np.asarray(w)
                assert g.dtype == w.dtype and g.shape == w.shape, c
                assert g.tobytes() == w.tobytes(), c
    assert os.path.exists(os.path.join(got_root, split, "_SUCCESS"))
    assert os.path.exists(os.path.join(want_root, split, "_SUCCESS"))


def _raw_shards(root, n=5, seed=0):
    """n confusable-testbed utterances as two raw PCM shards of train."""
    from datasets import Dataset
    tb = pds.ConfusableWaveformDataset(n, pcfg.AudioConfig(), seed=seed)
    waves = [tb.waveform(i) for i in range(n)]
    ds = Dataset.from_dict({"input_values": [w for w, _ in waves],
                            "input_ids": [lb.tolist() for _, lb in waves]})
    for i in range(2):
        ds.shard(num_shards=2, index=i).save_to_disk(os.path.join(root, "train", str(i)))
    return waves


def _copies(tmp_path, *names):
    src = tmp_path / "raw"
    _raw_shards(str(src))
    for name in names:
        shutil.copytree(src, tmp_path / name)
    return [str(tmp_path / name) for name in names]


# ---------------------------------------------------------------------------
# the ledger and the log-mel preparation
# ---------------------------------------------------------------------------


def test_ledger_matches_the_jax_package(tmp_path):
    for mod, name in ((jds, "jax"), (pds, "port")):
        d = str(tmp_path / name)
        assert mod.read_ledger(d) == {}
        mod.write_ledger_entry(d, "logmel", "train", baked_spec_augment=False)
        mod.write_ledger_entry(d, "waveform", "dev")
        mod.write_ledger_entry(d, "logmel", "train", baked_spec_augment=True)
    want = jds.read_ledger(str(tmp_path / "jax"))
    got = pds.read_ledger(str(tmp_path / "port"))
    assert _without_time(got) == _without_time(want) == {
        "train": {"logmel": {"baked_spec_augment": True}}, "dev": {"waveform": {}}}
    assert all(isinstance(e["time"], float) for t in got.values() for e in t.values())
    with open(tmp_path / "port" / "postprocess_log.json") as f:
        assert json.load(f) == got


@pytest.mark.parametrize("bake", [False, True])
def test_prepare_logmel_matches_the_jax_package(tmp_path, bake):
    """From copies of the same raw shards: equal shard counts (clamped to the
    5 rows), Arrow schemas, columns, features exactly, markers and ledger."""
    jax_src, port_src = _copies(tmp_path, "raw_jax", "raw_port")
    kw = dict(num_shards=8, bake_spec_augment=bake, seed=3)
    jds.prepare_logmel_dataset([jax_src], str(tmp_path / "jax"), "train",
                               jcfg.AudioConfig(), **kw)
    pds.prepare_logmel_dataset([port_src], str(tmp_path / "port"), "train",
                               pcfg.AudioConfig(), **kw)
    _assert_same_shards(str(tmp_path / "port"), str(tmp_path / "jax"), "train")
    assert len(pds.shard_dirs(str(tmp_path / "port"), "train")) == 5
    assert _without_time(pds.read_ledger(str(tmp_path / "port"))) == _without_time(
        jds.read_ledger(str(tmp_path / "jax"))) == {
            "train": {"logmel": {"baked_spec_augment": bake}}}
    ds = pds.ArrowAudioDataset([str(tmp_path / "port")], "train")
    raw = pds.load_shards([port_src], "train")
    feats = pds.logmel_np(np.asarray(raw[1]["input_values"], np.float32),
                          pcfg.AudioConfig())
    if bake:
        feats = pds.spec_augment_np(feats, pcfg.AudioConfig(),
                                    np.random.RandomState(3 + 1))
    assert np.array_equal(ds[1]["feats"], feats)
    assert ds.lengths()[1] == feats.shape[0]


def test_prepare_skips_a_finished_split_and_redoes_a_crashed_one(tmp_path, monkeypatch):
    (src,) = _copies(tmp_path, "raw_port")
    tgt = str(tmp_path / "port")
    cfg = pcfg.AudioConfig()
    pds.prepare_logmel_dataset([src], tgt, "train", cfg, num_shards=2)
    loads = []
    real = pds.load_shards
    monkeypatch.setattr(pds, "load_shards", lambda *a: loads.append(a) or real(*a))
    pds.prepare_logmel_dataset([src], tgt, "train", cfg, num_shards=2)
    assert loads == []
    # a crash before the marker: partial shards and no _SUCCESS
    os.remove(os.path.join(tgt, "train", "_SUCCESS"))
    shutil.rmtree(os.path.join(tgt, "train", "1"))
    pds.prepare_logmel_dataset([src], tgt, "train", cfg, num_shards=2)
    assert len(loads) == 1
    assert len(pds.ArrowAudioDataset([tgt], "train")) == 5
    assert os.path.exists(os.path.join(tgt, "train", "_SUCCESS"))


# ---------------------------------------------------------------------------
# raw PCM shards
# ---------------------------------------------------------------------------


def _items(n=5, seed=1):
    tb = pds.HardPatternedWaveformDataset(n, pcfg.AudioConfig(), seed=seed)
    return [{"wav": w, "labels": lb} for w, lb in (tb.waveform(i) for i in range(n))]


@pytest.mark.parametrize("streamed", [False, True])
def test_save_waveform_dataset_matches_the_jax_package(tmp_path, streamed):
    items = _items()
    total = len(items) if streamed else None
    jds.save_waveform_dataset(iter(items), str(tmp_path / "jax"), "train", 160,
                              num_shards=2, total=total)
    pds.save_waveform_dataset(iter(items), str(tmp_path / "port"), "train", 160,
                              num_shards=2, total=total)
    _assert_same_shards(str(tmp_path / "port"), str(tmp_path / "jax"), "train")
    assert _without_time(pds.read_ledger(str(tmp_path / "port"))) == _without_time(
        jds.read_ledger(str(tmp_path / "jax"))) == {"train": {"waveform": {}}}
    ds = pds.ArrowWaveformDataset([str(tmp_path / "port")], "train", pcfg.AudioConfig())
    assert len(ds) == len(items)
    for i, it in enumerate(items):
        assert np.array_equal(ds[i]["wav"], it["wav"])
        assert np.array_equal(ds[i]["labels"], it["labels"])
        assert ds.lengths()[i] == len(it["wav"]) // 160 + 1


def test_save_waveform_dataset_refuses_a_miscounted_iterable(tmp_path):
    items = _items(3)
    errors = []
    for mod, name in ((jds, "jax"), (pds, "port")):
        root = str(tmp_path / name)
        with pytest.raises(ValueError) as e:
            mod.save_waveform_dataset(iter(items), root, "dev", 160, num_shards=2,
                                      total=5)
        errors.append(str(e.value).replace(root, "ROOT"))
        assert not os.path.exists(os.path.join(root, "dev", "_SUCCESS"))
    assert errors[0] == errors[1]
    assert "yielded 3 items but total=5" in errors[1]


# ---------------------------------------------------------------------------
# the testbeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TESTBEDS)
@pytest.mark.parametrize("seed", [0, 4, 11])
def test_testbeds_equal_the_jax_ones_bit_for_bit(name, seed):
    kw = (dict(oov_fraction=0.3, n_words=40, n_oov_words=10)
          if name == "HardPatternedWaveformDataset" else dict(gap_segments=2))
    n = 5
    want = getattr(jds, name)(n, jcfg.AudioConfig(), seed=seed, pattern_seed=777 + seed,
                              **kw)
    got = getattr(pds, name)(n, pcfg.AudioConfig(), seed=seed, pattern_seed=777 + seed,
                             **kw)
    assert got.lexicon == want.lexicon and got.n_in_vocab == want.n_in_vocab
    assert np.array_equal(got.lengths(), want.lengths())
    assert np.array_equal(got.label_lengths(), want.label_lengths())
    for i in range(n):
        gw, gl = got.waveform(i)
        ww, wl = want.waveform(i)
        assert gw.dtype == ww.dtype and gw.tobytes() == ww.tobytes()
        assert gl.dtype == wl.dtype and gl.tobytes() == wl.tobytes()
        assert got[i]["feats"].tobytes() == want[i]["feats"].tobytes()
        assert got.word_sequences(i) == want.word_sequences(i)
    if name == "ConfusableWaveformDataset":
        assert (got.pairs, got.triggers) == (want.pairs, want.triggers)
        assert [got.homophone_slots(i) for i in range(n)] == \
            [want.homophone_slots(i) for i in range(n)]
        assert any(got.homophone_slots(i) for i in range(n))
    else:
        words = [w for i in range(n) for w in got.word_sequences(i)]
        assert any(w >= got.n_in_vocab for w in words)  # the OOV slice is drawn


# ---------------------------------------------------------------------------
# the manifest and tokenizer tools against the JAX package's scripts
# ---------------------------------------------------------------------------


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                         cwd=cwd, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _manifest(tmp_path):
    """A TSV of confusable-testbed WAVs (written with write_wav) whose
    transcripts are the tokenizer's decode of the labels, plus a malformed
    row, a missing WAV, an empty transcript, a blank line and an empty WAV."""
    tok = GraphemeTokenizer.default(72)
    tb = pds.ConfusableWaveformDataset(4, pcfg.AudioConfig(), seed=2)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rows, labels = [], []
    for i in range(len(tb)):
        wav, lb = tb.waveform(i)
        path = str(wav_dir / f"{i}.wav")
        write_wav(path, wav)
        rows.append(f"{path}\t{tok.decode(lb.tolist())}")
        labels.append(lb)
    write_wav(str(wav_dir / "empty.wav"), np.zeros(0, np.float32))
    lines = [rows[0], "no tab on this line", rows[1],
             f"{wav_dir / 'missing.wav'}\tㄱㅏ", "", f"{wav_dir / '2.wav'}\t ",
             rows[2], f"{wav_dir / 'empty.wav'}\tㄱㅏ", rows[3]]
    path = tmp_path / "train.tsv"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path), [r.split("\t")[0] for r in rows], labels


def test_prepare_manifest_matches_the_jax_script(tmp_path):
    manifest, wavs, labels = _manifest(tmp_path)
    outs = {}
    for name, args in (("jax", [os.path.join(REPO, "scripts", "prepare_manifest.py")]),
                       ("port", ["-m", "rnntransducer_tpu_torch.cli.prepare_manifest"])):
        root = str(tmp_path / name)
        outs[name] = _run(args + ["--manifest", manifest, "--out", root, "--split",
                                  "dev", "--num_shards", "2"], REPO).replace(root, "ROOT")
    assert outs["port"] == outs["jax"]
    assert "[skip] line 2:" in outs["port"] and "[skip] line 4:" in outs["port"]
    assert "wrote 4 utterances (4 skipped)" in outs["port"]
    _assert_same_shards_raw(tmp_path / "port", tmp_path / "jax")
    # the text round trip: ids equal the testbed's labels, PCM equals the file's
    rows = pds.load_shards([str(tmp_path / "port")], "dev")
    for i, row in enumerate(rows):
        assert row["input_ids"] == labels[i].tolist()
        assert np.array_equal(np.asarray(row["input_values"], np.float32),
                              read_wav(wavs[i]))


def _assert_same_shards_raw(got_root, want_root):
    got, want = _shards(got_root, "dev"), _shards(want_root, "dev")
    assert len(got) == len(want) == 2
    for (gcols, gschema), (wcols, wschema) in zip(got, want):
        assert gschema == wschema and gcols == wcols


@pytest.mark.parametrize("source", ["--text", "--manifest"])
def test_train_tokenizer_matches_the_jax_script(tmp_path, source):
    if source == "--text":
        path = tmp_path / "corpus.txt"
        path.write_text("안녕하세요 여러분\n\n반갑습니다 안녕\n음성 인식 안녕하세요\n",
                        encoding="utf-8")
    else:
        path = tmp_path / "train.tsv"
        path.write_text("a.wav\t안녕하세요 여러분\nbroken line\nb.wav\t음성 인식 안녕\n",
                        encoding="utf-8")
    outs = {}
    for name, args in (("jax", [os.path.join(REPO, "scripts", "train_tokenizer.py")]),
                       ("port", ["-m", "rnntransducer_tpu_torch.cli.train_tokenizer"])):
        out = str(tmp_path / f"{name}.json")
        outs[name] = _run(args + [source, str(path), "--vocab_size", "80",
                                  "--out", out], REPO).replace(out, "OUT")
    assert outs["port"] == outs["jax"] and "merges" in outs["port"]
    with open(tmp_path / "port.json", "rb") as f, open(tmp_path / "jax.json", "rb") as g:
        assert f.read() == g.read()
