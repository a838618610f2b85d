"""The port's host data feed (data/) against the JAX package's: the
bucketing sampler's batches and the collated arrays are equal, the
synthetic datasets' items agree, and the device prefetcher keeps order,
surfaces errors and releases its queue."""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from rnntransducer_tpu.config import AudioConfig as JaxAudioConfig
from rnntransducer_tpu.data import bucketing as jax_bucketing
from rnntransducer_tpu.data import dataset as jax_dataset
from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.data import bucketing, dataset
from rnntransducer_tpu_torch.data.prefetch import DevicePrefetcher, ordered_readahead

# the packages export a function named like the module
collate = importlib.import_module("rnntransducer_tpu_torch.data.collate")
jax_collate = importlib.import_module("rnntransducer_tpu.data.collate")


@pytest.mark.parametrize("drop_last, shuffle", [(False, True), (True, True), (False, False)])
def test_sampler_batches_equal_the_jax_samplers(drop_last, shuffle):
    rng = np.random.RandomState(3)
    lengths = rng.randint(20, 700, 97)
    label_lengths = rng.randint(1, 40, 97)
    kw = dict(boundaries=(128, 256, 512), batch_size=8, seed=11, shuffle=shuffle,
              drop_last=drop_last, label_lengths=label_lengths, max_label_length=32)
    ours = bucketing.LengthBucketSampler(lengths, **kw)
    theirs = jax_bucketing.LengthBucketSampler(lengths, **kw)
    for epoch in range(3):
        a, b = ours.epoch_batches(epoch), theirs.epoch_batches(epoch)
        assert len(a) == len(b) > 0
        for (ba, ia, na), (bb, ib, nb) in zip(a, b):
            assert ba == bb and na == nb and np.array_equal(ia, ib)
        assert (ours.last_dropped, ours.last_label_dropped) == (
            theirs.last_dropped, theirs.last_label_dropped)
    for n in (0, 128, 129, 600):
        assert bucketing.bucket_for(n, (128, 256)) == jax_bucketing.bucket_for(n, (128, 256))


def _items(seed, n=5, wav=False):
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        labels = rng.randint(1, 72, rng.randint(1, 30)).astype(np.int32)
        if wav:
            items.append({"wav": rng.randn(rng.randint(100, 4000)).astype(np.float32),
                          "labels": labels})
        else:
            items.append({"feats": rng.randn(rng.randint(5, 90), 80).astype(np.float32),
                          "labels": labels})
    return items


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    """Both packages' collation through the native packer, or both through
    numpy (the packer unavailable)."""
    if request.param == "native":
        assert collate._load_pack_lib(), "the native packer must build here"
        assert jax_collate._load_pack_lib()
    else:
        monkeypatch.setattr(collate, "_pack_lib", False)
        monkeypatch.setattr(jax_collate, "_pack_lib", False)
    return request.param


def test_collate_equals_the_jax_packages(packer):
    items = _items(1)
    _equal(collate.collate(items, max_frames=64, max_labels=24),
           jax_collate.collate(items, max_frames=64, max_labels=24))


@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_collate_waveforms_equals_the_jax_packages(packer, transfer):
    items = _items(2, wav=True)
    _equal(collate.collate_waveforms(items, 3000, 24, transfer_dtype=transfer),
           jax_collate.collate_waveforms(items, 3000, 24, transfer_dtype=transfer))
    with pytest.raises(ValueError, match="unknown wav transfer_dtype"):
        collate.collate_waveforms(items, 3000, 24, transfer_dtype="int8")


def test_quantize_waveforms_native_against_numpy(packer):
    """Each path equals the JAX package's same path exactly.  The two paths
    differ only at exact .5 ties (the native packer rounds half away from
    zero, numpy half to even), by one step at most."""
    waves = [it["wav"] for it in _items(4, n=7, wav=True)] + [np.zeros(50, np.float32)]
    got = collate.quantize_waveforms(waves, 2500)
    for a, b in zip(got, jax_collate.quantize_waveforms(waves, 2500)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if packer == "native":
        collate._pack_lib = False
        try:
            plain = collate.quantize_waveforms(waves, 2500)
        finally:
            collate._pack_lib = None
        assert np.array_equal(got[1], plain[1])
        assert np.abs(got[0].astype(np.int32) - plain[0]).max() <= 1


def test_collate_refuses_a_wrong_feature_width():
    items = _items(5)
    with pytest.raises(ValueError, match="feature dim"):
        collate.collate(items, 64, 24, n_mels=40)


@pytest.mark.parametrize("as_waveform", [False, True])
def test_synthetic_dataset_items_equal_the_jax_packages(as_waveform):
    kw = dict(min_sec=0.2, max_sec=0.6, min_labels=3, max_labels=9, seed=7,
              as_waveform=as_waveform)
    ours = dataset.SyntheticAudioDataset(4, AudioConfig(), **kw)
    theirs = jax_dataset.SyntheticAudioDataset(4, JaxAudioConfig(), **kw)
    assert np.array_equal(ours.lengths(), theirs.lengths())
    assert np.array_equal(ours.label_lengths(), theirs.label_lengths())
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert np.array_equal(a["labels"], b["labels"])
        key = "wav" if as_waveform else "feats"
        assert a[key].shape == b[key].shape
        assert np.abs(a[key] - b[key]).max() <= 1e-6


def test_patterned_datasets_equal_the_jax_packages():
    ours = dataset.PatternedSyntheticDataset(3, seed=2)
    theirs = jax_dataset.PatternedSyntheticDataset(3, seed=2)
    assert np.array_equal(ours.lengths(), theirs.lengths())
    for i in range(3):
        assert np.array_equal(ours[i]["feats"], theirs[i]["feats"])
    ours = dataset.PatternedWaveformDataset(2, AudioConfig(), seed=4)
    theirs = jax_dataset.PatternedWaveformDataset(2, JaxAudioConfig(), seed=4)
    for i in range(2):
        wa, la = ours.waveform(i)
        wb, lb = theirs.waveform(i)
        assert np.array_equal(wa, wb) and np.array_equal(la, lb)
        assert np.abs(ours[i]["feats"] - theirs[i]["feats"]).max() <= 1e-6


def test_arrow_shards_load_lazily(tmp_path):
    """``datasets`` is imported only when shards are loaded; with no shard
    directory the loader says so."""
    assert dataset.shard_dirs(str(tmp_path), "train") == []
    (tmp_path / "train" / "1").mkdir(parents=True)
    (tmp_path / "train" / "0").mkdir()
    (tmp_path / "train" / "x").mkdir()
    assert [p[-1] for p in dataset.shard_dirs(str(tmp_path), "train")] == ["0", "1"]


def _host_batches(n):
    for i in range(n):
        yield {"x": np.full((2, 3), i, np.float32), "i": np.asarray([i], np.int64)}


def test_prefetcher_keeps_the_order_and_moves_to_the_device():
    got = [int(b["i"][0]) for b in DevicePrefetcher(_host_batches(9), device="cpu",
                                                    size=2)]
    assert got == list(range(9))
    batch = next(iter(DevicePrefetcher(_host_batches(1), device="cpu")))
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].shape == (2, 3)


def test_prefetcher_raises_the_feeds_error_in_place():
    def failing():
        yield from _host_batches(2)
        raise KeyError("bad row")

    it = DevicePrefetcher(failing(), device="cpu")
    assert [int(b["i"][0]) for b in (next(it), next(it))] == [0, 1]
    with pytest.raises(KeyError, match="bad row"):
        next(it)


def test_prefetcher_close_releases_the_worker_and_its_queue():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"i": np.asarray([i])}
            i += 1

    it = DevicePrefetcher(endless(), device="cpu", size=2)
    next(it)
    time.sleep(0.2)
    assert len(produced) <= 4  # at most `size` queued ahead, one in hand
    it.close()
    assert not it._thread.is_alive() and it._q.empty()


def test_ordered_readahead_keeps_order_and_errors():
    def slow(i):
        def f():
            time.sleep(0.01 * ((7 - i) % 3))
            if i == 5:
                raise RuntimeError("fetch 5")
            return i, threading.current_thread().name
        return f

    it = ordered_readahead((slow(i) for i in range(8)), workers=3, depth=4)
    got = [next(it)[0] for _ in range(5)]
    assert got == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="fetch 5"):
        next(it)
    assert [r[0] for r in ordered_readahead((slow(i) for i in range(5)), workers=1)] \
        == list(range(5))
