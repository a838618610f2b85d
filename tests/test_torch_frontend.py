"""Parity of the port's log-mel frontend with the JAX frontend on ragged
batches, and with the committed frontend goldens at the tolerances
tests/test_frontend.py holds the JAX frontend to."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.config import AudioConfig as JaxAudioConfig
from rnntransducer_tpu.frontend import LogMelFrontend as JaxLogMel
from rnntransducer_tpu.frontend.melspec import frame_signal as jax_frame_signal

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.frontend import (LogMelFrontend, frame_signal,
                                              hann_window, mel_filterbank)

from _torch_parity import close, t


def _goldens():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "frontend_goldens.npz")
    return np.load(path)


@pytest.mark.parametrize("normalize", [True, False])
def test_logmel_matches_jax_on_ragged_batch(normalize):
    rng = np.random.RandomState(10)
    lengths = np.array([4800, 3333, 1601, 250], np.int32)
    wav = np.zeros((4, 4800), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.randn(n) * 0.3
    want, want_len = JaxLogMel(JaxAudioConfig(normalize=normalize))(
        jnp.asarray(wav), jnp.asarray(lengths))
    got, got_len = LogMelFrontend(AudioConfig(normalize=normalize))(
        t(wav), t(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, n in enumerate(np.asarray(want_len)):
        close(got[i, :n], np.asarray(want)[i, :n], atol=1e-4, rtol=1e-4,
              err_msg=f"row {i}")


def test_logmel_matches_golden():
    g = _goldens()
    feats, lengths = LogMelFrontend(AudioConfig(normalize=False))(
        t(g["wav_seed1_2x8000"]))
    close(feats, g["logmel_seed1"], atol=1e-4, rtol=1e-4)
    assert lengths.tolist() == [8000 // 160 + 1] * 2


def test_filterbank_and_window_match_goldens():
    np.testing.assert_allclose(mel_filterbank(201, 80, 16000),
                               _goldens()["fbank_201_80_16000"], atol=1e-6)
    np.testing.assert_allclose(hann_window(400), torch.hann_window(400).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("S", [1000, 150])
def test_frame_signal_matches_jax(S):
    """Framing with the tail-reflection fix-up, including a batch shorter
    than the reflect pad (numpy's repeated reflection)."""
    rng = np.random.RandomState(11)
    wav = rng.randn(4, S).astype(np.float32)
    lengths = np.array([S, S * 48 // 100, S * 43 // 100, 61], np.int32)
    want = np.asarray(jax_frame_signal(jnp.asarray(wav), 400, 160,
                                       jnp.asarray(lengths)))
    got = frame_signal(t(wav), 400, 160, t(lengths)).numpy()
    assert got.shape == want.shape
    for b in range(4):
        n_valid = max(int(lengths[b]), 1) // 160 + 1
        np.testing.assert_array_equal(got[b, :n_valid], want[b, :n_valid])
