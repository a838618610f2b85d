"""K6 for any window (frontend/fused_frontend.py, the chunked engine): the
plan never raises, the tiles that ran before keep their plan, and at
n_fft = 4096 the plain log-mel stays within the bounds tests/test_torch_logmel.py
derives against ``logmel_pallas`` in interpret mode: maximum 0.1 and mean
1e-2 by default, 2^-7 and 2e-3 in ``high_precision``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.config import AudioConfig as JaxAudioConfig
from rnntransducer_tpu.frontend.pallas_frontend import logmel_pallas

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.frontend import fused_frontend as ff
from rnntransducer_tpu_torch.frontend import logmel_fused_reference

from _torch_parity import t

SMEM = 232448
# n_fft = 4096 (a 256 ms window at 16 kHz), hop 1024, 128 filters; and 8192
N4096 = dict(window_size_sec=0.256, window_stride_sec=0.064, n_mels=128)
N8192 = dict(window_size_sec=0.512, window_stride_sec=0.128, n_mels=128)


@pytest.mark.parametrize("audio, want", [
    (N4096, (("mma", 16), ("chunked", 32))),
    (N8192, (("chunked", 32), ("chunked", 32)))])
def test_kernel_plan_takes_any_window(audio, want):
    cfg = AudioConfig(**audio)
    assert cfg.n_fft in (4096, 8192)
    assert (ff.kernel_plan(cfg, False, SMEM), ff.kernel_plan(cfg, True, SMEM)) == want
    # even a card with a quarter of the shared memory runs it
    assert ff.kernel_plan(cfg, True, SMEM // 4) == ("chunked", 32)


def test_tiles_that_fit_keep_their_plan():
    for audio, high, plan in (({}, False, ("wgmma", 128)), ({}, True, ("wgmma", 64)),
                              ({"window_size_sec": 0.064}, True, ("mma", 32))):
        assert ff.kernel_plan(AudioConfig(**audio), high, SMEM) == plan


def _wav(seed, lengths):
    rng = np.random.RandomState(seed)
    wav = np.zeros((len(lengths), int(max(lengths))), np.float32)
    for i, n in enumerate(lengths):
        x = rng.randn(n).astype(np.float32)
        x[1:] += 0.8 * x[:-1]
        wav[i, :n] = x
    return wav


@pytest.mark.parametrize("high,max_tol,mean_tol", [(False, 0.1, 1e-2),
                                                   (True, 2.0 ** -7, 2e-3)])
def test_logmel_reference_matches_logmel_pallas_at_n_fft_4096(high, max_tol, mean_tol):
    lengths = np.array([9000, 6100], np.int32)
    wav = _wav(13, lengths)
    want, want_len = logmel_pallas(jnp.asarray(wav), JaxAudioConfig(**N4096),
                                   jnp.asarray(lengths), high)
    got, got_len = logmel_fused_reference(t(wav), AudioConfig(**N4096), t(lengths), high)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape and got.shape[2] == 128
    diff = np.concatenate([np.abs(got[i, :n].numpy() - np.asarray(want)[i, :n]).ravel()
                           for i, n in enumerate(np.asarray(want_len))])
    assert diff.max() <= max_tol and diff.mean() <= mean_tol, (diff.max(), diff.mean())


@pytest.mark.parametrize("high", [False, True])
def test_chunked_engine_operands_compute_the_plain_version(high):
    """The chunked engine reads the mma.sync engine's n-major operands; at
    n_fft = 4096 they give the plain power (float64 sums of the same bf16
    values, 1e-5 of the largest power)."""
    cfg = AudioConfig(**N4096)
    Kf, Kbp, _ = ff.kernel_dims(cfg)
    bd, _ = (a.double() for a in ff.kernel_mats_reference(cfg))
    rows, _ = ff._frames(t(_wav(14, np.array([7000]))), cfg, t(np.array([7000])))
    x = torch.nn.functional.pad(rows, (0, Kf - cfg.n_fft)).double()
    xh = x.float().to(torch.bfloat16).double()
    xl = (x.float() - xh.float()).to(torch.bfloat16).double()
    re = xh @ bd[:, 0].reshape(Kbp, Kf).T
    im = xh @ bd[:, 1].reshape(Kbp, Kf).T
    if high:
        re = re + xh @ bd[:, 2].reshape(Kbp, Kf).T + xl @ bd[:, 0].reshape(Kbp, Kf).T
        im = im + xh @ bd[:, 3].reshape(Kbp, Kf).T + xl @ bd[:, 1].reshape(Kbp, Kf).T
    power = re * re + im * im
    K = cfg.n_fft // 2 + 1
    want = ff.dft_power_reference(rows, cfg, high)[:, :K].double()
    assert ((power[:, :K] - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert not power[:, K:].any()


@pytest.mark.cuda
def test_wide_logmel_kernel_matches_plain_version_on_the_card():
    """n_fft = 4096 in both modes, on the plan the wrapper picks and on the
    chunked engine: power within 1e-5 of its largest value, the mel stage
    within 1e-4, end to end within 2^-7 + 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = AudioConfig(**N4096)
    lengths = np.array([9000, 6100, 4000], np.int32)
    wav = t(_wav(15, lengths)).to("cuda")
    rows, _ = ff._frames(wav, cfg, t(lengths).to("cuda"))
    K = cfg.n_fft // 2 + 1
    for high in (False, True):
        want_power = ff.dft_power_reference(rows, cfg, high)[:, :K]
        want = ff.mel_reference(want_power, cfg)
        for plan in (None, ("chunked", 32)):
            power = torch.empty((rows.shape[0], ff.kernel_dims(cfg)[1]), device="cuda")
            got = ff.logmel_rows_cuda(rows, cfg, high, power, plan)
            scale = want_power.abs().max()
            assert ((power[:, :K] - want_power).abs().max() / scale).item() <= 1e-5
            assert (got - ff.mel_reference(power, cfg)).abs().max().item() <= 1e-4
            assert (got - want).abs().max().item() <= 2.0 ** -7 + 1e-4
