"""Parity of the port's fused log-mel frontend (K6's plain version) and its
raw-PCM training path with the JAX package.

The kernel computes what the TPU computes: bf16-rounded operands, fp32
accumulation (Mosaic's dot of fp32 operands is one bf16 pass), the DFT split
into three bf16 products in ``high_precision`` mode, the mel product one
bf16 pass in both modes.  The plain version makes each rounding explicit.

* Against the JAX package's own pieces (``_dft_mats``,
  ``melspec.frame_signal``, ``mean_var_normalize``) composed here with the
  same explicit bf16 rounding, at 1e-4: the power spectrum relative to its
  largest value, and the mel stage applied to one power.  The two stages
  are held apart because the mel product rounds the power to bf16: two
  summation orders of the DFT put a power value near a bf16 rounding
  boundary on either side of it, a one-ulp flip (2^-8 relative) that no
  tolerance near 1e-4 absorbs.
* Against ``logmel_pallas`` itself in interpret mode, which multiplies in
  fp32 on the CPU (7e-6 from the fp32 rfft frontend), so the gap is the
  TPU's bf16 rounding.  In ``high_precision`` only the bf16 mel product is
  left: power and filterbank are each rounded by up to 2^-8 relative, so
  the mel, a sum of positive terms, moves by up to 2^-7 relative and its
  log1p by up to 2^-7 absolute (measured: up to 6.7e-3, mean 1.1e-3).  In
  the default mode the JAX module documents ~5e-2 (``pallas_frontend.py:
  92-93``); that is this data's 99.9th percentile, while low-energy bins,
  where the bf16 DFT cancels, reach 0.075 (mean 8e-3).  So: maximum 0.1 and
  mean 1e-2 by default, maximum 2^-7 and mean 2e-3 in ``high_precision``.
* ``dequantize_wav`` equal to the JAX function on int16 input, the frame
  lengths equal to ``logmel_pallas``'s, and ``loss_fn`` on a 'wav' batch
  equal (1e-6) to ``loss_fn`` on the 'feats' batch the port's
  ``device_frontend`` gives for it.

The JAX package's ``device_frontend`` on the CPU takes the rfft frontend;
the port's takes the kernel's plain version, by design, as its GRU does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.config import AudioConfig as JaxAudioConfig
from rnntransducer_tpu.frontend.melspec import frame_signal as jax_frame_signal
from rnntransducer_tpu.frontend.melspec import mean_var_normalize as jax_normalize
from rnntransducer_tpu.frontend.pallas_frontend import _dft_mats as jax_dft_mats
from rnntransducer_tpu.frontend.pallas_frontend import logmel_pallas
from rnntransducer_tpu.train.state import dequantize_wav as jax_dequantize_wav

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.frontend import fused_frontend as ff
from rnntransducer_tpu_torch.frontend import logmel_fused, logmel_fused_reference
from rnntransducer_tpu_torch.train import TrainState, loss_fn
from rnntransducer_tpu_torch.train.state import dequantize_wav, device_frontend

from _torch_parity import close, model_dict, t

LENGTHS = np.array([4800, 3333, 1601, 250], np.int32)


def _wav(seed=10, lengths=LENGTHS):
    """A ragged batch of seeded speech-band signals plus noise."""
    rng = np.random.RandomState(seed)
    wav = np.zeros((len(lengths), int(lengths.max())), np.float32)
    for i, n in enumerate(lengths):
        tt = np.arange(n) / 16000.0
        f0 = rng.uniform(100, 300)
        sig = sum(np.sin(2 * np.pi * f0 * k * tt + rng.uniform(0, 6.3)) / k
                  for k in range(1, 6))
        wav[i, :n] = 0.1 * sig + 0.01 * rng.randn(n)
    return wav


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32), np.float64)


def _jax_rows(wav, lengths, cfg):
    """Normalised frames from the JAX package's pieces, (rows, n_fft)."""
    w = jnp.asarray(wav)
    if cfg.normalize:
        w = jax_normalize(w, jnp.asarray(lengths))
    frames = jax_frame_signal(w, cfg.n_fft, cfg.hop_length, jnp.asarray(lengths))
    return np.asarray(frames, np.float64).reshape(-1, cfg.n_fft), frames.shape[1]


def _jax_power(rows, cfg, high):
    """re^2 + im^2 from the JAX package's DFT matrices with the kernel's bf16
    rounding made explicit, products and sums in float64."""
    wc, ws, _ = jax_dft_mats(cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate)

    def dot(x, w):
        xh, wh = _bf16(x), _bf16(w)
        if not high:
            return xh @ wh
        return xh @ wh + xh @ _bf16(w - wh) + _bf16(x - xh) @ wh

    re, im = dot(rows, wc), dot(rows, ws)
    return re * re + im * im


def _jax_mel(power, cfg):
    _, _, fb = jax_dft_mats(cfg.n_fft, cfg.window, cfg.n_mels, cfg.sample_rate)
    return np.log1p(_bf16(power) @ _bf16(fb))[:, :cfg.n_mels]


@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_logmel_reference_matches_jax_pieces(normalize, high):
    cfg, jcfg = AudioConfig(normalize=normalize), JaxAudioConfig(normalize=normalize)
    wav = _wav()
    rows_j, F = _jax_rows(wav, LENGTHS, jcfg)
    rows, F_p = ff._frames(t(wav), cfg, t(LENGTHS))
    assert F_p == F
    # the two normalisers differ by an fp32 ulp (tests/test_torch_frontend.py)
    close(rows, rows_j, atol=1e-6)
    # each stage on the same input
    power = ff.dft_power_reference(t(rows_j.astype(np.float32)), cfg, high)
    want = _jax_power(rows_j.astype(np.float32), jcfg, high)
    close(power / want.max(), want / want.max(), atol=1e-4)
    close(ff.mel_reference(power, cfg), _jax_mel(power.numpy(), jcfg), atol=1e-4)
    # and the whole chain is the composition of the two stages
    feats, _ = logmel_fused_reference(t(wav), cfg, t(LENGTHS), high)
    staged = ff.mel_reference(ff.dft_power_reference(rows, cfg, high), cfg)
    np.testing.assert_array_equal(feats.numpy(),
                                  staged.reshape(len(LENGTHS), F, -1).numpy())


@pytest.mark.parametrize("high,max_tol,mean_tol", [(False, 0.1, 1e-2),
                                                   (True, 2.0 ** -7, 2e-3)])
def test_logmel_reference_matches_logmel_pallas(high, max_tol, mean_tol):
    wav = _wav(seed=3)
    want, want_len = logmel_pallas(jnp.asarray(wav), JaxAudioConfig(),
                                   jnp.asarray(LENGTHS), high)
    got, got_len = logmel_fused_reference(t(wav), AudioConfig(), t(LENGTHS), high)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape and got.dtype == torch.float32
    diff = np.concatenate([np.abs(got[i, :n].numpy() - np.asarray(want)[i, :n]).ravel()
                           for i, n in enumerate(np.asarray(want_len))])
    assert diff.max() <= max_tol and diff.mean() <= mean_tol, (diff.max(), diff.mean())


# a 32 ms window (n_fft = 512, 257 bins) and 160 filters: wider than the
# 256 bins and 128 filters the port's earlier kernel took
WIDE = {"window_size_sec": 0.032, "n_mels": 160}


@pytest.mark.parametrize("high,max_tol,mean_tol", [(False, 0.1, 1e-2),
                                                   (True, 2.0 ** -7, 2e-3)])
def test_logmel_reference_matches_logmel_pallas_at_wider_widths(high, max_tol,
                                                                 mean_tol):
    """The plain version against ``logmel_pallas`` at n_fft = 512 and 160
    mel filters, at the bounds derived above."""
    wav = _wav(seed=11)
    want, want_len = logmel_pallas(jnp.asarray(wav), JaxAudioConfig(**WIDE),
                                   jnp.asarray(LENGTHS), high)
    got, got_len = logmel_fused_reference(t(wav), AudioConfig(**WIDE), t(LENGTHS), high)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape == (len(LENGTHS), got.shape[1], 160)
    diff = np.concatenate([np.abs(got[i, :n].numpy() - np.asarray(want)[i, :n]).ravel()
                           for i, n in enumerate(np.asarray(want_len))])
    assert diff.max() <= max_tol and diff.mean() <= mean_tol, (diff.max(), diff.mean())


@pytest.mark.parametrize("audio", [{}, WIDE])
@pytest.mark.parametrize("high", [False, True])
def test_kernel_operands_compute_the_plain_version(audio, high):
    """The kernel's padded operands (bins and filters to 64, samples to 32,
    the DFT as cos / sin rows with their bf16 low parts, each mel pass over
    its window of bins) give the plain version's power and mel: the same
    bf16 values, products summed in fp32 (float64 here), within 1e-5 of the
    largest power and 1e-5 absolute."""
    cfg = AudioConfig(**audio)
    Kf, Kbp, Mp = ff.kernel_dims(cfg)
    assert (Kf % 32, Kbp % 64, Mp % 64) == (0, 0, 0)
    assert Kbp >= cfg.n_fft // 2 + 1 and Mp >= cfg.n_mels
    bd, bm = (a.double() for a in ff.kernel_mats_reference(cfg))
    assert bd.shape == (Kbp // 64, 4, 64, Kf) and bm.shape == (Mp // 64, 64, Kbp)
    rows, _ = ff._frames(t(_wav(seed=12)), cfg, t(LENGTHS))
    x = torch.nn.functional.pad(rows, (0, Kf - cfg.n_fft)).double()
    xh = x.float().to(torch.bfloat16).double()
    xl = (x - xh).float().to(torch.bfloat16).double()
    w = bd.transpose(0, 1).reshape(4, Kbp, Kf)   # cos, sin, cos-low, sin-low
    re, im = xh @ w[0].t(), xh @ w[1].t()
    if high:
        re = re + xl @ w[0].t() + xh @ w[2].t()
        im = im + xl @ w[1].t() + xh @ w[3].t()
    power = re * re + im * im
    want = ff.dft_power_reference(rows, cfg, high).double()
    K = cfg.n_fft // 2 + 1
    assert not power[:, K:].any()
    scale = want.abs().max().item()
    assert (power[:, :K] - want[:, :K]).abs().max().item() <= 1e-5 * scale
    # each mel pass multiplies only its window of 32-bin chunks: its filters
    # are zero outside it
    k0, ncm = ff.kernel_mel_windows(cfg)
    assert len(k0) == Mp // 64 and 2 <= ncm <= Kbp // 32
    pw = power.float().to(torch.bfloat16).double()
    parts = []
    for q, k in enumerate(k0):
        window = slice(32 * k, 32 * (k + ncm))
        outside = torch.ones(Kbp, dtype=torch.bool)
        outside[window] = False
        assert not bm[q][:, outside].any()
        parts.append(pw[:, window] @ bm[q][:, window].t())
    mel = torch.log1p(torch.cat(parts, dim=1))[:, :cfg.n_mels]
    want_mel = ff.mel_reference(power.float(), cfg).double()
    assert (mel - want_mel).abs().max().item() <= 1e-5


@pytest.mark.parametrize("audio", [{}, WIDE])
@pytest.mark.parametrize("high", [False, True])
def test_wgmma_operands_compute_the_plain_version(audio, high):
    """The wgmma engine's operands read as its descriptors read them (8 x 8
    core matrices, the next 8 samples 128 bytes on, the next 8 rows one
    stage row-group on) and its accumulator columns taken as its epilogue
    takes them (cos and sin of 32 bins in turn) give the plain version's
    power and mel, within 1e-5 of the largest power and 1e-5 absolute."""
    cfg = AudioConfig(**audio)
    Kf, Kbp, Mp = ff.kernel_dims(cfg)
    bd, bm = (a.double() for a in ff.kernel_mats_wgmma(cfg))
    assert bd.shape == (Kbp // 64, Kf // 32, 2, 16, 4, 8, 8)
    assert bm.shape == (Mp // 64, Kbp // 32, 8, 4, 8, 8)
    rows, _ = ff._frames(t(_wav(seed=13)), cfg, t(LENGTHS))
    x = torch.nn.functional.pad(rows, (0, Kf - cfg.n_fft)).double()
    xh = x.float().to(torch.bfloat16).double()
    xl = (x - xh).float().to(torch.bfloat16).double()
    n, k = torch.arange(128)[:, None], torch.arange(Kf)[None, :]
    power = []
    for p in range(Kbp // 64):
        hi, lo = (bd[p, k // 32, part, n // 8, k % 32 // 8, n % 8, k % 8] for part in (0, 1))
        acc = xh @ hi.t()
        if high:
            acc = acc + xl @ hi.t() + xh @ lo.t()
        re = torch.cat([acc[:, 0:32], acc[:, 64:96]], 1)
        im = torch.cat([acc[:, 32:64], acc[:, 96:128]], 1)
        power.append(re * re + im * im)
    power = torch.cat(power, 1)
    want = ff.dft_power_reference(rows, cfg, high).double()
    K = cfg.n_fft // 2 + 1
    assert not power[:, K:].any()
    assert (power[:, :K] - want[:, :K]).abs().max().item() <= 1e-5 * want.abs().max().item()
    k0, ncm = ff.kernel_mel_windows(cfg)
    pw = power.float().to(torch.bfloat16).double()
    f, b = torch.arange(64)[:, None], torch.arange(32 * ncm)[None, :]
    parts = []
    for q, c0 in enumerate(k0):
        fb = bm[q, c0 + b // 32, f // 8, b % 32 // 8, f % 8, b % 8]
        parts.append(pw[:, 32 * c0:32 * (c0 + ncm)] @ fb.t())
    mel = torch.log1p(torch.cat(parts, dim=1))[:, :cfg.n_mels]
    assert (mel - ff.mel_reference(power.float(), cfg).double()).abs().max().item() <= 1e-5


def test_kernel_plan_follows_the_shared_memory():
    """The wgmma engine takes 128-row tiles where they fit, 64 in high mode
    at the flagship width and at n_fft = 512 in both modes; n_fft = 1024 in
    high mode leaves the mma.sync engine's 32-row tiles; a card with less shared memory gets smaller
    tiles, and a window too wide for 16 rows takes the chunked engine, whose
    shared memory does not grow with n_fft, instead of raising."""
    smem = 232448
    base, wide = AudioConfig(), AudioConfig(**WIDE)
    assert ff.kernel_plan(base, False, smem) == ("wgmma", 128)
    assert ff.kernel_plan(base, True, smem) == ("wgmma", 64)
    assert ff.kernel_plan(wide, False, smem) == ("wgmma", 64)
    assert ff.kernel_plan(wide, True, smem) == ("wgmma", 64)
    wider = AudioConfig(window_size_sec=0.064)
    assert ff.kernel_plan(wider, False, smem) == ("wgmma", 64)
    assert ff.kernel_plan(wider, True, smem) == ("mma", 32)
    assert ff.kernel_smem_bytes(("wgmma", 128), base, False) == (
        128 + 3 * 8192 + 2 * 128 * (416 + 256))
    assert ff.kernel_smem_bytes(("wgmma", 64), wide, True) == (
        128 + 3 * 16384 + 2 * 64 * (2 * 512 + 320))
    assert ff.kernel_smem_bytes(("mma", 32), wider, True) == 2 * (
        2 * 32 * 1032 + 32 * 584 + 3 * 4 * 64 * 40)
    assert ff.kernel_plan(base, False, 101376) == ("mma", 32)
    widest = AudioConfig(window_size_sec=0.5)
    assert ff.kernel_smem_bytes(("mma", 16), widest, True) > smem
    assert ff.kernel_plan(widest, True, smem) == ("chunked", 32)
    assert ff.kernel_smem_bytes(("chunked", 32), widest, True) == 2 * (64 + 256) * 40


def test_frame_lengths_match_logmel_pallas_without_lengths():
    wav = _wav(seed=4, lengths=np.array([1000, 1000], np.int32))
    _, want_len = logmel_pallas(jnp.asarray(wav), JaxAudioConfig())
    feats, got_len = logmel_fused_reference(t(wav), AudioConfig())
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert feats.shape == (2, 1000 // 160 + 1, 80)


def test_logmel_fused_on_cpu_is_the_plain_version():
    wav = t(_wav(seed=5))
    before = logmel_fused.launches
    for high in (False, True):
        got = logmel_fused(wav, AudioConfig(), t(LENGTHS), high)
        want = logmel_fused_reference(wav, AudioConfig(), t(LENGTHS), high)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert logmel_fused.launches == before


def test_logmel_kernel_raises_instead_of_falling_back():
    rows = torch.zeros(4, 400)
    with pytest.raises(ValueError, match="runs on cuda"):
        ff.logmel_rows_cuda(rows, AudioConfig())
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        logmel_fused(rows.to("meta"), AudioConfig())


def _quantize(wav):
    """Peak-scaled int16 and per-row scales (data/collate.py's form)."""
    peak = np.abs(wav).max(axis=1)
    scale = np.where(peak > 0, peak / 32767.0, 0.0).astype(np.float32)
    q = np.round(wav / np.where(scale > 0, scale, 1.0)[:, None])
    return np.clip(q, -32767, 32767).astype(np.int16), scale


def test_dequantize_wav_matches_jax():
    q, scale = _quantize(_wav(seed=6))
    want = jax_dequantize_wav({"wav": jnp.asarray(q), "wav_scale": jnp.asarray(scale)})
    got = dequantize_wav({"wav": t(q), "wav_scale": t(scale)})
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = t(_wav(seed=6))
    assert dequantize_wav({"wav": f}) is f


def test_loss_fn_on_wav_batch_equals_loss_fn_on_its_features():
    d = {"model": model_dict(n_mels=80, vocab=11),
         "data": {"audio": {"spec_augment": False}},
         "train": {"precision": "fp32", "joint_chunk_frames": 256, "max_steps": 10}}
    cfg = pcfg.Config.from_dict(d)
    state = TrainState.create(cfg, "cpu")
    q, scale = _quantize(_wav(seed=7))
    rng = np.random.RandomState(8)
    B, U = len(LENGTHS), 3
    targets = torch.from_numpy(rng.randint(1, 11, size=(B, U)))
    text = {"text_in": torch.cat([torch.zeros(B, 1, dtype=torch.int64), targets], 1),
            "text_lengths": torch.tensor([4, 3, 2, 1]), "targets": targets,
            "target_lengths": torch.tensor([3, 2, 1, 0])}
    wav_batch = {"wav": t(q), "wav_scale": t(scale), "wav_lengths": t(LENGTHS), **text}
    feats, feat_lengths = device_frontend(cfg.data.audio, dequantize_wav(wav_batch),
                                          wav_batch["wav_lengths"])
    assert feat_lengths.tolist() == (LENGTHS // 160 + 1).tolist()
    feats_batch = {"feats": feats, "feat_lengths": feat_lengths, **text}
    params = state.params
    out = []
    for batch in (wav_batch, feats_batch):
        loss = loss_fn(state.model, cfg, params, batch, None, deterministic=True)
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    (lw, gw), (lf, gf) = out
    assert torch.isfinite(lw)
    close(lw, lf.detach().numpy(), atol=1e-6)
    for name, a, b in zip(params, gw, gf):
        close(a, b.numpy(), atol=1e-6, err_msg=name)


@pytest.mark.cuda
def test_logmel_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cfg, high in ((AudioConfig(), False), (AudioConfig(), True),
                      (AudioConfig(**WIDE), False), (AudioConfig(**WIDE), True)):
        wav = t(_wav(seed=9)).to("cuda")
        rows, _ = ff._frames(wav, cfg, t(LENGTHS).to("cuda"))
        K = cfg.n_fft // 2 + 1
        want_power = ff.dft_power_reference(rows, cfg, high)[:, :K]
        scale = want_power.abs().max()
        for plan in (None, ("mma", 32)):   # the wrapper's pick, and the mma.sync engine
            power = torch.empty((rows.shape[0], ff.kernel_dims(cfg)[1]), device="cuda")
            got = ff.logmel_rows_cuda(rows, cfg, high, power, plan)
            assert ((power[:, :K] - want_power).abs().max() / scale).item() <= 1e-5
            assert (got - ff.mel_reference(power, cfg)).abs().max().item() <= 1e-4
