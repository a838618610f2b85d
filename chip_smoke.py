#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rnntransducer_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (each raises, and the script exits non-zero, on failure):

1. Print the card's name and power limit, require CUDA, build every kernel
   of the serving path from ``rnntransducer_tpu_torch/csrc`` (one ``nvcc``
   per source, started together).
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time both.
3. Drive the serving path: ``Recognizer.transcribe_batch`` / ``transcribe``
   with greedy decoding on ``base_config()`` at full width (8-layer
   bidirectional GRU encoder, H=1024), random weights from a seeded
   ``torch.Generator`` passed through the flax-layout weight bridge, in bf16
   and fp32.  The kernels' launch counts are set to 0 before and read after;
   every GRU scan must have gone through the kernel.  Then the encoder is
   run again with the plain GRU on the card, and outputs and greedy tokens
   are compared.
4. Print one JSON line describing every kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Imports nothing from JAX or from the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from rnntransducer_tpu_torch.config import base_config  # noqa: E402
from rnntransducer_tpu_torch.decode import greedy as greedy_mod  # noqa: E402
from rnntransducer_tpu_torch.models import cells  # noqa: E402
from rnntransducer_tpu_torch.ops import build, rnn_kernels  # noqa: E402
from rnntransducer_tpu_torch.serve import Recognizer  # noqa: E402
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer  # noqa: E402
from rnntransducer_tpu_torch.utils.weights import random_flax_params  # noqa: E402

KERNELS = ["gru_fwd"]
T_FRAMES = 512                  # 5.11 s at a 10 ms hop: 81760 samples
N_SAMPLES = (T_FRAMES - 1) * 160
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain, same inputs on the card:
# fp32: both compute in fp32 and differ only in summation order (~1e-7 per
#   step); the GRU's gates keep that from growing over 512 steps.
# bf16: outputs are rounded to bf16, whose ulp is 2^-8 = 0.0039 for |h| < 1;
#   a one-ulp flip in a rounded h feeds the next step, so allow ~5 ulps.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Encoder outputs after 16 scans, kernel vs plain GRU:
# fp32: summation-order noise through 8 layers, far below 1e-4.
# bf16: rounding flips compound across layers; 8 ulps at |x| < 2 (2^-7 each).
ENCODER_TOL = {"fp32": 1e-4, "bf16": 6.25e-2}
# Joint logits: first-symbol decisions are compared where the top-2 margin
# exceeds this (the encoder tolerance through the 1024-wide joint).
LOGIT_TOL = {"fp32": 1e-3, "bf16": 0.125}


def _sync_time(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _gru_inputs(T, B, H, dtype, gen):
    s = 1.0 / H ** 0.5
    xw = torch.randn(T, B, 3 * H, device=DEVICE, generator=gen).to(dtype)
    w = ((torch.rand(H, 3 * H, device=DEVICE, generator=gen) * 2 - 1) * s).to(dtype)
    b = ((torch.rand(3 * H, device=DEVICE, generator=gen) * 2 - 1) * s).to(dtype)
    h0 = (torch.randn(B, H, device=DEVICE, generator=gen) * 0.5).to(dtype)
    lengths = torch.randint(1, T + 1, (B,), device=DEVICE, generator=gen)
    lengths[0] = T
    if B > 1:
        lengths[-1] = 1
    return xw, w, b, h0, lengths


def gru_bound_ms(T, B, H, dtype, lengths) -> tuple:
    """Least time for one scan: inputs read once (xw only at valid steps),
    outputs written once, over HBM; the recurrent product at valid steps
    over the peak rate of the inputs' type.  Returns (ms, bound_by)."""
    e = torch.tensor([], dtype=dtype).element_size()
    valid = int(lengths.sum())
    nbytes = (valid * 3 * H * e + 3 * H * H * e + 3 * H * e + B * H * e + B * 4
              + T * B * H * e + B * H * e)
    flops = 2.0 * valid * H * 3 * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(gen):
    """GRU kernel vs its plain version at H=1024, T=512."""
    H, T = 1024, T_FRAMES
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        # B=100 takes two passes through the kernel's 64-row dot buffer
        for B in (1, 8, 64, 100):
            for reverse in (False, True):
                xw, w, b, h0, lengths = _gru_inputs(T, B, H, dtype, gen)
                got, got_fin = rnn_kernels.gru_scan(xw, w, b, h0, lengths, reverse)
                want, want_fin = rnn_kernels.gru_scan_reference(
                    xw, w, b, h0, lengths, reverse)
                torch.cuda.synchronize()
                err = max((got.float() - want.float()).abs().max().item(),
                          (got_fin.float() - want_fin.float()).abs().max().item())
                print(f"gru_fwd check dtype={str(dtype)[6:]} B={B} T={T} H={H} "
                      f"reverse={reverse} max_abs_err={err:.3e} "
                      f"tol={KERNEL_TOL[dtype]:.0e}", flush=True)
                if not (err <= KERNEL_TOL[dtype]):
                    raise AssertionError(f"gru_fwd disagrees with its plain "
                                         f"version: {err} > {KERNEL_TOL[dtype]}")
                worst = max(worst, err)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8, 64):
            xw, w, b, h0, lengths = _gru_inputs(T, B, H, dtype, gen)
            ms = _sync_time(lambda: rnn_kernels.gru_scan(xw, w, b, h0, lengths), 5)
            plain = _sync_time(
                lambda: rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths), 2)
            bound, bound_by = gru_bound_ms(T, B, H, dtype, lengths)
            times[(dtype, B)] = (ms, plain, bound, bound_by)
            print(f"gru_fwd time dtype={str(dtype)[6:]} B={B} T={T} H={H}: "
                  f"kernel {ms:.3f} ms ({ms / T * 1e3:.2f} us/step), plain "
                  f"{plain:.3f} ms ({plain / T * 1e3:.2f} us/step), bound "
                  f"{bound:.4f} ms by {bound_by}", flush=True)
    return worst, times


def _waves(n):
    """Seeded synthetic speech-band signals, the longest exactly T_FRAMES."""
    rng = np.random.RandomState(SEED)
    out = []
    for i in range(n):
        length = N_SAMPLES if i == 0 else int(rng.randint(N_SAMPLES * 3 // 4,
                                                          N_SAMPLES))
        t = np.arange(length) / 16000.0
        f0 = rng.uniform(100, 300)
        sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.3)) / k
                  for k in range(1, 6))
        out.append((0.1 * sig + 0.01 * rng.randn(length)).astype(np.float32))
    return out


def _request(fn, *args):
    count0 = rnn_kernels.gru_scan.launches
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, rnn_kernels.gru_scan.launches - count0


def _first_symbol_logits(model, enc):
    """(B, T, V) joint logits of every frame against the blank-state
    prediction-net output: the first decision greedy makes at each frame."""
    B, T = enc.shape[0], enc.shape[1]
    blank = torch.zeros((B,), dtype=torch.int64, device=enc.device)
    dec0, _ = model.predict_step(blank, None)
    logits = model.joint_step(enc.reshape(B * T, -1), dec0.repeat_interleave(T, 0))
    return logits.view(B, T, -1).float()


def _encode_plain(model, feats, lengths):
    """The encoder with the plain GRU on the card (comparison only)."""
    cells.gru_scan = rnn_kernels.gru_scan_reference
    try:
        return model.encode(feats, lengths)[0]
    finally:
        cells.gru_scan = rnn_kernels.gru_scan


def phase_profile(rec, waves):
    """Device busy share and device time by kernel over one request."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.transcribe_batch(waves)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(r[0] for r in rows) / 1e3
    if device_ms == 0.0:
        print("profile: the profiler saw no device time (not measured)", flush=True)
        return
    print(f"profile bf16 batch of {len(waves)} (profiler on): wall {wall_ms:.1f} ms, "
          f"device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%)",
          flush=True)
    for dev_us, count, name in sorted(rows, reverse=True)[:8]:
        print(f"profile   {dev_us / 1e3:9.2f} ms  {count:7d} calls  {name[:70]}",
              flush=True)


def phase_serving(flax_params, tokenizer, waves):
    cfg = base_config()
    layers = cfg.model.transnet.num_layers * (2 if cfg.model.transnet.bidirectional else 1)
    recognizers = {}
    for precision in ("bf16", "fp32"):
        recognizers[precision] = Recognizer(cfg, flax_params, tokenizer,
                                            precision=precision, device=DEVICE)
        recognizers[precision].transcribe(waves[0][:16000])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, read after the last request -----
    rnn_kernels.gru_scan.launches = 0
    results = {}
    for precision, rec in recognizers.items():
        one, ms1, n1 = _request(rec.transcribe_batch, waves[:1])
        eight, ms8, n8 = _request(rec.transcribe_batch, waves)
        single, ms_s, n_s = _request(rec.transcribe, waves[3])
        t3 = len(waves[3]) // 160 + 1
        for n, want, what in ((n1, layers * T_FRAMES, "batch of 1"),
                              (n8, layers * T_FRAMES, "batch of 8"),
                              (n_s, layers * t3, "transcribe")):
            print(f"{precision} {what}: gru_fwd launches {n} (expected {want})",
                  flush=True)
            if n != want:
                raise AssertionError(f"{precision} {what}: {n} GRU kernel launches, "
                                     f"expected {want}")
        for texts in (one, eight, [single]):
            if not all(isinstance(s, str) for s in texts):
                raise AssertionError("transcripts must be strings")
        print(f"{precision} request latency: batch of 1 {ms1:.1f} ms, batch of 8 "
              f"{ms8:.1f} ms, transcribe {ms_s:.1f} ms", flush=True)
        print(f"{precision} transcripts (batch of 8): {eight}", flush=True)
        results[precision] = {"latency_ms": {"batch1": ms1, "batch8": ms8,
                                             "transcribe": ms_s}}
    launches = rnn_kernels.gru_scan.launches
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    phase_profile(recognizers["bf16"], waves)

    # ---- kernel vs plain GRU through the whole encoder -------------------
    for precision, rec in recognizers.items():
        model = rec.model
        with torch.inference_mode():
            feats, feat_lengths = rec._features(waves)
            feats = feats.to(next(model.parameters()).dtype)
            enc_ms = _sync_time(lambda: model.encode(feats, feat_lengths), 2)
            enc = model.encode(feats, feat_lengths)[0]
            t0 = time.perf_counter()
            enc_plain = _encode_plain(model, feats, feat_lengths)
            torch.cuda.synchronize()
            plain_enc_ms = (time.perf_counter() - t0) * 1e3
            if enc.shape != (len(waves), T_FRAMES, cfg.model.transnet.output_size):
                raise AssertionError(f"encoder output shape {tuple(enc.shape)}")
            if not torch.isfinite(enc.float()).all():
                raise AssertionError("encoder output is not finite")
            mask = (torch.arange(T_FRAMES, device=DEVICE)[None, :]
                    < feat_lengths[:, None])[..., None]
            enc_err = ((enc.float() - enc_plain.float()).abs() * mask).max().item()
            lk = _first_symbol_logits(model, enc)
            lp = _first_symbol_logits(model, enc_plain)
            top2 = lp.topk(2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1] > LOGIT_TOL[precision]) & mask[..., 0]
            flips = ((lk.argmax(-1) != lp.argmax(-1)) & sure).sum().item()
            tok_k, len_k = greedy_mod.greedy_decode_frames(
                model, enc, feat_lengths,
                greedy_mod.init_greedy_carry(model, len(waves), 0, 512))[3:5]
            tok_p, len_p = greedy_mod.greedy_decode_frames(
                model, enc_plain, feat_lengths,
                greedy_mod.init_greedy_carry(model, len(waves), 0, 512))[3:5]
        same = [bool(torch.equal(tok_k[i, :len_k[i]], tok_p[i, :len_p[i]]))
                for i in range(len(waves))]
        all_sure = [bool(sure[i, :feat_lengths[i]].all()) for i in range(len(waves))]
        print(f"{precision} encoder: kernel {enc_ms:.1f} ms, plain GRU "
              f"{plain_enc_ms:.1f} ms; max |enc diff| {enc_err:.3e} "
              f"(tol {ENCODER_TOL[precision]:.1e}); first-symbol argmax flips "
              f"where margin > {LOGIT_TOL[precision]}: {flips}; greedy tokens "
              f"equal per utterance {same}", flush=True)
        if not enc_err <= ENCODER_TOL[precision]:
            raise AssertionError(f"{precision}: encoder outputs differ by {enc_err}")
        if flips:
            raise AssertionError(f"{precision}: {flips} confident first-symbol "
                                 "decisions differ between kernel and plain GRU")
        for i, (eq, ok) in enumerate(zip(same, all_sure)):
            if ok and not eq:
                raise AssertionError(f"{precision}: utterance {i} decodes "
                                     "differently with every margin above tolerance")
        results[precision].update(encoder_ms=enc_ms, plain_encoder_ms=plain_enc_ms,
                                  encoder_max_abs_err=enc_err)
    return launches, results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all(KERNELS)
    print(f"built {KERNELS} in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst, times = phase_kernels(gen)

    cfg = base_config()
    flax_params = random_flax_params(cfg.model, torch.Generator().manual_seed(SEED))
    tokenizer = GraphemeTokenizer.default(cfg.model.jointnet.num_classes)
    launches, results = phase_serving(flax_params, tokenizer, _waves(8))
    print("serving " + json.dumps(results), flush=True)

    ms, plain, bound, bound_by = times[(torch.bfloat16, 8)]
    kernels = [{
        "name": "gru_fwd", "route": "cuda",
        "source": "rnntransducer_tpu_torch/csrc/gru_fwd.cu",
        "replaces": "rnntransducer_tpu/ops/rnn_pallas.py:92",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
