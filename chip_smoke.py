#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rnntransducer_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (each raises, and the script exits non-zero, on failure):

1. Print the card's name and power limit, require CUDA, build every kernel
   from ``rnntransducer_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together): gru_fwd (K1), gru_bwd (K2), lstm_fwd (K3), lstm_bwd (K4),
   rnnt_sweep (K5), logmel (K6).  Print the SM count and the shared memory
   a block may opt in to, read from the card: every co-residency limit and
   route comes from them.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the training and serving paths give it, and time both: K1 and K2
   (persistent: one launch per forward scan, the gates GEMM and the chain
   per backward scan) at H=1024, T=512, B in {1, 8, 64, 100}, both
   directions, fp32 and bf16 (K2 also against autograd through the plain
   forward loop, its gates GEMM alone against the plain product and, for
   timing only, beside cuBLAS's GEMM of the same shape), and their limit
   on this card (the largest H runs persistent, 1 + 2 launches, the next on
   the per-step kernels, T + T+1, both against the plain versions, and
   ``GRUScanFunction`` there against autograd of the plain loop); K3 and
   K4 (persistent in the same way) at the flagship prediction network
   (T=49, H=1024, B in {1, 64, 100}) and tiny_config's encoder (B in
   {8, 64}, T=512, H=320), both directions, fp32 and bf16, ragged lengths
   including 1 and T (K4 also against autograd), their limit (as the
   GRU's), their times at B in {1, 8, 64} beside the per-step route's and,
   at H=320, both block widths; a timing-only yardstick of cuDNN's
   one-layer LSTM / GRU against the port's layer; the per-step kernels
   above their whole-slice limits (route "step_chunked", the slice streamed
   in K chunks: fp32 GRU backward H=1280, fp32 LSTM H=2048 forward and
   backward, bf16 GRU forward H=4800, bf16 LSTM backward H=3584, against
   the plain versions and, fp32 backward, autograd), each timed beside the
   whole-slice kernel at its last H; K5 at the flagship lattice (B=64 and
   the 2B of one loss, T=512, U+1=49), a ragged T=300 and T=9000; K6 at the
   flagship raw-PCM shape (32768 frame rows), a ragged batch, n_fft=512
   with 160 filters and n_fft=4096 with 128 filters, in both precision
   modes, the power spectrum and the mel stage apart and end to end, on the
   plan the wrapper picks, on the mma.sync engine at 32 rows and on the
   chunked engine.
3. Drive the serving path: ``Recognizer.transcribe_batch`` / ``transcribe``
   with greedy decoding on ``base_config()`` at full width (8-layer
   bidirectional GRU encoder, H=1024), random weights from a seeded
   ``torch.Generator`` passed through the flax-layout weight bridge, in bf16
   and fp32.  The GRU kernel's launch count is set to 0 before and read
   after; every GRU scan must have gone through the kernel (one launch per
   layer and direction).  Label-looping greedy decode against the frame
   scan on the first 2 s of the bf16 batch of 8 (equal tokens).  Then the
   encoder is run again with the plain GRU on the card, and outputs and
   greedy tokens are compared.
4. The main paths, each with every launch count set to 0 before each timed
   step and read after it, against the count the design gives
   (``step_launches``):
   a. the flagship step: ``TrainState`` / ``train_step`` on a trainable
      ``base_config()`` at full width from the same seeded weights, B=64,
      T=512, U=48, bf16, precomputed features (the shape of ``bench.py``):
      K1 and K2 for the encoder, K3 and K4 for the 2-layer LSTM prediction
      network (1 and 2 launches per scan), K5 for the loss.  Step time,
      utt/s, MFU, a profile;
   b. the same step on raw PCM: 64 seeded waves of up to 81760 samples as
      int16 plus a per-utterance scale; K6 in every step.  Step time and
      the frontend's share of it;
   c. ``tiny_config()`` at full width (2-layer bidirectional LSTM encoder,
      H=320): bf16 steps at the same shape, then one greedy
      ``transcribe_batch`` of 8 waves; every LSTM scan through K3 / K4.
5. The training loop through its entry points (``phase_trainer``):
   ``Trainer.fit`` on ``base_config()`` at full width in bf16 on a raw-PCM
   ``SyntheticAudioDataset`` (1-5.11 s, 4-48 labels), global batch 64, to
   step 8 with validation and a checkpoint at steps 4 and 8, then
   ``fit(resume=True)`` to step 10 (it must continue the data schedule at
   step 8), every train step's launches checked (16 K1, 32 K2, 2 K3, 4 K4,
   1 K5, 1 K6); then ``Recognizer.from_checkpoint`` transcribes 8 waves.
   The logged step time, the host feed per batch, the device-busy share of
   a profiled window of 2 steps beside 4a's, validation and checkpoint
   times.
6. The decoding paths (``phase_decoding``, ``phase_streaming``,
   ``phase_cli``), each run's launches checked:
   a. the default ``Recognizer`` (the device beam, width 5) on
      ``base_config()`` at full width in bf16, batches of 1 and 8 (16 K1
      launches each); beam width 1 against greedy on the same features;
      fp32 beam tokens with the kernels against the plain GRU;
   b. the same with an order-3 char LM table on the card, built from an
      ARPA file the script writes over the graphemes: weight 0 gives the
      no-LM tokens;
   c. the host A/B beam with that LM and two hotwords on 2 waves of 0.5
      and 0.375 s, fp32 (16 K1 launches per wave), kernels against the
      plain GRU;
   d. streaming on ``bench_streaming.py``'s model (6-layer unidirectional
      LSTM encoder, H=1024) at full width: K3 against its plain version at
      one chunk's shape (T=64, B=1) with a carried h0 / c0, full and
      ragged; bf16 sessions, 100 ms feeds, chunk_frames 64, greedy and
      beam 4, 6 K3 launches per chunk, RTF and p50 first-token latency as
      ``bench_streaming.py`` defines them (median of 3 utterances, not its
      5); streaming greedy tokens against offline greedy in fp32;
   e. the inference CLI on phase 5's checkpoint (``--decoder
      beam_batched``, then ``beam``) and ``--stream`` on a checkpoint of
      (d)'s model (phase 5's encoder is bidirectional).
7. Many streams at once and a corpus (``phase_sessions``, ``phase_server``,
   ``phase_evaluate``, ``phase_import``), each run's launches checked:
   a. continuous batching (``decode/session_batch``) on (6d)'s model with
      ``experiments/bench_session_scale.py``'s traffic: 8 and 64 lanes of
      5 s (its 8 s cut), 100 ms feeds in lockstep, chunk_frames 16, greedy
      and beam 4,
      bf16; 6 K3 launches per tick; at 64 lanes an all-idle tick (K3 with
      every length 0) that must leave every lane bit-identical, and a
      profiled window of ticks; tick p50 / p99, aggregate real-time factor,
      the feed block's p99, the device-busy share; then in fp32 8 batched
      lanes against 8 independent ``StreamingRecognizer`` sessions on the
      first 1 s of each wave (K3 at the tick's shape against its plain
      version, idle rows included, runs with phase 2);
   b. ``serve_socket.StreamingServer`` on localhost: batch_sessions=8 with
      8 concurrent ``stream_wav`` clients (finals equal to (a)'s runner),
      the first-partial latency, a dropped client's slot freed,
      ``drain()``; per-connection sessions (finals equal to streaming
      sessions); ``python -m rnntransducer_tpu_torch.serve_socket`` on
      (6e)'s checkpoint, SIGTERM, exit 0;
   c. ``eval.evaluate_corpus`` on ``base_config()`` at full width, bf16 and
      fp32, over 32 seeded WAV files of 1-5.11 s: CER 0 and WER 0 against
      the Recognizer's own greedy tokens, beam_batched with the oracle
      n-best, 16 K1 launches per batch, RTF; ``cli.evaluate`` on phase 5's
      checkpoint with ``--dump``;
   d. a reference-layout checkpoint of ``base_config()`` (seeded
      ``torch.nn`` modules, Lightning-style) through
      ``utils/torch_import.convert_to_checkpoint``: greedy tokens equal to
      a Recognizer built by hand, joint logits within 1e-4 of the
      reference module's forward in fp32.
8. The Conformer (``phase_conformer``), seeded random weights through the
   flax-layout bridge, each main-path run's launches checked:
   a. Conformer-L (``experiments/perf_conformer.py:40,79-99``: 16 blocks,
      d=512, 8 heads, kernel 15, 4x stacking, full context, base_config's
      prediction network and joint): bf16 ``train_step`` at B=64, T=512
      (128 after stacking), U=48 on features (2 K3, 4 K4, 1 K5 per step;
      the encoder has no kernel): step time, utt/s, MFU, a profile (K3 /
      K4 / K5 against the rest); one step on int16 raw PCM (plus 1 K6);
      one AdamW, one adafactor and one lion step;
   b. one fp32 step at 4 blocks, B=8, kernels against plain versions;
   c. the offline Recognizer (greedy, the device beam) on a batch of 8
      waves in bf16 (no launches); in fp32 the padded batch's encoder rows
      against each wave alone;
   d. the streaming Conformer (``bench_streaming.py:40-50``: the same
      blocks, attention_chunk 16, 4 left chunks, stride 4): in fp32 chunk
      by chunk against the offline masked forward, streaming greedy against
      offline greedy, 8 staggered lanes of the batched runner (lanes idle
      mid-stream) against independent sessions, an all-idle tick at 64
      lanes; in bf16 ``StreamingRecognizer`` RTF and first-token latency
      (greedy, beam 4, 64-frame chunks, 100 ms feeds) and ticks of the
      batched runner at 8 and 64 lanes, each under its chunk's 640 ms.
9. The data axis (``phase_parallel``): ``Trainer.fit`` through a one-rank
   NCCL process group against the single device, and two gloo ranks
   sharing the card, replicated and ZeRO-1.
10. From a corpus to a trained model (``phase_corpus``), on
    ``base_config()`` at full width in bf16, every step's launches checked:
    a corpus of the ``ConfusableWaveformDataset`` testbed (128 train, 16
    dev, 16 eval_clean utterances; WAVs written with ``write_wav``, each
    scaled down by its peak where it would clip; transcripts the
    tokenizer's decode of the labels) through ``cli.prepare_manifest``
    (ids equal the labels, PCM equals ``read_wav`` of the file), then
    ``cli.train.main`` in-process with ``--hf_data_dirs``: log-mel shards
    equal to ``logmel_np`` of the raw rows, ledger and ``_PREPARED``
    written, 4 steps at global batch 64 (16 K1, 32 K2, 2 K3, 4 K4, 1 K5,
    0 K6 a step), validation at step 4; a second run with ``--eval_only``
    prepares nothing (the marker holds) and scores eval_clean; the same
    corpus through ``save_waveform_dataset`` and ``Trainer.fit`` on
    ``ArrowWaveformDataset``, 2 steps (plus 1 K6 a step); on one batch of
    it ``checked_rnnt_loss`` (K5 launched) against the plain loss on CPU
    copies of the batch, and a label id of V caught.  Host preparation
    times per 100 utterances and median step times (the steps after the
    first) are printed beside the card's name and power limit.
11. One fp32 step at full width (B=8: the plain backward scans are Python
    loops of small launches), kernels against plain versions (GRU, LSTM and
    the sweep): loss and the grads of named params.
12. Print one JSON line describing every kernel, then, as the last line,
    ``{"ok": true, "device": {...}}``.

Imports nothing from JAX or from the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from rnntransducer_tpu_torch.config import (  # noqa: E402
    TrainConfig, base_config, tiny_config)
from rnntransducer_tpu_torch.cli import prepare_manifest  # noqa: E402
from rnntransducer_tpu_torch.cli import train as cli_train  # noqa: E402
from rnntransducer_tpu_torch.data import dataset as data_mod  # noqa: E402
from rnntransducer_tpu_torch.data.collate import collate_waveforms  # noqa: E402
from rnntransducer_tpu_torch.data.dataset import (  # noqa: E402
    ArrowAudioDataset, ArrowWaveformDataset, ConfusableWaveformDataset,
    SyntheticAudioDataset, load_shards, logmel_np, read_ledger, save_waveform_dataset)
from rnntransducer_tpu_torch.decode import greedy as greedy_mod  # noqa: E402
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM  # noqa: E402
from rnntransducer_tpu_torch.frontend import fused_frontend  # noqa: E402
from rnntransducer_tpu_torch.models import cells  # noqa: E402
from rnntransducer_tpu_torch.models.transducer import build_model  # noqa: E402
from rnntransducer_tpu_torch.ops import build, rnn_kernels, rnnt_kernels  # noqa: E402
from rnntransducer_tpu_torch.serve import Recognizer  # noqa: E402
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer  # noqa: E402
from rnntransducer_tpu_torch.train import TrainState, loss_fn, train_step  # noqa: E402
from rnntransducer_tpu_torch.train import loop as train_loop  # noqa: E402
from rnntransducer_tpu_torch.train.state import (  # noqa: E402
    dequantize_wav, device_frontend)
from rnntransducer_tpu_torch.ops.rnnt_loss import rnnt_loss  # noqa: E402
from rnntransducer_tpu_torch.data.prefetch import to_device  # noqa: E402
from rnntransducer_tpu_torch.utils.audio_io import read_wav, write_wav  # noqa: E402
from rnntransducer_tpu_torch.utils.debugging import checked_rnnt_loss  # noqa: E402
from rnntransducer_tpu_torch.utils.weights import (  # noqa: E402
    random_flax_params, state_dict_from_flax)

KERNELS = ["gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd", "rnnt_sweep", "logmel"]
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
# GRU backward, kernel vs plain, same inputs (max |err| over dxw, dnr, dh0,
# and the assembled dW_hh / db_hh, each relative to its largest magnitude):
# fp32: both compute in fp32 and differ only in summation order (~1e-7 per
#   product); the dh chain's gates keep that from growing over 512 steps.
# bf16: outputs are rounded to bf16 (ulp 2^-8 of the value); a one-ulp flip
#   of a rounded dhw feeds the chain, so allow 4 ulps of the largest output.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 4 * 2.0 ** -8}
# LSTM forward and backward, kernel vs plain, same inputs, each output
# relative to its largest magnitude: fp32 differs only in summation order;
# bf16 outputs are rounded (ulp 2^-8 of the value) and a one-ulp flip of a
# rounded h or dgates feeds the carries, so allow 4 ulps.
LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 4 * 2.0 ** -8}
# K2's gates GEMM (hw = h_prev @ W_hh + b_hh in fp32), kernel vs plain, same
# inputs, relative to the largest |hw|: both sum exact products (bf16 x
# bf16 is exact in fp32) in fp32, in two orders; over K=1024 terms the
# difference stays near sqrt(K) fp32 ulps, ~1e-6.
GATES_TOL = 1e-5
# (B, T, H) of the LSTM checks: the flagship prediction network (U+1 = 49)
# and tiny_config's encoder at two batches
LSTM_SHAPES = ((64, 49, 1024), (8, 512, 320), (64, 512, 320))
# checked: those, and the prediction network at B=1 and at B=100 (two
# 64-row chunks); timed: B in {1, 8, 64} at the prediction network's shape
# and tiny_config's encoder at B=64
LSTM_CHECK_SHAPES = LSTM_SHAPES + ((1, 49, 1024), (100, 49, 1024))
LSTM_TIME_SHAPES = ((1, 49, 1024), (8, 49, 1024), (64, 49, 1024), (64, 512, 320))
# (cell, B, T, H, input width) of the cuDNN yardstick: a flagship
# prediction-network layer (layer 2 takes the 1024-wide output of layer
# 1), a tiny_config encoder layer (layer 2 takes 2 x 320) and a flagship
# encoder layer (layers 2-8 take 2 x 1024)
CUDNN_LAYER_SHAPES = (("lstm", 64, 49, 1024, 1024), ("lstm", 64, 512, 320, 640),
                      ("gru", 64, 512, 1024, 2048))
# Log-mel, kernel vs plain, checked in two stages on the same frames: the
# power spectrum relative to its largest value (fp32 sums of exact bf16
# products in two orders), and the mel stage on the kernel's own power
# (log1p of fp32 sums of exact products: 1e-4 absolute).  End to end the
# mel product rounds power to bf16, and a power value within the summation
# noise of a rounding boundary lands on either side of it: one ulp, up to
# 2^-7 relative, moves a mel value dominated by that bin by as much, and
# its log1p by up to 2^-7 absolute.  That is the end-to-end bound.
LOGMEL_POWER_TOL = 1e-5
LOGMEL_MEL_TOL = 1e-4
LOGMEL_END_TOL = 2.0 ** -7 + 1e-4
# RNN-T sweep, kernel vs plain, fp32: alpha is a sum of ~T+U log-probs, in
# the thousands at T=512, where one fp32 ulp is ~1e-4; the two scans add in
# another order.  Relative to max(|alpha|, 1).
SWEEP_TOL = 1e-5
# Full-width fp32 training step, kernels vs plain versions: the same
# function in another summation order through 16 GRU scans and their
# backward; loss relative, grads relative to the param grad's largest entry.
# Every grad passes through the loss's occupancy exp(alpha + beta - logZ),
# whose terms are in the thousands at T=512: one fp32 ulp there (~1.2e-4)
# is that much relative error in every grad, so allow ~10 ulps.
STEP_LOSS_TOL = 1e-5
STEP_GRAD_TOL = 1e-3
STEP_GRAD_PARAMS = ("encoder.rnn.fwd.0.w_hh", "encoder.rnn.bwd.7.w_hh",
                    "prednet.rnn.fwd.0.w_hh", "prednet.rnn.fwd.1.w_hh",
                    "joint.fc.weight", "joint.fc.bias")
# Training path shape (bench.py): B utterances of T frames, U labels
TRAIN_B, TRAIN_U = 64, 48
# the fp32 kernels-vs-plain step: ragged frame and label counts, B=8
PLAIN_STEP_LENGTHS = ([512, 400, 300, 511, 64, 1, 256, 512],
                      [48, 40, 30, 48, 8, 0, 20, 47])
WARMUP_STEPS, TIMED_STEPS = 2, 3
RAW_PCM_STEPS, TINY_STEPS = 3, 3  # timed, after one warm-up step each
PEAK_BF16_FLOPS = 989e12


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


def gru_bwd_bound_ms(T, B, H, dtype, lengths) -> tuple:
    """Least time for one backward scan: xw, h_prev and g_out read once at
    valid steps, W_hh once; dxw, dnr and dh0 written once, over HBM; the two
    products (gate recompute and dh chain) at valid steps over the peak rate
    of the inputs' type.  Returns (ms, bound_by)."""
    e = torch.tensor([], dtype=dtype).element_size()
    valid = int(lengths.sum())
    nbytes = (valid * 5 * H * e + 3 * H * H * e + 3 * H * e + B * H * e + B * 4
              + T * B * 4 * H * e + B * H * e)
    flops = 2.0 * (2.0 * valid * H * 3 * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bound_ms(N, T, U1) -> tuple:
    """Least time for one sweep: be and le read and alpha written once
    (3 N T (U+1) fp32 words) over HBM, against ~10 fp32 operations per
    lattice point (the sum scan's add, d = prev + le - cb, the logaddexp
    scan's combine, cb + lse) over the fp32 peak without tensor cores."""
    t_bytes = 3 * N * T * U1 * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 10.0 * N * T * U1 / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _gru_check(xw, w, b, h0, lengths, reverse, gen):
    """GRU forward and backward kernels against their plain versions on the
    same inputs, the backward's dW / db assembled by the off-loop GEMMs.
    Returns (forward max abs err, backward rel errs dxw/dnr/dh0/dW/db)."""
    dtype, (T, B, H) = xw.dtype, (xw.shape[0], xw.shape[1], xw.shape[2] // 3)
    got = rnn_kernels.gru_scan(xw, w, b, h0, lengths, reverse)
    want = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths, reverse)
    h_prev = rnn_kernels.prev_all(want[0], h0, lengths, reverse)
    gout = torch.randn(T, B, H, device=DEVICE, generator=gen).to(dtype)
    gfin = torch.randn(B, H, device=DEVICE, generator=gen).to(dtype)
    args = (xw, h_prev, w, b, lengths, gout, gfin, reverse)
    gotb = rnn_kernels.gru_scan_backward(*args)
    wantb = rnn_kernels.gru_scan_backward_reference(*args)
    gotb += rnn_kernels.gru_weight_grads(h_prev, gotb[0], gotb[1], dtype)
    wantb += rnn_kernels.gru_weight_grads(h_prev, wantb[0], wantb[1], dtype)
    torch.cuda.synchronize()
    fwd = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, want))
    return fwd, [_rel_err(g, r) for g, r in zip(gotb, wantb)]


def phase_gru_limits(gen):
    """The GRU kernels' limits on this card: the wrappers' shared-memory
    formulas equal the kernels' own (persistent and per-step), the card
    holds the persistent grid at H=320, 1024 and the largest H its SMs
    take; that H runs persistent (1 + 2 launches) and the next on the
    per-step kernels (T + T+1), both holding their plain versions, and
    GRUScanFunction there holds autograd of the plain loop."""
    fwd_lib, bwd_lib = rnn_kernels._library(), rnn_kernels._bwd_library()
    sms, smem = rnn_kernels.device_limits(DEVICE)
    T = 6
    for dtype in (torch.float32, torch.bfloat16):
        code = rnn_kernels._DTYPE_CODES[dtype]
        top = rnn_kernels.gru_max_hidden(TRAIN_B, dtype, DEVICE)
        if not rnn_kernels.gru_fits(1024, TRAIN_B, dtype, DEVICE):
            raise AssertionError(f"H=1024 does not fit in {dtype}")
        for H in (320, 1024, top):
            Hk, Kc = rnn_kernels._padded(H), rnn_kernels._padded(3 * H)
            got = (fwd_lib.gru_scan_fwd_smem(Hk, code), bwd_lib.gru_scan_bwd_smem(Kc, code))
            want = (rnn_kernels.gru_smem_bytes(H, dtype),
                    rnn_kernels.gru_smem_bytes(H, dtype, backward=True))
            if got != want:
                raise AssertionError(f"shared memory at H={H} {dtype}: kernels {got}, "
                                     f"wrapper {want}")
            fit = (fwd_lib.gru_scan_fwd_max_blocks(Hk, code),
                   bwd_lib.gru_scan_bwd_max_blocks(Kc, code))
            if min(fit) < -(-H // 8):
                raise AssertionError(f"H={H} {dtype}: the card holds {fit} blocks, "
                                     f"the grid needs {-(-H // 8)}")
        Hk, Kc = rnn_kernels._padded(top + 1), rnn_kernels._padded(3 * (top + 1))
        step = (fwd_lib.gru_scan_fwd_step_smem(Hk, code),
                bwd_lib.gru_scan_bwd_step_smem(Hk, Kc, code))
        want = (rnn_kernels.step_smem_bytes("gru", top + 1, dtype),
                rnn_kernels.step_smem_bytes("gru", top + 1, dtype, backward=True))
        if step != want:
            raise AssertionError(f"per-step shared memory at H={top + 1} {dtype}: "
                                 f"kernels {step}, wrapper {want}")
        print(f"gru limit {str(dtype)[6:]}: {sms} SMs, {smem} bytes of shared memory "
              f"per block; persistent up to H={top} (co-resident blocks fwd/bwd {fit}), "
              f"per-step up to H={rnn_kernels.step_max_hidden('gru', dtype, False, DEVICE)}"
              f" forward, {rnn_kernels.step_max_hidden('gru', dtype, True, DEVICE)} "
              f"backward", flush=True)
        for H, route, want_launches in ((top, "persistent", (1, 2)),
                                        (top + 1, "per_step", (T, T + 1))):
            if rnn_kernels.gru_route(H, 4, dtype, DEVICE) != route:
                raise AssertionError(f"gru H={H} {dtype}: route "
                                     f"{rnn_kernels.gru_route(H, 4, dtype, DEVICE)}")
            before = (rnn_kernels.gru_scan.launches, rnn_kernels.gru_scan_backward.launches)
            fwd_err, berrs = _gru_check(*_gru_inputs(T, 4, H, dtype, gen), False, gen)
            launched = (rnn_kernels.gru_scan.launches - before[0],
                        rnn_kernels.gru_scan_backward.launches - before[1])
            print(f"gru limit {str(dtype)[6:]}: H={H} {route}, launches fwd/bwd "
                  f"{launched}, fwd max_abs_err {fwd_err:.2e} (tol "
                  f"{KERNEL_TOL[dtype]:.0e}), bwd rel_err dxw/dnr/dh0/dW/db "
                  f"{'/'.join(f'{e:.2e}' for e in berrs)} (tol {BWD_TOL[dtype]:.1e})",
                  flush=True)
            if launched != want_launches:
                raise AssertionError(f"gru H={H}: launches {launched}, expected "
                                     f"{want_launches}")
            if not (fwd_err <= KERNEL_TOL[dtype] and max(berrs) <= BWD_TOL[dtype]):
                raise AssertionError(f"gru H={H} {route} disagrees with its plain "
                                     f"versions: {fwd_err} {berrs}")
    # the autograd form on the per-step route, fp32
    H = rnn_kernels.gru_max_hidden(4, torch.float32, DEVICE) + 1
    xw, w, b, h0, lengths = _gru_inputs(T, 4, H, torch.float32, gen)
    leaves = [a.clone().requires_grad_() for a in (xw, w, b, h0)]
    cot = (torch.randn(T, 4, H, device=DEVICE, generator=gen),
           torch.randn(4, H, device=DEVICE, generator=gen))
    want = torch.autograd.grad(rnn_kernels.gru_scan_reference(*leaves, lengths), leaves, cot)
    before = (rnn_kernels.gru_scan.launches, rnn_kernels.gru_scan_backward.launches)
    got = torch.autograd.grad(rnn_kernels.GRUScanFunction.apply(*leaves, lengths, False),
                              leaves, cot)
    launched = (rnn_kernels.gru_scan.launches - before[0],
                rnn_kernels.gru_scan_backward.launches - before[1])
    errs = [_rel_err(g, r) for g, r in zip(got, want)]
    print(f"gru limit: GRUScanFunction at H={H} fp32 vs autograd of the plain loop: "
          f"launches {launched}, rel_err dxw/dW/db/dh0 "
          f"{'/'.join(f'{e:.2e}' for e in errs)} (tol {BWD_TOL[torch.float32]:.0e})",
          flush=True)
    if launched != (T, T + 1) or not max(errs) <= BWD_TOL[torch.float32]:
        raise AssertionError(f"GRUScanFunction on the per-step route: {launched} {errs}")


def phase_gru_bwd(gen):
    """GRU backward kernel vs its plain version at H=1024, T=512, and vs
    autograd through the plain forward loop; its gates GEMM alone vs the
    plain product."""
    H, T = 1024, T_FRAMES
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xw, w, b, h0, lengths = _gru_inputs(T, TRAIN_B, H, dtype, gen)
        h_prev = torch.randn(T, TRAIN_B, H, device=DEVICE, generator=gen).to(dtype)
        got = rnn_kernels.gru_bwd_gates(h_prev, w, b)
        want = rnn_kernels.gru_bwd_gates_reference(h_prev, w, b)
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        print(f"gru_bwd gates GEMM check dtype={str(dtype)[6:]} (T*B, H) x (H, 3H) = "
              f"({T * TRAIN_B}, {H}) x ({H}, {3 * H}): rel_err {err:.2e} "
              f"tol {GATES_TOL:.0e}", flush=True)
        if not err <= GATES_TOL:
            raise AssertionError(f"gru_bwd's gates GEMM disagrees: {err}")
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 8, 64, 100):
            for reverse in (False, True):
                xw, w, b, h0, lengths = _gru_inputs(T, B, H, dtype, gen)
                h_all, _ = rnn_kernels.gru_scan(xw, w, b, h0, lengths, reverse)
                h_prev = rnn_kernels.prev_all(h_all, h0, lengths, reverse)
                gout = torch.randn(T, B, H, device=DEVICE, generator=gen).to(dtype)
                gfin = torch.randn(B, H, device=DEVICE, generator=gen).to(dtype)
                args = (xw, h_prev, w, b, lengths, gout, gfin, reverse)
                got = rnn_kernels.gru_scan_backward(*args)
                want = rnn_kernels.gru_scan_backward_reference(*args)
                got += rnn_kernels.gru_weight_grads(h_prev, got[0], got[1], dtype)
                want += rnn_kernels.gru_weight_grads(h_prev, want[0], want[1], dtype)
                torch.cuda.synchronize()
                errs = [_rel_err(g, r) for g, r in zip(got, want)]
                # the kernel's own outputs (dW / db are the GEMMs' afterwards)
                abs_err = max((g.float() - r.float()).abs().max().item()
                              for g, r in zip(got[:3], want[:3]))
                print(f"gru_bwd check dtype={str(dtype)[6:]} B={B} T={T} H={H} "
                      f"reverse={reverse} rel_err dxw/dnr/dh0/dW/db="
                      f"{'/'.join(f'{e:.2e}' for e in errs)} max_abs_err(dxw,dnr,dh0)="
                      f"{abs_err:.3e} tol={BWD_TOL[dtype]:.1e}", flush=True)
                if not max(errs) <= BWD_TOL[dtype]:
                    raise AssertionError(f"gru_bwd disagrees with its plain version: "
                                         f"{errs} > {BWD_TOL[dtype]}")
                worst = max(worst, abs_err)
    # against autograd through the plain forward loop, fp32, B=8
    for reverse in (False, True):
        xw, w, b, h0, lengths = _gru_inputs(T, 8, H, torch.float32, gen)
        leaves = [a.clone().requires_grad_() for a in (xw, w, b, h0)]
        gout = torch.randn(T, 8, H, device=DEVICE, generator=gen)
        gfin = torch.randn(8, H, device=DEVICE, generator=gen)
        outs = rnn_kernels.gru_scan_reference(*leaves, lengths, reverse)
        want = torch.autograd.grad(outs, leaves, (gout, gfin))
        outs = rnn_kernels.GRUScanFunction.apply(*leaves, lengths, reverse)
        got = torch.autograd.grad(outs, leaves, (gout, gfin))
        errs = [_rel_err(g, r) for g, r in zip(got, want)]
        print(f"gru_bwd vs autograd of the plain forward fp32 B=8 reverse={reverse}: "
              f"rel_err dxw/dW/db/dh0={'/'.join(f'{e:.2e}' for e in errs)} "
              f"tol={BWD_TOL[torch.float32]:.0e}", flush=True)
        if not max(errs) <= BWD_TOL[torch.float32]:
            raise AssertionError(f"GRUScanFunction disagrees with autograd: {errs}")
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8, 64):
            xw, w, b, h0, lengths = _gru_inputs(T, B, H, dtype, gen)
            h_all, _ = rnn_kernels.gru_scan(xw, w, b, h0, lengths)
            h_prev = rnn_kernels.prev_all(h_all, h0, lengths)
            gout = torch.randn(T, B, H, device=DEVICE, generator=gen).to(dtype)
            gfin = torch.zeros(B, H, device=DEVICE, dtype=dtype)
            args = (xw, h_prev, w, b, lengths, gout, gfin)
            ms = _sync_time(lambda: rnn_kernels.gru_scan_backward(*args), 3)
            gates_ms = _sync_time(lambda: rnn_kernels.gru_bwd_gates(h_prev, w, b), 3)
            plain = _sync_time(lambda: rnn_kernels.gru_scan_backward_reference(*args), 1)
            bound, bound_by = gru_bwd_bound_ms(T, B, H, dtype, lengths)
            times[(dtype, B)] = (ms, plain, bound, bound_by)
            print(f"gru_bwd time dtype={str(dtype)[6:]} B={B} T={T} H={H}: kernel "
                  f"{ms:.3f} ms ({ms / T * 1e3:.2f} us/step, gates GEMM "
                  f"{gates_ms:.3f} ms), plain {plain:.3f} ms ({plain / T * 1e3:.2f} "
                  f"us/step), bound {bound:.4f} ms by {bound_by}", flush=True)
    times["gates_yardstick"] = gates_yardstick(T * TRAIN_B, H, gen)
    return worst, times


def gates_yardstick(M, H, gen) -> dict:
    """Timing only: cuBLAS (``torch.mm``) on the product of K2's gates GEMM,
    (M x H) . (H x 3H) in bf16 with fp32 accumulation, beside the port's
    ``gates_gemm_bf16`` (``gru_bwd_gates``, which also adds b_hh) on the same
    operands.  cuBLAS writes fp32 where this torch takes ``out_dtype``, else
    bf16 (half the output bytes).  Nothing on any path calls cuBLAS here."""
    a = torch.randn(M, H, device=DEVICE, generator=gen).to(torch.bfloat16)
    w = (torch.randn(H, 3 * H, device=DEVICE, generator=gen) / H ** 0.5).to(torch.bfloat16)
    b = torch.zeros(3 * H, device=DEVICE, dtype=torch.bfloat16)
    try:
        torch.mm(a[:64], w, out_dtype=torch.float32)
        call, out = (lambda: torch.mm(a, w, out_dtype=torch.float32)), "float32"
    except (TypeError, RuntimeError):
        call, out = (lambda: torch.mm(a, w)), "bfloat16"
    lib_ms = _sync_time(call, 5)
    own_ms = _sync_time(lambda: rnn_kernels.gru_bwd_gates(a.view(1, M, H), w, b), 5)
    bound, bound_by = gemm_bound_ms(M, H, 3 * H)
    print(f"gates GEMM yardstick ({M} x {H}) . ({H} x {3 * H}) bf16, fp32 accumulation: "
          f"cuBLAS ({out} out) {lib_ms:.3f} ms, gates_gemm_bf16 {own_ms:.3f} ms, bound "
          f"{bound:.4f} ms by {bound_by}", flush=True)
    return {"cublas_ms": lib_ms, "cublas_out_dtype": out, "gates_gemm_ms": own_ms,
            "bound_ms": bound, "bound_by": bound_by}


def gemm_bound_ms(M, K, N) -> tuple:
    """Least time for a bf16 (M x K) . (K x N) product with an fp32 result:
    operands read and the result written once over HBM; 2 M K N operations
    at the bf16 peak."""
    t_bytes = (2 * (M * K + K * N) + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * K * N / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lstm_inputs(T, B, H, dtype, gen):
    s = 1.0 / H ** 0.5
    xw = torch.randn(T, B, 4 * H, device=DEVICE, generator=gen).to(dtype)
    w = ((torch.rand(H, 4 * H, device=DEVICE, generator=gen) * 2 - 1) * s).to(dtype)
    b = ((torch.rand(4 * H, device=DEVICE, generator=gen) * 2 - 1) * s).to(dtype)
    h0 = (torch.randn(B, H, device=DEVICE, generator=gen) * 0.5).to(dtype)
    c0 = (torch.randn(B, H, device=DEVICE, generator=gen) * 0.5).to(dtype)
    lengths = torch.randint(1, T + 1, (B,), device=DEVICE, generator=gen)
    lengths[0] = T
    lengths[-1] = 1
    return xw, w, b, h0, c0, lengths


def lstm_bound_ms(T, B, H, dtype, lengths, backward: bool) -> tuple:
    """Least time for one LSTM scan.  Forward: xw read at valid steps, W_hh,
    b_hh, h0, c0 and lengths once; h_all and c_all (T, B, H), h_final and
    c_final written once; the recurrent product at valid steps.  Backward:
    xw, h_prev, c_prev and g_out read at valid steps, W_hh, b_hh, g_hfin,
    g_cfin once; dxw (T, B, 4H), dh0 and dc0 written once; the gate
    recompute and the dh-chain products at valid steps.  Bytes over HBM,
    products over the peak rate of the inputs' type; (ms, bound_by)."""
    e = torch.tensor([], dtype=dtype).element_size()
    valid = int(lengths.sum())
    weights = 4 * H * H * e + 4 * H * e + B * 4
    if backward:
        nbytes = (valid * 7 * H * e + weights + 2 * B * H * e
                  + T * B * 4 * H * e + 2 * B * H * e)
        flops = 2.0 * (2.0 * valid * H * 4 * H)
    else:
        nbytes = (valid * 4 * H * e + weights + 2 * B * H * e + 2 * T * B * H * e
                  + 2 * B * H * e)
        flops = 2.0 * valid * H * 4 * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lstm_check(xw, w, b, h0, c0, lengths, reverse, gen):
    """Forward and backward kernels against their plain versions on the same
    inputs, the backward's dW / db assembled by the off-loop GEMMs.  Returns
    (forward rel errs, backward rel errs, forward max abs err, backward max
    abs err)."""
    dtype, (T, B, H) = xw.dtype, (xw.shape[0], xw.shape[1], xw.shape[2] // 4)
    args = (xw, w, b, h0, c0, lengths, reverse)
    got = rnn_kernels.lstm_scan(*args, with_carry=True)
    want = rnn_kernels.lstm_scan_reference(*args, with_carry=True)
    h_prev = rnn_kernels.prev_all(want[0], h0, lengths, reverse)
    c_prev = rnn_kernels.prev_all(want[1], c0, lengths, reverse)
    cot = [torch.randn(*s, device=DEVICE, generator=gen).to(dtype)
           for s in ((T, B, H), (B, H), (B, H))]
    bargs = (xw, h_prev, c_prev, w, b, lengths, *cot, reverse)
    gotb = rnn_kernels.lstm_scan_backward(*bargs)
    wantb = rnn_kernels.lstm_scan_backward_reference(*bargs)
    gotb += rnn_kernels.lstm_weight_grads(h_prev, gotb[0], dtype)
    wantb += rnn_kernels.lstm_weight_grads(h_prev, wantb[0], dtype)
    torch.cuda.synchronize()
    errs = [_rel_err(g, r) for g, r in zip(got, want)]
    berrs = [_rel_err(g, r) for g, r in zip(gotb, wantb)]
    fwd_abs = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, want))
    bwd_abs = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(gotb[:3], wantb[:3]))
    return errs, berrs, fwd_abs, bwd_abs


@contextlib.contextmanager
def _lstm_forced(route=None, tile_width=None):
    """The LSTM wrappers forced onto one route or block width (timing the
    alternatives only)."""
    saved = rnn_kernels.lstm_route, rnn_kernels.lstm_tile_width
    if route is not None:
        rnn_kernels.lstm_route = lambda *args, **kwargs: route
    if tile_width is not None:
        rnn_kernels.lstm_tile_width = lambda *args, **kwargs: tile_width
    try:
        yield
    finally:
        rnn_kernels.lstm_route, rnn_kernels.lstm_tile_width = saved


def phase_lstm(gen):
    """LSTM forward and backward kernels vs their plain versions at the
    flagship prediction network's shape (B in {1, 64, 100}) and
    tiny_config's encoder shapes, both directions, fp32 and bf16, ragged
    lengths including 1 and T; the backward also against autograd through
    the plain forward loop; times of both at B in {1, 8, 64} beside their
    bounds and the per-step route's times, and of both block widths at
    tiny's H=320."""
    fwd_worst = bwd_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H in LSTM_CHECK_SHAPES:
            for reverse in (False, True):
                inputs = _lstm_inputs(T, B, H, dtype, gen)
                errs, berrs, fwd_abs, bwd_abs = _lstm_check(*inputs, reverse, gen)
                fwd_worst, bwd_worst = max(fwd_worst, fwd_abs), max(bwd_worst, bwd_abs)
                print(f"lstm check dtype={str(dtype)[6:]} B={B} T={T} H={H} "
                      f"reverse={reverse} "
                      f"route={rnn_kernels.lstm_route(H, B, dtype, DEVICE)}: "
                      f"fwd rel_err h_all/c_all/h_fin/c_fin="
                      f"{'/'.join(f'{e:.2e}' for e in errs)}; bwd rel_err dxw/dh0/dc0/"
                      f"dW/db={'/'.join(f'{e:.2e}' for e in berrs)} "
                      f"tol={LSTM_TOL[dtype]:.1e}", flush=True)
                if not max(errs + berrs) <= LSTM_TOL[dtype]:
                    raise AssertionError(f"lstm kernels disagree with their plain "
                                         f"versions: {errs} {berrs}")
    # against autograd through the plain forward loop, fp32, B=8
    B, T, H = 8, LSTM_SHAPES[0][1], LSTM_SHAPES[0][2]
    for reverse in (False, True):
        xw, w, b, h0, c0, lengths = _lstm_inputs(T, B, H, torch.float32, gen)
        leaves = [a.clone().requires_grad_() for a in (xw, w, b, h0, c0)]
        cot = [torch.randn(*s, device=DEVICE, generator=gen)
               for s in ((T, B, H), (B, H), (B, H))]
        outs = rnn_kernels.lstm_scan_reference(*leaves, lengths, reverse)
        want = torch.autograd.grad(outs, leaves, cot)
        outs = rnn_kernels.LSTMScanFunction.apply(*leaves, lengths, reverse)
        got = torch.autograd.grad(outs, leaves, cot)
        errs = [_rel_err(g, r) for g, r in zip(got, want)]
        print(f"lstm_bwd vs autograd of the plain forward fp32 B={B} T={T} H={H} "
              f"reverse={reverse}: rel_err dxw/dW/db/dh0/dc0="
              f"{'/'.join(f'{e:.2e}' for e in errs)} "
              f"tol={LSTM_TOL[torch.float32]:.0e}", flush=True)
        if not max(errs) <= LSTM_TOL[torch.float32]:
            raise AssertionError(f"LSTMScanFunction disagrees with autograd: {errs}")
    times = {}
    for B, T, H in LSTM_TIME_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            xw, w, b, h0, c0, lengths = _lstm_inputs(T, B, H, dtype, gen)
            lengths[:] = T
            fwd = (xw, w, b, h0, c0, lengths)
            h_all, c_all, _, _ = rnn_kernels.lstm_scan(*fwd, with_carry=True)
            bwd = (xw, rnn_kernels.prev_all(h_all, h0, lengths),
                   rnn_kernels.prev_all(c_all, c0, lengths), w, b, lengths,
                   torch.randn(T, B, H, device=DEVICE, generator=gen).to(dtype),
                   torch.zeros(B, H, device=DEVICE, dtype=dtype),
                   torch.zeros(B, H, device=DEVICE, dtype=dtype))
            row = {}
            for what, fn, ref, a in (
                    ("fwd", rnn_kernels.lstm_scan, rnn_kernels.lstm_scan_reference, fwd),
                    ("bwd", rnn_kernels.lstm_scan_backward,
                     rnn_kernels.lstm_scan_backward_reference, bwd)):
                ms = _sync_time(lambda: fn(*a), 5)
                with _lstm_forced(route="per_step"):
                    step_ms = _sync_time(lambda: fn(*a), 3)
                plain = _sync_time(lambda: ref(*a), 1)
                bound, bound_by = lstm_bound_ms(T, B, H, dtype, lengths, what == "bwd")
                row[what] = (ms, plain, bound, bound_by)
                widths = ""
                if H == LSTM_SHAPES[2][2] and B == LSTM_SHAPES[2][0]:
                    by_width = {}
                    for jt in (4, 8):
                        with _lstm_forced(tile_width=jt):
                            by_width[jt] = _sync_time(lambda: fn(*a), 5)
                    widths = (f", by block width: 4 units {by_width[4]:.3f} ms, "
                              f"8 units {by_width[8]:.3f} ms (chosen "
                              f"{rnn_kernels.lstm_tile_width(H, DEVICE)})")
                print(f"lstm_{what} time dtype={str(dtype)[6:]} B={B} T={T} H={H}: "
                      f"kernel {ms:.3f} ms ({ms / T * 1e3:.2f} us/step), per-step "
                      f"route {step_ms:.3f} ms, plain {plain:.3f} ms, bound "
                      f"{bound:.4f} ms by {bound_by}{widths}", flush=True)
            times[(dtype, B, T, H)] = row
    return fwd_worst, bwd_worst, times


def phase_lstm_limits(gen):
    """The persistent LSTM kernels' co-residency limit: the wrappers'
    shared-memory formula equals the kernels' own and the card holds the
    grid at H=320, 1024 and the largest H; the largest H runs on the
    persistent kernels and the next on the per-step ones (launch counts
    say which), both holding their plain versions."""
    fwd_lib, bwd_lib = rnn_kernels._lstm_fwd_library(), rnn_kernels._lstm_bwd_library()
    sms, smem = rnn_kernels.device_limits(DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        code = rnn_kernels._DTYPE_CODES[dtype]
        top = rnn_kernels.lstm_max_hidden(TRAIN_B, dtype, DEVICE)
        for H in (320, 1024, top):
            jt = rnn_kernels.lstm_tile_width(H, DEVICE)
            Hk, Kc = rnn_kernels._padded(H), rnn_kernels._padded(4 * H)
            got = (fwd_lib.lstm_scan_fwd_smem(Hk, jt, code),
                   bwd_lib.lstm_scan_bwd_smem(Kc, code))
            want = (rnn_kernels.lstm_smem_bytes(H, dtype, jt=jt),
                    rnn_kernels.lstm_smem_bytes(H, dtype, backward=True))
            if got != want:
                raise AssertionError(f"lstm shared memory at H={H} {dtype}: kernels "
                                     f"{got}, wrapper {want}")
            fit = (fwd_lib.lstm_scan_fwd_max_blocks(Hk, jt, code),
                   bwd_lib.lstm_scan_bwd_max_blocks(Kc, jt, code))
            if min(fit) < -(-H // jt):
                raise AssertionError(f"lstm H={H} {dtype}: the card holds {fit} blocks, "
                                     f"the grid needs {-(-H // jt)}")
        print(f"lstm limit {str(dtype)[6:]}: {sms} SMs, {smem} bytes of shared memory "
              f"per block; persistent up to H={top} (co-resident blocks fwd/bwd {fit}, "
              f"shared memory per block fwd/bwd {got} bytes), per-step up to "
              f"H={rnn_kernels.step_max_hidden('lstm', dtype, False, DEVICE)} forward, "
              f"{rnn_kernels.step_max_hidden('lstm', dtype, True, DEVICE)} backward",
              flush=True)
        T = 6
        for H, route, want_launches in ((top, "persistent", (1, 2)),
                                        (top + 1, "per_step", (T, T + 1))):
            if rnn_kernels.lstm_route(H, 4, dtype, DEVICE) != route:
                raise AssertionError(f"lstm H={H} {dtype}: route "
                                     f"{rnn_kernels.lstm_route(H, 4, dtype, DEVICE)}, "
                                     f"not {route}")
            before = (rnn_kernels.lstm_scan.launches,
                      rnn_kernels.lstm_scan_backward.launches)
            inputs = _lstm_inputs(T, 4, H, dtype, gen)
            errs, berrs, _, _ = _lstm_check(*inputs, False, gen)
            launched = (rnn_kernels.lstm_scan.launches - before[0],
                        rnn_kernels.lstm_scan_backward.launches - before[1])
            print(f"lstm limit {str(dtype)[6:]}: H={H} {route}, launches fwd/bwd "
                  f"{launched}, rel_err fwd {max(errs):.2e} bwd {max(berrs):.2e} "
                  f"tol {LSTM_TOL[dtype]:.1e}", flush=True)
            if launched != want_launches:
                raise AssertionError(f"lstm H={H}: launches {launched}, expected "
                                     f"{want_launches}")
            if not max(errs + berrs) <= LSTM_TOL[dtype]:
                raise AssertionError(f"lstm H={H} {route} disagrees with its plain "
                                     f"versions: {errs} {berrs}")


# The shapes above the per-step kernels' whole-slice limits (PERF.md §6):
# (cell, dtype, H, the routes forward / backward, which directions to
# check).  fp32 LSTM H=2048 is He et al. 2019's streaming RNN-T width
# (arXiv:1811.06621): its forward stays whole-slice, its backward streams.
STEP_CHUNKED_CASES = (("gru", torch.float32, 1280, ("per_step", "step_chunked"), "fb"),
                      ("lstm", torch.float32, 2048, ("per_step", "step_chunked"), "fb"),
                      ("gru", torch.bfloat16, 4800, ("step_chunked", "step_chunked"), "f"),
                      ("lstm", torch.bfloat16, 3584, ("per_step", "step_chunked"), "fb"))
STEP_CHUNKED_TB = (8, 8)


@contextlib.contextmanager
def _step_route_forced(route):
    """Every per-step call forced onto ``route`` (timing the whole-slice and
    streamed kernels at one H only)."""
    saved = rnn_kernels._step_route
    rnn_kernels._step_route = lambda *args: route
    try:
        yield
    finally:
        rnn_kernels._step_route = saved


def _autograd_check(cell, inputs, gen):
    """GRUScanFunction / LSTMScanFunction against autograd of the plain loop,
    fp32: rel errs of every grad."""
    T, B = inputs[0].shape[:2]
    H = inputs[1].shape[0]
    n = 4 if cell == "gru" else 5
    leaves = [a.clone().requires_grad_() for a in inputs[:n]]
    lengths = inputs[n]
    fn = rnn_kernels.GRUScanFunction if cell == "gru" else rnn_kernels.LSTMScanFunction
    ref = rnn_kernels.gru_scan_reference if cell == "gru" else rnn_kernels.lstm_scan_reference
    cot = [torch.randn(T, B, H, device=DEVICE, generator=gen)] + [
        torch.randn(B, H, device=DEVICE, generator=gen) for _ in range(n - 3)]
    want = torch.autograd.grad(ref(*leaves, lengths), leaves, cot)
    got = torch.autograd.grad(fn.apply(*leaves, lengths, False), leaves, cot)
    torch.cuda.synchronize()
    return [_rel_err(g, r) for g, r in zip(got, want)]


def phase_step_chunked(gen):
    """The per-step kernels above their whole-slice limits (route
    "step_chunked": the slice streamed through shared memory in K chunks):
    the wrappers' shared memory equals the kernels' own, each case takes the
    routes and launch counts it should and holds its plain versions at the
    existing tolerances, fp32 backward also autograd of the plain loop; then
    each kernel timed whole-slice and streamed at its last whole-slice H
    (fp32, forced)."""
    libs = {"gru": (rnn_kernels._library(), rnn_kernels._bwd_library()),
            "lstm": (rnn_kernels._lstm_fwd_library(), rnn_kernels._lstm_bwd_library())}
    for cell, (fl, bl) in libs.items():
        for dtype in (torch.float32, torch.bfloat16):
            code = rnn_kernels._DTYPE_CODES[dtype]
            got = (getattr(fl, f"{cell}_scan_fwd_step_chunked_smem")(code),
                   getattr(bl, f"{cell}_scan_bwd_step_chunked_smem")(code))
            want = (rnn_kernels.step_chunked_smem_bytes(cell, dtype),
                    rnn_kernels.step_chunked_smem_bytes(cell, dtype, backward=True))
            if got != want:
                raise AssertionError(f"{cell} streamed per-step shared memory {dtype}: "
                                     f"kernels {got}, wrapper {want}")
    T, B = STEP_CHUNKED_TB
    results = []
    for cell, dtype, H, routes, dirs in STEP_CHUNKED_CASES:
        route_fn = rnn_kernels.gru_route if cell == "gru" else rnn_kernels.lstm_route
        got_routes = (route_fn(H, B, dtype, DEVICE), route_fn(H, B, dtype, DEVICE,
                                                               backward=True))
        if got_routes != routes:
            raise AssertionError(f"{cell} H={H} {dtype}: routes {got_routes}, not {routes}")
        fwd_op = rnn_kernels.gru_scan if cell == "gru" else rnn_kernels.lstm_scan
        bwd_op = (rnn_kernels.gru_scan_backward if cell == "gru"
                  else rnn_kernels.lstm_scan_backward)
        inputs = (_gru_inputs if cell == "gru" else _lstm_inputs)(T, B, H, dtype, gen)
        before = (fwd_op.launches, bwd_op.launches)
        if dirs == "f":
            xw, w, b, h0, lengths = inputs
            got = rnn_kernels.gru_scan(xw, w, b, h0, lengths)
            want = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths)
            torch.cuda.synchronize()
            errs, berrs = [_rel_err(g, r) for g, r in zip(got, want)], []
            ferr = max((g.float() - r.float()).abs().max().item()
                       for g, r in zip(got, want))
            ok = ferr <= KERNEL_TOL[dtype]
            tol = f"fwd max_abs_err {ferr:.2e} (tol {KERNEL_TOL[dtype]:.0e})"
            want_launches = (T, 0)
        elif cell == "gru":
            ferr, berrs = _gru_check(*inputs, False, gen)
            ok = ferr <= KERNEL_TOL[dtype] and max(berrs) <= BWD_TOL[dtype]
            tol = (f"fwd max_abs_err {ferr:.2e} (tol {KERNEL_TOL[dtype]:.0e}), bwd "
                   f"rel_err dxw/dnr/dh0/dW/db {'/'.join(f'{e:.2e}' for e in berrs)} "
                   f"(tol {BWD_TOL[dtype]:.1e})")
            want_launches = (T, T + 1)
        else:
            errs, berrs, _, _ = _lstm_check(*inputs, False, gen)
            ok = max(errs + berrs) <= LSTM_TOL[dtype]
            tol = (f"rel_err fwd {max(errs):.2e} bwd {max(berrs):.2e} "
                   f"(tol {LSTM_TOL[dtype]:.1e})")
            want_launches = (T, T + 1)
        launched = (fwd_op.launches - before[0], bwd_op.launches - before[1])
        auto = ""
        if dtype == torch.float32 and "b" in dirs:
            before = (fwd_op.launches, bwd_op.launches)
            aerrs = _autograd_check(cell, inputs, gen)
            alaunched = (fwd_op.launches - before[0], bwd_op.launches - before[1])
            auto = (f"; {cell.upper()}ScanFunction vs autograd of the plain loop "
                    f"launches {alaunched}, rel_err {'/'.join(f'{e:.2e}' for e in aerrs)}"
                    f" (tol {BWD_TOL[dtype]:.0e})")
            ok = ok and max(aerrs) <= BWD_TOL[dtype] and alaunched == (T, T + 1)
        print(f"step chunked {cell} {str(dtype)[6:]} H={H} T={T} B={B}: routes fwd/bwd "
              f"{got_routes}, launches {launched}, {tol}{auto}", flush=True)
        if launched != want_launches:
            raise AssertionError(f"{cell} H={H}: launches {launched}, expected "
                                 f"{want_launches}")
        if not ok:
            raise AssertionError(f"{cell} H={H} {dtype} on the streamed per-step route "
                                 "disagrees with its plain versions")
        results.append((cell, dtype, H))
    times = {}
    for cell in ("gru", "lstm"):
        for backward in (False, True):
            dtype = torch.float32
            H = rnn_kernels.step_max_hidden(cell, dtype, backward, DEVICE)
            inputs = (_gru_inputs if cell == "gru" else _lstm_inputs)(T, B, H, dtype, gen)
            if cell == "gru":
                xw, w, b, h0, lengths = inputs
                hall, _ = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths)
                hp = rnn_kernels.prev_all(hall, h0, lengths)
                gh = torch.randn(T, B, H, device=DEVICE, generator=gen)
                call = ((lambda: rnn_kernels.gru_scan_backward(
                    xw, hp, w, b, lengths, gh, h0)) if backward
                    else (lambda: rnn_kernels.gru_scan(xw, w, b, h0, lengths)))
            else:
                xw, w, b, h0, c0, lengths = inputs
                hall, call_, _, _ = rnn_kernels.lstm_scan_reference(
                    xw, w, b, h0, c0, lengths, with_carry=True)
                hp = rnn_kernels.prev_all(hall, h0, lengths)
                cp = rnn_kernels.prev_all(call_, c0, lengths)
                gh = torch.randn(T, B, H, device=DEVICE, generator=gen)
                call = ((lambda: rnn_kernels.lstm_scan_backward(
                    xw, hp, cp, w, b, lengths, gh, h0, c0)) if backward
                    else (lambda: rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths)))
            with _step_route_forced("per_step"):
                whole = _sync_time(call, 5)
            with _step_route_forced("step_chunked"):
                streamed = _sync_time(call, 5)
            with _step_route_forced("per_step"):
                whole = (whole + _sync_time(call, 5)) / 2
            name = f"{cell} {'bwd' if backward else 'fwd'}"
            times[name] = (H, whole, streamed)
            print(f"step chunked time {name} fp32 H={H} T={T} B={B}: whole-slice "
                  f"{whole:.3f} ms, streamed {streamed:.3f} ms (per scan)", flush=True)
    return times


def phase_cudnn_layers(gen):
    """Timing only, a yardstick: cuDNN's one-layer ``torch.nn.LSTM`` /
    ``torch.nn.GRU`` against the port's layer (``cells.RNNLayer``: the input
    GEMM, then K3/K4 or K1/K2) with the same bf16 weights, one direction,
    full lengths (where the two compute the same function; torch's GRU also
    keeps b_hn inside r * (...)), forward alone and forward + backward, at
    the main paths' shapes.  Both times include the input GEMM; PyTorch
    keeps bf16 RNN weights unflattened, so cuDNN's time also includes its
    per-call weight compaction (it warns so).  Nothing on any path calls
    cuDNN."""
    results = {}
    for rnn_type, B, T, H, I in CUDNN_LAYER_SHAPES:
        dtype = torch.bfloat16
        ref = {"lstm": torch.nn.LSTM, "gru": torch.nn.GRU}[rnn_type](
            I, H, batch_first=True).to(DEVICE, dtype)
        port = cells.RNNLayer(I, H, rnn_type).to(DEVICE, dtype)
        with torch.no_grad():
            port.w_ih.copy_(ref.weight_ih_l0.t())
            port.w_hh.copy_(ref.weight_hh_l0.t())
            port.b_ih.copy_(ref.bias_ih_l0)
            port.b_hh.copy_(ref.bias_hh_l0)
        x = torch.randn(B, T, I, device=DEVICE, generator=gen).to(dtype).requires_grad_()
        lengths = torch.full((B,), T, device=DEVICE)
        g_out = torch.randn(B, T, H, device=DEVICE, generator=gen).to(dtype)
        calls = {"cudnn": lambda: ref(x)[0], "port": lambda: port(x, lengths)[0]}
        params = {"cudnn": list(ref.parameters()), "port": list(port.parameters())}
        with torch.no_grad():
            diff = (calls["cudnn"]().float() - calls["port"]().float()).abs().max().item()
        row = {}
        for name, call in calls.items():
            with torch.no_grad():
                row[f"{name}_fwd_ms"] = _sync_time(call, 5)
            row[f"{name}_fwd_bwd_ms"] = _sync_time(lambda: torch.autograd.grad(
                call(), [x] + params[name], g_out), 5)
        results[f"{rnn_type} B={B} T={T} H={H} I={I}"] = row
        print(f"cudnn layer yardstick {rnn_type} bf16 B={B} T={T} H={H} input {I}: "
              f"forward cuDNN {row['cudnn_fwd_ms']:.3f} ms / port "
              f"{row['port_fwd_ms']:.3f} ms; forward+backward cuDNN "
              f"{row['cudnn_fwd_bwd_ms']:.3f} ms / port {row['port_fwd_bwd_ms']:.3f} ms "
              f"(max |output difference| {diff:.2e}, bf16 inside cuDNN)", flush=True)
        del ref, port
    return results


def _pcm(n, lengths=None, seed=SEED):
    """``_waves(n, lengths, seed)`` zero padded into (n, max length) float32,
    with their lengths."""
    waves = _waves(n, lengths, seed)
    wav = np.zeros((n, max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        wav[i, :len(w)] = w
    return wav, np.asarray([len(w) for w in waves], np.int64)


def logmel_bound_ms(rows, n_fft, n_bins, n_mels, high: bool) -> tuple:
    """Least time for one log-mel launch: the fp32 frames read once, the
    bf16 DFT matrices (two, or four with their low parts) and filterbank
    once, the (rows, n_mels) fp32 output written once, over HBM; the DFT
    (3 products in high mode) and the mel product over their real widths
    (n_fft samples, n_bins bins, n_mels filters) at the bf16 peak."""
    nbytes = (rows * n_fft * 4 + (4 if high else 2) * n_fft * n_bins * 2
              + n_bins * n_mels * 2 + rows * n_mels * 4)
    flops = (2.0 * rows * n_fft * 2 * n_bins * (3 if high else 1)
             + 2.0 * rows * n_bins * n_mels)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _logmel_plans(cfg, high, smem):
    """The plan the wrapper picks; where that is the wgmma engine also the
    mma.sync engine at 32 rows (its own check, the tiles it runs for wide
    windows); and the chunked engine wherever it was not picked."""
    plan = fused_frontend.kernel_plan(cfg, high, smem)
    plans = [plan]
    if plan[0] == "wgmma" and fused_frontend.kernel_smem_bytes(("mma", 32), cfg, high) <= smem:
        plans.append(("mma", 32))
    if plan[0] != "chunked":
        plans.append(("chunked", 32))
    return plans


# K6 beyond a 16-row tile of whole frames in high mode: n_fft=4096 (a 256 ms
# window at 16 kHz), hop 1024, 128 filters; 8 flagship waves, 640 frame rows
LOGMEL_WIDE = dict(window_size_sec=0.256, window_stride_sec=0.064, n_mels=128)


def phase_logmel():
    """Log-mel kernel vs its plain version at the flagship raw-PCM shape
    (B=64 waves up to 81760 samples, 32768 frame rows), a ragged batch with
    short utterances, the flagship waves at n_fft=512 with 160 filters, and
    8 of them at n_fft=4096 with 128 filters, in both precision modes, on
    the plan the wrapper picks, on the mma.sync engine at 32 rows where the
    pick is wgmma, and on the chunked engine; timed at the flagship shape
    and at n_fft=4096 (the picked plan and the chunked engine)."""
    base = base_config().data.audio
    wide = dataclasses.replace(base, window_size_sec=0.032, n_mels=160)
    widest = dataclasses.replace(base, **LOGMEL_WIDE)
    smem = rnn_kernels.device_limits(DEVICE)[1]
    worst, times = 0.0, {}
    batches = {"flagship": (base, _pcm(TRAIN_B)),
               "ragged": (base, _pcm(8, [N_SAMPLES, 4800, 3333, 1601, 250, 161, 40000,
                                         1])),
               "wide": (wide, _pcm(TRAIN_B)),
               "n_fft=4096": (widest, _pcm(8))}
    for name, (cfg, (wav, lengths)) in batches.items():
        wav = torch.from_numpy(wav).to(DEVICE)
        lengths = torch.from_numpy(lengths).to(DEVICE)
        rows, F = fused_frontend._frames(wav, cfg, lengths)
        K = cfg.n_fft // 2 + 1
        Kf, Kbp, _ = fused_frontend.kernel_dims(cfg)
        for high in (False, True):
            plans = _logmel_plans(cfg, high, smem)
            want_power = fused_frontend.dft_power_reference(rows, cfg, high)[:, :K]
            want = fused_frontend.mel_reference(want_power, cfg)
            for plan in plans:
                kernel_smem = fused_frontend._library().logmel_smem(
                    plan[1], Kf, Kbp, int(high), fused_frontend._ENGINES[plan[0]])
                if kernel_smem != fused_frontend.kernel_smem_bytes(plan, cfg, high):
                    raise AssertionError(
                        f"logmel shared memory {plan}: kernel {kernel_smem}, wrapper "
                        f"{fused_frontend.kernel_smem_bytes(plan, cfg, high)}")
                power = torch.empty((rows.shape[0], Kbp), device=DEVICE)
                got = fused_frontend.logmel_rows_cuda(rows, cfg, high, power, plan)
                staged = fused_frontend.mel_reference(power, cfg)
                torch.cuda.synchronize()
                p_err = _rel_err(power[:, :K], want_power)
                m_err = (got - staged).abs().max().item()
                end = (got - want).abs()
                e_err = end.max().item()
                over = (end > LOGMEL_MEL_TOL).float().mean().item()
                print(f"logmel check {name} n_fft={cfg.n_fft} n_mels={cfg.n_mels} "
                      f"rows={rows.shape[0]} high={high} {plan[0]} engine, tile rows "
                      f"{plan[1]} ({kernel_smem} bytes of shared memory): power rel_err "
                      f"{p_err:.2e} (tol {LOGMEL_POWER_TOL:.0e}); mel stage on the "
                      f"kernel's power max_abs_err {m_err:.2e} (tol {LOGMEL_MEL_TOL:.0e}); "
                      f"end to end max_abs_err {e_err:.2e} (tol {LOGMEL_END_TOL:.2e}), "
                      f"share above {LOGMEL_MEL_TOL:.0e}: {over:.2e}", flush=True)
                if not (p_err <= LOGMEL_POWER_TOL and m_err <= LOGMEL_MEL_TOL
                        and e_err <= LOGMEL_END_TOL and not power[:, K:].any()):
                    raise AssertionError(f"logmel ({plan}) disagrees with its plain version")
                worst = max(worst, e_err)
                if plan == plans[0]:
                    chosen = got
            feats, flen = fused_frontend.logmel_fused(wav, cfg, lengths, high)
            torch.cuda.synchronize()
            if not (feats.shape == (wav.shape[0], F, cfg.n_mels)
                    and torch.isfinite(feats).all()
                    and torch.equal(flen.cpu(), (lengths.cpu() // cfg.hop_length + 1)
                                    .to(torch.int32))
                    and torch.equal(feats.reshape(-1, cfg.n_mels), chosen)):
                raise AssertionError("logmel_fused: wrong shape, lengths or values")
            if name not in ("flagship", "n_fft=4096"):
                continue
            ms = _sync_time(lambda: fused_frontend.logmel_rows_cuda(rows, cfg, high), 20)
            plain = _sync_time(lambda: fused_frontend.mel_reference(
                fused_frontend.dft_power_reference(rows, cfg, high), cfg), 5)
            bound, bound_by = logmel_bound_ms(rows.shape[0], cfg.n_fft, K, cfg.n_mels, high)
            extra = ""
            if name == "flagship":
                times[high] = (ms, plain, bound, bound_by)
            else:
                chunked = _sync_time(lambda: fused_frontend.logmel_rows_cuda(
                    rows, cfg, high, None, ("chunked", 32)), 20)
                times[("wide", high)] = (plans[0], ms, chunked, bound)
                extra = f", chunked engine {chunked:.4f} ms"
            print(f"logmel time {name} rows={rows.shape[0]} high={high}: kernel "
                  f"({plans[0][0]} engine, {plans[0][1]} rows) {ms:.4f} ms{extra}, plain "
                  f"{plain:.3f} ms, bound {bound:.4f} ms by {bound_by}", flush=True)
    return worst, times


def _lattice_edges(N, T, U1, gen):
    """Blank / label log-probs of a random V=72 lattice, (N, T, U+1) fp32."""
    lp = torch.log_softmax(torch.randn(N, T, U1, 72, device=DEVICE, generator=gen), -1)
    return lp[..., 0].contiguous(), lp[..., 5].contiguous()


def _sweep_err(got, want) -> float:
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def phase_sweep(gen):
    """RNN-T sweep kernel vs its plain version: the flagship lattice, the 2B
    lattices of one loss (alpha and beta in one launch), a ragged T and a T
    above 8192."""
    U1 = TRAIN_U + 1
    worst = 0.0
    for N, T in ((TRAIN_B, T_FRAMES), (2 * TRAIN_B, T_FRAMES), (TRAIN_B, 300), (2, 9000)):
        be, le = _lattice_edges(N, T, U1, gen)
        got = rnnt_kernels.sweep(be, le)
        want = rnnt_kernels.sweep_reference(be, le)
        torch.cuda.synchronize()
        abs_err = (got - want).abs().max().item()
        rel = _sweep_err(got, want)
        print(f"rnnt_sweep check N={N} T={T} U+1={U1}: max_abs_err {abs_err:.3e} "
              f"(|alpha| up to {want.abs().max().item():.1f}), rel {rel:.2e} "
              f"tol {SWEEP_TOL:.0e}", flush=True)
        if not (rel <= SWEEP_TOL and got.shape == want.shape and got.is_contiguous()):
            raise AssertionError(f"rnnt_sweep disagrees with its plain version: {rel}")
        worst = max(worst, abs_err)
    times = {}
    for N in (TRAIN_B, 2 * TRAIN_B):
        be, le = _lattice_edges(N, T_FRAMES, U1, gen)
        ms = _sync_time(lambda: rnnt_kernels.sweep(be, le), 20)
        plain = _sync_time(lambda: rnnt_kernels.sweep_reference(be, le), 3)
        bound, bound_by = sweep_bound_ms(N, T_FRAMES, U1)
        times[N] = (ms, plain, bound, bound_by)
        print(f"rnnt_sweep time N={N} T={T_FRAMES} U+1={U1}: kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, bound {bound:.4f} ms by {bound_by}", flush=True)
    return worst, times


def _waves(n, lengths=None, seed=SEED):
    """Seeded synthetic speech-band signals; without ``lengths`` the first
    is exactly T_FRAMES long and the others 3/4 of that or more."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if lengths is not None:
            length = lengths[i]
        else:
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


@contextlib.contextmanager
def _plain_gru(plain: bool = True):
    """Within the block (where ``plain``), the encoder's GRU layers run the
    plain GRU on the card (comparison only)."""
    saved = cells.gru_scan
    if plain:
        cells.gru_scan = rnn_kernels.gru_scan_reference
    try:
        yield
    finally:
        cells.gru_scan = saved


def _encode_plain(model, feats, lengths):
    """The encoder with the plain GRU on the card (comparison only)."""
    with _plain_gru():
        return model.encode(feats, lengths)[0]


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


def step_model_flops(cfg, batch: int, t_frames: int, u_labels: int) -> float:
    """Matmul FLOPs of one training step (fwd + bwd) from the config: 2 m n k
    per forward GEMM, 3x forward for training (the port's copy of
    ``bench.py::step_model_flops`` with its prediction-net and joint
    terms)."""
    tn, pn, jn = cfg.model.transnet, cfg.model.prednet, cfg.model.jointnet
    gates = {"gru": 3, "lstm": 4, "rnn": 1}
    H, dirs = tn.hidden_size, 2 if tn.bidirectional else 1
    fwd, in_size = 0.0, tn.input_size
    for _ in range(tn.num_layers):
        fwd += dirs * 2 * batch * t_frames * gates[tn.rnn_type.lower()] * H * (in_size + H)
        in_size = dirs * H
    fwd += 2 * batch * t_frames * in_size * tn.output_size
    Hp, u1 = pn.hidden_size, u_labels + 1
    pg = {**gates, "stateless": 0}[pn.rnn_type.lower()]
    fwd += pn.num_layers * 2 * batch * u1 * pg * Hp * (Hp + Hp) if pg else 0.0
    fwd += 2 * batch * u1 * Hp * pn.output_size
    fwd += 2 * batch * t_frames * tn.output_size * jn.num_classes
    fwd += 2 * batch * u1 * pn.output_size * jn.num_classes
    return 3.0 * fwd


def _train_batch(cfg, B, T, U, seed=SEED):
    """A seeded batch built like ``__graft_entry__._example_batch``, with
    full feature lengths as ``bench.py`` uses, on the card."""
    rng = np.random.RandomState(seed)
    V = cfg.model.jointnet.num_classes
    targets = rng.randint(1, V, size=(B, U)).astype(np.int64)
    text_in = np.concatenate([np.zeros((B, 1), np.int64), targets], axis=1)
    feats = rng.randn(B, T, cfg.model.transnet.input_size).astype(np.float32)
    batch = {"feats": feats, "feat_lengths": np.full((B,), T, np.int64),
             "text_in": text_in, "text_lengths": np.full((B,), U + 1, np.int64),
             "targets": targets, "target_lengths": np.full((B,), U, np.int64)}
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


KERNEL_WRAPPERS = {"gru_fwd": rnn_kernels.gru_scan,
                   "gru_bwd": rnn_kernels.gru_scan_backward,
                   "lstm_fwd": rnn_kernels.lstm_scan,
                   "lstm_bwd": rnn_kernels.lstm_scan_backward,
                   "rnnt_sweep": rnnt_kernels.sweep,
                   "logmel": fused_frontend.logmel_fused}


def _counts():
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def _zero_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def scan_launches(rnn_type: str, steps: int, hidden: int = 1024,
                  batch: int = TRAIN_B, dtype=torch.bfloat16, device=None) -> tuple:
    """Launches of one directional scan of ``steps`` steps, forward and
    backward, on the card of ``device`` (an H100 SXM where none is named):
    the persistent kernels take 1 forward and 2 backward (the gates GEMM,
    then the chain) whatever the length; above the persistent limit a GRU
    or an LSTM takes the per-step kernels, T forward and T + 1 backward."""
    route = {"gru": rnn_kernels.gru_route, "lstm": rnn_kernels.lstm_route}[
        rnn_type.lower()]
    if route(hidden, batch, dtype, device) != "persistent":
        return steps, steps + 1
    return 1, 2


def step_launches(cfg, T: int, U: int, raw_pcm: bool = False, device=None) -> dict:
    """Kernel launches of one train_step: every directional scan of an RNN
    encoder (T steps) and of the prediction network (U+1 steps) takes
    ``scan_launches`` in its cell type's kernels (no RNN config here
    reduces time; a Conformer encoder launches none); the loss one sweep; a
    raw-PCM batch one log-mel."""
    tn, pn = cfg.model.transnet, cfg.model.prednet
    want = dict.fromkeys(KERNELS, 0)
    nets = [(pn, pn.num_layers, U + 1)]
    if tn.arch == "rnn":  # the Conformer encoder reaches no kernel
        nets.append((tn, tn.num_layers * (2 if tn.bidirectional else 1), T))
    for net, scans, steps in nets:
        fwd, bwd = scan_launches(net.rnn_type, steps, net.hidden_size, device=device)
        want[f"{net.rnn_type.lower()}_fwd"] += scans * fwd
        want[f"{net.rnn_type.lower()}_bwd"] += scans * bwd
    want["rnnt_sweep"] = 1
    want["logmel"] = int(raw_pcm)
    return want


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel of the training and serving paths swapped for its plain
    version (comparison only)."""
    saved = (cells.gru_scan, rnn_kernels.gru_scan, rnn_kernels.gru_scan_backward,
             cells.lstm_scan, rnn_kernels.lstm_scan, rnn_kernels.lstm_scan_backward,
             rnnt_kernels.sweep)
    cells.gru_scan = rnn_kernels.gru_scan = rnn_kernels.gru_scan_reference
    rnn_kernels.gru_scan_backward = rnn_kernels.gru_scan_backward_reference
    cells.lstm_scan = rnn_kernels.lstm_scan = rnn_kernels.lstm_scan_reference
    rnn_kernels.lstm_scan_backward = rnn_kernels.lstm_scan_backward_reference
    rnnt_kernels.sweep = rnnt_kernels.sweep_reference
    try:
        yield
    finally:
        (cells.gru_scan, rnn_kernels.gru_scan, rnn_kernels.gru_scan_backward,
         cells.lstm_scan, rnn_kernels.lstm_scan, rnn_kernels.lstm_scan_backward,
         rnnt_kernels.sweep) = saved


def phase_profile_step(state, batch, rows_out=None):
    """Device busy share and device time by kernel over one training step
    (``rows_out``, a list, receives (device us, calls, kernel name) rows)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(r[0] for r in rows) / 1e3
    if rows_out is not None:
        rows_out.extend(rows)
    if device_ms == 0.0:
        print("train profile: the profiler saw no device time (not measured)",
              flush=True)
        return None
    print(f"train profile bf16 step (profiler on): wall {wall_ms:.1f} ms, device "
          f"busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%)", flush=True)
    for dev_us, count, name in sorted(rows, reverse=True)[:12]:
        print(f"train profile   {dev_us / 1e3:9.2f} ms  {count:7d} calls  "
              f"{name[:70]}", flush=True)
    return device_ms / wall_ms


def _bf16_train_state(cfg, flax_params):
    cfg = dataclasses.replace(cfg, train=TrainConfig(
        precision="bf16", accumulate_grad_batches=1, max_steps=1000))
    sd = state_dict_from_flax(flax_params, cfg.model)
    return cfg, TrainState.create(cfg, DEVICE, state_dict=sd, seed=SEED)


def _run_steps(label, state, batch, want, warmup, steps, watch):
    """``warmup`` steps, then ``steps`` timed steps with the launch counts set
    to 0 before and read after each: they must equal ``want``, the loss and
    grad norm must be finite and ``watch`` (a param name) must move.
    Returns (step ms list, summed launches, last metrics)."""
    for _ in range(warmup):
        metrics = train_step(state, batch)
    torch.cuda.synchronize()
    param = state.params[watch]
    step_ms, launches = [], dict.fromkeys(KERNELS, 0)
    for i in range(steps):
        before = param.detach().clone()
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = _counts()
        launches = {k: launches[k] + got[k] for k in KERNELS}
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        moved = (param.detach() - before).abs().max().item()
        print(f"{label} step {i}: {step_ms[-1]:.1f} ms loss {loss:.4f} grad_norm "
              f"{gnorm:.4f} max |d {watch}| {moved:.3e}; launches "
              f"{json.dumps(got)}", flush=True)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"{label} step {i}: loss {loss}, grad_norm {gnorm}")
        if not moved > 0.0:
            raise AssertionError(f"{label} step {i}: the params did not change")
        if got != want:
            raise AssertionError(f"{label} step {i}: launches {got}, expected {want}")
    return step_ms, launches, metrics


def phase_training(flax_params):
    """The flagship path: bf16 train_step of base_config() at B=64, T=512,
    U=48 on precomputed features."""
    cfg, state = _bf16_train_state(base_config(), flax_params)
    B, T, U = TRAIN_B, T_FRAMES, TRAIN_U
    batch = _train_batch(cfg, B, T, U)
    want = step_launches(cfg, T, U, device=DEVICE)
    print(f"train expected launches per step {json.dumps(want)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    step_ms, launches, _ = _run_steps("train", state, batch, want, WARMUP_STEPS,
                                      TIMED_STEPS, "encoder.rnn.fwd.0.w_hh")
    ms = float(np.mean(step_ms))
    mfu = step_model_flops(cfg, B, T, U) / (ms / 1e3) / PEAK_BF16_FLOPS
    result = {"step_ms": ms, "step_ms_each": step_ms, "utt_per_s": B / (ms / 1e3),
              "mfu": mfu, "launches_per_step": want, "max_memory_allocated_mib":
              torch.cuda.max_memory_allocated() / 2 ** 20}
    print(f"train bf16 B={B} T={T} U={U}: step {ms:.1f} ms, {result['utt_per_s']:.2f} "
          f"utt/s, MFU {mfu:.4f} (of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), "
          f"max_memory_allocated {result['max_memory_allocated_mib']:.0f} MiB",
          flush=True)
    result["device_busy_share"] = phase_profile_step(state, batch)
    del state
    torch.cuda.empty_cache()
    return launches, result


def quantize_pcm(wav: np.ndarray, lengths: np.ndarray):
    """Peak-scaled int16 and per-utterance float32 scales, wav[b] ~= q[b] *
    scale[b] (the numpy recipe of ``data/collate.py::quantize_waveforms``)."""
    q = np.zeros(wav.shape, np.int16)
    scales = np.zeros((wav.shape[0],), np.float32)
    for i, n in enumerate(lengths):
        peak = float(np.max(np.abs(wav[i, :n]))) if n else 0.0
        scales[i] = peak / 32767.0 if peak > 0 else 0.0
        if scales[i] > 0:
            q[i, :n] = np.round(wav[i, :n] / scales[i]).astype(np.int16)
    return q, scales


def phase_raw_pcm(flax_params):
    """bf16 train_step of base_config() on raw PCM at the flagship shape:
    B=64 seeded waves of up to 81760 samples (512 frames) shipped as int16
    plus a per-utterance scale, U=48; the log-mel kernel runs in every
    step.  Step time and the frontend's share of it."""
    cfg, state = _bf16_train_state(base_config(), flax_params)
    B, T, U = TRAIN_B, T_FRAMES, TRAIN_U
    wav, lengths = _pcm(B, seed=SEED + 2)
    q, scale = quantize_pcm(wav, lengths)
    text = {k: v for k, v in _train_batch(cfg, B, T, U).items()
            if k not in ("feats", "feat_lengths")}
    batch = {"wav": torch.from_numpy(q).to(DEVICE),
             "wav_scale": torch.from_numpy(scale).to(DEVICE),
             "wav_lengths": torch.from_numpy(lengths).to(DEVICE), **text}
    want = step_launches(cfg, T, U, raw_pcm=True, device=DEVICE)
    print(f"raw-PCM expected launches per step {json.dumps(want)}", flush=True)
    step_ms, launches, metrics = _run_steps("raw-PCM", state, batch, want, 1,
                                            RAW_PCM_STEPS, "encoder.rnn.fwd.0.w_hh")
    feats, flen = device_frontend(cfg.data.audio, dequantize_wav(batch),
                                  batch["wav_lengths"])
    if not (feats.shape == (B, T, cfg.data.audio.n_mels)
            and torch.isfinite(feats).all() and int(flen.max()) == T):
        raise AssertionError(f"raw-PCM features {tuple(feats.shape)}, lengths up "
                             f"to {int(flen.max())}")
    frontend_ms = _sync_time(lambda: device_frontend(
        cfg.data.audio, dequantize_wav(batch), batch["wav_lengths"]), 5)
    ms = float(np.mean(step_ms))
    result = {"step_ms": ms, "step_ms_each": step_ms, "utt_per_s": B / (ms / 1e3),
              "frontend_ms": frontend_ms, "frontend_share": frontend_ms / ms,
              "loss": metrics["loss"].item(), "launches_per_step": want}
    print(f"raw-PCM bf16 B={B} S={wav.shape[1]} (int16) U={U}: step {ms:.1f} ms, "
          f"{result['utt_per_s']:.2f} utt/s; frontend (dequantize, normalise, "
          f"frame, log-mel kernel) {frontend_ms:.3f} ms = "
          f"{100 * frontend_ms / ms:.2f}% of the step", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches, result


def phase_tiny(tokenizer, waves):
    """tiny_config() at full width (2-layer bidirectional LSTM encoder and a
    1-layer LSTM prediction network, H=320) from seeded flax-layout
    weights: bf16 train_steps at B=64, T=512, U=48, then one greedy
    transcribe_batch of 8 waves; every LSTM scan through K3 / K4."""
    cfg = tiny_config()
    flax_params = random_flax_params(cfg.model, torch.Generator().manual_seed(SEED + 3))
    cfg, state = _bf16_train_state(cfg, flax_params)
    B, T, U = TRAIN_B, T_FRAMES, TRAIN_U
    batch = _train_batch(cfg, B, T, U)
    want = step_launches(cfg, T, U, device=DEVICE)
    print(f"tiny expected launches per step {json.dumps(want)}", flush=True)
    step_ms, launches, metrics = _run_steps("tiny", state, batch, want, 1,
                                            TINY_STEPS, "encoder.rnn.bwd.1.w_hh")
    del state
    rec = Recognizer(cfg, flax_params, tokenizer, decoder="greedy", precision="bf16",
                     device=DEVICE)
    rec.transcribe(waves[0][:16000])  # warm-up
    _zero_counts()
    texts, req_ms, _ = _request(rec.transcribe_batch, waves)
    got = _counts()
    scans = cfg.model.transnet.num_layers * 2
    want_serve = dict.fromkeys(KERNELS, 0)
    want_serve["lstm_fwd"] = scans * scan_launches(
        "lstm", T_FRAMES, cfg.model.transnet.hidden_size, len(waves), device=DEVICE)[0]
    print(f"tiny bf16 transcribe_batch of {len(waves)}: {req_ms:.1f} ms, launches "
          f"{json.dumps(got)} (expected {json.dumps(want_serve)}); {texts}", flush=True)
    if got != want_serve or not all(isinstance(x, str) for x in texts):
        raise AssertionError("tiny transcribe_batch: wrong launches or transcripts")
    launches["lstm_fwd"] += got["lstm_fwd"]
    ms = float(np.mean(step_ms))
    result = {"step_ms": ms, "step_ms_each": step_ms, "utt_per_s": B / (ms / 1e3),
              "loss": metrics["loss"].item(), "launches_per_step": want,
              "transcribe_batch8_ms": req_ms}
    print(f"tiny bf16 B={B} T={T} U={U}: step {ms:.1f} ms, "
          f"{result['utt_per_s']:.2f} utt/s", flush=True)
    torch.cuda.empty_cache()
    return launches, result


def phase_step_vs_plain(flax_params):
    """One fp32 loss + grads at full width with the kernels, then with every
    kernel's plain version; deterministic (no SpecAugment, no dropout)."""
    cfg = base_config()
    cfg = dataclasses.replace(cfg, train=TrainConfig(precision="fp32"))
    model = build_model(cfg, DEVICE, state_dict_from_flax(flax_params, cfg.model),
                        trainable=True)
    params = dict(model.named_parameters())
    feat_lengths, target_lengths = PLAIN_STEP_LENGTHS
    batch = _train_batch(cfg, len(feat_lengths), T_FRAMES, TRAIN_U, seed=SEED + 1)
    batch["feat_lengths"] = torch.tensor(feat_lengths, device=DEVICE).clamp(max=T_FRAMES)
    batch["target_lengths"] = torch.tensor(target_lengths, device=DEVICE)

    def run():
        t0 = time.perf_counter()
        loss = loss_fn(model, cfg, params, batch, None, deterministic=True)
        grads = torch.autograd.grad(loss, [params[n] for n in STEP_GRAD_PARAMS])
        torch.cuda.synchronize()
        return loss.item(), grads, (time.perf_counter() - t0) * 1e3

    loss_k, grads_k, ms_k = run()
    with _plain_kernels():
        loss_p, grads_p, ms_p = run()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = {n: _rel_err(g, r) for n, g, r in zip(STEP_GRAD_PARAMS, grads_k, grads_p)}
    print(f"fp32 step B={len(feat_lengths)} kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_err:.2e}, tol {STEP_LOSS_TOL:.0e}); grad rel err "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (tol {STEP_GRAD_TOL:.0e}); loss+grads {ms_k:.0f} ms with kernels, "
          f"{ms_p:.0f} ms plain", flush=True)
    if not (loss_err <= STEP_LOSS_TOL and max(errs.values()) <= STEP_GRAD_TOL):
        raise AssertionError("the fp32 step with kernels disagrees with the plain one")
    del model, params
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_rel_err": errs, "kernel_ms": ms_k,
            "plain_ms": ms_p}


def phase_serving(flax_params, tokenizer, waves):
    cfg = base_config()
    layers = cfg.model.transnet.num_layers * (2 if cfg.model.transnet.bidirectional else 1)
    recognizers = {}
    for precision in ("bf16", "fp32"):
        recognizers[precision] = Recognizer(cfg, flax_params, tokenizer,
                                            decoder="greedy", precision=precision,
                                            device=DEVICE)
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
        for n, want, what in ((n1, layers, "batch of 1"), (n8, layers, "batch of 8"),
                              (n_s, layers, "transcribe")):
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
    # the first 2 s of each wave: the frame loop's cost grows with the frames
    results["label_looping"] = phase_label_looping(
        recognizers["bf16"], [w[:LABEL_LOOP_SAMPLES] for w in waves])

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

# Phase 5, the Trainer: base_config() on raw PCM, a global batch of 64,
# validation and a checkpoint at step 4 and at the end of fit (step 8), then
# a resumed fit to step 10; 2 steps profiled; checkpoints under build/.
TRAINER_N, TRAINER_VAL, TRAINER_B = 640, 16, 64
TRAINER_STEPS, TRAINER_RESUME_STEPS, TRAINER_VAL_EVERY = 8, 10, 4
TRAINER_PROFILE = (5, 7)
TRAINER_DIR = os.path.join(REPO, "build", "trainer")


def _fingerprint(batch) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(batch["targets"]).tobytes()
                          + np.ascontiguousarray(batch["wav_lengths"]).tobytes()
                          ).hexdigest()[:16]


def _recording_trainer(trainer, seen):
    """Record a fingerprint of every training batch the feed yields, in
    order (the prefetcher hands them to train_step in that order)."""
    host = trainer._host_batches

    def recorded(dataset, *args, **kwargs):
        for batch in host(dataset, *args, **kwargs):
            if dataset is trainer.train_ds:
                seen.append(_fingerprint(batch))
            yield batch
    trainer._host_batches = recorded


def _device_busy_ms(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def phase_trainer(flax_params, waves, bare_busy):
    """The training loop through its entry points: Trainer.fit on raw PCM,
    validation (eval_step, greedy decode, WER / CER), checkpoints, a resumed
    fit, then Recognizer.from_checkpoint; every train_step's launches
    checked; the step time, the host feed per batch, the device-busy share
    of a profiled window, validation and checkpoint times."""
    base = base_config()
    audio = base.data.audio
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, precision="bf16", per_device_train_batch_size=TRAINER_B,
        per_device_eval_batch_size=8, max_steps=TRAINER_STEPS,
        val_every_steps=TRAINER_VAL_EVERY, log_every_steps=2,
        checkpoint_dir=TRAINER_DIR, wav_transfer_dtype="int16", seed=SEED))
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    V = cfg.model.jointnet.num_classes
    max_sec = N_SAMPLES / audio.sample_rate
    train_ds = SyntheticAudioDataset(TRAINER_N, audio, vocab_size=V, min_sec=1.0,
                                     max_sec=max_sec, min_labels=4, max_labels=48,
                                     seed=SEED, as_waveform=True)
    val_ds = SyntheticAudioDataset(TRAINER_VAL, audio, vocab_size=V, min_sec=1.0,
                                   max_sec=max_sec, min_labels=4, max_labels=48,
                                   seed=SEED + 1, as_waveform=True)
    sd = state_dict_from_flax(flax_params, cfg.model)
    want = step_launches(cfg, T_FRAMES, TRAIN_U, raw_pcm=True, device=DEVICE)
    launches = dict.fromkeys(KERNELS, 0)
    steps_checked = []
    step_fn = train_loop.train_step

    def counted_step(state, batch):
        _zero_counts()
        metrics = step_fn(state, batch)
        got = _counts()
        steps_checked.append(got)
        if got != want:
            raise AssertionError(f"Trainer step {state.step}: launches {got}, "
                                 f"expected {want}")
        for k in KERNELS:
            launches[k] += got[k]
        return metrics

    train_loop.train_step = counted_step
    try:
        seen_a, seen_b = [], []
        trainer = train_loop.Trainer(cfg, train_ds, val_ds, device=DEVICE, state_dict=sd,
                                     profile_dir=os.path.join(TRAINER_DIR, "profile"),
                                     profile_steps=TRAINER_PROFILE)
        _recording_trainer(trainer, seen_a)
        t0 = time.perf_counter()
        state = trainer.fit()
        fit_s = time.perf_counter() - t0
        if state.step != TRAINER_STEPS or trainer.ckpt.latest_step() != TRAINER_STEPS:
            raise AssertionError(f"fit ended at step {state.step}, latest checkpoint "
                                 f"{trainer.ckpt.latest_step()}")
        busy_ms = _device_busy_ms(trainer.profile)
        wall_ms = trainer.profile_wall_s * 1e3
        busy = busy_ms / wall_ms if busy_ms > 0 else None  # no device time seen
        feed_a, val_s, save_s = (list(trainer.feed_s), list(trainer.validate_s),
                                 list(trainer.save_s))
        del trainer, state
        torch.cuda.empty_cache()

        resumed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, max_steps=TRAINER_RESUME_STEPS))
        trainer = train_loop.Trainer(resumed_cfg, train_ds, val_ds, device=DEVICE)
        _recording_trainer(trainer, seen_b)
        state = trainer.fit(resume=True)
        if state.step != TRAINER_RESUME_STEPS:
            raise AssertionError(f"the resumed fit ended at step {state.step}")
        schedule = [_fingerprint(b) for epoch in (0, 1)
                    for b in train_loop.Trainer._host_batches(
                        trainer, train_ds, epoch, TRAINER_B)][:TRAINER_RESUME_STEPS]
        if (seen_a[:TRAINER_STEPS] != schedule[:TRAINER_STEPS]
                or seen_b[:TRAINER_RESUME_STEPS - TRAINER_STEPS]
                != schedule[TRAINER_STEPS:]):
            raise AssertionError("the resumed fit did not continue the schedule at step "
                                 f"{TRAINER_STEPS}: {seen_a} {seen_b} {schedule}")
        restore_s, val_s = trainer.restore_s, val_s + trainer.validate_s
        save_s += trainer.save_s
        ledger = trainer.ckpt._read_ledger()
        del trainer, state
        torch.cuda.empty_cache()
    finally:
        train_loop.train_step = step_fn
    if len(steps_checked) != TRAINER_RESUME_STEPS:
        raise AssertionError(f"{len(steps_checked)} train steps counted")

    logs = [json.loads(line) for line in open(os.path.join(TRAINER_DIR, "metrics.jsonl"))]
    train_logs = [r for r in logs if r.get("split") == "train"]
    val_logs = [r for r in logs if r.get("split") == "val"]
    if not (train_logs and all(np.isfinite(r["loss"]) for r in train_logs)
            and len(val_logs) == 3 and all(np.isfinite(r["val_loss"]) for r in val_logs)
            and any(r.get("event") == "resumed" and r["step"] == TRAINER_STEPS
                    for r in logs)):
        raise AssertionError(f"Trainer logs: {logs}")

    rec = Recognizer.from_checkpoint(TRAINER_DIR, use_ema=False, decoder="greedy",
                                     precision="bf16", device=DEVICE)
    texts, req_ms, _ = _request(rec.transcribe_batch, waves)
    if len(texts) != len(waves) or not all(isinstance(x, str) for x in texts):
        raise AssertionError(f"Recognizer.from_checkpoint transcripts: {texts}")
    del rec
    torch.cuda.empty_cache()

    step_ms = [r["step_ms"] for r in train_logs]
    result = {
        "steps": TRAINER_RESUME_STEPS, "launches_per_step": want,
        "step_ms_logged": step_ms, "feed_ms_per_batch": [1e3 * x for x in feed_a],
        "profile_window_steps": TRAINER_PROFILE, "profile_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy,
        "bare_step_device_busy_share": bare_busy, "fit_s": fit_s,
        "validate_s": val_s, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s, "val": [
            {k: r[k] for k in ("step", "val_loss", "val_wer", "val_cer")}
            for r in val_logs],
        "retained_steps": sorted(ledger), "from_checkpoint_batch8_ms": req_ms}
    print(f"trainer bf16 raw PCM, global batch {TRAINER_B}: fit to step {TRAINER_STEPS} "
          f"in {fit_s:.1f} s, resumed to {TRAINER_RESUME_STEPS}; logged step_ms "
          f"{step_ms}; host feed per batch (ms) "
          f"{[round(1e3 * x, 1) for x in feed_a]}; device busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of a "
          f"profiled window of 2 steps "
          f"({wall_ms:.1f} ms, profiler on) vs the bare step's "
          f"{'not measured' if bare_busy is None else f'{100 * bare_busy:.1f}%'} "
          f"(phase 4a); validation {[round(x, 2) for x in val_s]} s, checkpoint save "
          f"{[round(x, 2) for x in save_s]} s, restore {[round(x, 2) for x in restore_s]}"
          f" s; retained steps {sorted(ledger)}; from_checkpoint batch of 8 "
          f"{req_ms:.1f} ms: {texts}", flush=True)
    return launches, result


LABEL_LOOP_SAMPLES = 32000


def phase_label_looping(rec, waves):
    """Label-looping greedy decode against the frame scan on one batch: the
    tokens must be equal; both timed (host clock, synchronised)."""
    with torch.inference_mode():
        feats, feat_lengths = rec._features(waves)
        kw = dict(blank_id=rec.tokenizer.blank_token_id,
                  max_symbols=rec.cfg.train.greedy_max_symbols,
                  max_output_len=rec.max_output_len)
        out, ms = {}, {}
        for name, fn in (("frame", greedy_mod.greedy_decode),
                         ("label", greedy_mod.greedy_decode_label_looping)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn(rec.model, feats, feat_lengths, **kw)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
    (tf, lf), (tl, ll) = out["frame"], out["label"]
    same = torch.equal(lf, ll) and all(torch.equal(tf[i, :lf[i]], tl[i, :ll[i]])
                                       for i in range(len(waves)))
    print(f"label looping vs frame scan, bf16 batch of {len(waves)}: tokens equal "
          f"{same}; frame scan {ms['frame']:.1f} ms, label looping {ms['label']:.1f} ms "
          f"(encoder included, after the requests above)", flush=True)
    if not same:
        raise AssertionError("label-looping tokens differ from the frame scan's")
    return {"tokens_equal": same, "frame_scan_ms": ms["frame"],
            "label_looping_ms": ms["label"]}


# Phase 6, decoding: the serving paths users run.  Offline: the default
# Recognizer (the device beam, width cfg.inference.beam_width = 5) on
# base_config() in bf16, with and without an on-device char LM, and the host
# A/B beam with that LM and two hotwords; streaming on bench_streaming.py's
# model; the inference CLI.
# the host beam's 2 waves: 0.5 s and 0.375 s (1.0 s and 0.75 s before,
# halved for the script's time limit)
HOST_BEAM_SAMPLES = (8000, 6000)
CLI_SAMPLES = 16000                 # the CLI's 2 waves: 1.0 s each
HOTWORDS = ["ㄱㅏ", "ㄴㅏ"]          # graphemes of the default vocabulary
DEVICE_LM_WEIGHT = 0.5
STREAM_CHUNK_FRAMES = 64
STREAM_FEED_MS = 100
STREAM_UTT_SEC = 10.0
# bench_streaming.py times 5 utterances after a warm-up; 3 here, for the
# script's time limit
STREAM_UTTS = 3
STREAM_POLL_EVERY = 5  # beam partials polled every 5 feeds, as bench_streaming.py
DECODE_DIR = os.path.join(REPO, "build", "decoding")


def write_char_arpa(tokenizer, path: str, seed: int = SEED) -> str:
    """A seeded order-3 ARPA file over the tokenizer's graphemes (the word
    delimiter included): every grapheme a unigram, 400 bigrams and 400
    trigrams whose histories are among the bigrams."""
    rng = np.random.RandomState(seed)
    chars = [tokenizer.ids_to_tokens[i] for i in range(tokenizer.vocab_size)
             if i not in tokenizer._special_ids]
    pick = lambda: chars[rng.randint(len(chars))]
    pairs = set()
    while len(pairs) < 400:
        pairs.add((pick(), pick()))
    pairs = sorted(pairs)
    triples = set()
    while len(triples) < 400:
        triples.add(pairs[rng.randint(len(pairs))] + (pick(),))
    lines = ["\\data\\", f"ngram 1={len(chars) + 2}", f"ngram 2={len(pairs)}",
             f"ngram 3={len(triples)}", "", "\\1-grams:",
             f"-1.0000\t<s>\t{-rng.uniform(0.1, 0.8):.4f}", "-1.5000\t</s>"]
    lines += [f"{-rng.uniform(0.5, 2.5):.4f}\t{c}\t{-rng.uniform(0.1, 0.8):.4f}"
              for c in chars]
    lines += ["", "\\2-grams:"]
    lines += [f"{-rng.uniform(0.1, 1.5):.4f}\t{' '.join(g)}\t{-rng.uniform(0.1, 0.8):.4f}"
              for g in pairs]
    lines += ["", "\\3-grams:"]
    lines += [f"{-rng.uniform(0.05, 1.0):.4f}\t{' '.join(g)}" for g in sorted(triples)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))
    return path


def _counted(fn, *args, **kwargs):
    """``fn`` as a main-path run: every count set to 0 before it and read
    after it.  Returns (result, host ms synchronised, counts)."""
    _zero_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, _counts()


def _expect_launches(what: str, got: dict, want: dict) -> None:
    print(f"{what}: launches {json.dumps(got)}", flush=True)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _gru_launches(cfg, batch: int, dtype) -> dict:
    """Kernel launches of one encode of ``cfg``'s bidirectional GRU."""
    tn = cfg.model.transnet
    want = dict.fromkeys(KERNELS, 0)
    want["gru_fwd"] = tn.num_layers * 2 * scan_launches(
        "gru", T_FRAMES, tn.hidden_size, batch, dtype, device=DEVICE)[0]
    return want


def _beam_tokens(rec, waves, beam_width=None, device_lm=None, plain=False):
    """Best beam tokens per wave from ``rec``'s device beam (``plain``: the
    encoder's GRU on its plain version, for comparison only)."""
    from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
    with _plain_gru(plain), torch.inference_mode():
        feats, lengths = rec._features(waves)
        toks, lens, _ = batched_beam_decode(
            rec.model, feats, lengths, blank_id=rec.tokenizer.blank_token_id,
            beam_width=beam_width or rec.beam_width,
            max_symbols=rec.cfg.train.greedy_max_symbols,
            max_output_len=rec.max_output_len, device_lm=device_lm)
    return [toks[i, 0, :lens[i, 0]].tolist() for i in range(len(waves))]


def _greedy_tokens(rec, waves):
    with torch.inference_mode():
        feats, lengths = rec._features(waves)
        toks, lens = greedy_mod.greedy_decode(rec.model, feats, lengths,
                                              blank_id=rec.tokenizer.blank_token_id,
                                              max_symbols=rec.cfg.train.greedy_max_symbols,
                                              max_output_len=rec.max_output_len)
    return [toks[i, :lens[i]].tolist() for i in range(len(waves))]


def _host_tokens(rec, waves, plain=False):
    """Best host-beam tokens per wave (``plain`` as in ``_beam_tokens``)."""
    dec = rec._host_beam()
    with _plain_gru(plain), torch.inference_mode():
        feats, lengths = rec._features(waves)
        return [dec.decode(feats[i:i + 1], lengths[i:i + 1])[0]
                for i in range(len(waves))]


def phase_decoding(flax_params, tokenizer, waves):
    """Offline decoding on base_config() at full width.  (a) The default
    Recognizer, the device beam at width 5, bf16, batches of 1 and 8 (16
    K1 launches per request); beam width 1 against greedy on the same
    features; fp32 tokens with the kernels against the plain GRU.  (b) The
    same with an order-3 device char LM from a seeded ARPA over the
    graphemes: weight 0 gives the no-LM tokens.  (c) The host A/B beam with
    that LM (word-level) and two hotwords on 2 waves of up to 0.5 s, fp32, 16
    K1 launches per wave; kernels against the plain GRU."""
    cfg = base_config()
    os.makedirs(DECODE_DIR, exist_ok=True)
    arpa = write_char_arpa(tokenizer, os.path.join(DECODE_DIR, "char3.arpa"))
    launches = dict.fromkeys(KERNELS, 0)
    result = {}

    def run(what, fn, *args, want):
        out, ms, got = _counted(fn, *args)
        _expect_launches(what, got, want)
        for k in KERNELS:
            launches[k] += got[k]
        return out, ms

    # (a) the default device beam, bf16
    rec = Recognizer(cfg, flax_params, tokenizer, precision="bf16", device=DEVICE)
    if (rec.decoder, rec.beam_width) != ("beam_batched", cfg.inference.beam_width):
        raise AssertionError(f"Recognizer default {rec.decoder} width {rec.beam_width}")
    rec.transcribe(waves[0][:16000])  # warm-up
    bf16 = torch.bfloat16
    one, ms1 = run("beam bf16 batch of 1", rec.transcribe_batch, waves[:1],
                   want=_gru_launches(cfg, 1, bf16))
    eight, ms8 = run("beam bf16 batch of 8", rec.transcribe_batch, waves,
                     want=_gru_launches(cfg, len(waves), bf16))
    print(f"beam_batched (width {rec.beam_width}) bf16 request latency: batch of 1 "
          f"{ms1:.1f} ms, batch of 8 {ms8:.1f} ms; transcripts {eight}", flush=True)
    # beam width 1 against greedy: equal in exact arithmetic; the beam adds
    # each log-prob to an fp32 running score, and at |score| in the thousands
    # (random weights emit up to max_output_len tokens) its rounding unit
    # swallows log-prob gaps greedy's argmax still sees.  Held on the first
    # second of each wave; the full waves are reported.
    first = [w[:16000] for w in waves]
    short_eq = _beam_tokens(rec, first, beam_width=1) == _greedy_tokens(rec, first)
    beam1, greedy = _beam_tokens(rec, waves, beam_width=1), _greedy_tokens(rec, waves)
    diverge = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                    None if len(x) == len(y) else min(len(x), len(y)))
               for x, y in zip(beam1, greedy)]
    print(f"beam width 1 vs greedy, bf16, first second of the 8 waves: tokens equal "
          f"{short_eq}; full waves: first differing token per wave {diverge} "
          f"(greedy tokens per wave {[len(x) for x in greedy]})", flush=True)
    if not short_eq:
        raise AssertionError("beam width 1 differs from greedy")
    no_lm = _beam_tokens(rec, waves)
    result["beam_bf16"] = {"batch1_ms": ms1, "batch8_ms": ms8,
                           "tokens_per_wave": [len(x) for x in no_lm]}

    rec32 = Recognizer(cfg, flax_params, tokenizer, precision="fp32", device=DEVICE)
    rec32.transcribe(waves[0][:16000])  # warm-up
    _, ms32 = run("beam fp32 batch of 8", rec32.transcribe_batch, waves,
                  want=_gru_launches(cfg, len(waves), torch.float32))
    k32, p32 = _beam_tokens(rec32, waves), _beam_tokens(rec32, waves, plain=True)
    print(f"beam fp32 batch of 8: {ms32:.1f} ms; kernels vs plain GRU tokens equal "
          f"{k32 == p32} (per wave {[a == b for a, b in zip(k32, p32)]})", flush=True)
    if k32 != p32:
        raise AssertionError("fp32 beam tokens differ between the GRU kernel and "
                             "the plain GRU")
    result["beam_fp32"] = {"batch8_ms": ms32, "kernel_vs_plain_tokens_equal": True}

    # (b) the device char LM
    t0 = time.perf_counter()
    rec_lm = Recognizer(cfg, flax_params, tokenizer, precision="bf16", device=DEVICE,
                        device_lm_path=arpa, device_lm_weight=DEVICE_LM_WEIGHT)
    build_s = time.perf_counter() - t0
    table = rec_lm.device_lm.table
    if tuple(table.shape) != (72, 72, 72) or table.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"device LM table {tuple(table.shape)} on {table.device}")
    rec_lm.transcribe(waves[0][:16000])  # warm-up
    texts_lm, ms_lm = run("beam + device LM bf16 batch of 8", rec_lm.transcribe_batch,
                          waves, want=_gru_launches(cfg, len(waves), bf16))
    with_lm = _beam_tokens(rec_lm, waves, device_lm=rec_lm.device_lm)
    at_zero = _beam_tokens(rec_lm, waves, device_lm=DeviceCharLM(table, weight=0.0))
    print(f"beam + device char LM (order 3, {table.numel() * 4 / 2**20:.2f} MiB on the "
          f"card, built in {build_s:.1f} s) bf16 batch of 8: {ms_lm:.1f} ms; weight 0 "
          f"tokens equal the no-LM tokens {at_zero == no_lm}; weight "
          f"{DEVICE_LM_WEIGHT} changes {sum(a != b for a, b in zip(with_lm, no_lm))} "
          f"of {len(waves)} transcripts: {texts_lm}", flush=True)
    if at_zero != no_lm:
        raise AssertionError("the device LM at weight 0 changed the beam's tokens")
    result["device_lm_bf16"] = {"batch8_ms": ms_lm, "table_build_s": build_s}

    # (c) the host A/B beam, n-gram LM and two hotwords, fp32
    host_waves = _waves(len(HOST_BEAM_SAMPLES), lengths=HOST_BEAM_SAMPLES, seed=SEED + 5)
    rec_h = Recognizer(cfg, flax_params, tokenizer, precision="fp32", device=DEVICE,
                       lm_path=arpa, lm_weight=0.5, hotwords=HOTWORDS,
                       hotword_weight=2.0)
    if not rec_h.fused:
        raise AssertionError("the LM / hotword Recognizer is not fused")
    rec_h.transcribe(host_waves[1][:4000])  # warm-up
    want_h = {k: v * len(host_waves) for k, v in _gru_launches(
        cfg, 1, torch.float32).items()}
    # the Recognizer's own host decoder (what its transcribe_batch runs for a
    # fused recognizer), run once with the kernels and once with the plain GRU:
    # with random weights the search prunes weakly and its host work dominates
    kh, ms_h = run("host beam + LM + hotwords fp32, 2 waves", _host_tokens, rec_h,
                   host_waves, want=want_h)
    ph = _host_tokens(rec_h, host_waves, plain=True)
    texts_h = [rec_h._decode_text(t) for t in kh]
    secs = sum(HOST_BEAM_SAMPLES) / 16000
    print(f"host A/B beam + n-gram LM + hotwords {HOTWORDS}, fp32, {len(host_waves)} "
          f"waves ({secs:.2f} s of audio): {ms_h:.1f} ms, "
          f"{ms_h / len(host_waves):.1f} ms per utterance; kernels vs plain GRU tokens "
          f"equal {kh == ph}: {texts_h}", flush=True)
    if kh != ph:
        raise AssertionError("host-beam tokens differ between the GRU kernel and the "
                             "plain GRU")
    result["host_beam_fp32"] = {"ms": ms_h, "ms_per_utterance": ms_h / len(host_waves),
                                "audio_s": secs}
    del rec, rec32, rec_lm, rec_h
    torch.cuda.empty_cache()
    return launches, result


def streaming_config():
    """bench_streaming.py's model: a 6-layer unidirectional LSTM encoder
    (H=1024, output 512), a 2-layer LSTM prediction network (H=1024, output
    512), V=72, audio without per-utterance normalisation."""
    from rnntransducer_tpu_torch.config import (AudioConfig, Config, DataConfig,
                                                JointNetConfig, ModelConfig,
                                                PredNetConfig, TransNetConfig)
    model = ModelConfig(
        transnet=TransNetConfig(input_size=80, hidden_size=1024, output_size=512,
                                num_layers=6, rnn_type="lstm", dropout=0.0,
                                bidirectional=False),
        prednet=PredNetConfig(embedding_size=72, hidden_size=1024, output_size=512,
                              num_layers=2, rnn_type="lstm", dropout=0.0),
        jointnet=JointNetConfig(num_classes=72))
    return Config(model=model, data=DataConfig(audio=AudioConfig(normalize=False)))


def _stream_waves(n, seed):
    """bench_streaming.py's utterances: 10 s of seeded noise at scale 2."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(int(16000 * STREAM_UTT_SEC)) * 2).astype(np.float32)
            for _ in range(n)]


def _stream_rtf(label, model, audio, T, decoder, want, launches, chunks):
    """bf16 ``StreamingRecognizer`` sessions over ``STREAM_UTTS`` + 1
    utterances of ``STREAM_UTT_SEC`` (the first a warm-up), 100 ms feeds,
    chunk_frames ``T``, as bench_streaming.py defines its figures: RTF (the
    compute of feed / poll / flush over the audio's length, median) and p50
    first-token latency.  Each utterance's launches must equal ``want``
    (added into ``launches``)."""
    from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
    feed = audio.sample_rate * STREAM_FEED_MS // 1000
    rtfs, first = [], []
    for u, wav in enumerate(_stream_waves(STREAM_UTTS + 1, SEED + 11)):
        _zero_counts()
        rec = StreamingRecognizer(model, audio, chunk_frames=T, normalize="none",
                                  decoder=decoder, beam_width=4)
        t0 = time.perf_counter()
        tft, compute = None, 0.0
        for ci, s in enumerate(range(0, len(wav), feed)):
            c0 = time.perf_counter()
            toks = rec.feed(wav[s:s + feed])
            if decoder == "beam" and ci % STREAM_POLL_EVERY == STREAM_POLL_EVERY - 1:
                toks = rec.tokens
            compute += time.perf_counter() - c0
            if toks and tft is None:
                tft = time.perf_counter() - t0
        c0 = time.perf_counter()
        rec.flush()
        torch.cuda.synchronize()
        compute += time.perf_counter() - c0
        got = _counts()
        _expect_launches(f"{label} {decoder} bf16 utterance {u} ({chunks})", got, want)
        for k in KERNELS:
            launches[k] += got[k]
        if u == 0:
            continue  # warm-up
        rtfs.append(compute / STREAM_UTT_SEC)
        if tft is not None:
            first.append(tft)
    rtf = float(np.median(rtfs))
    p50 = float(np.median(first)) if first else None
    print(f"{label} {decoder}{' width 4' if decoder == 'beam' else ''} bf16, "
          f"{STREAM_FEED_MS} ms feeds, chunk_frames {T}: RTF {rtf:.4f} (median of "
          f"{rtfs}); p50 first-token latency "
          f"{'not measured (no token)' if p50 is None else f'{p50 * 1e3:.1f} ms'}; "
          f"last utterance {len(rec.tokens)} tokens", flush=True)
    return {"rtf": rtf, "rtf_each": rtfs, "first_token_p50_s": p50,
            "first_token_s": first}


def phase_streaming(stream_sd):
    """Streaming on bench_streaming.py's model at full width.  K3 against its
    plain version at one chunk's shape (T=64, B=1, H=1024) with a carried
    h0 / c0, full and ragged; bf16 sessions, 100 ms feeds, chunk_frames 64,
    greedy and beam 4: 6 K3 launches per chunk, RTF and p50 first-token
    latency as bench_streaming.py defines them; streaming greedy tokens
    against offline greedy tokens in fp32."""
    from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
    from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
    cfg = streaming_config()
    tn, audio = cfg.model.transnet, cfg.data.audio
    H, T = tn.hidden_size, STREAM_CHUNK_FRAMES
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    k3 = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n_valid in (T, 41):
            xw, w, b, h0, c0, _ = _lstm_inputs(T, 1, H, dtype, gen)
            lengths = torch.tensor([n_valid], device=DEVICE)
            got = rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths, False, True)
            want = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths, False, True)
            torch.cuda.synchronize()
            errs = [_rel_err(g, r) for g, r in zip(got, want)]
            abs_err = max((g.float() - r.float()).abs().max().item()
                          for g, r in zip(got, want))
            ms = _sync_time(lambda: rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths), 20)
            plain = _sync_time(lambda: rnn_kernels.lstm_scan_reference(
                xw, w, b, h0, c0, lengths), 3)
            bound, by = lstm_bound_ms(T, 1, H, dtype, lengths, False)
            k3[(str(dtype)[6:], n_valid)] = {"ms": ms, "plain_ms": plain,
                                             "bound_ms": bound, "bound_by": by,
                                             "max_abs_err": abs_err}
            print(f"lstm_fwd streaming chunk dtype={str(dtype)[6:]} T={T} B=1 H={H} "
                  f"valid={n_valid} carried h0/c0: rel_err h_all/c_all/h_fin/c_fin="
                  f"{'/'.join(f'{e:.2e}' for e in errs)} (tol {LSTM_TOL[dtype]:.1e}); "
                  f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)
            if not max(errs) <= LSTM_TOL[dtype]:
                raise AssertionError(f"K3 disagrees with its plain version at the "
                                     f"streaming chunk: {errs}")
    per_chunk = tn.num_layers * scan_launches("lstm", T, H, 1, torch.bfloat16,
                                              device=DEVICE)[0]
    if per_chunk != tn.num_layers:
        raise AssertionError(f"K3 at the chunk's shape takes {per_chunk} launches "
                             f"per chunk, not {tn.num_layers}")
    model = build_model(cfg, DEVICE, state_dict=stream_sd).to(torch.bfloat16)
    feed = audio.sample_rate * STREAM_FEED_MS // 1000
    n_frames = int(audio.sample_rate * STREAM_UTT_SEC) // audio.hop_length + 1
    n_chunks = -(-n_frames // T)
    want = dict.fromkeys(KERNELS, 0)
    want["lstm_fwd"] = per_chunk * n_chunks
    launches = dict.fromkeys(KERNELS, 0)
    result = {"k3_chunk": {f"{d} valid={n}": v for (d, n), v in k3.items()}}
    for decoder in ("greedy", "beam"):
        result[decoder] = _stream_rtf("streaming", model, audio, T, decoder, want,
                                      launches, f"{n_chunks} chunks")
    # streaming greedy against offline greedy, fp32
    model32 = build_model(cfg, DEVICE, state_dict=stream_sd)
    wav = _stream_waves(1, SEED + 12)[0]
    with torch.inference_mode():
        feats, lengths = LogMelFrontend(audio)(torch.from_numpy(wav[None]).to(DEVICE))
        toks, lens = greedy_mod.greedy_decode(model32, feats, lengths, max_output_len=512)
    offline = toks[0, :lens[0]].tolist()
    rec = StreamingRecognizer(model32, audio, chunk_frames=T, normalize="none")
    streamed = []
    for s in range(0, len(wav), feed):
        streamed += rec.feed(wav[s:s + feed])
    streamed += rec.flush()
    print(f"streaming greedy vs offline greedy, fp32, {STREAM_UTT_SEC:.0f} s "
          f"({n_frames} frames, last chunk {n_frames - (n_chunks - 1) * T} frames): "
          f"tokens equal {streamed == offline} ({len(offline)} tokens)", flush=True)
    if streamed != offline or not offline:
        raise AssertionError("streaming greedy tokens differ from offline greedy "
                             "(or none were emitted)")
    result["stream_vs_offline_fp32_tokens"] = len(offline)
    del model, model32
    torch.cuda.empty_cache()
    return launches, result


def phase_cli(stream_cfg, stream_sd, waves):
    """``python -m rnntransducer_tpu_torch.cli.infer`` in-process, bf16, on
    phase 5's checkpoint with --decoder beam_batched, then beam; --stream on
    a checkpoint of phase 6d's streaming model written by CheckpointManager
    (phase 5's encoder is bidirectional, which streaming refuses)."""
    from rnntransducer_tpu_torch.cli import infer
    from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
    from rnntransducer_tpu_torch.utils.audio_io import write_wav
    base = base_config()
    os.makedirs(DECODE_DIR, exist_ok=True)
    paths = []
    for i, w in enumerate(waves[:2]):
        paths.append(os.path.join(DECODE_DIR, f"cli{i}.wav"))
        write_wav(paths[-1], w[:CLI_SAMPLES])
    stream_dir = os.path.join(DECODE_DIR, "stream_ckpt")
    mgr = CheckpointManager(stream_dir)
    mgr.save(1, TrainState.create(stream_cfg, DEVICE, state_dict=stream_sd),
             config=stream_cfg)
    mgr.close()
    torch.cuda.empty_cache()
    gru_one = _gru_launches(base, 1, torch.bfloat16)
    stream_chunks = len(paths) * -(-(CLI_SAMPLES // 160 + 1) // STREAM_CHUNK_FRAMES)
    stream_want = dict.fromkeys(KERNELS, 0)
    stream_want["lstm_fwd"] = stream_cfg.model.transnet.num_layers * stream_chunks
    launches = dict.fromkeys(KERNELS, 0)
    result = {}
    for name, ckpt, flags, want in (
            ("beam_batched", TRAINER_DIR, ["--decoder", "beam_batched"],
             _gru_launches(base, len(paths), torch.bfloat16)),
            ("beam", TRAINER_DIR, ["--decoder", "beam", "--hotwords", *HOTWORDS],
             {k: v * len(paths) for k, v in gru_one.items()}),
            ("stream", stream_dir, ["--stream", "--decoder", "greedy"], stream_want)):
        lines, ms, got = _counted(infer.main, [
            "--checkpoint_dir", ckpt, "--wav", *paths, "--precision", "bf16",
            "--device", DEVICE, *flags])
        _expect_launches(f"cli {name}", got, want)
        for k in KERNELS:
            launches[k] += got[k]
        if len(lines) != len(paths):
            raise AssertionError(f"cli {name} printed {lines}")
        print(f"cli {name}: {ms:.1f} ms (checkpoint load included): {lines}",
              flush=True)
        result[name] = {"ms": ms}
    torch.cuda.empty_cache()
    return launches, result


# ---- phases 8-11: many sessions at once, the server, a corpus, an import ----
SESSION_LANES = (8, 64)
SESSION_CHUNK_FRAMES = 16   # experiments/bench_session_scale.py
SESSION_UTT_SEC = 5.0       # its --utt_sec is 8: cut for the time limit
SESSION_FEED = 1600         # 100 ms feeds, every lane in lockstep
SESSION_CMP_SEC = 1.0       # batched vs independent sessions: the first 1 s
SESSION_IDLE_ROUND = 20     # the 64-lane runs' all-idle tick, mid-stream
SESSION_PROFILE_ROUNDS = (35, 45)
SERVER_LANES = 8
SERVER_PREFIX_SEC = 2.0     # per-connection sessions and first-partial latency
SERVER_PLAIN_CLIENTS = 4    # per-connection sessions take turns on the card
EVAL_N, EVAL_BATCH, EVAL_BUCKET = 32, 16, 128
EVAL_DIR = os.path.join(REPO, "build", "evaluate")
IMPORT_DIR = os.path.join(REPO, "build", "import")
IMPORT_LOGIT_TOL = 1e-4     # tests/test_torch_checkpoint_import.py


def _session_waves(n, seed, sec):
    """bench_session_scale.py's lanes: seeded noise at scale 0.3, on the
    int16 levels a socket client sends."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        w = np.clip(rng.randn(int(16000 * sec)) * 0.3 * 32768.0, -32768, 32767)
        out.append(w.astype("<i2").astype(np.float32) / 32768.0)
    return out


def phase_lstm_tick(gen):
    """K3 at a tick's shape (T = chunk_frames 16, B = 64 lanes, H=1024)
    against its plain version, both dtypes: idle lanes (length 0) beside
    full and ragged rows, then every lane idle.  An idle row's h_final /
    c_final must be its h0 / c0 bit for bit.  Times bf16 at the mixed
    lengths of a busy tick."""
    T, B, H = SESSION_CHUNK_FRAMES, max(SESSION_LANES), 1024
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        xw, w, b, h0, c0, _ = _lstm_inputs(T, B, H, dtype, gen)
        mixed = torch.randint(0, T + 1, (B,), device=DEVICE, generator=gen)
        mixed[:3] = torch.tensor([0, T, 1])
        for name, lengths in (("mixed", mixed), ("idle", torch.zeros_like(mixed))):
            got = rnn_kernels.lstm_scan(xw, w, b, h0, c0, lengths, False, True)
            want = rnn_kernels.lstm_scan_reference(xw, w, b, h0, c0, lengths, False, True)
            torch.cuda.synchronize()
            errs = [_rel_err(g, r) for g, r in zip(got, want)]
            idle = lengths == 0
            kept = (torch.equal(got[2][idle], h0[idle]) and torch.equal(got[3][idle], c0[idle])
                    and not got[0][:, idle].any())
            print(f"lstm_fwd tick dtype={str(dtype)[6:]} T={T} B={B} H={H} lengths={name} "
                  f"({int(idle.sum())} idle rows): rel_err h_all/c_all/h_fin/c_fin="
                  f"{'/'.join(f'{e:.2e}' for e in errs)} (tol {LSTM_TOL[dtype]:.1e}); idle "
                  f"rows keep h0 / c0 bit for bit {kept}", flush=True)
            if not (max(errs) <= LSTM_TOL[dtype] and kept):
                raise AssertionError(f"K3 at the tick shape, lengths {name}: {errs}, "
                                     f"idle rows kept {kept}")
        if dtype is torch.bfloat16:
            ms = _sync_time(lambda: rnn_kernels.lstm_scan(xw, w, b, h0, c0, mixed), 20)
            plain = _sync_time(lambda: rnn_kernels.lstm_scan_reference(
                xw, w, b, h0, c0, mixed), 3)
            bound, by = lstm_bound_ms(T, B, H, dtype, mixed, False)
            out = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "valid_steps": int(mixed.sum())}
            print(f"lstm_fwd tick bf16 T={T} B={B} H={H}, {int(mixed.sum())} valid steps: "
                  f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)
    return out


def _state_leaves(runner):
    """Every tensor of a runner's persistent state (encoder state, carry)."""
    leaves = [runner._enc_state.h, runner._enc_state.c]
    for leaf in runner._carry:
        leaves += list(leaf) if isinstance(leaf, tuple) else [leaf]
    return [x for x in leaves if x is not None]


def _idle_tick_check(runner, what: str) -> None:
    """One all-idle tick against the live state: every lane's encoder state
    and carry come back torch.equal (K3 with every length 0)."""
    before = [x.clone() for x in _state_leaves(runner)]
    runner._enc_state, runner._carry = runner._step(*runner._idle_inputs())
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(_state_leaves(runner), before))
    print(f"{what}: all-idle tick leaves every lane bit-identical {same}", flush=True)
    if not same:
        raise AssertionError(f"{what}: an all-idle tick changed the state")


def _lockstep(runner, waves, idle_round=None, profile_rounds=None, flush=True):
    """bench_session_scale.py's traffic: every lane gets its next 100 ms
    (buffer-only feeds), then one drain serves them; a probe thread polls
    lane 0's partials every 10 ms (the feed block: how long a state-lock
    operation waits while a tick runs).  Optionally one all-idle tick at
    ``idle_round`` and a profiled window of rounds (left out of the tick
    and RTF figures).  At the end every lane flushes (two ticks each: its
    last full chunk, then its final partial one), or, without ``flush``,
    its partials are read and its slot freed.  Returns the lanes' tokens
    and the figures."""
    ticks = [0]
    drain = runner.drain

    def counted_drain(*args, **kwargs):
        n = drain(*args, **kwargs)
        ticks[0] += n
        return n

    runner.drain = counted_drain
    sessions = [runner.open(normalize="none") for _ in waves]
    got = [[] for _ in waves]
    tick_ms, poll_ms, round_s = [], [], []
    stop = threading.Event()

    def probe():
        while not stop.is_set():
            t0 = time.perf_counter()
            sessions[0].tokens
            poll_ms.append((time.perf_counter() - t0) * 1e3)
            time.sleep(0.01)

    prober = threading.Thread(target=probe, daemon=True)
    prober.start()
    busy = None
    n_rounds = -(-max(len(w) for w in waves) // SESSION_FEED)
    try:
        for r in range(n_rounds):
            if idle_round == r:
                _idle_tick_check(runner, f"{runner.decoder} {len(waves)} lanes")
            profiling = profile_rounds is not None and profile_rounds[0] <= r < profile_rounds[1]
            if profile_rounds is not None and r == profile_rounds[0]:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                prof_t0 = time.perf_counter()
            t0 = time.perf_counter()
            for i, s in enumerate(sessions):
                piece = waves[i][r * SESSION_FEED:(r + 1) * SESSION_FEED]
                if len(piece):
                    got[i] += s.feed(piece, drain=False)
            t1 = time.perf_counter()
            n = runner.drain()  # ends in the partials' device-to-host copy
            t2 = time.perf_counter()
            if not profiling:
                round_s.append(t2 - t0)
                if n:
                    tick_ms.append((t2 - t1) * 1e3 / n)
            if profile_rounds is not None and r == profile_rounds[1] - 1:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - prof_t0) * 1e3
                prof.__exit__(None, None, None)
                device_ms = _device_busy_ms(prof)
                busy = device_ms / wall_ms if device_ms else None
                print(f"{runner.decoder} {len(waves)} lanes, profiled rounds "
                      f"{profile_rounds} (profiler on): wall {wall_ms:.1f} ms, device "
                      f"busy {device_ms:.1f} ms "
                      f"({'not measured' if busy is None else f'{100 * busy:.1f}%'})",
                      flush=True)
    finally:
        stop.set()
        prober.join(timeout=5)
    times = []
    for i, s in enumerate(sessions):
        if not flush:
            got[i] = s.tokens
            s.abort()
            continue
        fin = s.flush()
        got[i] = fin if runner.decoder == "beam" else got[i] + fin
        if runner.decoder == "greedy":
            times.append(s.timestamps)
    tick_ms.sort()
    poll_ms.sort()
    audio_s = len(waves) * SESSION_FEED / 16000 * len(round_s)
    return {"tokens": got, "times": times, "ticks": ticks[0],
            "tick_ms_p50": tick_ms[len(tick_ms) // 2],
            "tick_ms_p99": tick_ms[int(len(tick_ms) * 0.99)],
            "aggregate_rtf": audio_s / sum(round_s),
            "poll_block_ms_p99": poll_ms[int(len(poll_ms) * 0.99)] if poll_ms else 0.0,
            "device_busy_share": busy}


def _near_tie(model, wave, decoder, frames, max_symbols,
              chunk_frames=SESSION_CHUNK_FRAMES, audio=None):
    """(frame, margin) of the smallest decision margin an independent fp32
    session met in encoder frames ``frames`` (a range): greedy, the top-2
    gap of the joint's logits; beam, the gap between the K-th and the
    (K+1)-th candidate of a top-K selection."""
    from rnntransducer_tpu_torch.decode import beam_batched
    from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
    seen = []
    top_k, joint_step = beam_batched._top_k, model.joint_step
    if decoder == "beam":
        def recording(pool, k):
            out = top_k(pool, k)
            seen.append(torch.sort(pool[0], descending=True).values[k - 1:k + 1])
            return out
        beam_batched._top_k = recording
    else:
        def recording(enc_t, dec_u):
            logits = joint_step(enc_t, dec_u)
            seen.append(torch.topk(logits[0].float(), 2).values)
            return logits
        model.joint_step = recording
    try:
        rec = StreamingRecognizer(model, audio or streaming_config().data.audio,
                                  chunk_frames=chunk_frames, normalize="none",
                                  decoder=decoder, beam_width=4, max_output_len=512)
        for s in range(0, len(wave), SESSION_FEED):
            rec.feed(wave[s:s + SESSION_FEED])
        rec.flush()
    finally:
        beam_batched._top_k = top_k
        if decoder == "greedy":
            del model.joint_step
    pairs = torch.stack(seen).float().cpu().numpy()
    # NEG-filled candidates tie exactly, and the stable sort orders them by
    # index whatever the arithmetic: only real candidates count
    gaps = np.where(pairs[:, 0] > -1e29, pairs[:, 0] - pairs[:, 1], np.inf)
    frame_of = np.arange(len(gaps)) // max_symbols
    window = np.isin(frame_of, np.asarray(list(frames)))
    i = int(np.argmin(np.where(window, gaps, np.inf)))
    return int(frame_of[i]), float(gaps[i])


def _margin_rule(model, what, decoder, waves, batched_tokens, batched_times,
                 independent, max_symbols, chunk_frames, audio, frame_sec):
    """Batched lanes against independent fp32 sessions ``independent``
    ((tokens, greedy timestamps or None) per lane): a lane may differ only
    after a decision whose margin (``_near_tie``) is below
    ENCODER_TOL['fp32'], and each such lane is printed.  ``frame_sec`` is an
    encoder frame's duration.  Returns the near-ties."""
    ties = []
    hop = int(round(frame_sec * audio.sample_rate))
    for i, (b_toks, (i_toks, i_times)) in enumerate(zip(batched_tokens, independent)):
        if b_toks == i_toks:
            continue
        j = next((j for j, (x, y) in enumerate(zip(b_toks, i_toks)) if x != y),
                 min(len(b_toks), len(i_toks)))
        if decoder == "greedy":
            # the decision that split them lies between the last common
            # token's frame and the first differing token's
            b_times = batched_times[i]
            lo = round(i_times[j - 1] / frame_sec) if j else 0
            ends = [round(t[j] / frame_sec) for t in (i_times, b_times) if j < len(t)]
            frames = range(lo, (min(ends) if ends else len(waves[i]) // hop) + 1)
        else:
            frames = range(len(waves[i]) // hop + 1)
        frame, margin = _near_tie(model, waves[i], decoder, frames, max_symbols,
                                  chunk_frames, audio)
        print(f"{what}: lane {i} differs from its independent session at token {j}; "
              f"smallest decision margin {margin:.3e} at frame {frame} (tolerance "
              f"{ENCODER_TOL['fp32']:.0e})", flush=True)
        if not margin < ENCODER_TOL["fp32"]:
            raise AssertionError(f"{what}: lane {i} differs from its independent "
                                 "session with no near-tie")
        ties.append({"lane": i, "token": j, "frame": frame, "margin": margin})
    return ties


def phase_sessions(stream_sd, shared):
    """Continuous batching (``decode/session_batch.BatchedStreamingRunner``)
    on bench_streaming.py's model at full width with
    experiments/bench_session_scale.py's traffic: 8 and 64 lanes of 5 s,
    100 ms feeds in lockstep, chunk_frames 16, greedy and beam 4, bf16;
    warmup, 6 K3 launches per tick, at 64 lanes an all-idle tick that must
    leave the state bit-identical and a profiled window of ticks; then, in
    fp32, 8 batched lanes against 8 independent StreamingRecognizers on the
    first 1 s of each wave (tokens equal, or different only after a
    decision whose margin is below ENCODER_TOL['fp32'])."""
    from rnntransducer_tpu_torch.decode.session_batch import BatchedStreamingRunner
    from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
    cfg = streaming_config()
    tn, audio = cfg.model.transnet, cfg.data.audio
    T, H = SESSION_CHUNK_FRAMES, tn.hidden_size
    max_symbols = cfg.train.greedy_max_symbols
    waves = _session_waves(max(SESSION_LANES), SEED + 21, SESSION_UTT_SEC)
    shared["session_waves"] = waves
    launches = dict.fromkeys(KERNELS, 0)
    result = {}

    def runner_of(model, lanes, decoder):
        return BatchedStreamingRunner(model, audio, max_sessions=lanes, chunk_frames=T,
                                      max_symbols=max_symbols, max_output_len=512,
                                      decoder=decoder, beam_width=4)

    model = build_model(cfg, DEVICE, state_dict=stream_sd).to(torch.bfloat16)
    for lanes in SESSION_LANES:
        per_tick = tn.num_layers * scan_launches("lstm", T, H, lanes, torch.bfloat16,
                                                 device=DEVICE)[0]
        if per_tick != tn.num_layers:
            raise AssertionError(f"K3 at the tick's shape takes {per_tick} launches per "
                                 f"tick, not {tn.num_layers}")
        for decoder in ("greedy", "beam"):
            runner = runner_of(model, lanes, decoder)
            _zero_counts()
            t0 = time.perf_counter()
            runner.warmup()
            warm_s = time.perf_counter() - t0
            big = lanes == max(SESSION_LANES)
            # the wide runs read their partials at the end instead of
            # flushing lane by lane (128 ticks that measure nothing new)
            stats = _lockstep(runner, waves[:lanes],
                              idle_round=SESSION_IDLE_ROUND if big else None,
                              profile_rounds=SESSION_PROFILE_ROUNDS if big else None,
                              flush=not big)
            torch.cuda.synchronize()
            got = _counts()
            want = dict.fromkeys(KERNELS, 0)
            # the warmup's tick, the traffic's ticks and the all-idle tick
            want["lstm_fwd"] = per_tick * (1 + stats["ticks"] + int(big))
            what = f"sessions {decoder} bf16 {lanes} lanes ({stats['ticks']} ticks)"
            _expect_launches(what, got, want)
            for k in KERNELS:
                launches[k] += got[k]
            tokens = stats.pop("tokens")
            stats.pop("times")
            print(f"{what}: warmup {warm_s:.2f} s; tick p50 {stats['tick_ms_p50']:.1f} ms, "
                  f"p99 {stats['tick_ms_p99']:.1f} ms; aggregate RTF "
                  f"{stats['aggregate_rtf']:.2f} audio s per wall s; feed block p99 "
                  f"{stats['poll_block_ms_p99']:.2f} ms; tokens per lane "
                  f"{[len(t) for t in tokens[:8]]}", flush=True)
            if not all(tokens):
                raise AssertionError(f"{what}: a lane decoded no token")
            if lanes == SERVER_LANES and decoder == "greedy":
                shared["runner_tokens"] = tokens
            result[f"{decoder}_{lanes}"] = dict(stats, warmup_s=warm_s)
            del runner
    del model
    torch.cuda.empty_cache()

    # batched lanes against independent sessions, fp32 (TF32 off)
    model32 = build_model(cfg, DEVICE, state_dict=stream_sd)
    short = [w[:int(16000 * SESSION_CMP_SEC)] for w in waves[:SERVER_LANES]]
    frame_sec = audio.window_stride_sec
    for decoder in ("greedy", "beam"):
        _zero_counts()
        batched = _lockstep(runner_of(model32, len(short), decoder), short)
        independent = []
        for w in short:
            rec = StreamingRecognizer(model32, audio, chunk_frames=T, normalize="none",
                                      decoder=decoder, beam_width=4, max_output_len=512)
            fed = []
            for s in range(0, len(w), SESSION_FEED):
                fed += rec.feed(w[s:s + SESSION_FEED])
            fin = rec.flush()
            independent.append((fin if decoder == "beam" else fed + fin,
                                rec.timestamps if decoder == "greedy" else None))
        got = _counts()
        for k in KERNELS:
            launches[k] += got[k]
        ties = _margin_rule(model32, f"sessions {decoder} fp32", decoder, short,
                            batched["tokens"], batched["times"], independent,
                            max_symbols, T, audio, frame_sec)
        print(f"sessions {decoder} fp32, {len(short)} lanes of {SESSION_CMP_SEC:.0f} s: "
              f"tokens equal to independent sessions on "
              f"{len(short) - len(ties)} of {len(short)} lanes; near-ties {ties}; tokens "
              f"per lane {[len(t) for t in batched['tokens']]}", flush=True)
        result[f"{decoder}_vs_independent_fp32"] = {"near_ties": ties}
    del model32
    torch.cuda.empty_cache()
    return launches, result


def _timed_stream(port, wave):
    """The socket protocol as ``serve_socket.stream_wav`` speaks it, timed:
    (seconds from the connect to the first partial with text, the final).
    The client sends its next chunk when the reply comes, so no audio
    pacing is in the time."""
    import socket
    import struct
    pcm16 = np.clip(wave * 32768.0, -32768, 32767).astype("<i2")
    first = None
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port)) as s:
        f = s.makefile("rb")
        for i in range(0, len(pcm16), SESSION_FEED):
            chunk = pcm16[i:i + SESSION_FEED].tobytes()
            s.sendall(struct.pack("<i", len(chunk)) + chunk)
            if json.loads(f.readline()).get("partial") and first is None:
                first = time.perf_counter() - t0
        s.sendall(struct.pack("<i", 0))
        return first, json.loads(f.readline())


def _clients(fn, args_list):
    """``fn(*args)`` for every entry on threads started together."""
    out = [None] * len(args_list)
    errors = []

    def run(i):
        try:
            out[i] = fn(*args_list[i])
        except Exception as e:  # surfaced below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"clients failed: {errors}")
    return out


def phase_server(stream_cfg, stream_sd, shared):
    """``serve_socket.StreamingServer`` on localhost on bench_streaming.py's
    model, bf16, greedy: batch_sessions=8 with 8 concurrent clients
    (``stream_wav``) on phase 7a's waves, each final equal to the runner's
    tokens for the same pieces; the first-partial latency of 8 concurrent
    clients on the first 2 s; a dropped client frees its slot; drain().
    Then per-connection sessions (batch_sessions=0): 4 concurrent clients
    on the first 2 s, each final equal to a StreamingRecognizer fed the
    same pieces.  Then
    ``python -m rnntransducer_tpu_torch.serve_socket`` on phase 6e's
    checkpoint of this model: one wave, SIGTERM, exit 0 after draining."""
    import signal
    import socket
    import struct
    from rnntransducer_tpu_torch.serve_socket import StreamingServer, stream_wav
    waves = shared["session_waves"][:SERVER_LANES]
    want = shared["runner_tokens"]
    tokenizer = GraphemeTokenizer.default(stream_cfg.model.jointnet.num_classes)
    rec = Recognizer(stream_cfg, stream_sd, tokenizer, decoder="greedy",
                     precision="bf16", device=DEVICE)
    launches = dict.fromkeys(KERNELS, 0)
    result = {}
    per_chunk = stream_cfg.model.transnet.num_layers

    def count(what, got, multiple_of):
        print(f"{what}: launches {json.dumps(got)}", flush=True)
        if not (got["lstm_fwd"] > 0 and got["lstm_fwd"] % multiple_of == 0
                and all(v == 0 for k, v in got.items() if k != "lstm_fwd")):
            raise AssertionError(f"{what}: launches {got}")
        for k in KERNELS:
            launches[k] += got[k]

    _zero_counts()
    server = StreamingServer(rec, port=0, chunk_frames=SESSION_CHUNK_FRAMES,
                             batch_sessions=SERVER_LANES).start()
    try:
        t0 = time.perf_counter()
        finals = _clients(stream_wav, [("127.0.0.1", server.port, w) for w in waves])
        batched_s = time.perf_counter() - t0
        equal = [f["tokens"] == t for (_, f), t in zip(finals, want)]
        print(f"server batch_sessions={SERVER_LANES}: {len(waves)} concurrent clients of "
              f"{SESSION_UTT_SEC:.0f} s in {batched_s:.1f} s; finals equal to the runner's "
              f"{equal}", flush=True)
        if not all(equal):
            raise AssertionError("server finals differ from the runner's")
        prefix = int(16000 * SERVER_PREFIX_SEC)
        timed = _clients(_timed_stream, [(server.port, w[:prefix]) for w in waves])
        firsts = sorted(t for t, _ in timed if t is not None)
        p50 = firsts[len(firsts) // 2] if firsts else None
        print(f"server first partial with text, {len(waves)} concurrent clients: p50 "
              f"{'not measured (no text)' if p50 is None else f'{p50 * 1e3:.1f} ms'} "
              f"({[round(t * 1e3, 1) for t in firsts]})", flush=True)
        with socket.create_connection(("127.0.0.1", server.port)) as s:
            chunk = np.zeros(SESSION_FEED, "<i2").tobytes()
            s.sendall(struct.pack("<i", len(chunk)) + chunk)
            s.makefile("rb").readline()  # one partial, then vanish
        deadline = time.time() + 30
        while time.time() < deadline and server._conns_done < server._conns_started:
            time.sleep(0.02)
        freed = len(server._runner._free) == SERVER_LANES
        print(f"server: a dropped client's slot is free again {freed}", flush=True)
        if not freed:
            raise AssertionError("a dropped client kept its slot")
    finally:
        drained = server.drain(timeout=60)
    print(f"server drain() {drained}", flush=True)
    if not drained:
        raise AssertionError("server drain() timed out")
    torch.cuda.synchronize()
    count(f"server batch_sessions={SERVER_LANES}", _counts(), per_chunk)
    result["batched"] = {"s": batched_s, "first_partial_p50_s": p50,
                         "first_partial_s": firsts}

    short = [w[:prefix] for w in waves[:SERVER_PLAIN_CLIENTS]]
    _zero_counts()
    with StreamingServer(rec, port=0, chunk_frames=SESSION_CHUNK_FRAMES) as server:
        t0 = time.perf_counter()
        finals = _clients(stream_wav, [("127.0.0.1", server.port, w) for w in short])
        plain_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    count("server batch_sessions=0", _counts(), per_chunk)
    direct = []
    for w in short:
        session = rec.stream(chunk_frames=SESSION_CHUNK_FRAMES)
        fed = []
        for s in range(0, len(w), SESSION_FEED):
            fed += session.feed(w[s:s + SESSION_FEED])
        direct.append(fed + session.flush())
    equal = [f["tokens"] == d for (_, f), d in zip(finals, direct)]
    print(f"server batch_sessions=0: {len(short)} concurrent clients of "
          f"{SERVER_PREFIX_SEC:.0f} s in {plain_s:.1f} s; finals equal to "
          f"StreamingRecognizer sessions {equal}", flush=True)
    if not all(equal):
        raise AssertionError("per-connection finals differ from streaming sessions")
    result["per_connection"] = {"s": plain_s}

    stream_dir = os.path.join(DECODE_DIR, "stream_ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rnntransducer_tpu_torch.serve_socket", "--checkpoint_dir",
         stream_dir, "--port", "0", "--precision", "bf16", "--batch_sessions", "2",
         "--chunk_frames", str(SESSION_CHUNK_FRAMES), "--device", DEVICE],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if "streaming on" not in line:
            raise AssertionError(f"serve_socket did not start: {line}")
        port = int(line.split(":")[1].split()[0])
        _, final = stream_wav("127.0.0.1", port, short[0])
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"serve_socket CLI: final of {len(final['tokens'])} tokens, SIGTERM -> exit "
          f"{proc.returncode}, {out.strip().splitlines()[-1] if out.strip() else ''}",
          flush=True)
    if proc.returncode != 0 or "drained: all sessions finished" not in out:
        raise AssertionError(f"serve_socket CLI: exit {proc.returncode}: {err[-2000:]}")
    del rec
    torch.cuda.empty_cache()
    return launches, result


def _eval_waves(tokenizer):
    """32 seeded speech-band waves of 1-5.11 s written as WAV files with a
    TSV manifest under build/evaluate, read back (int16 levels).  Returns
    (waves, manifest path)."""
    from rnntransducer_tpu_torch.utils.audio_io import read_wav, write_wav
    os.makedirs(EVAL_DIR, exist_ok=True)
    rng = np.random.RandomState(SEED + 31)
    lengths = rng.randint(16000, N_SAMPLES + 1, size=EVAL_N)
    lengths[0] = N_SAMPLES
    manifest = os.path.join(EVAL_DIR, "eval.tsv")
    waves = []
    with open(manifest, "w", encoding="utf-8") as f:
        for i, w in enumerate(_waves(EVAL_N, lengths=lengths, seed=SEED + 31)):
            path = os.path.join(EVAL_DIR, f"utt{i:02d}.wav")
            write_wav(path, w)
            waves.append(read_wav(path))
            f.write(f"{path}\t가나다 라마\n")
    return waves, manifest


def _eval_batches(waves, hop):
    """evaluate_corpus's batches: (indices, padded sample count) of each,
    length-sorted, EVAL_BATCH waves padded to a multiple of EVAL_BUCKET
    frames."""
    frames = np.asarray([(len(w) + hop - 1) // hop for w in waves])
    order = np.argsort(frames, kind="stable")
    out = []
    for lo in range(0, len(order), EVAL_BATCH):
        idxs = order[lo:lo + EVAL_BATCH]
        out.append((idxs, -(-int(frames[idxs].max()) // EVAL_BUCKET) * EVAL_BUCKET * hop))
    return out


def _reference_tokens(rec, waves, n_samples):
    """The Recognizer's greedy tokens for ``waves`` zero-padded to
    ``n_samples`` (its frontend, its model, the greedy frame scan)."""
    batch = np.zeros((len(waves), n_samples), np.float32)
    lengths = np.zeros((len(waves),), np.int64)
    for r, w in enumerate(waves):
        batch[r, :len(w)] = w
        lengths[r] = len(w)
    with torch.inference_mode():
        feats, feat_lengths = rec.frontend(torch.from_numpy(batch).to(DEVICE),
                                           torch.from_numpy(lengths).to(DEVICE))
        toks, lens = greedy_mod.greedy_decode(
            rec.model, feats, feat_lengths, blank_id=rec.tokenizer.blank_token_id,
            max_symbols=rec.cfg.train.greedy_max_symbols,
            max_output_len=rec.max_output_len)
    return [toks[i, :lens[i]].tolist() for i in range(len(waves))]


def phase_evaluate(flax_params, tokenizer):
    """Corpus evaluation (``eval.evaluate_corpus``) on base_config() at full
    width, bf16 and fp32, over 32 seeded waves of 1-5.11 s read from WAV
    files: references from the port's own greedy Recognizer on the same
    waves in evaluate_corpus's batches, so greedy scores CER 0 and WER 0
    exactly, in input order; beam_batched with the oracle n-best (oracle CER
    <= top-1 CER), bf16; 16 K1 launches per batch; RTF per decoder.  Then
    ``python -m rnntransducer_tpu_torch.cli.evaluate`` on phase 5's
    checkpoint with --dump."""
    from rnntransducer_tpu_torch.cli import evaluate as eval_cli
    from rnntransducer_tpu_torch.eval import evaluate_corpus
    cfg = base_config()
    audio = cfg.data.audio
    waves, manifest = _eval_waves(tokenizer)
    batches = _eval_batches(waves, audio.hop_length)
    audio_s = sum(len(w) for w in waves) / audio.sample_rate
    launches = dict.fromkeys(KERNELS, 0)
    result = {"audio_s": audio_s}

    def run(what, fn, *args, dtype, **kwargs):
        out, ms, got = _counted(fn, *args, **kwargs)
        want = {k: v * len(batches) for k, v in _gru_launches(cfg, EVAL_BATCH, dtype).items()}
        _expect_launches(f"{what} ({len(batches)} batches)", got, want)
        for k in KERNELS:
            launches[k] += got[k]
        return out, ms

    for precision, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        rec = Recognizer(cfg, flax_params, tokenizer, decoder="greedy",
                         precision=precision, device=DEVICE)
        refs = [None] * len(waves)
        # evaluate_corpus's batches and padding: the same rows in the same
        # shapes, so the bf16 run gives the same tokens too
        for idxs, n_samples in batches:
            for i, toks in zip(idxs, _reference_tokens(rec, [waves[i] for i in idxs],
                                                       n_samples)):
                refs[int(i)] = np.asarray(toks, np.int32)
        items = [{"wav": w, "labels": r} for w, r in zip(waves, refs)]
        kw = dict(batch_size=EVAL_BATCH, frame_bucket=EVAL_BUCKET,
                  max_symbols=cfg.train.greedy_max_symbols,
                  max_output_len=rec.max_output_len)
        res, ms = run(f"evaluate greedy {precision}", evaluate_corpus, rec.model,
                      tokenizer, audio, items, decoder="greedy", dtype=dtype, **kw)
        in_order = all(r["id"] == str(i) and r["ref"] == r["hyp"]
                       and abs(r["audio_sec"] - len(w) / audio.sample_rate) < 0.011
                       for i, (r, w) in enumerate(zip(res.per_utt, waves)))
        print(f"evaluate greedy {precision}: CER {res.cer} WER {res.wer} against the "
              f"Recognizer's own greedy tokens, records in input order {in_order}; "
              f"{ms:.1f} ms, RTF {res.rtf:.4f} ({audio_s:.1f} s of audio, "
              f"{sum(len(r) for r in refs)} reference tokens)", flush=True)
        if not (res.cer == 0.0 and res.wer == 0.0 and in_order):
            raise AssertionError(f"evaluate greedy {precision}: CER {res.cer} WER "
                                 f"{res.wer}, in order {in_order}")
        result[f"greedy_{precision}"] = {"rtf": res.rtf, "ms": ms}
        if precision == "bf16":
            res, ms = run("evaluate beam_batched bf16", evaluate_corpus, rec.model,
                          tokenizer, audio, items, decoder="beam_batched",
                          beam_width=cfg.inference.beam_width, oracle_nbest=True,
                          dtype=dtype, **kw)
            print(f"evaluate beam_batched (width {cfg.inference.beam_width}) bf16: CER "
                  f"{res.cer:.4f} oracle CER {res.oracle_cer:.4f}; {ms:.1f} ms, RTF "
                  f"{res.rtf:.4f}", flush=True)
            if not res.oracle_cer <= res.cer:
                raise AssertionError("the oracle CER exceeds the top-1 CER")
            result["beam_batched_bf16"] = {"rtf": res.rtf, "ms": ms, "cer": res.cer,
                                           "oracle_cer": res.oracle_cer}
        del rec
        torch.cuda.empty_cache()

    dump = os.path.join(EVAL_DIR, "per_utt.jsonl")
    summary, ms = run("cli evaluate bf16", eval_cli.main, [
        "--checkpoint_dir", TRAINER_DIR, "--manifest", manifest, "--dump", dump,
        "--precision", "bf16", "--batch_size", str(EVAL_BATCH), "--max_output_len", "512",
        "--device", DEVICE], dtype=torch.bfloat16)
    with open(dump, encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    print(f"cli evaluate on phase 5's checkpoint: {ms:.1f} ms (checkpoint load "
          f"included); {json.dumps(summary, ensure_ascii=False)}; {len(records)} "
          f"records dumped", flush=True)
    if summary["n_utts"] != EVAL_N or len(records) != EVAL_N:
        raise AssertionError(f"cli evaluate: {summary}, {len(records)} records")
    result["cli"] = {"ms": ms, "rtf": summary["rtf"]}
    return launches, result


class _ReferenceRNNT(torch.nn.Module):
    """The original PyTorch-Lightning model's module tree and state_dict
    names (encoder.rnn / out_proj, decoder.embedding / rnn / out_proj, fc),
    built from torch.nn modules: the yardstick checkpoint the import reads,
    never on the port's path."""

    def __init__(self, cfg):
        super().__init__()
        tn, pn, jn = cfg.model.transnet, cfg.model.prednet, cfg.model.jointnet
        rnn = {"gru": torch.nn.GRU, "lstm": torch.nn.LSTM}
        self.encoder = torch.nn.Module()
        self.encoder.rnn = rnn[tn.rnn_type.lower()](
            tn.input_size, tn.hidden_size, num_layers=tn.num_layers, batch_first=True,
            bidirectional=tn.bidirectional)
        self.encoder.out_proj = torch.nn.Linear(
            (2 if tn.bidirectional else 1) * tn.hidden_size, tn.output_size)
        self.decoder = torch.nn.Module()
        self.decoder.embedding = torch.nn.Embedding(pn.embedding_size, pn.hidden_size,
                                                    padding_idx=0)
        self.decoder.rnn = rnn[pn.rnn_type.lower()](pn.hidden_size, pn.hidden_size,
                                                    num_layers=pn.num_layers,
                                                    batch_first=True)
        self.decoder.out_proj = torch.nn.Linear(pn.hidden_size, pn.output_size)
        self.fc = torch.nn.Linear(tn.output_size + pn.output_size, jn.num_classes)

    def forward(self, feats, lengths, text_in):
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            feats, lengths.cpu(), batch_first=True, enforce_sorted=False)
        enc, _ = self.encoder.rnn(packed)
        enc, _ = torch.nn.utils.rnn.pad_packed_sequence(enc, batch_first=True,
                                                        total_length=feats.shape[1])
        enc = self.encoder.out_proj(enc)
        dec, _ = self.decoder.rnn(self.decoder.embedding(text_in))
        dec = self.decoder.out_proj(dec)
        T, U = enc.shape[1], dec.shape[1]
        x = torch.cat([enc[:, :, None].expand(-1, -1, U, -1),
                       dec[:, None].expand(-1, T, -1, -1)], dim=-1)
        return self.fc(torch.nn.functional.gelu(x, approximate="tanh"))


def phase_import(tokenizer):
    """A reference-layout checkpoint of base_config() at full width (seeded
    torch.nn.GRU / LSTM / Linear / Embedding, a Lightning-style
    {"state_dict": ...} file) converted by
    ``utils.torch_import.convert_to_checkpoint``: Recognizer.from_checkpoint
    gives the greedy tokens of a Recognizer built from the same weights by
    hand (16 K1 launches each), and the port's joint logits match the
    reference module's forward (cuDNN, fp32, TF32 off) within 1e-4."""
    from rnntransducer_tpu_torch.utils.torch_import import (convert_to_checkpoint,
                                                            load_torch_checkpoint)
    cfg = base_config()
    os.makedirs(IMPORT_DIR, exist_ok=True)
    torch.manual_seed(SEED + 41)
    ref = _ReferenceRNNT(cfg)
    path = os.path.join(IMPORT_DIR, "reference.ckpt")
    torch.save({"state_dict": {f"jointnet.{k}": v for k, v in ref.state_dict().items()},
                "epoch": 0}, path)
    ckpt = os.path.join(IMPORT_DIR, "ckpt")
    t0 = time.perf_counter()
    convert_to_checkpoint(path, cfg, ckpt, device=DEVICE)
    convert_s = time.perf_counter() - t0
    launches = dict.fromkeys(KERNELS, 0)
    waves = [w[:32000] for w in _waves(4, seed=SEED + 43)]
    want = _gru_launches(cfg, len(waves), torch.float32)
    toks = {}
    for name, make in (("from_checkpoint", lambda: Recognizer.from_checkpoint(
                            ckpt, decoder="greedy", device=DEVICE)),
                       ("by hand", lambda: Recognizer(
                           cfg, load_torch_checkpoint(path, cfg.model), tokenizer,
                           decoder="greedy", device=DEVICE))):
        rec = make()
        toks[name], ms, got = _counted(_greedy_tokens, rec, waves)
        _expect_launches(f"import greedy fp32, Recognizer {name}", got, want)
        for k in KERNELS:
            launches[k] += got[k]
    equal = toks["from_checkpoint"] == toks["by hand"]
    print(f"import: converted in {convert_s:.1f} s; greedy tokens of the converted "
          f"checkpoint equal those of the weights loaded by hand {equal} (tokens per "
          f"wave {[len(t) for t in toks['by hand']]})", flush=True)
    if not equal or not all(toks["by hand"]):
        raise AssertionError("the converted checkpoint decodes differently")
    ref = ref.to(DEVICE).eval()
    rng = np.random.RandomState(SEED + 44)
    text_in = torch.from_numpy(np.concatenate(
        [np.zeros((2, 1), np.int64), rng.randint(1, 72, (2, 10))], axis=1)).to(DEVICE)
    with torch.inference_mode():
        feats, lengths = rec._features(waves[:2])
        want_logits = ref(feats, lengths, text_in)
        _zero_counts()
        got_logits = rec.model(feats, lengths, text_in,
                               torch.full((2,), text_in.shape[1], device=DEVICE))
        torch.cuda.synchronize()
        got = _counts()
    for k in KERNELS:
        launches[k] += got[k]
    err = max((got_logits[b, :n] - want_logits[b, :n]).abs().max().item()
              for b, n in enumerate(lengths.tolist()))
    print(f"import: joint logits {tuple(got_logits.shape)} against the reference "
          f"module's forward, fp32: max abs err {err:.3e} (tol {IMPORT_LOGIT_TOL:.0e}); "
          f"launches {json.dumps(got)}", flush=True)
    if not err <= IMPORT_LOGIT_TOL:
        raise AssertionError(f"imported logits differ from the reference's by {err}")
    del ref, rec
    shutil.rmtree(IMPORT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, {"convert_s": convert_s, "logit_max_abs_err": err}


# ---- the Conformer (phase 8) --------------------------------------------
CONFORMER_STREAM_FRAMES = 64   # bench_streaming.py --conformer: one 100 ms
                               # feed's chunk of 64 frames = one attention chunk
CONFORMER_PLAIN_LAYERS = 4     # the fp32 kernels-vs-plain step: depth cut, B=8
CONFORMER_GRAD_PARAMS = ("encoder.in_proj.weight", "encoder.blocks.0.attn.q_proj.weight",
                         "encoder.blocks.1.conv.conv.weight", "prednet.rnn.fwd.0.w_hh",
                         "prednet.rnn.fwd.1.w_hh", "joint.fc.weight")
# chunk by chunk against the offline masked forward: tests/test_conformer.py:253-254
CONFORMER_STREAM_ATOL, CONFORMER_STREAM_RTOL = 2e-5, 1e-4
CONFORMER_STREAM_CHUNKS = 10   # the chunk-by-chunk check: 640 frames, 6.4 s
CONFORMER_CMP_SEC = 3.0        # staggered lanes vs independent sessions, fp32
CONFORMER_IDLE_ROUND = 20      # the 64-lane all-idle tick, mid-stream


def conformer_l_config():
    """Conformer-L offline (experiments/perf_conformer.py:40,79-99):
    ``base_config()`` with a 16-block Conformer encoder, d_model 512, 8
    heads, ff x4, conv kernel 15, 4x frame stacking at the input, full
    context; its 2-layer LSTM prediction network and concat joint, V=72."""
    cfg = base_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transnet=dataclasses.replace(
            cfg.model.transnet, arch="conformer", hidden_size=512, num_layers=16,
            attention_heads=8, ff_multiplier=4, conv_kernel_size=15,
            time_reduction_stride=4, time_reduction_layer=0)))


def streaming_conformer_config():
    """The streaming Conformer of bench_streaming.py:40-50: its model with
    the encoder replaced by the same blocks (16, d=512, 8 heads, ff x4,
    kernel 15) made chunked-causal: attention_chunk 16, left 4 chunks, 4x
    frame stacking."""
    cfg = streaming_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transnet=dataclasses.replace(
            cfg.model.transnet, arch="conformer", hidden_size=512, num_layers=16,
            attention_heads=8, ff_multiplier=4, conv_kernel_size=15,
            bidirectional=False, attention_chunk=16, attention_left_chunks=4,
            time_reduction_stride=4, time_reduction_layer=0)))


def conformer_step_flops(cfg, batch: int, t_frames: int, u_labels: int) -> float:
    """Matmul FLOPs of one Conformer training step (fwd + bwd = 3x forward
    GEMMs): the port's copy of experiments/perf_conformer.py:44-65, with
    bench.py's prediction-net and joint terms at the reduced frame rate."""
    tn, pn, jn = cfg.model.transnet, cfg.model.prednet, cfg.model.jointnet
    d, ff = tn.hidden_size, tn.ff_multiplier
    tp = t_frames // tn.time_reduction_stride
    fwd = 2 * batch * tp * (tn.input_size * tn.time_reduction_stride) * d
    per_block = (2 * (2 * 2 * batch * tp * d * ff * d)   # two macaron FFNs
                 + 4 * 2 * batch * tp * d * d            # q / k / v / out
                 + 2 * 2 * batch * tp * tp * d           # scores + values
                 + 2 * batch * tp * d * 2 * d            # conv pointwise-in (GLU)
                 + 2 * batch * tp * d * d)               # conv pointwise-out
    fwd += tn.num_layers * per_block
    fwd += 2 * batch * tp * d * tn.output_size
    Hp, u1 = pn.hidden_size, u_labels + 1
    fwd += pn.num_layers * 2 * batch * u1 * 4 * Hp * (Hp + Hp)
    fwd += 2 * batch * u1 * Hp * pn.output_size
    fwd += 2 * batch * tp * tn.output_size * jn.num_classes
    fwd += 2 * batch * u1 * pn.output_size * jn.num_classes
    return 3.0 * fwd


def _kernel_share(rows, *names) -> float:
    """Device ms of the profiled kernels whose names contain any of ``names``."""
    return sum(us for us, _, key in rows if any(n in key for n in names)) / 1e3


def _conformer_step(cfg, flax_params, results, launches):
    """(a) The Conformer-L bf16 train_step at B=64, T=512 (128 after
    stacking), U=48 on features, timed, with a profile; one raw-PCM step;
    one AdamW, one adafactor and one lion step."""
    cfg, state = _bf16_train_state(cfg, flax_params)
    B, T, U = TRAIN_B, T_FRAMES, TRAIN_U
    batch = _train_batch(cfg, B, T, U, seed=SEED + 31)
    want = step_launches(cfg, T, U, device=DEVICE)
    print(f"conformer expected launches per step {json.dumps(want)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    step_ms, got, _ = _run_steps("conformer", state, batch, want, WARMUP_STEPS,
                                 TIMED_STEPS, "encoder.blocks.0.attn.q_proj.weight")
    launches.update({k: launches[k] + got[k] for k in KERNELS})
    ms = float(np.mean(step_ms))
    n_params = sum(p.numel() for p in state.model.parameters())
    mfu = conformer_step_flops(cfg, B, T, U) / (ms / 1e3) / PEAK_BF16_FLOPS
    rows = []
    busy = phase_profile_step(state, batch, rows)
    shares = None
    if rows:
        total = sum(r[0] for r in rows) / 1e3
        shares = {"device_ms": total,
                  "k3_lstm_fwd_ms": _kernel_share(rows, "lstm_fwd"),
                  "k4_lstm_bwd_ms": _kernel_share(rows, "lstm_bwd", "gates_gemm"),
                  "k5_rnnt_sweep_ms": _kernel_share(rows, "rnnt_sweep")}
        shares["rest_ms"] = total - sum(v for k, v in shares.items() if k != "device_ms")
        print("conformer profile: " + ", ".join(f"{k} {v:.2f}" for k, v in shares.items()),
              flush=True)
    results["step"] = {
        "step_ms": ms, "step_ms_each": step_ms, "utt_per_s": B / (ms / 1e3), "mfu": mfu,
        "params": n_params, "launches_per_step": want, "device_busy_share": busy,
        "profile_ms": shares, "top_kernels": [(us / 1e3, n, key[:90]) for us, n, key in
                                              sorted(rows, reverse=True)[:15]],
        "max_memory_allocated_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    print(f"conformer-L bf16 B={B} T={T} (T'={T // 4}) U={U}, {n_params / 1e6:.1f} M "
          f"params: step {ms:.1f} ms, {B / (ms / 1e3):.2f} utt/s, MFU {mfu:.4f} (of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)

    wav, lengths = _pcm(B, seed=SEED + 32)
    q, scale = quantize_pcm(wav, lengths)
    text = {k: v for k, v in batch.items() if k not in ("feats", "feat_lengths")}
    pcm = {"wav": torch.from_numpy(q).to(DEVICE),
           "wav_scale": torch.from_numpy(scale).to(DEVICE),
           "wav_lengths": torch.from_numpy(lengths).to(DEVICE), **text}
    want_pcm = step_launches(cfg, T, U, raw_pcm=True, device=DEVICE)
    pcm_ms, got, _ = _run_steps("conformer raw-PCM", state, pcm, want_pcm, 1, 1,
                                "encoder.out_proj.weight")
    launches.update({k: launches[k] + got[k] for k in KERNELS})
    results["raw_pcm_step_ms"] = pcm_ms[0]
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    for kind in ("adamw", "adafactor", "lion"):
        ocfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                  optimizer=kind))
        ostate = TrainState.create(ocfg, DEVICE, state_dict=sd, seed=SEED)
        o_ms, got, metrics = _run_steps(f"conformer {kind}", ostate, batch, want, 0, 1,
                                        "encoder.blocks.0.ff1.dense0.weight")
        launches.update({k: launches[k] + got[k] for k in KERNELS})
        results[f"{kind}_step"] = {"ms": o_ms[0], "loss": metrics["loss"].item()}
        del ostate
        torch.cuda.empty_cache()


def _conformer_vs_plain(cfg, flax_params):
    """(b) One fp32 loss + grads of the Conformer at 4 blocks, B=8, with the
    kernels (K3, K4, K5) and with their plain versions; deterministic.
    Comparison only: its launches are not the main path's."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transnet=dataclasses.replace(cfg.model.transnet,
                                                num_layers=CONFORMER_PLAIN_LAYERS)),
        train=TrainConfig(precision="fp32"))
    tree = dict(flax_params, encoder={k: v for k, v in flax_params["encoder"].items()
                                      if not k.startswith("block_")
                                      or int(k[6:]) < CONFORMER_PLAIN_LAYERS})
    model = build_model(cfg, DEVICE, state_dict_from_flax(tree, cfg.model), trainable=True)
    params = dict(model.named_parameters())
    feat_lengths, target_lengths = PLAIN_STEP_LENGTHS
    batch = _train_batch(cfg, len(feat_lengths), T_FRAMES, TRAIN_U, seed=SEED + 33)
    batch["feat_lengths"] = torch.tensor(feat_lengths, device=DEVICE)
    batch["target_lengths"] = torch.tensor(target_lengths, device=DEVICE)

    def run():
        loss = loss_fn(model, cfg, params, batch, None, deterministic=True)
        grads = torch.autograd.grad(loss, [params[n] for n in CONFORMER_GRAD_PARAMS])
        torch.cuda.synchronize()
        return loss.item(), grads

    loss_k, grads_k = run()
    with _plain_kernels():
        loss_p, grads_p = run()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = {n: _rel_err(g, r) for n, g, r in zip(CONFORMER_GRAD_PARAMS, grads_k, grads_p)}
    print(f"conformer fp32 step ({CONFORMER_PLAIN_LAYERS} blocks) B={len(feat_lengths)} "
          f"kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.2e}, tol "
          f"{STEP_LOSS_TOL:.0e}); grad rel err "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (tol {STEP_GRAD_TOL:.0e})", flush=True)
    if not (loss_err <= STEP_LOSS_TOL and max(errs.values()) <= STEP_GRAD_TOL):
        raise AssertionError("the fp32 Conformer step with kernels disagrees with the "
                             "plain one")
    del model, params
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_rel_err": errs}


def _conformer_offline(cfg, flax_params, tokenizer, waves, launches):
    """(c) The offline Recognizer on Conformer-L: a batch of 8 waves, bf16,
    greedy and the device beam (width 5): transcripts, times, launches
    (none: the encoder has no kernel, the decoders step the prediction
    network with the plain cell).  Then, in fp32, the padded batch's
    encoder rows against each wave encoded alone (the masking contract)."""
    from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
    out = {}
    none = dict.fromkeys(KERNELS, 0)
    for decoder in ("greedy", "beam_batched"):
        rec = Recognizer(cfg, flax_params, tokenizer, decoder=decoder, precision="bf16",
                         device=DEVICE)
        rec.transcribe(waves[0][:16000])  # warm-up
        texts, ms, got = _counted(rec.transcribe_batch, waves)
        _expect_launches(f"conformer Recognizer {decoder} bf16 batch of {len(waves)}",
                         got, none)
        if not all(isinstance(x, str) for x in texts):
            raise AssertionError(f"conformer Recognizer {decoder}: {texts}")
        print(f"conformer Recognizer {decoder} bf16 transcribe_batch of {len(waves)}: "
              f"{ms:.1f} ms; {[len(x) for x in texts]} characters", flush=True)
        out[f"{decoder}_batch{len(waves)}_ms"] = ms
        del rec
    model = build_model(cfg, DEVICE, state_dict_from_flax(flax_params, cfg.model))
    lens = [len(w) for w in waves]
    pad = np.zeros((len(waves), max(lens)), np.float32)
    for i, w in enumerate(waves):
        pad[i, :len(w)] = w
    frontend = LogMelFrontend(cfg.data.audio)
    err = 0.0
    with torch.inference_mode():
        feats, flen = frontend(torch.from_numpy(pad).to(DEVICE),
                               torch.tensor(lens, device=DEVICE))
        enc, _ = model.encode(feats, flen)
        elen = cfg.model.transnet.output_lengths(flen)
        for i in range(len(waves)):
            n = int(flen[i])
            solo, _ = model.encode(feats[i:i + 1, :n], flen[i:i + 1])
            err = max(err, _rel_err(enc[i, :int(elen[i])], solo[0]))
    print(f"conformer fp32 padded batch of {len(waves)} vs each wave alone: encoder rel "
          f"err {err:.2e} (tol {ENCODER_TOL['fp32']:.0e})", flush=True)
    if not err <= ENCODER_TOL["fp32"]:
        raise AssertionError("the Conformer's padded batch differs from its waves alone")
    out["padded_vs_alone_rel_err"] = err
    del model
    torch.cuda.empty_cache()
    return out


def _staggered(runner, waves):
    """Lane i opens at round i; every open lane gets its next 100 ms each
    round, fed with a drain, so each tick serves the lanes whose chunk is
    full and the others idle mid-stream.  Returns (tokens, greedy
    timestamps, ticks where a live lane idled beside a busy one)."""
    idled = [0]
    step = runner._step

    def recording(feats, n_valid):
        live = sorted(runner._live)
        nv = n_valid[live]
        idled[0] += int(bool((nv == 0).any() and (nv > 0).any()))
        return step(feats, n_valid)

    runner._step = recording
    sessions, got, pos, r = [], [[] for _ in waves], [0] * len(waves), 0
    while any(p < len(w) for p, w in zip(pos, waves)):
        if r < len(waves):
            sessions.append(runner.open(normalize="none"))
        for i, sess in enumerate(sessions):
            if pos[i] < len(waves[i]):
                got[i] += sess.feed(waves[i][pos[i]:pos[i] + SESSION_FEED])
                pos[i] += SESSION_FEED
        r += 1
    times = []
    for i, sess in enumerate(sessions):
        got[i] += sess.flush()
        times.append(sess.timestamps)
    runner._step = step
    return got, times, idled[0]


def _conformer_streaming(cfg, sd, launches):
    """(d) The streaming Conformer at full width.  fp32 (TF32 off): chunk by
    chunk against the offline masked forward; streaming greedy against
    offline greedy; 8 staggered lanes against 8 independent sessions; an
    all-idle tick at 64 lanes.  bf16: StreamingRecognizer RTF and
    first-token latency, greedy and beam 4; ticks of the batched runner at
    8 and 64 lanes (another all-idle tick at 64).  No kernel on any of these
    paths."""
    from rnntransducer_tpu_torch.decode.session_batch import BatchedStreamingRunner
    from rnntransducer_tpu_torch.decode.streaming import (StreamingRecognizer,
                                                          _zero_encoder_state)
    from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
    tn, audio = cfg.model.transnet, cfg.data.audio
    T = CONFORMER_STREAM_FRAMES
    max_symbols = cfg.train.greedy_max_symbols
    frame_sec = tn.time_reduction_stride * audio.window_stride_sec
    none = dict.fromkeys(KERNELS, 0)
    out = {}
    model32 = build_model(cfg, DEVICE, state_dict=sd)

    # chunk by chunk against the offline masked forward (a ragged batch of 2)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 34)
    n = CONFORMER_STREAM_CHUNKS * T
    feats = torch.randn(2, n, tn.input_size, device=DEVICE, generator=gen)
    flen = torch.tensor([n, n - T - 37], device=DEVICE)
    with torch.inference_mode():
        offline, _ = model32.encode(feats, flen)
        state = _zero_encoder_state(model32, 2)
        chunks = []
        for c0 in range(0, n, T):
            enc, state = model32.encode(feats[:, c0:c0 + T], (flen - c0).clamp(0, T), state)
            chunks.append(enc)
        stream = torch.cat(chunks, dim=1)
    diff = (stream - offline).abs()
    bound = CONFORMER_STREAM_ATOL + CONFORMER_STREAM_RTOL * offline.abs()
    worst = (diff / bound).max().item()
    print(f"streaming conformer fp32 chunk by chunk ({CONFORMER_STREAM_CHUNKS} chunks of {T} "
          f"frames, rows {flen.tolist()}) vs the offline masked forward: max abs diff "
          f"{diff.max().item():.2e}, worst / (atol {CONFORMER_STREAM_ATOL:.0e} + rtol "
          f"{CONFORMER_STREAM_RTOL:.0e} |x|) = {worst:.3f}", flush=True)
    if not worst <= 1.0:
        raise AssertionError("the streaming Conformer's chunks differ from its offline "
                             "masked forward")
    out["chunk_vs_offline_max_abs"] = diff.max().item()

    # streaming greedy against offline greedy
    wav = _stream_waves(1, SEED + 35)[0]
    with torch.inference_mode():
        f, fl = LogMelFrontend(audio)(torch.from_numpy(wav[None]).to(DEVICE))
        toks, lens = greedy_mod.greedy_decode(model32, f, fl, max_symbols=max_symbols,
                                              max_output_len=512)
    offline_toks = toks[0, :lens[0]].tolist()
    rec = StreamingRecognizer(model32, audio, chunk_frames=T, normalize="none",
                              max_symbols=max_symbols)
    streamed = []
    for s0 in range(0, len(wav), SESSION_FEED):
        streamed += rec.feed(wav[s0:s0 + SESSION_FEED])
    streamed += rec.flush()
    print(f"streaming conformer greedy vs offline greedy, fp32, {STREAM_UTT_SEC:.0f} s: "
          f"tokens equal {streamed == offline_toks} ({len(offline_toks)} tokens)",
          flush=True)
    if streamed != offline_toks or not offline_toks:
        raise AssertionError("streaming Conformer greedy differs from offline greedy "
                             "(or emitted nothing)")

    def runner_of(model, lanes, decoder):
        return BatchedStreamingRunner(model, audio, max_sessions=lanes, chunk_frames=T,
                                      max_symbols=max_symbols, max_output_len=512,
                                      decoder=decoder, beam_width=4)

    # 8 staggered lanes against independent sessions, greedy
    short = _session_waves(SERVER_LANES, SEED + 36, CONFORMER_CMP_SEC)
    got, times, idled = _staggered(runner_of(model32, len(short), "greedy"), short)
    independent = []
    for w in short:
        rec = StreamingRecognizer(model32, audio, chunk_frames=T, normalize="none",
                                  max_symbols=max_symbols, max_output_len=512)
        fed = []
        for s0 in range(0, len(w), SESSION_FEED):
            fed += rec.feed(w[s0:s0 + SESSION_FEED])
        independent.append((fed + rec.flush(), rec.timestamps))
    ties = _margin_rule(model32, "conformer sessions greedy fp32 staggered", "greedy",
                        short, got, times, independent, max_symbols, T, audio, frame_sec)
    print(f"conformer sessions greedy fp32, {len(short)} staggered lanes of "
          f"{CONFORMER_CMP_SEC:.0f} s ({idled} ticks with a live lane idle): tokens equal "
          f"to independent sessions on {len(short) - len(ties)} of {len(short)} lanes; "
          f"near-ties {ties}; tokens per lane {[len(x) for x in got]}", flush=True)
    if not idled:
        raise AssertionError("the staggered traffic idled no live lane")
    out["staggered_fp32"] = {"idle_ticks": idled, "near_ties": ties}
    # an all-idle tick at 64 live lanes, two chunks into their streams
    lanes = max(SESSION_LANES)
    _lockstep(runner_of(model32, lanes, "greedy"),
              _session_waves(lanes, SEED + 39, 3 * T * 10 / 1000),
              idle_round=2 * T * 10 // 100 + 1, flush=False)
    del model32
    torch.cuda.empty_cache()

    # bf16: sessions and ticks
    model = build_model(cfg, DEVICE, state_dict=sd).to(torch.bfloat16)
    for decoder in ("greedy", "beam"):
        out[decoder] = _stream_rtf("streaming conformer", model, audio, T, decoder, none,
                                   launches, f"chunks of {T} frames")
    waves = _session_waves(max(SESSION_LANES), SEED + 37, SESSION_UTT_SEC)
    for lanes in SESSION_LANES:
        for decoder in ("greedy", "beam"):
            runner = runner_of(model, lanes, decoder)
            runner.warmup()
            big = lanes == max(SESSION_LANES)
            _zero_counts()
            stats = _lockstep(runner, waves[:lanes],
                              idle_round=CONFORMER_IDLE_ROUND if big else None,
                              flush=not big)
            torch.cuda.synchronize()
            what = f"conformer sessions {decoder} bf16 {lanes} lanes ({stats['ticks']} ticks)"
            _expect_launches(what, _counts(), none)
            tokens = stats.pop("tokens")
            stats.pop("times")
            print(f"{what}: tick p50 {stats['tick_ms_p50']:.1f} ms, p99 "
                  f"{stats['tick_ms_p99']:.1f} ms (a chunk is {T * 10} ms of audio); "
                  f"aggregate RTF {stats['aggregate_rtf']:.2f} audio s per wall s; feed "
                  f"block p99 {stats['poll_block_ms_p99']:.2f} ms; tokens per lane "
                  f"{[len(x) for x in tokens[:8]]}", flush=True)
            if not all(tokens):
                raise AssertionError(f"{what}: a lane decoded no token")
            if not stats["tick_ms_p99"] < T * 10:
                raise AssertionError(f"{what}: a tick takes longer than its chunk's audio")
            out[f"{decoder}_{lanes}"] = stats
            del runner
    del model
    torch.cuda.empty_cache()
    return out


def phase_conformer(tokenizer, waves):
    """Phase 8: the Conformer at full width (conformer_l_config,
    streaming_conformer_config) with seeded random weights through the
    flax-layout bridge: (a) training steps, (b) fp32 kernels vs plain,
    (c) the offline Recognizer, (d) the streaming Conformer.  Returns the
    main paths' launches (a, c, d) and the figures."""
    cfg = conformer_l_config()
    flax_params = random_flax_params(cfg.model, torch.Generator().manual_seed(SEED + 30))
    launches = dict.fromkeys(KERNELS, 0)
    results = {}
    _conformer_step(cfg, flax_params, results, launches)
    results["vs_plain_fp32"] = _conformer_vs_plain(cfg, flax_params)
    results["offline"] = _conformer_offline(cfg, flax_params, tokenizer, waves, launches)
    scfg = streaming_conformer_config()
    sd = state_dict_from_flax(random_flax_params(
        scfg.model, torch.Generator().manual_seed(SEED + 38)), scfg.model)
    results["streaming"] = _conformer_streaming(scfg, sd, launches)
    return launches, results



# ---- phase 9: data parallelism (parallel/) ----------------------------------
# a: one rank over NCCL in this process against the single-device Trainer
# (twice: its run-to-run spread is the bound), base_config() bf16 raw PCM,
# global batch 64; b: two worker ranks sharing the card over gloo (NCCL
# refuses two ranks on one device) against one process at their global
# batch, base_config() at full width with the encoder cut to 2 layers, fp32.
PARALLEL_DIR = os.path.join(REPO, "build", "parallel")
PARALLEL_N, PARALLEL_STEPS = 256, 4
PARALLEL_RANK_B, PARALLEL_LAYERS, PARALLEL_B_STEPS = 8, 2, 3
PARALLEL_TOL = 1e-5             # ROADMAP: losses and grads, 1e-5 relative
PARALLEL_TIMEOUT_S = 300        # a hung worker or barrier fails the phase
PARALLEL_ALLREDUCE_REPS = 10


def _params_of(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _max_param_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def _parallel_trainer_run(cfg, flax_params, want, launches):
    """``Trainer.fit`` to PARALLEL_STEPS on a raw-PCM synthetic dataset,
    every step's launches checked against ``want`` and added to
    ``launches``; returns (final params, logged step_ms, logged losses)."""
    audio = cfg.data.audio
    train_ds = SyntheticAudioDataset(
        PARALLEL_N, audio, vocab_size=cfg.model.jointnet.num_classes, min_sec=1.0,
        max_sec=N_SAMPLES / audio.sample_rate, min_labels=4, max_labels=48, seed=SEED,
        as_waveform=True)
    step_fn = train_loop.train_step

    def counted_step(state, batch):
        _zero_counts()
        metrics = step_fn(state, batch)
        got = _counts()
        if got != want:
            raise AssertionError(f"parallel Trainer step {state.step}: launches {got}, "
                                 f"expected {want}")
        for k in KERNELS:
            launches[k] += got[k]
        return metrics

    shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    train_loop.train_step = counted_step
    try:
        trainer = train_loop.Trainer(cfg, train_ds, device=DEVICE,
                                     state_dict=state_dict_from_flax(flax_params, cfg.model))
        state = trainer.fit()
        if state.step != PARALLEL_STEPS:
            raise AssertionError(f"the parallel fit ended at step {state.step}")
        params = _params_of(trainer.state)
    finally:
        train_loop.train_step = step_fn
    logs = [json.loads(line) for line in open(os.path.join(cfg.train.checkpoint_dir,
                                                           "metrics.jsonl"))]
    train_logs = [r for r in logs if r.get("split") == "train"]
    del trainer, state
    shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return params, [r["step_ms"] for r in train_logs], [r["loss"] for r in train_logs]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _allreduce_ms(params) -> tuple:
    """CUDA-event time of ``parallel.all_reduce_mean`` on float32 grads of
    every param (the step's one all-reduce), and its bytes."""
    from rnntransducer_tpu_torch.parallel import all_reduce_mean
    grads = [torch.randn(p.shape, device=DEVICE) for p in params.values()]
    all_reduce_mean(grads)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(PARALLEL_ALLREDUCE_REPS):
        all_reduce_mean(grads)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / PARALLEL_ALLREDUCE_REPS,
            sum(g.numel() * 4 for g in grads))


def _parallel_nccl(flax_params, launches) -> dict:
    """Phase 9a: Trainer.fit through a one-rank NCCL process group against
    the single-device Trainer on the same seed."""
    from rnntransducer_tpu_torch import parallel
    base = base_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, precision="bf16", per_device_train_batch_size=TRAINER_B,
        max_steps=PARALLEL_STEPS, log_every_steps=1, seed=SEED,
        checkpoint_dir=os.path.join(PARALLEL_DIR, "nccl"), wav_transfer_dtype="int16"))
    want = step_launches(cfg, T_FRAMES, TRAIN_U, raw_pcm=True, device=DEVICE)
    single_a, ms_a, loss_a = _parallel_trainer_run(cfg, flax_params, want, launches)
    single_b, ms_b, loss_b = _parallel_trainer_run(cfg, flax_params, want, launches)
    topology = parallel.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE,
                                   timeout_s=PARALLEL_TIMEOUT_S)
    try:
        if parallel.world_size() != 1 or topology["process_count"] != 1:
            raise AssertionError(f"process group topology {topology}")
        grouped, ms_g, loss_g = _parallel_trainer_run(cfg, flax_params, want, launches)
        ar_ms, ar_bytes = _allreduce_ms(grouped)
    finally:
        parallel.shutdown()
    if parallel.is_initialized():
        raise AssertionError("the process group outlived the phase")
    spread, diff = _max_param_diff(single_a, single_b), _max_param_diff(single_a, grouped)
    del single_a, single_b, grouped
    torch.cuda.empty_cache()
    print(f"parallel a: NCCL, 1 rank, bf16 raw PCM, global batch {TRAINER_B}, "
          f"{PARALLEL_STEPS} steps: max |param diff| single vs single {spread:.3e}, "
          f"single vs process group {diff:.3e}; logged step_ms single {ms_a} / {ms_b}, "
          f"process group {ms_g}; losses {loss_a} / {loss_g}; all-reduce of "
          f"{ar_bytes / 1e6:.1f} MB of float32 grads {ar_ms:.3f} ms", flush=True)
    if diff > spread:
        raise AssertionError(f"the process group's params differ from the single "
                             f"device's by {diff}, more than two single-device runs "
                             f"({spread})")
    return {"launches_per_step": want, "max_param_diff_single_vs_single": spread,
            "max_param_diff_single_vs_group": diff, "step_ms_single": [ms_a, ms_b],
            "step_ms_group": ms_g, "loss_single": loss_a, "loss_group": loss_g,
            "allreduce_ms": ar_ms, "allreduce_bytes": ar_bytes}


def _parallel_b_config():
    """base_config() at full width, the encoder cut to 2 layers, fp32, no
    dropout or SpecAugment (the ranks draw other masks than one process)."""
    base = base_config()
    m = base.model
    return dataclasses.replace(
        base, model=dataclasses.replace(
            m, transnet=dataclasses.replace(m.transnet, num_layers=PARALLEL_LAYERS,
                                            dropout=0.0),
            prednet=dataclasses.replace(m.prednet, dropout=0.0)),
        data=dataclasses.replace(base.data, audio=dataclasses.replace(
            base.data.audio, spec_augment=False)),
        train=TrainConfig(precision="fp32", accumulate_grad_batches=1, max_steps=1000,
                          seed=SEED))


def _parallel_steps(cfg, sd, batch, want, zero=False):
    """PARALLEL_B_STEPS train_steps from ``sd``; every step's launches checked.
    Returns (losses, the first step's grads (all-reduced), final params,
    moment bytes)."""
    from rnntransducer_tpu_torch.parallel import moment_bytes
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, shard_optimizer_state=zero))
    state = TrainState.create(cfg, DEVICE, state_dict=sd, seed=SEED)
    grads = {}
    step = state.optimizer.step

    def capture():
        if not grads:
            grads.update({n: p.grad.detach().clone()
                          for n, p in state.model.named_parameters()})
        return step()

    state.optimizer.step = capture
    losses = []
    for i in range(PARALLEL_B_STEPS):
        _zero_counts()
        losses.append(train_step(state, batch)["loss"].item())
        got = _counts()
        if got != want:
            raise AssertionError(f"parallel b step {i}: launches {got}, expected {want}")
    return losses, grads, _params_of(state), moment_bytes(state.optimizer)


def parallel_worker(rank_: int, port: str, out_dir: str) -> int:
    """One rank of phase 9b, run in a process of its own on cuda:0: the
    replicated and the ZeRO-1 steps on this rank's rows of the global batch;
    rank 0 saves the first step's grads and the final params."""
    from rnntransducer_tpu_torch import parallel
    build.build_all(KERNELS)
    parallel.initialize(f"127.0.0.1:{port}", 2, rank_, device=DEVICE, backend="gloo",
                        timeout_s=PARALLEL_TIMEOUT_S)
    try:
        cfg = _parallel_b_config()
        sd = state_dict_from_flax(random_flax_params(
            cfg.model, torch.Generator().manual_seed(SEED + 40)), cfg.model)
        batch = _train_batch(cfg, 2 * PARALLEL_RANK_B, T_FRAMES, TRAIN_U)
        local = {k: v[rank_::2] for k, v in batch.items()}
        want = step_launches(cfg, T_FRAMES, TRAIN_U, device=DEVICE)
        losses, grads, params, rep_bytes = _parallel_steps(cfg, sd, local, want)
        zlosses, _, zparams, zero_bytes = _parallel_steps(cfg, sd, local, want, zero=True)
        result = {"rank": rank_, "losses": losses, "zero_losses": zlosses,
                  "launches_per_step": want, "moment_bytes_replicated": rep_bytes,
                  "moment_bytes_zero": zero_bytes,
                  "zero_vs_replicated_max_abs": _max_param_diff(params, zparams),
                  "zero_vs_replicated_max_rel": max(
                      (params[k] - zparams[k]).abs().max().item()
                      / max(params[k].abs().max().item(), 1e-30) for k in params)}
        if rank_ == 0:
            torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                        "params": {k: v.cpu() for k, v in params.items()}},
                       os.path.join(out_dir, "rank0.pt"))
        with open(os.path.join(out_dir, f"rank{rank_}.json"), "w") as f:
            json.dump(result, f)
    finally:
        parallel.shutdown()
    return 0


def _parallel_gloo() -> dict:
    """Phase 9b: two worker processes share the card over gloo; this process
    runs their global batch alone meanwhile, then holds their losses, first
    grads and params against its own."""
    out_dir = os.path.join(PARALLEL_DIR, "gloo")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    worker = os.path.join(out_dir, "worker.py")
    with open(worker, "w") as f:
        f.write(f"import sys\nsys.path.insert(0, {REPO!r})\nimport chip_smoke\n"
                "sys.exit(chip_smoke.parallel_worker(int(sys.argv[1]), sys.argv[2], "
                "sys.argv[3]))\n")
    port = str(_free_port())
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, worker, str(r), port, out_dir],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(2)]
    try:
        cfg = _parallel_b_config()
        sd = state_dict_from_flax(random_flax_params(
            cfg.model, torch.Generator().manual_seed(SEED + 40)), cfg.model)
        batch = _train_batch(cfg, 2 * PARALLEL_RANK_B, T_FRAMES, TRAIN_U)
        want_single = step_launches(cfg, T_FRAMES, TRAIN_U, device=DEVICE)
        losses, grads, params, rep_bytes = _parallel_steps(cfg, sd, batch, want_single)
        # the same rows as two microbatches, rank 0's then rank 1's: the
        # ranks' arithmetic in one process (the kernels at their batch shape)
        order = torch.cat([torch.arange(0, 2 * PARALLEL_RANK_B, 2),
                           torch.arange(1, 2 * PARALLEL_RANK_B, 2)]).to(DEVICE)
        acc_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, accumulate_grad_batches=2))
        acc_losses, acc_grads, acc_params, _ = _parallel_steps(
            acc_cfg, sd, {k: v[order] for k, v in batch.items()},
            {k: 2 * v for k, v in want_single.items()})
        del sd, batch
        torch.cuda.empty_cache()
        deadline = time.time() + PARALLEL_TIMEOUT_S
        rcs = [p.wait(timeout=max(deadline - time.time(), 1)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs):
        if rc != 0:
            tail = open(os.path.join(out_dir, f"rank{r}.log")).read()[-4000:]
            raise AssertionError(f"parallel b: worker rank {r} exited {rc}:\n{tail}")
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
    saved = torch.load(os.path.join(out_dir, "rank0.pt"))
    loss_rel = max(abs(g - w) / abs(w) for rk in ranks for g, w in zip(rk["losses"], losses))
    # relative in each tensor's 2-norm: the ranks sum their halves of the
    # batch in another order than one process, and an element whose terms
    # cancel keeps that rounding at its own (small) scale
    grad_norm_rel = {k: ((saved["grads"][k] - grads[k].cpu()).norm()
                         / grads[k].cpu().norm().clamp_min(1e-30)).item() for k in grads}
    grad_elem_rel = {k: ((saved["grads"][k] - grads[k].cpu()).abs().max()
                         / grads[k].cpu().abs().max().clamp_min(1e-30)).item()
                     for k in grads}
    acc_norm_rel = max(((acc_grads[k] - grads[k]).cpu().norm()
                        / grads[k].cpu().norm().clamp_min(1e-30)).item() for k in grads)
    grad_rel = max(grad_norm_rel.values())
    worst = max(grad_elem_rel, key=grad_elem_rel.get)
    param_rel = max((saved["params"][k] - params[k].cpu()).abs().max().item()
                    / max(params[k].abs().max().item(), 1e-30) for k in params)
    vs_acc = {"grads": _max_param_diff(saved["grads"], {k: v.cpu() for k, v in
                                                        acc_grads.items()}),
              "params": _max_param_diff(saved["params"], {k: v.cpu() for k, v in
                                                          acc_params.items()}),
              "losses": max(abs(g - w) for rk in ranks
                            for g, w in zip(rk["losses"], acc_losses))}
    del grads, params, acc_grads, acc_params
    torch.cuda.empty_cache()
    print(f"parallel b: 2 gloo ranks on one card x {PARALLEL_RANK_B} rows vs one process "
          f"x {2 * PARALLEL_RANK_B}, fp32, {PARALLEL_LAYERS}-layer encoder, "
          f"{PARALLEL_B_STEPS} steps: losses {ranks[0]['losses']} vs {losses} (max rel "
          f"{loss_rel:.3e}); first step's grads: max over tensors of the 2-norm rel "
          f"error {grad_rel:.3e} ({max(grad_norm_rel, key=grad_norm_rel.get)}), of "
          f"the max element error over the tensor's max {grad_elem_rel[worst]:.3e} "
          f"({worst}); the same process over the same rows as two microbatches of "
          f"{PARALLEL_RANK_B}: 2-norm rel error {acc_norm_rel:.3e}, and the ranks against "
          f"it: max abs diff of grads {vs_acc['grads']:.3e}, params "
          f"{vs_acc['params']:.3e}, losses {vs_acc['losses']:.3e}; final params max "
          f"rel {param_rel:.3e}; ZeRO-1 vs replicated params max abs "
          f"{[rk['zero_vs_replicated_max_abs'] for rk in ranks]}; AdamW moment bytes per "
          f"rank ZeRO {[rk['moment_bytes_zero'] for rk in ranks]} vs replicated "
          f"{[rk['moment_bytes_replicated'] for rk in ranks]} (one process {rep_bytes}); "
          f"launches per step per rank {ranks[0]['launches_per_step']}", flush=True)
    # the losses hold one process at the global batch; the grads and params
    # equal the same process's microbatches of the ranks' rows to the bit, so
    # they hold the global batch's as closely as those microbatches do
    if not (loss_rel <= PARALLEL_TOL and max(vs_acc.values()) == 0.0):
        raise AssertionError(f"parallel b: the ranks differ from one process: losses "
                             f"{loss_rel} (tolerance {PARALLEL_TOL}), grads {grad_rel} "
                             f"(its microbatches {acc_norm_rel}), against the "
                             f"microbatches {vs_acc}")
    for rk in ranks:
        if rk["zero_losses"] != rk["losses"] or rk["zero_vs_replicated_max_abs"] != 0.0:
            raise AssertionError(f"parallel b: ZeRO-1 differs from replicated on rank "
                                 f"{rk['rank']}: {rk}")
        if not 0.45 <= rk["moment_bytes_zero"] / rk["moment_bytes_replicated"] <= 0.55:
            raise AssertionError(f"parallel b: rank {rk['rank']} holds "
                                 f"{rk['moment_bytes_zero']} moment bytes under ZeRO-1, "
                                 f"replicated {rk['moment_bytes_replicated']}")
    return {"ranks": 2, "rows_per_rank": PARALLEL_RANK_B, "loss_max_rel": loss_rel,
            "first_grads_norm_rel": grad_rel,
            "first_grads_elem_rel": grad_elem_rel[worst],
            "microbatched_grads_norm_rel": acc_norm_rel,
            "vs_microbatched_max_abs": vs_acc,
            "final_params_max_rel": param_rel,
            "losses_ranks": ranks[0]["losses"], "losses_single": losses,
            "launches_per_step_per_rank": ranks[0]["launches_per_step"],
            "moment_bytes_zero": [rk["moment_bytes_zero"] for rk in ranks],
            "moment_bytes_replicated": [rk["moment_bytes_replicated"] for rk in ranks]}


def phase_parallel(flax_params):
    """Phase 9: the data axis on the card: (a) Trainer.fit through a
    one-rank NCCL process group, (b) two gloo ranks sharing the card, their
    replicated and ZeRO-1 steps.  Returns (a)'s launches (the process
    group's run and the single-device runs it is held against) and the
    figures."""
    launches = dict.fromkeys(KERNELS, 0)
    results = {"nccl": _parallel_nccl(flax_params, launches),
               "gloo": _parallel_gloo()}
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    return launches, results


CORPUS_DIR = os.path.join(REPO, "build", "corpus")
CORPUS_SPLITS = (("train", 128), ("dev", 16), ("eval_clean", 16))
CORPUS_B, CORPUS_EVAL_B = 64, 16
CORPUS_STEPS, CORPUS_WAVE_STEPS = 4, 2
CORPUS_LOSS_TOL = 1e-5      # checked_rnnt_loss on the card vs the plain loss on the CPU


def _corpus_config(max_steps: int, checkpoint_dir: str):
    """base_config() at full width, bf16, the flagship's (T=512, U=48)
    bucket, global batch 64, a validation at step CORPUS_STEPS."""
    base = base_config()
    return dataclasses.replace(
        base, data=dataclasses.replace(base.data, audio_buckets=(T_FRAMES,),
                                       label_buckets=(TRAIN_U,)),
        train=dataclasses.replace(
            base.train, precision="bf16", per_device_train_batch_size=CORPUS_B,
            per_device_eval_batch_size=CORPUS_EVAL_B, max_steps=max_steps,
            val_every_steps=CORPUS_STEPS, log_every_steps=1,
            checkpoint_dir=checkpoint_dir, seed=SEED))


def _write_corpus(tokenizer, audio) -> dict:
    """split -> (TSV path, [(WAV path, labels)]): the confusable testbed's
    waves as WAV files (scaled down by their peak where ``write_wav``
    would clip them) and a manifest of the tokenizer's decode of the
    labels (the testbed draws graphemes below 56, which decode keeps)."""
    corpus = {}
    for k, (split, n) in enumerate(CORPUS_SPLITS):
        tb = ConfusableWaveformDataset(n, audio, seed=SEED + k)
        wav_dir = os.path.join(CORPUS_DIR, "wavs", split)
        os.makedirs(wav_dir, exist_ok=True)
        rows, lines = [], []
        for i in range(n):
            wav, labels = tb.waveform(i)
            path = os.path.join(wav_dir, f"{i}.wav")
            write_wav(path, wav / max(1.0, float(np.abs(wav).max())),
                      audio.sample_rate)
            rows.append((path, labels))
            lines.append(f"{path}\t{tokenizer.decode(labels.tolist())}\n")
        tsv = os.path.join(CORPUS_DIR, f"{split}.tsv")
        with open(tsv, "w", encoding="utf-8") as f:
            f.writelines(lines)
        corpus[split] = (tsv, rows)
    return corpus


@contextlib.contextmanager
def _counted_steps(what: str, want: dict, launches: dict, steps: list):
    """Every Trainer step in the block with its launches set to 0 before
    and read after: they must equal ``want``; each step's counts go to
    ``steps`` and are added to ``launches``."""
    step_fn = train_loop.train_step

    def counted_step(state, batch):
        _zero_counts()
        metrics = step_fn(state, batch)
        got = _counts()
        steps.append(got)
        if got != want:
            raise AssertionError(f"{what} step {state.step}: launches {got}, "
                                 f"expected {want}")
        for k in KERNELS:
            launches[k] += got[k]
        return metrics

    train_loop.train_step = counted_step
    try:
        yield
    finally:
        train_loop.train_step = step_fn


def _step_ms(checkpoint_dir: str) -> list:
    logs = [json.loads(line) for line in open(os.path.join(checkpoint_dir,
                                                           "metrics.jsonl"))]
    train = [r for r in logs if r.get("split") == "train"]
    if not (train and all(np.isfinite(r["loss"]) for r in train)):
        raise AssertionError(f"corpus train logs: {logs}")
    return [r["step_ms"] for r in train], [r for r in logs if r.get("split") == "val"]


def _check_manifest_shards(raw: str, corpus: dict) -> None:
    """Every raw shard row: ids equal the testbed's labels, PCM equals
    read_wav of its file, exactly."""
    for split, (_, rows) in corpus.items():
        ds = load_shards([raw], split).with_format("numpy")
        if len(ds) != len(rows):
            raise AssertionError(f"{split}: {len(ds)} rows for {len(rows)} WAVs")
        for i, (path, labels) in enumerate(rows):
            row = ds[i]
            if not np.array_equal(row["input_ids"], labels):
                raise AssertionError(f"{split} row {i}: ids {row['input_ids']} "
                                     f"for labels {labels}")
            if not np.array_equal(np.asarray(row["input_values"], np.float32),
                                  read_wav(path)):
                raise AssertionError(f"{split} row {i}: PCM differs from {path}")


def _check_logmel_shards(raw: str, logmel: str, audio) -> None:
    """The prepared features equal logmel_np of the raw rows, exactly."""
    for split, _ in CORPUS_SPLITS:
        src = load_shards([raw], split).with_format("numpy")
        got = ArrowAudioDataset([logmel], split)
        if len(got) != len(src):
            raise AssertionError(f"{split}: {len(got)} log-mel rows for {len(src)}")
        for i in range(len(src)):
            want = logmel_np(np.asarray(src[i]["input_values"], np.float32), audio)
            item = got[i]
            if not (np.array_equal(item["feats"], want)
                    and np.array_equal(item["labels"], src[i]["input_ids"])):
                raise AssertionError(f"{split} row {i}: the log-mel shard differs")


def _checked_loss(trainer, ds, audio) -> dict:
    """On one batch of the waveform run: checked_rnnt_loss (fp32 logits of
    the trained params; K5 launched once) against rnnt_loss on CPU copies
    of the same inputs (the plain sweep, a route independent of the card),
    and a label id of V caught with the vocabulary hint."""
    cfg = trainer.cfg
    V = cfg.model.jointnet.num_classes
    b = to_device(collate_waveforms(
        ds.get_batch(range(CORPUS_B)), max_samples=T_FRAMES * audio.hop_length - 1,
        max_labels=TRAIN_U, pad_id=cfg.data.text.pad_token_id), DEVICE)
    model = trainer.state.model
    with torch.no_grad():
        feats, feat_lengths = device_frontend(audio, dequantize_wav(b), b["wav_lengths"])
        logits = model(feats, feat_lengths, b["text_in"], b["text_lengths"])
        enc_lengths = cfg.model.transnet.output_lengths(feat_lengths)
        args = (logits, b["targets"], enc_lengths, b["target_lengths"])
        _zero_counts()
        err, loss = checked_rnnt_loss(*args)
        k5 = _counts()["rnnt_sweep"]
        ref = rnnt_loss(*(a.cpu() for a in args)).item()
        bad = b["targets"].clone()
        bad[0, 0] = V
        bad_err, _ = checked_rnnt_loss(logits, bad, enc_lengths, b["target_lengths"])
    rel = abs(loss.item() - ref) / abs(ref)
    if err is not None or k5 != 1 or not rel <= CORPUS_LOSS_TOL:
        raise AssertionError(f"checked_rnnt_loss: {err}, loss {loss.item()} vs the "
                             f"plain {ref} (rel {rel:.3e}), {k5} K5 launches")
    try:
        bad_err.throw()
        raise AssertionError("a label id of V was not caught")
    except ValueError as e:
        if "vocab/tokenizer mismatch?" not in str(e):
            raise
    del logits, feats
    return {"loss": ref, "checked_rel_err": rel, "k5_launches": k5}


def phase_corpus(flax_params, smi: str):
    """Phase 10: from a corpus of WAVs and transcripts to a trained model,
    through the entry points a user calls (see the module docstring).
    Returns the counted steps' launches and the figures."""
    t_phase = time.perf_counter()
    shutil.rmtree(CORPUS_DIR, ignore_errors=True)
    tokenizer = GraphemeTokenizer.default(base_config().model.jointnet.num_classes)
    cfg = _corpus_config(CORPUS_STEPS, os.path.join(CORPUS_DIR, "ckpt"))
    audio = cfg.data.audio
    n_utts = sum(n for _, n in CORPUS_SPLITS)
    corpus = _write_corpus(tokenizer, audio)

    raw, logmel = os.path.join(CORPUS_DIR, "raw"), os.path.join(CORPUS_DIR, "logmel")
    t0 = time.perf_counter()
    for split, (tsv, rows) in corpus.items():
        n = prepare_manifest.main(["--manifest", tsv, "--out", raw, "--split", split,
                                   "--num_shards", "2" if split == "train" else "1"])
        if n != len(rows):
            raise AssertionError(f"prepare_manifest wrote {n} of {len(rows)} rows")
    manifest_s = time.perf_counter() - t0
    _check_manifest_shards(raw, corpus)

    cfg_path = os.path.join(CORPUS_DIR, "config.json")
    cfg.to_json(cfg_path)
    cli_args = ["--config", cfg_path, "--hf_data_dirs", raw, "--pl_data_dir", logmel,
                "--num_shards", "2", "--device", DEVICE]
    prepare_s, prepared = [], []
    prepare_fn, prepare_split = cli_train.prepare_shards, data_mod.prepare_logmel_dataset

    def timed_prepare(*a, **kw):
        t = time.perf_counter()
        prepare_fn(*a, **kw)
        prepare_s.append(time.perf_counter() - t)

    def recorded_split(*a, **kw):
        prepared.append(a[2])
        return prepare_split(*a, **kw)

    want = step_launches(cfg, T_FRAMES, TRAIN_U, device=DEVICE)
    launches, steps = dict.fromkeys(KERNELS, 0), []
    cli_train.prepare_shards, data_mod.prepare_logmel_dataset = timed_prepare, recorded_split
    try:
        with _counted_steps("corpus log-mel", want, launches, steps):
            state = cli_train.main(cli_args)
        if state.step != CORPUS_STEPS or len(steps) != CORPUS_STEPS:
            raise AssertionError(f"the CLI ended at step {state.step} ({len(steps)} "
                                 "steps counted)")
        del state
        torch.cuda.empty_cache()
        first = list(prepared)
        ledger_stamp = os.path.getmtime(os.path.join(logmel, "postprocess_log.json"))
        results = cli_train.main(cli_args + ["--eval_only"])
    finally:
        cli_train.prepare_shards, data_mod.prepare_logmel_dataset = (prepare_fn,
                                                                     prepare_split)
    torch.cuda.empty_cache()
    if first != [s for s, _ in CORPUS_SPLITS] + ["eval_other"] or prepared != first:
        raise AssertionError(f"splits prepared: {first}, then {prepared[len(first):]}")
    if (os.path.getmtime(os.path.join(logmel, "postprocess_log.json")) != ledger_stamp
            or not os.path.exists(os.path.join(logmel, "_PREPARED"))
            or sorted(read_ledger(logmel)) != sorted(s for s, _ in CORPUS_SPLITS)):
        raise AssertionError(f"ledger {read_ledger(logmel)}")
    _check_logmel_shards(raw, logmel, audio)
    logmel_ms, val = _step_ms(cfg.train.checkpoint_dir)
    ev = results.get("eval_clean", {})
    if not (len(val) == 1 and np.isfinite(val[0]["val_loss"]) and set(results) ==
            {"eval_clean"} and all(np.isfinite(ev.get(k, np.nan))
                                   for k in ("loss", "wer", "cer"))):
        raise AssertionError(f"validation {val}, eval_only {results}")

    wave_root = os.path.join(CORPUS_DIR, "wave")
    train_rows = corpus["train"][1]
    save_waveform_dataset(({"wav": read_wav(p), "labels": lb} for p, lb in train_rows),
                          wave_root, "train", audio.hop_length, num_shards=2,
                          total=len(train_rows))
    wave_ds = ArrowWaveformDataset([wave_root], "train", audio)
    wave_cfg = _corpus_config(CORPUS_WAVE_STEPS, os.path.join(CORPUS_DIR, "wave_ckpt"))
    want_wave = step_launches(wave_cfg, T_FRAMES, TRAIN_U, raw_pcm=True, device=DEVICE)
    wave_steps = []
    with _counted_steps("corpus waveform", want_wave, launches, wave_steps):
        trainer = train_loop.Trainer(wave_cfg, wave_ds, device=DEVICE,
                                     state_dict=state_dict_from_flax(flax_params,
                                                                     wave_cfg.model))
        state = trainer.fit()
    if state.step != CORPUS_WAVE_STEPS or len(wave_steps) != CORPUS_WAVE_STEPS:
        raise AssertionError(f"the waveform fit ended at step {state.step}")
    wave_ms, _ = _step_ms(wave_cfg.train.checkpoint_dir)
    checked = _checked_loss(trainer, wave_ds, audio)
    del trainer, state
    torch.cuda.empty_cache()
    shutil.rmtree(CORPUS_DIR, ignore_errors=True)

    wall_s = time.perf_counter() - t_phase
    result = {
        "utterances": dict(CORPUS_SPLITS), "launches_per_step": want,
        "launches_per_step_waveform": want_wave,
        "manifest_s_per_100_utts": 100 * manifest_s / n_utts,
        "logmel_prepare_s_per_100_utts": 100 * prepare_s[0] / n_utts,
        "logmel_step_ms": logmel_ms,
        "logmel_step_ms_median": float(np.median(logmel_ms[1:])),
        "waveform_step_ms": wave_ms,
        "waveform_step_ms_median": float(np.median(wave_ms[1:])),
        "val": {k: val[0][k] for k in ("val_loss", "val_wer", "val_cer")},
        "eval_clean": ev, "checked_loss": checked, "wall_s": wall_s}
    print(f"corpus ({smi}): host preparation per 100 utterances: manifest "
          f"{result['manifest_s_per_100_utts']:.3f} s, log-mel "
          f"{result['logmel_prepare_s_per_100_utts']:.3f} s", flush=True)
    print(f"corpus ({smi}): median of the steps after the first (the first warms "
          f"up): from log-mel shards {result['logmel_step_ms_median']:.1f} ms (all "
          f"steps {logmel_ms}), from waveform shards "
          f"{result['waveform_step_ms_median']:.1f} ms (all steps {wave_ms})",
          flush=True)
    print(f"corpus ({smi}): phase wall time {wall_s:.1f} s", flush=True)
    return launches, result


def _timed(name, fn, *args):
    """``fn(*args)``, its wall time printed (where the script's time goes)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    sms, smem = rnn_kernels.device_limits(DEVICE)
    print(f"card limits read from the device: {sms} SMs, {smem} bytes of shared memory "
          f"a block may opt in to", flush=True)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fwd_err, fwd_times = _timed("kernels", phase_kernels, gen)
    _timed("gru_limits", phase_gru_limits, gen)
    bwd_err, bwd_times = _timed("gru_bwd", phase_gru_bwd, gen)
    _timed("lstm_limits", phase_lstm_limits, gen)
    lstm_fwd_err, lstm_bwd_err, lstm_times = _timed("lstm", phase_lstm, gen)
    print("lstm_tick " + json.dumps(_timed("lstm_tick", phase_lstm_tick, gen)), flush=True)
    print("cudnn_layers " + json.dumps(_timed("cudnn_layers", phase_cudnn_layers, gen)),
          flush=True)
    _timed("step_chunked", phase_step_chunked, gen)
    sweep_err, sweep_times = _timed("sweep", phase_sweep, gen)
    logmel_err, logmel_times = _timed("logmel", phase_logmel)

    cfg = base_config()
    flax_params = random_flax_params(cfg.model, torch.Generator().manual_seed(SEED))
    tokenizer = GraphemeTokenizer.default(cfg.model.jointnet.num_classes)
    waves = _waves(8)
    serve_launches, results = _timed("serving", phase_serving, flax_params, tokenizer,
                                     waves)
    print("serving " + json.dumps(results), flush=True)
    if not serve_launches > 0:
        raise AssertionError("the serving path launched no GRU kernel")
    torch.cuda.empty_cache()

    stream_cfg = streaming_config()
    stream_sd = state_dict_from_flax(random_flax_params(
        stream_cfg.model, torch.Generator().manual_seed(SEED + 7)), stream_cfg.model)

    # ---- the main paths: each sets the counts to 0 before every step -------
    launches = dict.fromkeys(KERNELS, 0)
    bare_busy = {}
    shared = {}  # phase 7a's waves and runner tokens, for phase 7b
    try:
        for name, run in (
                ("training", lambda: phase_training(flax_params)),
                ("raw_pcm", lambda: phase_raw_pcm(flax_params)),
                ("tiny", lambda: phase_tiny(tokenizer, waves)),
                ("trainer", lambda: phase_trainer(flax_params, waves,
                                                  bare_busy.get("training"))),
                ("decoding", lambda: phase_decoding(flax_params, tokenizer, waves)),
                ("streaming", lambda: phase_streaming(stream_sd)),
                ("cli", lambda: phase_cli(stream_cfg, stream_sd, waves)),
                ("sessions", lambda: phase_sessions(stream_sd, shared)),
                ("server", lambda: phase_server(stream_cfg, stream_sd, shared)),
                ("evaluate", lambda: phase_evaluate(flax_params, tokenizer)),
                ("import", lambda: phase_import(tokenizer)),
                ("conformer", lambda: phase_conformer(tokenizer, waves)),
                ("parallel", lambda: phase_parallel(flax_params)),
                ("corpus", lambda: phase_corpus(flax_params, smi))):
            got, result = _timed(name, run)
            bare_busy[name] = result.get("device_busy_share")
            launches = {k: launches[k] + got[k] for k in KERNELS}
            print(f"{name} " + json.dumps(result, ensure_ascii=False), flush=True)
    finally:
        for d in (TRAINER_DIR, DECODE_DIR, EVAL_DIR, IMPORT_DIR, PARALLEL_DIR,
                  CORPUS_DIR):
            shutil.rmtree(d, ignore_errors=True)
    vs_plain = _timed("step_vs_plain", phase_step_vs_plain, flax_params)
    print("step_vs_plain " + json.dumps(vs_plain), flush=True)

    flagship_lstm = lstm_times[(torch.bfloat16,) + LSTM_SHAPES[0]]
    rows = (("gru_fwd", "ops/rnn_pallas.py:92", fwd_err,
             fwd_times[(torch.bfloat16, TRAIN_B)]),
            ("gru_bwd", "ops/rnn_pallas.py:163", bwd_err,
             bwd_times[(torch.bfloat16, TRAIN_B)]),
            ("lstm_fwd", "ops/rnn_pallas.py:121", lstm_fwd_err, flagship_lstm["fwd"]),
            ("lstm_bwd", "ops/rnn_pallas.py:226", lstm_bwd_err, flagship_lstm["bwd"]),
            ("rnnt_sweep", "ops/rnnt_pallas.py:71", sweep_err, sweep_times[2 * TRAIN_B]),
            ("logmel", "frontend/pallas_frontend.py:84", logmel_err, logmel_times[False]))
    kernels = []
    for name, replaces, err, (ms, plain, bound, bound_by) in rows:
        if not launches[name] > 0:
            raise AssertionError(f"{name} was not launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"rnntransducer_tpu_torch/csrc/{name}.cu",
            "replaces": "rnntransducer_tpu/" + replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
