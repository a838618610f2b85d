"""Training: the pieces ``Trainer.fit`` composes, in one process on one card.

``LengthBucketSampler`` (seeded with the configuration's own training seed,
so every run seed trains the same batches of buckets on other utterances) ->
``collate_waveforms`` (raw PCM, shipped as the configuration says) on the
prefetch thread -> ``DevicePrefetcher`` -> ``train_step``.

The sampler's batches of an epoch are played in a fixed order of buckets
(``order``): first one batch of the longest audio bucket, one of the
shortest and one of the bucket that holds the most frames (the checked
steps), then the rest so that every prefix of the epoch holds each bucket
in its share of the epoch to within one batch.  So a window of any length,
and a faster program that fits more batches into it, runs the traffic's mix.

Set-up builds the one ``TrainState`` from weights drawn on the card from the
seed, warms every (audio bucket, label bucket) shape of the epoch with a
forward and backward that leaves the state alone, then drives the state
through its first three steps through the window's own feed and call,
reading each step's loss, its dropout and SpecAugment masks
(``harness.masks``), the first gradient (from AdamW's first moment after
one step) and the parameters' change after the third.  The window then runs
on the same state for ``--seconds``; it ends in a synchronize.  After it,
with the program's state freed, the plain reference follows the same three
steps from the same weights with the same masks, and the numbers of
``reference.train.readings`` and the masks' dropped share
(``reference.augment.share_gap``) are held to the cell's limits.
"""

from __future__ import annotations

import collections
import gc
import itertools
import math
import time
from typing import Callable, Dict, List

import numpy as np

from benchmark.harness.common import Outcome, Spans, log, process_age_s
from benchmark.harness.masks import MaskLog, read_back
from benchmark.harness.trace import profiled, summarize
from benchmark.harness.traffic import utterances

KERNELS = ["gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd", "rnnt_sweep", "logmel"]
CHECKED_STEPS = 3


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """The sampler -> collate -> prefetch chain over seeded utterances, and
    the host-side facts of each batch it yields, in order."""

    def __init__(self, cfg, mix: dict, utts, device):
        from rnntransducer_tpu_torch.data.bucketing import LengthBucketSampler
        self.cfg, self.mix, self.utts, self.device = cfg, mix, utts, device
        hop = cfg.data.audio.hop_length
        self.frames = utts.samples // hop + 1
        self.sampler = LengthBucketSampler(
            self.frames, cfg.data.audio_buckets, mix["batch"], seed=cfg.train.seed,
            shuffle=True, label_lengths=[len(x) for x in utts.labels],
            max_label_length=cfg.data.label_buckets[-1])
        self.facts: collections.deque = collections.deque()

    def label_bucket(self, idxs) -> int:
        u = max(len(self.utts.labels[i]) for i in idxs)
        return next((b for b in self.cfg.data.label_buckets if u <= b),
                    self.cfg.data.label_buckets[-1])

    def host_batch(self, b_idx: int, idxs) -> dict:
        from rnntransducer_tpu_torch.data.collate import collate_waveforms
        cfg = self.cfg
        items = [{"wav": self.utts.wav(i), "labels": self.utts.labels[i]} for i in idxs]
        return collate_waveforms(
            items, max_samples=cfg.data.audio_buckets[b_idx] * cfg.data.audio.hop_length - 1,
            max_labels=self.label_bucket(idxs), pad_id=cfg.data.text.pad_token_id,
            transfer_dtype=cfg.train.wav_transfer_dtype)

    def _host_batches(self):
        for epoch in itertools.count():
            for b_idx, idxs, n_valid in order(list(self.sampler.epoch_batches(epoch)),
                                              self.cfg.data.audio_buckets):
                batch = self.host_batch(b_idx, idxs)
                self.facts.append({
                    "idxs": np.asarray(idxs), "n_valid": int(n_valid),
                    "T": int(self.cfg.data.audio_buckets[b_idx]),
                    "U": int(batch["targets"].shape[1]),
                    "frames": [int(min(self.frames[i], self.cfg.data.audio_buckets[b_idx]))
                               for i in idxs],
                    "labels": [len(self.utts.labels[i]) for i in idxs]})
                yield batch

    def start(self):
        from rnntransducer_tpu_torch.data.prefetch import DevicePrefetcher
        self.prefetcher = DevicePrefetcher(self._host_batches(), device=self.device)
        return self.prefetcher

    def shapes(self) -> List[tuple]:
        """(audio bucket, label bucket, a batch's indices) of every shape of
        the first epoch, largest first."""
        seen = {}
        for b_idx, idxs, _ in self.sampler.epoch_batches(0):
            key = (b_idx, self.label_bucket(idxs))
            seen.setdefault(key, idxs)
        return [(b, u, seen[(b, u)]) for b, u in sorted(seen, reverse=True)]


def order(batches: List[tuple], buckets) -> List[tuple]:
    """The sampler's (bucket, indices, n_valid) batches of one epoch in the
    played order: one batch each of the longest bucket, the shortest and
    the one with the most frames first, then at every position the bucket
    furthest below its share of the epoch (the longer on a tie), each
    bucket's batches in the sampler's order."""
    by: Dict[int, collections.deque] = collections.defaultdict(collections.deque)
    for b in batches:
        by[b[0]].append(b)
    share = {k: len(v) / len(batches) for k, v in by.items()}
    most = max(by, key=lambda k: (len(by[k]) * buckets[k], k))
    first = list(dict.fromkeys([max(by), min(by), most]))
    out, placed = [], collections.Counter()
    for k in first:
        out.append(by[k].popleft())
        placed[k] += 1
    while len(out) < len(batches):
        n = len(out) + 1
        k = max((k for k in by if by[k]), key=lambda k: (n * share[k] - placed[k], k))
        out.append(by[k].popleft())
        placed[k] += 1
    return out


def _program_readings(state, params0, losses, grad1) -> dict:
    import torch
    change = {}
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            change[name] = float((p.detach().double()
                                  - params0[name].to(p.device).double()).norm())
    return {"losses": losses, "grad1": grad1, "change": change}


def _grad1(state) -> Dict[str, float]:
    """The first gradient of every leaf as AdamW got it: its first moment
    after one step over (1 - beta1)."""
    import torch
    out = {}
    with torch.no_grad():
        for group in state.optimizer.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                m = state.optimizer.state[p]["exp_avg"]
                out[p] = float(m.double().norm()) / (1.0 - b1)
    return {name: out[p] for name, p in state.model.named_parameters()}


def _step_fn(fault: str) -> Callable:
    """``train_step``, or the step with a planted fault (tests and the
    calibration of limits)."""
    from rnntransducer_tpu_torch.train import state as st
    if fault == "half_batch":
        def step(state, batch):
            B = next(iter(batch.values())).shape[0]
            return st.train_step(state, {k: v[:B // 2] for k, v in batch.items()})
        return step
    if fault == "unchanged":
        def step(state, batch):
            loss = st.eval_step(state.cfg, state.model, batch)
            return {"loss": loss, "grad_norm": loss, "nonfinite_grad": loss.int()}
        return step
    return st.train_step


def _setup(cell, seed: int, fault: str = ""):
    """Data, weights, state, feed; the warm-up; the checked steps.  Returns
    (config, state, feed, iterator, params0 on the host, program readings
    with the checked steps' masks, checked batches' facts, utterances)."""
    import torch
    from rnntransducer_tpu_torch.config import Config
    from rnntransducer_tpu_torch.train import state as st
    from benchmark.reference.model import param_specs, seeded_params

    run = cell.run_cfg
    cfg = Config.from_dict(run)
    device = torch.device(cell.device)
    mix = cell.traffic
    utts = utterances(mix, mix["utterances"]["count"], seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = cell.config.get("weights", {})
    params = seeded_params(param_specs(run["model"]), gen, device,
                           blank_bias=w.get("blank_bias", 0.0),
                           suppressed=w.get("suppressed"),
                           suppress_bias=w.get("suppress_bias", 0.0),
                           encoder_gain=w.get("encoder_gain", 1.0),
                           joint_scale=w.get("joint_scale", 1.0))
    params0 = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
    state = st.TrainState.create(cfg, device, state_dict=params, seed=seed)
    del params
    log(f"seed {seed}: {len(utts)} utterances, weights and state built")
    feed = Feed(cfg, mix, utts, device)
    # warm-up: every shape of the epoch, forward and backward, no update
    names, masters = zip(*state.model.named_parameters())
    for b_idx, _, idxs in feed.shapes():
        from rnntransducer_tpu_torch.data.prefetch import to_device
        batch = to_device(feed.host_batch(b_idx, idxs), device)
        loss = st.loss_fn(state.model, cfg, dict(zip(names, masters)), batch,
                          state.generator, deterministic=False,
                          noise_generator=state.noise_generator, mesh=state.mesh)
        torch.autograd.grad(loss, masters)
        del batch, loss
    _sync(device)
    log(f"warmed {len(feed.shapes())} shapes")
    step = _step_fn(fault)
    it = feed.start()
    losses, grad1, checked, masks = [], {}, [], []
    for k in range(CHECKED_STEPS):
        batch = next(it)
        checked.append(feed.facts.popleft())
        with read_back(MaskLog()) as read:
            losses.append(float(step(state, batch)["loss"]))
        masks.append(read.as_dict())
        if k == 0:
            grad1 = _grad1(state) if fault != "unchanged" else {
                n: 0.0 for n, _ in state.model.named_parameters()}
    prog = _program_readings(state, params0, losses, grad1)
    prog["masks"] = masks
    log(f"checked steps (audio buckets {[f['T'] for f in checked]}): losses {losses}")
    return cfg, state, feed, it, params0, prog, checked, utts


def _reference(cell, params0, checked, utts, masks, precision: str = "fp32") -> dict:
    import torch
    from benchmark.reference.precision import exact_float32
    from benchmark.reference.train import reference_steps
    device = torch.device(cell.device)
    batches = [[{"wav": utts.wav(i), "labels": utts.labels[i]} for i in f["idxs"]]
               for f in checked]
    with exact_float32():
        return reference_steps(cell.run_cfg, params0, batches, device, precision, masks)


def _readings(cell, prog, ref) -> Dict[str, float]:
    """The numbers compared: ``reference.train.readings`` of the program
    against ``ref`` (None where the program's masks did not fit its steps:
    every number then reads infinite) and the masks' dropped share."""
    from benchmark.reference.augment import share_gap
    from benchmark.reference.train import readings
    got = readings(prog, ref) if ref is not None else {
        "loss_rel": math.inf, "grad1_leaf": math.inf, "change_leaf": math.inf}
    got["drop_share_gap"] = share_gap(prog["masks"], cell.run_cfg)
    return got


def _fitting_reference(cell, params0, checked, utts, masks, precision: str = "fp32"):
    """``_reference``, or None where the program's masks do not fit."""
    from benchmark.reference.augment import MaskMismatch
    try:
        return _reference(cell, params0, checked, utts, masks, precision)
    except MaskMismatch as e:
        log(f"the program's masks do not fit its steps: {e}")
        return None


def _free(*objs) -> None:
    import torch
    for o in objs:
        close = getattr(o, "close", None)
        if close:
            close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell) -> Outcome:
    import torch

    device = torch.device(cell.device)
    if device.type == "cuda":
        from rnntransducer_tpu_torch.ops import build
        build.build_all(KERNELS)
    fault = cell.options.get("fault", "")
    cfg, state, feed, it, params0, prog, checked, utts = _setup(cell, cell.seed, fault)
    step = _step_fn(fault)
    setup_s = process_age_s()
    if device.type == "cuda":
        # the window's peak (the read-back of the checked steps' masks adds
        # copies of its own)
        torch.cuda.reset_peak_memory_stats(device)
    seconds = cell.seconds
    spans = Spans(tracing=cell.trace)
    steps, losses = [], []
    with profiled(cell.trace) as prof:
        _sync(device)
        t0 = time.perf_counter()
        while True:
            with spans.span("feed_wait"):
                batch = next(it)
            facts = feed.facts.popleft()
            with spans.span("train_step"):
                losses.append(step(state, batch)["loss"])
            steps.append(facts)
            del batch
            if time.perf_counter() - t0 >= seconds:
                break
        with spans.span("drain"):
            _sync(device)
        window_s = time.perf_counter() - t0
    summary = summarize(prof, window_s) if prof is not None else None
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    utt = sum(f["n_valid"] for f in steps)
    _free(it)
    del state, losses
    _free()
    log(f"window: {len(steps)} steps, {utt} utterances in {window_s:.3f} s; peak "
        f"{peak / 2**30:.2f} GiB")
    ref = _fitting_reference(cell, params0, checked, utts, prog["masks"])
    got = _readings(cell, prog, ref)
    if ref is not None:
        log(f"reference: losses {ref['losses']}")
    checks = [(k, got[k], float(v)) for k, v in cell.limits["checks"].items()]
    ctx = {"kind": "train", "spans": spans.times, "steps": steps, "window_s": window_s,
           "trace": summary, "model": cell.run_cfg["model"],
           "precision": cell.run_cfg["train"]["precision"], "readings": got}
    return Outcome({"train_utt_per_s": utt / window_s}, len(steps), failed, checks, ctx,
                   peak, setup_s)


def calibrate(cell, seeds, control_seeds, fault_seeds, out) -> None:
    """The readings the limits are set from, one JSON line per seed to
    ``out``: the program's (a dozen seeds or more), the fp8 control's and
    the half-batch fault's (three seeds or more), each against the fp32
    reference of its seed."""
    import json
    import torch

    device = torch.device(cell.device)
    if device.type == "cuda":
        from rnntransducer_tpu_torch.ops import build
        build.build_all(KERNELS)
    for seed in seeds:
        t0 = time.perf_counter()
        _, state, _, it, params0, prog, checked, utts = _setup(cell, seed)
        _free(it)
        del state
        _free()
        fault = None
        if seed in fault_seeds:
            _, state, _, it, _, fault, _, _ = _setup(cell, seed, "half_batch")
            _free(it)
            del state
            _free()
        masks = prog["masks"]
        ref = _reference(cell, params0, checked, utts, masks)
        line = {"seed": seed, "buckets": [f["T"] for f in checked],
                "program": _readings(cell, prog, ref),
                "losses": {"program": prog["losses"], "reference": ref["losses"]}}
        if fault is not None:
            line["half_batch"] = _readings(cell, fault, ref)
        if seed in control_seeds:
            control = _reference(cell, params0, checked, utts, masks, "fp8")
            control["masks"] = masks
            line["control_fp8"] = _readings(cell, control, ref)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), file=out, flush=True)
