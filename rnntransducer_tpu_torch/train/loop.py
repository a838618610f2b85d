"""The trainer (port of ``rnntransducer_tpu/train/loop.py``).

* epoch loop over length-bucketed batches (``LengthBucketSampler``), rows
  fetched on reader threads ahead of the step (``ordered_readahead``),
  collated on a background thread and copied to the device on a side stream
  (``DevicePrefetcher``);
* ``train_step`` per batch (the recurrent, sweep and, on raw PCM, log-mel
  kernels on the card); the host counts steps itself and reads the loss
  back only at log steps;
* periodic validation: per-sample loss (``eval_step``) plus a greedy or
  batched-beam decode (``train.val_decoder``) and corpus WER / CER;
* checkpoints: top k by ``val_cer`` plus the latest; ``fit(resume=True)``
  continues the deterministic data schedule exactly where the run stopped;
* SIGTERM checkpoints the current step and ends ``fit`` cleanly.

The mesh comes from ``cfg.train.{model_parallel, pipeline_stages,
sequence_parallel}`` and the process group (``parallel/``, one device per
rank), as the JAX package's Trainer builds it: ``data × [time | stage] ×
[model]``.  Every rank walks the same global batch sequence and takes the
rows ``idxs[d::D]`` of its data index d; the label bucket comes from the
global batch, so every rank runs the same shapes; ``train_step`` reduces
the grads once per step (the encoder's over the stage group, every leaf's
mean over the data group); validation runs the loss and a decode on each
data index's rows (a vocab-sharded model decodes with the fc gathered) and
sums the counts over the data indices; only rank 0 writes logs and
checkpoints; a SIGTERM on any rank stops every rank at the same step.
"""

from __future__ import annotations

import contextlib
import time
from typing import Mapping, Optional

import torch

from rnntransducer_tpu_torch.config import Config
from rnntransducer_tpu_torch.data.bucketing import LengthBucketSampler
from rnntransducer_tpu_torch.data.collate import collate, collate_waveforms
from rnntransducer_tpu_torch.data.prefetch import (DevicePrefetcher,
                                                   ordered_readahead, to_device)
from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
from rnntransducer_tpu_torch.decode.greedy import greedy_decode
from rnntransducer_tpu_torch.parallel import distributed
from rnntransducer_tpu_torch.models.transducer import build_model
from rnntransducer_tpu_torch.parallel.mesh import broadcast_state, local_rows
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
from rnntransducer_tpu_torch.train.metrics import error_counts
from rnntransducer_tpu_torch.train.state import (TrainState, dequantize_wav,
                                                 device_frontend, eval_step,
                                                 learning_rate_at, train_step,
                                                 watch_step)
from rnntransducer_tpu_torch.utils.device import resolve_device
from rnntransducer_tpu_torch.utils.logging import MetricsLogger
from rnntransducer_tpu_torch.utils.profiling import reset as reset_spans, spans, trace


def _span_ms_per_step() -> dict:
    """Milliseconds per train step of each outermost span recorded, the
    profile window's log line: ``train/step_ms`` on the device's clock,
    ``data/prefetch_wait_ms`` on the host's (a span timed on the host)."""
    rows = spans()
    steps = max(sum(s["name"] == "train/step" for s in rows), 1)
    total: dict = {}
    for s in rows:
        if s["parent"] is None:
            total[s["name"]] = total.get(s["name"], 0.0) + s["device_s"]
    return {f"{name}_ms": round(1e3 * t / steps, 3) for name, t in total.items()}


class Trainer:
    def __init__(self, cfg: Config, train_dataset, val_dataset=None,
                 tokenizer: Optional[GraphemeTokenizer] = None,
                 log_dir: Optional[str] = None, device=None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 profile_dir: Optional[str] = None, profile_steps: tuple = (10, 15)):
        self.cfg = cfg
        self.train_ds = train_dataset
        self.val_ds = val_dataset
        self.tokenizer = tokenizer or (
            GraphemeTokenizer.from_file(cfg.vocab_path) if cfg.vocab_path
            else GraphemeTokenizer.default(cfg.model.jointnet.num_classes))
        self.device = resolve_device(device)
        # the mesh (raises the JAX package's errors where the world size does
        # not fit cfg.train's axes) and this process's place on its data axis
        self.state = TrainState.create(cfg, self.device, state_dict=state_dict)
        self.mesh = self.state.mesh
        self.rank, self.world = self.mesh.data_index, self.mesh.data_width
        lead = distributed.rank() == 0
        self.logger = MetricsLogger((log_dir or cfg.train.checkpoint_dir) if lead else None,
                                    stdout=lead)
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                      save_top_k=cfg.train.save_top_k)
        broadcast_state(self.state)
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.profile = None          # the last profiled window's profiler
        self.profile_wall_s = None   # and its wall time, the card drained at both ends
        # host-side step mirror, read by the feed thread
        self._host_step = int(self.state.step)
        self._preempted = None
        # seconds of host work per batch (its rows' fetch and its collation,
        # not the time it waits for the step), and of each validation,
        # checkpoint save and restore
        self.feed_s: list = []
        self.validate_s: list = []
        self.save_s: list = []
        self.restore_s: list = []

    # ------------------------------------------------------------- batching
    def _global_batch(self) -> int:
        return (self.cfg.train.per_device_train_batch_size * self.world
                * self.cfg.train.accumulate_grad_batches)

    def _label_bucket_for(self, max_label_len: int) -> int:
        """The smallest label bucket covering the batch (labels are never
        cut: that would corrupt supervision)."""
        for lb in self.cfg.data.label_buckets:
            if max_label_len <= lb:
                return lb
        return self.cfg.data.label_buckets[-1]

    def _sampler(self, dataset, batch_size: int, shuffle: bool) -> LengthBucketSampler:
        label_lens = (dataset.label_lengths() if hasattr(dataset, "label_lengths")
                      else None)
        return LengthBucketSampler(
            dataset.lengths(), self.cfg.data.audio_buckets, batch_size,
            seed=self.cfg.train.seed, shuffle=shuffle, label_lengths=label_lens,
            max_label_length=self.cfg.data.label_buckets[-1])

    def _schedule_position(self, step: int):
        """(epoch, batches consumed within it) of a global step count: the
        sampler is seeded by seed + epoch, so every epoch's batch count is
        known without reading any data."""
        if step <= 0:
            return 0, 0
        sampler = self._sampler(self.train_ds, self._global_batch(), True)
        consumed, epoch = 0, 0
        while True:
            n = len(sampler.epoch_batches(epoch))
            if n == 0:
                return epoch, 0
            if consumed + n > step:
                return epoch, step - consumed
            consumed += n
            epoch += 1

    def _host_batches(self, dataset, epoch: int, batch_size: int,
                      shuffle: bool = True, with_counts: bool = False, skip: int = 0):
        """Collated host batches of ``epoch``'s schedule, the first ``skip``
        left out (the batches a resumed run already trained): this rank's
        rows of each global batch of ``batch_size``, padded to the label
        bucket of the global batch's longest label; ``with_counts`` yields
        the number of this rank's rows that are not wrap-padding beside
        each.  Runs on the prefetch thread: reads nothing of the train state
        and makes no collective call."""
        label_lens = (dataset.label_lengths() if hasattr(dataset, "label_lengths")
                      else None)
        sampler = self._sampler(dataset, batch_size, shuffle)
        batches = sampler.epoch_batches(epoch)[skip:]
        step = self._host_step
        if sampler.last_dropped:
            self.logger.log(step, event="overlong_dropped", count=sampler.last_dropped,
                            max_frames=self.cfg.data.audio_buckets[-1])
        if sampler.last_label_dropped:
            self.logger.log(step, event="overlong_label_dropped",
                            count=sampler.last_label_dropped,
                            max_labels=self.cfg.data.label_buckets[-1])
        get_batch = getattr(dataset, "get_batch", None)
        r, world = self.rank, self.world
        # without label lengths the global batch's longest label is read
        # from its rows: every rank fetches them all
        fetch_all = label_lens is None and world > 1

        def fetch_thunk(idxs):
            idxs = idxs if fetch_all else local_rows(idxs, r, world)

            def fetch():
                t0 = time.perf_counter()
                items = (get_batch(idxs) if get_batch is not None
                         else [dataset[i] for i in idxs])
                return time.perf_counter() - t0, items
            return fetch

        fetched = ordered_readahead((fetch_thunk(idxs) for _, idxs, _ in batches),
                                    workers=self.cfg.train.feed_reader_threads,
                                    depth=self.cfg.train.feed_read_ahead)
        for (b_idx, idxs, n_valid), (fetch_s, items) in zip(batches, fetched):
            t0 = time.perf_counter()
            if label_lens is not None:
                max_u = int(max(label_lens[i] for i in idxs))
            else:
                max_u = max(len(it["labels"]) for it in items)
            if fetch_all:
                items = items[r::world]
            label_bucket = self._label_bucket_for(max_u)
            if max_u > label_bucket:
                raise ValueError(
                    f"batch max label length {max_u} exceeds the largest label "
                    f"bucket {label_bucket}; truncating labels would corrupt "
                    "supervision. Widen cfg.data.label_buckets or give the dataset "
                    "a label_lengths() method so overlong utterances are dropped "
                    "(like overlong audio).")
            if "wav" in items[0]:
                # raw PCM: the largest sample count whose frame count fits the
                # bucket (num_frames = S // hop + 1), so no sample is lost
                frames_b = self.cfg.data.audio_buckets[b_idx]
                batch = collate_waveforms(
                    items, max_samples=frames_b * self.cfg.data.audio.hop_length - 1,
                    max_labels=label_bucket, pad_id=self.cfg.data.text.pad_token_id,
                    transfer_dtype=self.cfg.train.wav_transfer_dtype)
            else:
                batch = collate(items, max_frames=self.cfg.data.audio_buckets[b_idx],
                                max_labels=label_bucket,
                                pad_id=self.cfg.data.text.pad_token_id)
            self.feed_s.append(fetch_s + time.perf_counter() - t0)
            # global position of local row j: r + j * world
            yield (batch, len(range(r, n_valid, world))) if with_counts else batch

    # ----------------------------------------------------------------- fit
    def fit(self, resume: bool = False) -> TrainState:
        cfg = self.cfg
        if resume and self.ckpt.latest_step() is not None:
            t0 = time.perf_counter()
            self.ckpt.restore(self.state)
            broadcast_state(self.state)
            self.restore_s.append(time.perf_counter() - t0)
            self.logger.log(self.state.step, event="resumed")
        # the host counts steps: reading the state's step back every step
        # would not sync, but reading the loss would
        step = int(self.state.step)
        self._host_step = step
        epoch, skip = self._schedule_position(step)
        profile = contextlib.ExitStack()
        profiling = False
        last_log_t, last_log_step, last_feed = time.perf_counter(), step, len(self.feed_s)
        self._install_preemption_handler()
        lead = distributed.rank() == 0
        # the agreed flag, not self._preempted: a signal may land on one rank
        # between two agreements, and every rank must take the same branches
        preempted = False
        while step < cfg.train.max_steps and not preempted:
            preempted = self._agree_preempted()
            if preempted:
                break
            batches = DevicePrefetcher(
                self._host_batches(self.train_ds, epoch, self._global_batch(), skip=skip),
                device=self.device)
            skip = 0  # only the resumed epoch skips
            made_progress = False
            for batch in batches:
                if step >= cfg.train.max_steps:
                    batches.close()  # release the worker and its queued batches
                    break
                preempted = self._agree_preempted()
                if preempted:
                    batches.close()
                    break
                made_progress = True
                if (self.profile_dir and lead and not profiling
                        and self.profile_steps[0] <= step < self.profile_steps[1]):
                    self._sync()
                    self.profile = profile.enter_context(trace(self.profile_dir))
                    profile_t0 = time.perf_counter()
                    profiling = True
                if (self.rank == 0 and cfg.train.watch_every_steps
                        and step % cfg.train.watch_every_steps == 0):
                    # data index 0's rows (every rank of its model / stage /
                    # time row takes part): logged by rank 0, never reduced
                    hists = watch_step(self.state, batch)
                    if lead:
                        self.logger.log_histograms(step, {
                            g: {n: (c.cpu().numpy(), e.cpu().numpy())
                                for n, (c, e) in h.items()} for g, h in hists.items()})
                metrics = train_step(self.state, batch)
                step += 1
                self._host_step = step
                if lead and (step % cfg.train.log_every_steps == 0 or step == 1):
                    # the loss read syncs the queue; the steps in between ran
                    # without a host sync, so a step's time is the wall time
                    # since the last log over the steps in it
                    loss = float(metrics["loss"])
                    now = time.perf_counter()
                    step_ms = (now - last_log_t) / max(step - last_log_step, 1)
                    feed = self.feed_s[last_feed:]
                    last_log_t, last_log_step, last_feed = now, step, len(self.feed_s)
                    extra = {}
                    if int(metrics["nonfinite_grad"]):
                        extra["nonfinite_grad"] = 1
                    if feed:
                        extra["feed_ms"] = round(1e3 * sum(feed) / len(feed), 3)
                    self.logger.log(step, split="train", loss=loss,
                                    grad_norm=float(metrics["grad_norm"]),
                                    lr=learning_rate_at(cfg, step),
                                    step_ms=round(step_ms * 1e3, 1), epoch=epoch,
                                    **extra)
                if profiling and step >= self.profile_steps[1]:
                    self._sync()
                    self.profile_wall_s = time.perf_counter() - profile_t0
                    profile.close()
                    profiling = False
                    self.logger.log(step, event="profile_written", dir=self.profile_dir,
                                    **_span_ms_per_step())
                    reset_spans()
                if self.val_ds is not None and step % cfg.train.val_every_steps == 0:
                    val = self.validate()
                    # the state is copied to the host before save returns;
                    # the file is written while training goes on
                    self._save(step, val, wait=False)
            if not made_progress and not preempted:
                raise RuntimeError(
                    "training epoch produced no batches: dataset empty or every "
                    "utterance exceeds the largest audio bucket "
                    f"({cfg.data.audio_buckets[-1]} frames)")
            epoch += 1
        profile.close()
        if preempted:
            self.logger.log(step, event="preempted", signal=self._preempted)
        # the final save, unless validation just saved this step; on
        # preemption without validation, to beat the kill's grace period
        if self.ckpt.latest_step() != step:
            val = ({} if preempted else
                   self.validate() if self.val_ds is not None else {})
            self._save(step, val, wait=True)
        self.ckpt.wait()
        self._remove_preemption_handler()
        return self.state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save(self, step: int, metrics: dict, wait: bool) -> None:
        t0 = time.perf_counter()
        self.ckpt.save(step, self.state, metrics=metrics, config=self.cfg, wait=wait)
        self.save_s.append(time.perf_counter() - t0)

    # ------------------------------------------------- preemption handling
    # SIGTERM, the preemption notice of schedulers, sets a flag; the step
    # loop is the only place it is read, so the saved state is always a
    # consistent (params, optimizer state, step) triple.
    def _install_preemption_handler(self):
        import signal
        import threading

        self._preempted = None
        self._prev_handlers = {}
        if threading.current_thread() is not threading.main_thread():
            return  # signals reach only the main thread

        def handler(signum, frame):
            self._preempted = signal.Signals(signum).name

        try:
            self._prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):
            pass

    def _agree_preempted(self) -> bool:
        """Whether any rank has been preempted: the signal numbers
        all-reduced with MAX on the host, so every rank stops, and saves, at
        the same step (a rank stopping alone would hang the others in their
        next all-reduce).  The agreed value is returned, never the local
        flag, which a signal may set on one rank after its number was
        sent."""
        import signal

        if not distributed.is_initialized():
            return bool(self._preempted)
        mine = signal.Signals[self._preempted].value if self._preempted else 0
        agreed = int(distributed.host_all_reduce([mine], "max")[0])
        if agreed and not self._preempted:
            self._preempted = signal.Signals(agreed).name
        return bool(agreed)

    def _remove_preemption_handler(self):
        import signal

        for sig, prev in getattr(self, "_prev_handlers", {}).items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers = {}

    # ------------------------------------------------------------ evaluate
    def test(self, datasets: dict, max_batches: Optional[int] = None) -> dict:
        """Evaluate named test sets: {name: {loss, wer, cer}}, each logged."""
        results = {}
        for name, ds in datasets.items():
            out = self._evaluate(ds, max_batches)
            results[name] = out
            self.logger.log(self._host_step, split=f"test/{name}", **out)
        return results

    def validate(self, max_batches: Optional[int] = None) -> dict:
        t0 = time.perf_counter()
        out = self._evaluate(self.val_ds, max_batches)
        out = {"val_loss": out["loss"], "val_wer": out["wer"], "val_cer": out["cer"]}
        self.validate_s.append(time.perf_counter() - t0)
        self.logger.log(self._host_step, split="val", **out)
        return out

    def _decode_model(self):
        """The model validation decodes with: the state's own, or under a
        model axis one holding the whole fc (gathered over the model group)."""
        if self.state.vocab_shard is None:
            return self.state.model
        with torch.no_grad():
            whole = self.state.whole({k: v.detach() for k, v in
                                      self.state.model.state_dict().items()})
        return build_model(self.cfg, self.device, whole)

    def _evaluate(self, dataset, max_batches: Optional[int] = None) -> dict:
        cfg = self.cfg
        model = self.state.model
        decoder = self._decode_model()
        loss_sum, loss_n = 0.0, 0
        preds, refs = [], []
        n = 0
        for batch, n_valid in self._host_batches(
                dataset, epoch=0,
                batch_size=cfg.train.per_device_eval_batch_size * self.world,
                shuffle=False, with_counts=True):
            dev = to_device(batch, self.device)
            if "feats" not in dev:
                # raw PCM: the frontend once (no SpecAugment at eval); the
                # loss and the decode both read its features
                feats, feat_lengths = device_frontend(
                    cfg.data.audio, dequantize_wav(dev), dev["wav_lengths"])
                dev = dict(dev, feats=feats, feat_lengths=feat_lengths)
            # per-sample losses, so the wrap-padding rows do not count
            per_sample = eval_step(cfg, model, dev, reduction="none", mesh=self.mesh)
            kw = dict(blank_id=cfg.data.text.pad_token_id,
                      max_symbols=cfg.train.greedy_max_symbols,
                      max_output_len=max(cfg.data.label_buckets))
            if cfg.train.val_decoder == "beam":
                toks, lens, _ = batched_beam_decode(
                    decoder, dev["feats"], dev["feat_lengths"],
                    beam_width=cfg.train.val_beam_width, **kw)
                toks, lens = toks[:, 0], lens[:, 0]
            else:
                toks, lens = greedy_decode(decoder, dev["feats"], dev["feat_lengths"],
                                           **kw)
            per_sample = per_sample.float().cpu().numpy()
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            for j in range(n_valid):
                loss_sum += float(per_sample[j])
                loss_n += 1
                preds.append(self.tokenizer.decode(toks[j][:int(lens[j])],
                                                   group_tokens=False))
                u = int(batch["target_lengths"][j])
                refs.append(self.tokenizer.decode(batch["targets"][j, :u],
                                                  group_tokens=False))
            n += 1
            if max_batches is not None and n >= max_batches:
                break
        # corpus-level: the sufficient statistics summed over the data
        # indices (one rank speaks for each: its row computed the same rows)
        counts = [loss_sum, loss_n, *error_counts(preds, refs)]
        loss_sum, loss_n, we, wt, ce, ct = distributed.host_all_reduce(
            counts if self.mesh.is_data_lead() else [0.0] * len(counts)).tolist()
        return {"loss": loss_sum / loss_n if loss_n else float("nan"),
                "wer": we / max(wt, 1), "cer": ce / max(ct, 1)}

