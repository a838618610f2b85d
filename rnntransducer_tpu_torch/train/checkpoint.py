"""Checkpoints: save and restore a TrainState, keeping the top k by
validation CER plus the latest (port of ``rnntransducer_tpu/train/checkpoint.py``).

Each checkpoint is ``<directory>/<step>/state.pt``, one ``torch.save`` of the
params, the optimizer state, ``step``, ``updates``, the EMA shadow, the
generator's state and the config, written under a temporary name and renamed
into place, so a directory named by a step is always complete.  The metrics
of every retained step live in the JSON ledger ``checkpoint_metrics.json``,
written by atomic replace.  Retention keeps {top k by the monitored metric}
∪ {the latest} ∪ {the step just saved}, so pure top-k pruning can never
delete the training progress a resume needs.  One restore serves both
resume (into a live TrainState) and decoding (:func:`load_decode_params`).

Across the ranks of a process group every rank calls ``save`` at the same
steps: the state is gathered there into the single-device layout (the
joint fc's rows and their moments over the model group, a ZeRO-sharded
optimizer's moments over the data group, one mask generator per data
index), only rank 0 writes, keeps the ledger and prunes, and the ranks
meet when the write is done, agreeing on whether it succeeded.
``restore`` reads the same file on every rank, which takes its own slices
and its data index's generator, so a checkpoint moves between widths and
topologies (data parallel to vocab-sharded and back).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import torch

from rnntransducer_tpu_torch.config import Config
from rnntransducer_tpu_torch.parallel.distributed import (host_all_gather,
                                                          host_all_reduce, rank)
from rnntransducer_tpu_torch.parallel.mesh import TP_LEAVES, gather_vocab, vocab_slice
from rnntransducer_tpu_torch.train.optim import Adafactor
from rnntransducer_tpu_torch.train.state import TrainState, rank_seed

_STATE_FILE = "state.pt"


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory, so the
    device buffers may change while the copy is written."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _tp_moments(state: TrainState, sd: dict, fn, whole_layout: bool) -> dict:
    """``sd`` (an optimizer state dict, in the single-device layout where
    ``whole_layout``, else this rank's) with ``fn`` applied to each moment
    of the joint fc's vocabulary-sharded params that holds their rows: one
    shaped like the param, or adafactor's factored statistic that keeps
    the vocabulary dim."""
    shard = state.vocab_shard
    names = [n for n, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    factored = isinstance(state.optimizer, Adafactor)
    sd = dict(sd, state=dict(sd["state"]))
    for i, name in enumerate(names):
        st = sd["state"].get(i)
        if name not in TP_LEAVES or not st:
            continue
        whole = (shard.total,) + tuple(params[name].shape[1:])
        shape = whole if whole_layout else tuple(params[name].shape)

        def rows(k, v):
            return isinstance(v, torch.Tensor) and v.dim() > 0 and (
                tuple(v.shape) == shape or (factored and k in ("v_row", "v_col")
                                            and Adafactor.keeps_rows(k, whole)))
        sd["state"][i] = {k: fn(v) if rows(k, v) else v for k, v in st.items()}
    return sd


def state_payload(state: TrainState) -> dict:
    """Everything a resume needs, on the host, in the single-device layout;
    'generator' lists each data index's mask generator state, in data
    order.  A collective across a process group: every rank calls it."""
    shard = state.vocab_shard
    optimizer = state.optimizer.state_dict()
    if shard is not None:
        optimizer = _tp_moments(state, optimizer, lambda v: gather_vocab(v, shard), False)
    mesh = state.mesh
    gens = host_all_gather((mesh.data_index, mesh.is_data_lead(),
                            state.generator.get_state()))
    return _to_host({
        "params": state.whole(state.model.state_dict()),
        "optimizer": optimizer,
        "step": int(state.step),
        "updates": int(state.updates),
        "ema": None if state.ema is None else state.whole(state.ema),
        "generator": [g for _, lead, g in sorted(gens, key=lambda e: e[0]) if lead],
        "noise_generator": state.noise_generator.get_state(),
        "config": state.cfg.to_dict(),
    })


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 3, monitor: str = "val_cer"):
        self.directory = os.path.abspath(directory)
        self.monitor = monitor
        self.save_top_k = save_top_k
        # (step, metrics, writer thread) of a save still being written; no
        # thread on the ranks that do not write
        self._pending: List[Tuple[int, dict, threading.Thread]] = []
        self._error: Optional[BaseException] = None

    # -- metrics ledger --------------------------------------------------
    def _ledger_path(self) -> str:
        return os.path.join(self.directory, "checkpoint_metrics.json")

    def _read_ledger(self) -> Dict[int, dict]:
        try:
            with open(self._ledger_path()) as f:
                return {int(k): v for k, v in json.load(f).items()}
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_ledger(self, ledger: Dict[int, dict]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        # atomic replace: a reader never sees a truncated ledger
        tmp = f"{self._ledger_path()}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in ledger.items()}, f, indent=1)
        os.replace(tmp, self._ledger_path())

    def _retained(self, ledger: Dict[int, dict], current: int) -> set:
        """Top k by the metric, the latest, and the step just saved (which
        may be lower than an existing one after a restore of the best)."""
        steps = sorted(ledger)
        if not steps:
            return set()
        with_metric = [s for s in steps if self.monitor in ledger[s]]
        best = sorted(with_metric, key=lambda s: ledger[s][self.monitor])[:self.save_top_k]
        return set(best) | {steps[-1], int(current)}

    # -- files ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Steps whose checkpoint is complete on disk."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _STATE_FILE)))

    def _write(self, step: int, payload: dict) -> None:
        final = self._step_dir(step)
        tmp = f"{final}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    # -- public API -------------------------------------------------------
    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None,
             config: Optional[Config] = None, wait: bool = True):
        """Save a checkpoint of ``state`` at ``step``.

        The state is copied to host memory before this returns, so training
        may go on at once; with ``wait=False`` the file is written on a
        thread, and the ledger and pruning wait for the next save, an
        explicit :meth:`wait` or :meth:`close`.  The ledger is written only
        after the file is in place, so it never names a step that is not on
        disk."""
        self.wait()  # at most one save in flight
        payload = state_payload(state)
        if rank() != 0:
            self._pending.append((int(step), metrics or {}, None))
            if wait:
                self.wait()
            return
        os.makedirs(self.directory, exist_ok=True)
        if config is not None:
            cfg_path = os.path.join(self.directory, "config.json")
            if not os.path.exists(cfg_path):
                config.to_json(cfg_path)

        def write():
            try:
                self._write(step, payload)
            except BaseException as e:  # raised again by wait()
                self._error = e

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        self._pending.append((int(step), metrics or {}, thread))
        if wait:
            self.wait()

    def wait(self):
        """Block until a save in flight is on disk, then write its ledger
        entry and prune (rank 0), and meet the other ranks.  No-op when
        nothing is pending."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        err = None
        if rank() == 0:
            try:
                self._finish(pending)
            except BaseException as e:  # raised below, after the ranks meet
                err = e
        # the barrier: every rank learns whether rank 0's write succeeded
        if host_all_reduce([float(err is not None)], "max")[0] and err is None:
            err = RuntimeError(f"rank 0 failed to write the checkpoint of step "
                               f"{pending[-1][0]} in {self.directory}")
        if err is not None:
            raise err

    def _finish(self, pending) -> None:
        for _, _, thread in pending:
            thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        ledger = self._read_ledger()
        for step, metrics, _ in pending:
            ledger[int(step)] = {k: float(v) for k, v in metrics.items()}
        keep = self._retained(ledger, pending[-1][0])
        for s in list(ledger):
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                del ledger[s]
        self._write_ledger(ledger)

    def load(self, step: Optional[int] = None, map_location="cpu") -> dict:
        """The saved payload of ``step`` (default the latest)."""
        self.wait()  # a save in flight may be the step asked for
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self._step_dir(step), _STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.directory}")
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default the latest) into ``state`` in place: params,
        optimizer state (this rank's slices of a sharded one), step and
        update counts, EMA shadow, generators; under a model axis this
        rank's rows of the fc and of its moments.  A data index the
        checkpoint saved no mask generator for (a run resumed on more ranks)
        seeds its own."""
        dev = next(state.model.parameters()).device
        payload = self.load(step, map_location=dev)
        shard = state.vocab_shard
        state.model.load_state_dict(state.own(payload["params"]))
        optimizer = payload["optimizer"]
        if shard is not None:
            optimizer = _tp_moments(state, optimizer, lambda v: vocab_slice(v, shard).clone(),
                                True)
        state.optimizer.load_state_dict(optimizer)
        state.step = int(payload["step"])
        state.updates = int(payload["updates"])
        if payload["ema"] is not None:
            state.ema = {k: v.to(dev).clone() for k, v in state.own(payload["ema"]).items()}
        if "noise_generator" in payload:
            state.noise_generator.set_state(payload["noise_generator"].cpu())
        masks = payload["generator"]
        masks = masks if isinstance(masks, list) else [masks]
        d = state.mesh.data_index
        if d < len(masks):
            state.generator.set_state(masks[d].cpu())
        else:
            state.generator.manual_seed(
                rank_seed(state.noise_generator.initial_seed(), d))
        return state

    def best_step(self) -> Optional[int]:
        self.wait()  # a pending save's metrics may win
        ledger = self._read_ledger()
        with_metric = [s for s in ledger if self.monitor in ledger[s]]
        if not with_metric:
            return None
        return min(with_metric, key=lambda s: ledger[s][self.monitor])

    def best_or_latest_step(self) -> Optional[int]:
        """The best step by the metric, else the latest (a best step 0 is
        kept: never ``best_step() or latest_step()``)."""
        best = self.best_step()
        return best if best is not None else self.latest_step()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps() + [s for s, _, _ in self._pending]
        return max(steps) if steps else None

    def close(self):
        self.wait()


def load_config(checkpoint_dir: str) -> Config:
    return Config.from_json(os.path.join(os.path.abspath(checkpoint_dir), "config.json"))


def average_checkpoint_params(checkpoint_dir: str, steps: Optional[list] = None,
                              k: Optional[int] = None, monitor: str = "val_cer"
                              ) -> Tuple[Dict[str, torch.Tensor], List[int]]:
    """The element-wise mean of several retained checkpoints' params (an
    inference artifact: optimizer state and step are not averaged).
    ``steps``: the steps to average; or ``k``: the best k by ``monitor`` in
    the ledger (the k most recent where no metrics were recorded; 3 where
    neither is given).  Float params are summed in fp32 and cast back to
    their dtype; other tensors keep the first checkpoint's value.  Returns
    (state_dict, the steps used)."""
    if k is not None and k < 1:
        raise ValueError(f"average_k must be >= 1, got {k}")
    mgr = CheckpointManager(checkpoint_dir, monitor=monitor)
    if steps is None:
        n = k if k is not None else 3
        ledger = mgr._read_ledger()
        steps = sorted((s for s in ledger if monitor in ledger[s]),
                       key=lambda s: ledger[s][monitor])[:n]
        if not steps:
            steps = mgr.all_steps()[-n:]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    steps = sorted(set(int(s) for s in steps))
    acc: Optional[Dict[str, torch.Tensor]] = None
    dtypes: Dict[str, torch.dtype] = {}
    for s in steps:
        params = mgr.load(s)["params"]
        if acc is None:
            dtypes = {n: v.dtype for n, v in params.items()}
            acc = {n: v.float() if v.is_floating_point() else v.clone()
                   for n, v in params.items()}
        else:
            for n, v in params.items():
                if v.is_floating_point():
                    acc[n] += v.float()
    inv = 1.0 / len(steps)
    return ({n: (v * inv).to(dtypes[n]) if dtypes[n].is_floating_point else v
             for n, v in acc.items()}, steps)


def load_decode_params(checkpoint_dir: str, cfg: Optional[Config] = None, *,
                       step: Optional[int] = None, average_k: Optional[int] = None,
                       use_ema: bool = False) -> Tuple[Dict[str, torch.Tensor], str]:
    """The params a decode entry point runs with: an explicit ``step``, the
    mean of the best ``average_k`` checkpoints, or the best-by-val_cer
    (else latest) checkpoint; ``use_ema`` takes that checkpoint's EMA
    shadow.  Returns (state_dict on the host, a description of what was
    picked)."""
    if cfg is None:
        cfg = load_config(checkpoint_dir)
    if average_k is not None:
        if step is not None:
            raise ValueError("pass either step or average_k, not both")
        if use_ema:
            raise ValueError("pass either use_ema or average_k, not both")
        params, used = average_checkpoint_params(checkpoint_dir, k=average_k)
        return params, f"average of steps {used}"
    mgr = CheckpointManager(checkpoint_dir, save_top_k=cfg.train.save_top_k)
    if step is None:
        step = mgr.best_or_latest_step()
    payload = mgr.load(step)
    if use_ema:
        if payload["ema"] is None:
            raise ValueError("use_ema: this checkpoint holds no EMA shadow (the run "
                             "trained with train.ema_decay == 0)")
        return dict(payload["ema"]), f"step {step} (EMA shadow)"
    return payload["params"], f"step {step}"
