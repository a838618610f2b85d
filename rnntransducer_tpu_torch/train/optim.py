"""Optimizer and LR schedules (port of ``rnntransducer_tpu/train/optim.py``).

The schedules are plain functions of the optimizer's update count that
reproduce optax's formulas (``cosine_onecycle_schedule``,
``warmup_cosine_decay_schedule``, ``join_schedules`` of
``linear_schedule``s), including the ``(warmup + 0.5) / steps`` pct_start
that pins OneCycle's warmup to a whole number of steps.  optax evaluates a
schedule at the count BEFORE the update, so ``TrainState`` sets the lr to
``schedule(count)`` before ``optimizer.step()``.

``torch.optim.AdamW`` computes what ``optax.adamw`` does: the same moments
and bias corrections, eps 1e-8 added outside the square root, and decoupled
decay of every param by lr * weight_decay (torch decays before the Adam
step, optax adds wd * p to the update: the same p - lr (u + wd p)).
``torch.optim.SGD(momentum=0.9)`` is ``optax.sgd(momentum=0.9)``: both start
the trace at the first gradient.  ``Adafactor`` and ``Lion`` are written
here with optax's semantics as the JAX package configures them
(``optax.adafactor(min_dim_size_to_factor=128,
multiply_by_parameter_scale=False, weight_decay_rate=wd or None)``,
``optax.lion(b1=0.9, b2=0.99, weight_decay=wd)``); ``torch.optim.Adafactor``
has other defaults and another weight decay.

``ShardedOptimizer`` is ZeRO-1 across the ranks of the mesh's data axis
(``train.shard_optimizer_state``): each rank keeps its slice of every
moment that ``parallel.mesh.zero_split_dims`` splits, updates that slice of
the param with the same optimizer, and the data group all-gathers the
params.  Every update above but adafactor's is elementwise, so the sliced
step computes the replicated step's values bit for bit, and a model rank's
update of its vocabulary rows is those rows of the single device's.
adafactor is never ZeRO-split; on a model rank it sums its statistics of
the fc's rows and its update's RMS over the model group.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def _warmup_steps(cfg) -> tuple:
    steps = max(cfg.max_steps, 2)
    return steps, min(max(int(steps * cfg.warmup_ratio), 1), steps - 1)


def _linear(init: float, end: float, transition: int) -> Schedule:
    """optax.linear_schedule."""
    if transition <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), transition) / transition
        return (init - end) * frac + end
    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each later schedule sees the steps since its
    boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def onecycle_schedule(cfg) -> Schedule:
    """optax.cosine_onecycle_schedule with the warmup pinned to a whole
    number of steps >= 1 (``optim.py:17-32`` of the JAX package)."""
    steps, warmup = _warmup_steps(cfg)
    init = cfg.learning_rate / cfg.div_factor
    bounds = [0, int((warmup + 0.5) / steps * steps), int(steps)]
    values = [init, init * cfg.div_factor,
              init * cfg.div_factor / (cfg.div_factor * cfg.final_div_factor)]

    def schedule(count):
        if count >= bounds[-1]:
            return values[-1]
        i = 0 if count < bounds[1] else 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        start, end = values[i], values[i + 1]
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    return schedule


def make_schedule(cfg) -> Schedule:
    """LR schedule per ``cfg.lr_schedule``: onecycle | cosine | linear |
    constant, all warming up for ``warmup_ratio`` of the run."""
    kind = cfg.lr_schedule.lower()
    if kind == "onecycle":
        return onecycle_schedule(cfg)
    steps, warmup = _warmup_steps(cfg)
    lr = cfg.learning_rate
    ramp = _linear(lr / cfg.div_factor, lr, warmup)
    if kind == "cosine":
        decay = steps - warmup

        def cosine(count):
            count = min(count, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return _join([ramp, cosine], [warmup])
    if kind == "linear":
        return _join([ramp, _linear(lr, 0.0, steps - warmup)], [warmup])
    if kind == "constant":
        return _join([ramp, lambda count: lr], [warmup])
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                     "(onecycle | cosine | linear | constant)")


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` at ``min_dim_size_to_factor=128``: the
    (second largest, largest) axis of a tensor of two or more dims whose
    second largest dim is at least 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` as the JAX package builds it, per param and step:

    1. ``scale_by_factored_rms`` (decay 1 - t^-0.8 at update t = 1, 2, ...,
       eps 1e-30 added to g^2): a tensor whose two largest dims are both >=
       128 keeps row and column means of g^2 and scales g by
       (v_row / mean(v_row))^-1/2 (v_col)^-1/2; any other keeps the full
       second moment v and scales g by v^-1/2;
    2. ``clip_by_block_rms(1.0)``: the update over max(1, rms(update));
    3. times the learning rate;
    4. plus ``weight_decay`` * p, after the lr scaling (the decay is not
       multiplied by the lr);
    5. subtracted from p.

    Row and column factoring is symmetric, so a param stored transposed
    (torch's (out, in) against flax's (in, out)) gets the same update.

    ``row_split`` maps a param that holds this rank's rows (dim 0) of a
    leaf split over a process group (the joint fc over the model axis) to
    (the leaf's rows, a function that sums a tensor over that group in
    place).  Such a param is factored by the whole leaf's shape, and every
    mean over its rows and the update's RMS sum over the group, so each
    rank's update is its rows of the whole leaf's, as GSPMD computes it."""

    DECAY_RATE, EPS, CLIPPING_THRESHOLD = 0.8, 1e-30, 1.0

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 row_split: Optional[Mapping[torch.Tensor, Tuple[int, Callable]]] = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.row_split = dict(row_split or {})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, group)

    def _update(self, p, g, group):
        state = self.state[p]
        rows, group_sum = self.row_split.get(p, (p.shape[0] if p.dim() else 0, None))
        whole = (rows,) + tuple(p.shape[1:]) if p.dim() else ()
        dims = factored_dims(whole)

        def mean(x, dim, split):
            # the mean over ``dim`` of ``x``; over the group where ``dim`` is
            # the split rows (``split``: whether x still holds them at dim 0)
            if group_sum is None or not split or dim != 0:
                return x.mean(dim=dim)
            return group_sum(x.sum(dim=0)) / rows

        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(p.sum(dim=d0))
                state["v_col"] = torch.zeros_like(p.sum(dim=d1))
        t = np.float32(state["step"] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.DECAY_RATE))
        keep = float(np.float32(1.0) - np.float32(decay))
        grad_sqr = g * g + self.EPS
        if dims is None:
            v = state["v"].mul_(decay).add_(grad_sqr * keep)
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_(mean(grad_sqr, d0, True) * keep)
            v_col = state["v_col"].mul_(decay).add_(mean(grad_sqr, d1, True) * keep)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / mean(v_row, reduced_d1, d0 != 0).unsqueeze(
                reduced_d1)).pow(-0.5)
            u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        if group_sum is None:
            rms = torch.sqrt(torch.mean(u * u))
        else:
            rms = torch.sqrt(group_sum(torch.sum(u * u).reshape(1))[0] / math.prod(whole))
        u = u / torch.clamp(rms / self.CLIPPING_THRESHOLD, min=1.0)
        u = group["lr"] * u
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.sub_(u)
        state["step"] += 1

    @staticmethod
    def keeps_rows(key: str, shape: Sequence[int]) -> bool:
        """Whether the state entry ``key`` of a param of the whole ``shape``
        keeps its dim 0 (so a row split of the param splits it too)."""
        dims = factored_dims(shape)
        if key == "v_row":
            return dims is not None and dims[1] != 0
        if key == "v_col":
            return dims is not None and dims[0] != 0
        return key == "v"


class Lion(torch.optim.Optimizer):
    """``optax.lion``: update = sign((1 - b1) g + b1 m), then m = b2 m +
    (1 - b2) g; the decayed weights are added before the lr scaling:
    p -= lr (update + weight_decay p)."""

    B1, B2 = 0.9, 0.99

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.B1, self.B2
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m = state["exp_avg"]
                u = torch.sign((1.0 - b1) * g + b1 * m)
                m.copy_((1.0 - b2) * g + b2 * m)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(group["lr"] * u)


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   row_split=None) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optimizer`` over ``params``; its lr is set from
    the schedule before every step (see module docstring).  ``row_split``:
    adafactor's (:class:`Adafactor`); the elementwise updates need none."""
    kind = getattr(cfg, "optimizer", "adamw").lower()
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9)
    if kind == "adafactor":
        # factored second moment: optimizer memory ~ row + column sums;
        # tensors with a dim below 128 stay unfactored
        return Adafactor(params, weight_decay=cfg.weight_decay or 0.0, row_split=row_split)
    if kind == "lion":
        return Lion(params, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                     "(adamw | adafactor | lion | sgd)")


class ShardedOptimizer:
    """ZeRO-1 over the data axis of ``mesh``: ``make(tensors)`` builds the
    optimizer over this rank's slice of each param whose entry of ``dims``
    names a dim (data index r holds the r-th of the width's equal slices
    along it) and over the whole of every other param.  ``step`` reads the
    grads from the params' ``.grad`` (the full, all-reduced grads), updates
    the slices and all-gathers the params.  ``state_dict`` gathers the
    moments into the single-device layout (a collective: every rank calls it
    in lockstep) and ``load_state_dict`` takes this rank's slices of one, so
    a checkpoint moves between widths."""

    def __init__(self, make: Callable[[list], torch.optim.Optimizer],
                 params: Sequence[torch.nn.Parameter], dims: Sequence[Optional[int]],
                 mesh):
        r, w = mesh.data_index, mesh.data_width
        self.mesh = mesh
        self.params = list(params)
        self.dims = list(dims)
        self._slices = [None if d is None else (d, r * (p.shape[d] // w), p.shape[d] // w)
                        for p, d in zip(self.params, self.dims)]
        self.shards = [p if sl is None else p.detach().narrow(*sl).clone()
                       for p, sl in zip(self.params, self._slices)]
        self.inner = make(self.shards)
        self._split = [i for i, sl in enumerate(self._slices) if sl is not None]

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        """This rank's state, keyed by the tensors it updates."""
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        from rnntransducer_tpu_torch.parallel.mesh import all_gather_shards

        for i in self._split:
            p, s, sl = self.params[i], self.shards[i], self._slices[i]
            s.copy_(p.narrow(*sl))  # the param may have been loaded or broadcast
            s.grad = None if p.grad is None else p.grad.narrow(*sl).contiguous()
        self.inner.step()
        all_gather_shards([self.params[i] for i in self._split],
                          [self.shards[i] for i in self._split],
                          [self.dims[i] for i in self._split], self.mesh)

    @staticmethod
    def _sliced_keys(st: dict, shape) -> List[str]:
        """The entries of a param's state shaped like ``shape`` (its moments;
        not the scalar step count)."""
        return sorted(k for k, v in st.items()
                      if isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(shape)
                      and v.dim() > 0)

    def state_dict(self) -> dict:
        from rnntransducer_tpu_torch.parallel.mesh import all_gather_shards

        sd = self.inner.state_dict()
        fulls, shards, dims = [], [], []
        for i in self._split:
            if not sd["state"].get(i):
                continue
            # a copy: the packed state holds the live per-param dicts
            st = sd["state"][i] = dict(sd["state"][i])
            for k in self._sliced_keys(st, self.shards[i].shape):
                full = torch.empty_like(self.params[i], dtype=st[k].dtype)
                fulls.append(full)
                shards.append(st[k])
                dims.append(self.dims[i])
                st[k] = full
        all_gather_shards(fulls, shards, dims, self.mesh)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        state = {}
        for i, st in sd["state"].items():
            st = dict(st)
            i = int(i)
            if self._slices[i] is not None:
                for k in self._sliced_keys(st, self.params[i].shape):
                    st[k] = st[k].narrow(*self._slices[i]).clone()
            state[i] = st
        self.inner.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def make_train_optimizer(cfg, model_cfg, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                         mesh=None):
    """The optimizer of ``cfg`` (a TrainConfig) over ``named_params``:
    ZeRO-1 sharded over the data axis of ``mesh`` when
    ``cfg.shard_optimizer_state`` and that axis has more than one rank and
    some moment splits (adafactor's never do, nor the joint fc's under a
    model axis); otherwise replicated, as on a one-device JAX mesh.  Under
    a model axis adafactor sums its statistics of the fc's rows and its
    update's RMS over the model group (``Adafactor``'s ``row_split``)."""
    from rnntransducer_tpu_torch.parallel.mesh import MODEL_AXIS, TP_LEAVES, zero_split_dims

    names = [n for n, _ in named_params]
    params = [p for _, p in named_params]
    kind = getattr(cfg, "optimizer", "adamw")
    tp = mesh is not None and mesh.size(MODEL_AXIS) > 1
    if tp and kind.lower() == "adafactor":
        rows = model_cfg.jointnet.num_classes
        return make_optimizer(cfg, params, row_split={
            p: (rows, lambda t: mesh.all_reduce(t, MODEL_AXIS))
            for n, p in named_params if n in TP_LEAVES})
    if cfg.shard_optimizer_state and mesh is not None and mesh.data_width > 1:
        plan = zero_split_dims(model_cfg, dict(named_params), mesh.data_width, kind,
                               vocab_sharded=tp)
        dims = [plan[n] for n in names]
        if any(d is not None for d in dims):
            return ShardedOptimizer(lambda ts: make_optimizer(cfg, ts), params, dims,
                                    mesh)
    return make_optimizer(cfg, params)


def replicated_state_tensors(optimizer) -> List[torch.Tensor]:
    """The optimizer state tensors every rank holds whole, in param order:
    all of a replicated optimizer's, and a sharded one's of unsplit params."""
    if isinstance(optimizer, ShardedOptimizer):
        keys = [s for s, sl in zip(optimizer.shards, optimizer._slices) if sl is None]
    else:
        keys = [p for group in optimizer.param_groups for p in group["params"]]
    out = []
    for p in keys:
        st = optimizer.state.get(p, {})
        out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    return out


def global_norm(tensors: Sequence[torch.Tensor], sharded: Sequence[int] = (),
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    The tensors at the indices ``sharded`` are this rank's rows of a leaf
    split over the model axis of ``mesh``: their squares are summed over
    the model group, every other tensor's counted once."""
    from rnntransducer_tpu_torch.parallel.mesh import MODEL_AXIS

    if not sharded or mesh is None or mesh.size(MODEL_AXIS) <= 1:
        return torch.sqrt(sum(torch.sum(t * t) for t in tensors))
    split = set(sharded)
    own = sum(torch.sum(t * t) for i, t in enumerate(tensors) if i in split)
    rest = sum(torch.sum(t * t) for i, t in enumerate(tensors) if i not in split)
    return torch.sqrt(rest + mesh.all_reduce(own.reshape(1), MODEL_AXIS)[0])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    ``max_norm``, else each tensor times max_norm / norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]
