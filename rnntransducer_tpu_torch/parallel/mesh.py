"""The mesh (port of ``rnntransducer_tpu/parallel/mesh.py``).

The JAX package lays its devices out on a grid ``data × [time | stage] ×
[model]`` (model innermost) and lets GSPMD place every leaf.  Here each
rank is a process with one device, so every axis but ``data`` spans
processes (the JAX package keeps those axes inside one process; the port
has no other layout).  :func:`make_mesh` puts rank ``(d·S + s)·k + m`` at
grid point (d, s, m), as the JAX grid order does, and opens one process
group per row of every axis, created by every rank in the same order.

* ``data``: every rank of a data row walks the same global batch sequence
  and takes the rows ``idxs[d::D]`` of each batch (:func:`local_rows`, by the
  data index: the ranks of one model / stage / time row get the same rows);
  :func:`all_reduce_mean` sums the float32 grads over the data group in
  buckets of bounded size and divides by its width, once per step;
  :func:`broadcast_state` copies the data row's first params, EMA and
  replicated optimizer state to the rest once after a state is created or
  restored.
* ZeRO-1 (``train.shard_optimizer_state``): :func:`zero_split_dims` is the
  placement rule of the JAX package's ``_is_adam_moment`` / ``_zero_spec`` /
  ``_leaf_spec``, over the data group only; :func:`all_gather_shards` puts
  the updated slices back together.  The joint fc's moments keep their
  pure vocabulary placement (``_TP_RULES``), as in the JAX package.
* ``model``: the joint fc's V rows (torch's (V, De+Dd) weight and its bias)
  split over the model group by ``torch.tensor_split``'s rule (GSPMD pads,
  so any V works); :func:`copy_to`, :func:`reduce_from` and
  :func:`gather_rows` are the autograd regions the vocab-sharded joint and
  loss need.
* ``stage`` / ``time``: the groups the schedules of ``pipeline.py`` and
  ``wavefront.py`` send their activations and carries over
  (:func:`send` / :func:`recv`).

gloo carries no CUDA tensor in ``send`` / ``recv``: on a gloo group those
two stage a CUDA tensor through a host copy (two gloo ranks sharing one
card, as ``chip_smoke.py`` runs them; NCCL refuses two ranks on one
device).  NCCL sends device tensors.  gloo's collectives take CUDA tensors
themselves.
"""

from __future__ import annotations

from typing import (Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from rnntransducer_tpu_torch.parallel.distributed import (host_group, is_initialized,
                                                          rank, world_size)

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
TIME_AXIS = "time"

# largest bucket of one collective: bounds the flat copy a full-width model's
# 0.6 GB of float32 grads would otherwise need
BUCKET_BYTES = 64 << 20

# the optimizer moments ZeRO-1 splits: AdamW's mu / nu, lion's mu and SGD's
# trace in the JAX package's optax state; adafactor's statistics stay whole
_SPLIT_OPTIMIZERS = ("adamw", "lion", "sgd")

# the leaves the model axis splits (``_TP_RULES``): the joint fc's V rows
TP_LEAVES = ("joint.fc.weight", "joint.fc.bias")


def vocab_sizes(total: int, k: int) -> List[int]:
    """The rows of a V = ``total`` classifier each of ``k`` model ranks holds,
    by ``torch.tensor_split``'s rule: the first ``total % k`` take one more."""
    return [total // k + (1 if i < total % k else 0) for i in range(k)]


class VocabShard(NamedTuple):
    """This rank's columns of a V-wide classifier: [start, start + size) of
    ``total``, over ``mesh``'s model group."""

    mesh: "Mesh"
    start: int
    size: int
    total: int


class Mesh:
    """This rank's place on the grid ``data × [time | stage] × [model]``:
    the axes' names and widths, this rank's index on each, and the process
    groups of its rows.  Built by :func:`make_mesh`."""

    def __init__(self, shape: Mapping[str, int], coords: Mapping[str, int],
                 rows: Mapping[str, List[int]], groups: Mapping[str, object],
                 hosts: Mapping[str, object]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self._coords = dict(coords)
        self._rows = {k: list(v) for k, v in rows.items()}
        self._groups = dict(groups)
        self._hosts = dict(hosts)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, at {self._coords})"

    def size(self, axis: str) -> int:
        """The width of ``axis`` (1 where the mesh lacks it)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 where the mesh lacks it)."""
        return self._coords.get(axis, 0)

    @property
    def data_index(self) -> int:
        return self.index(DATA_AXIS)

    @property
    def data_width(self) -> int:
        return self.size(DATA_AXIS)

    def is_data_lead(self) -> bool:
        """Whether this rank is the first of its data row's other axes (the
        one that speaks for its data index)."""
        return all(self.index(a) == 0 for a in self.axis_names if a != DATA_AXIS)

    def ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's row along ``axis``, by index."""
        return self._rows.get(axis, [rank()])

    def group(self, axis: str, tensor: Optional[torch.Tensor] = None):
        """The process group of this rank's row along ``axis`` (None = the
        world's default group); the gloo host group for a CPU ``tensor``
        when the device group is not gloo."""
        if tensor is not None and tensor.device.type == "cpu":
            return self._hosts.get(axis)
        return self._groups.get(axis)

    def vocab_shard(self, total: int) -> Optional[VocabShard]:
        """This rank's rows of a V = ``total`` classifier by
        ``torch.tensor_split``'s rule (the first ``total % k`` ranks take one
        more); None without a model axis."""
        if self.size(MODEL_AXIS) <= 1:
            return None
        sizes = vocab_sizes(total, self.size(MODEL_AXIS))
        m = self.index(MODEL_AXIS)
        return VocabShard(self, sum(sizes[:m]), sizes[m], total)

    # -- collectives along one axis (no-ops on an axis of width 1) ---------
    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``t`` reduced in place over ``axis`` (SUM or MAX)."""
        if self.size(axis) > 1:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                            group=self.group(axis, t))
        return t

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """``t`` in place set to the value of the rank at index ``src`` of
        ``axis``."""
        if self.size(axis) > 1:
            dist.broadcast(t, self.ranks(axis)[src], group=self.group(axis, t))
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The row's tensors laid side by side along ``dim``, in index order;
        index i's is ``sizes[i]`` long along ``dim`` (all as long as ``t``
        where None)."""
        n = self.size(axis)
        if n <= 1:
            return t
        sizes = [int(t.shape[dim])] * n if sizes is None else list(sizes)
        width = max(sizes)
        pad = list(t.shape)
        pad[dim] = width - t.shape[dim]
        padded = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t.contiguous()
        parts = [torch.empty_like(padded) for _ in range(n)]
        dist.all_gather(parts, padded, group=self.group(axis, t))
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)

    def _staged(self, axis: str, t: torch.Tensor) -> bool:
        # gloo's send / recv read host memory only: stage a CUDA tensor
        # through a host copy there; NCCL sends device tensors
        return t.is_cuda and dist.get_backend(self.group(axis)) == "gloo"

    def send(self, t: torch.Tensor, axis: str, dst: int) -> None:
        """``t`` to the rank at index ``dst`` of ``axis``."""
        peer = self.ranks(axis)[dst]
        group = self.group(axis)
        dist.send(t.detach().cpu() if self._staged(axis, t) else t.detach().contiguous(),
                  peer, group=group)

    def recv(self, shape, dtype, device, axis: str, src: int) -> torch.Tensor:
        """A tensor of ``shape`` / ``dtype`` from the rank at index ``src`` of
        ``axis``, on ``device``."""
        peer = self.ranks(axis)[src]
        out = torch.empty(shape, dtype=dtype, device=device)
        if self._staged(axis, out):
            host = torch.empty(shape, dtype=dtype)
            dist.recv(host, peer, group=self.group(axis))
            return out.copy_(host)
        dist.recv(out, peer, group=self.group(axis))
        return out


def mesh_shape(model_parallel: int = 1, pipeline_stages: int = 1,
               sequence_parallel: int = 1, world: Optional[int] = None) -> Dict[str, int]:
    """The axes' widths over ``world`` ranks (default: the process group's),
    in the JAX package's order: ``data``, then ``time`` or ``stage``, then
    ``model`` (innermost), each extra axis only where asked for.  Raises
    the JAX package's errors: the two schedules together, or a world size
    the extra axes do not divide (a single process asking for any)."""
    world = world_size() if world is None else world
    if pipeline_stages > 1 and sequence_parallel > 1:
        raise ValueError(
            "pipeline_stages and sequence_parallel are mutually exclusive "
            "(layer pipelining targets bidirectional stacks, the time "
            "wavefront unidirectional ones — one encoder uses one schedule)")
    extra = []
    if sequence_parallel > 1:
        extra.append((TIME_AXIS, sequence_parallel))
    if pipeline_stages > 1:
        extra.append((STAGE_AXIS, pipeline_stages))
    if model_parallel > 1:
        extra.append((MODEL_AXIS, model_parallel))
    denom = int(np.prod([s for _, s in extra])) if extra else 1
    if world % denom:
        raise ValueError(f"{world} devices not divisible by "
                         f"{' x '.join(f'{n}={s}' for n, s in extra)}")
    return {DATA_AXIS: world // denom, **dict(extra)}


def make_mesh(model_parallel: int = 1, pipeline_stages: int = 1,
              sequence_parallel: int = 1) -> Mesh:
    """The mesh of this process group (one data axis over every rank by
    default; :func:`mesh_shape` gives the axes and raises the JAX package's
    errors).  ``sequence_parallel=k``: a ``time`` axis for the wavefront
    encoder; ``pipeline_stages=k``: a ``stage`` axis for the GPipe encoder
    pipeline; ``model_parallel=k``: a ``model`` axis for the vocab-sharded
    joint.  Every rank must call it, in the same order as the others: it
    opens the rows' process groups."""
    shape = mesh_shape(model_parallel, pipeline_stages, sequence_parallel)
    world, r = world_size(), rank()
    if len(shape) == 1:
        # the data axis is the world: the default groups
        return Mesh(shape, {DATA_AXIS: r}, {DATA_AXIS: list(range(world))},
                    {DATA_AXIS: None}, {DATA_AXIS: host_group()})
    grid = np.arange(world).reshape(tuple(shape.values()))
    coords = dict(zip(shape, (int(i) for i in np.unravel_index(r, grid.shape))))
    rows, groups, hosts = {}, {}, {}
    gloo = dist.get_backend() == "gloo"
    for pos, axis in enumerate(shape):
        if shape[axis] <= 1:
            continue
        for row in np.moveaxis(grid, pos, -1).reshape(-1, shape[axis]).tolist():
            # every rank creates every group, in the same order
            g = dist.new_group(row)
            h = g if gloo else dist.new_group(row, backend="gloo")
            if r in row:
                rows[axis], groups[axis], hosts[axis] = row, g, h
    return Mesh(shape, coords, rows, groups, hosts)


def mesh_of(train_cfg) -> Mesh:
    """The mesh ``cfg.train`` asks for (:func:`make_mesh`)."""
    return make_mesh(model_parallel=train_cfg.model_parallel,
                     pipeline_stages=train_cfg.pipeline_stages,
                     sequence_parallel=train_cfg.sequence_parallel)


def lane_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a lane-sharded ``BatchedStreamingRunner``, one lane
    group each: the serving counterpart of the JAX package's 1-D
    ``make_mesh()`` over the local devices.  One process drives them all;
    it has nothing to do with the process-group :class:`Mesh` of training.

    By default every visible CUDA device; without CUDA it raises unless
    ``devices`` names them.  A list may repeat a device (two lane groups on
    one card, or CPU entries)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("lane_devices() takes every visible CUDA device and "
                               "there is none: pass the devices")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("lane_devices: no device given")
    return out


# ---------------------------------------------------------------------------
# autograd regions of the model axis (Megatron's f / g operators)
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; the cotangent summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the axis forward; the identity backward (the transpose of
    the JAX ``psum`` under a loss every rank of the axis computes alike)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """The row's vocabulary slices gathered along dim 0 forward; this rank's
    slice of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.start, ctx.size = shard.start, shard.size
        return gather_vocab(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.start, ctx.size), None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Enter a region whose ranks each compute a part of one function of
    ``x``: the identity forward, the sum of their cotangents backward."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Leave such a region: the ranks' partial values summed forward, the
    cotangent passed through unchanged backward (not summed again)."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_vocab(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The whole V-wide tensor from each model rank's rows ``x`` (dim 0), no
    autograd: a collective of the model group."""
    return shard.mesh.all_gather(x, MODEL_AXIS, 0,
                                 vocab_sizes(shard.total, shard.mesh.size(MODEL_AXIS)))


def gather_rows(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The whole V-wide tensor from this rank's rows ``x`` (autograd: each
    rank keeps its rows of the cotangent)."""
    return _GatherRows.apply(x, shard)


def vocab_slice(t: torch.Tensor, shard: Optional[VocabShard]) -> torch.Tensor:
    """This rank's rows of a whole V-wide tensor (itself without a shard)."""
    return t if shard is None else t.narrow(0, shard.start, shard.size)


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------


def local_rows(idxs, index: Optional[int] = None, width: Optional[int] = None):
    """The rows of a global batch's indices that data index ``index`` of
    ``width`` takes: ``idxs[index::width]`` (default: this rank of the
    world).  Every index gets ``len(idxs) // width`` of them; a batch that
    does not split evenly raises, since the mean of the shares' means is the
    global mean only over equal shares."""
    index = rank() if index is None else index
    width = world_size() if width is None else width
    if len(idxs) % width:
        raise ValueError(f"a global batch of {len(idxs)} rows does not split over "
                         f"{width} ranks")
    return idxs[index::width]


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """Consecutive indices of ``tensors`` grouped into buckets of at most
    BUCKET_BYTES (a larger tensor is a bucket of its own)."""
    bucket, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if bucket and size + nbytes > BUCKET_BYTES:
            yield bucket
            bucket, size = [], 0
        bucket.append(i)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """``tensors`` (one dtype, one device) replaced in place by their SUM
    over ``group`` (None = the world), in buckets of at most BUCKET_BYTES."""
    for idx in _buckets(tensors):
        if len(idx) == 1 and tensors[idx[0]].is_contiguous():
            dist.all_reduce(tensors[idx[0]], group=group)
            continue
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
            offset += n
    return tensors


def all_reduce_mean(tensors: List[torch.Tensor], mesh: Optional[Mesh] = None
                    ) -> List[torch.Tensor]:
    """``tensors`` (float32, on this rank's device) replaced in place by their
    mean over the data group of ``mesh`` (the world without one): a SUM in
    buckets, then a division by the width.  A no-op without a process group
    or on a data axis of width 1."""
    if not is_initialized():
        return tensors
    width = world_size() if mesh is None else mesh.data_width
    if width <= 1:
        return tensors
    group = None if mesh is None else mesh.group(DATA_AXIS)
    # a division, not a multiply by 1 / w: the same bits only where w is a
    # power of two
    all_reduce_sum(tensors, group)
    for t in tensors:
        t.div_(width)
    return tensors


def all_gather_shards(params: Sequence[torch.Tensor], shards: Sequence[torch.Tensor],
                      dims: Sequence[int], mesh: Optional[Mesh] = None) -> None:
    """Each ``params[i]`` set, in place, to the data row's ``shards[i]`` laid
    side by side along ``dims[i]`` (data index r's slice at r * shard size),
    one all-gather per bucket (over the world without a mesh)."""
    width = world_size() if mesh is None else mesh.data_width
    group = None if mesh is None else mesh.group(DATA_AXIS)
    for idx in _buckets(shards):
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(width)]
        dist.all_gather(parts, flat, group=group)
        for r, part in enumerate(parts):
            offset = 0
            for i in idx:
                s = shards[i]
                c = s.shape[dims[i]]
                params[i].narrow(dims[i], r * c, c).copy_(
                    part[offset:offset + s.numel()].view(s.shape))
                offset += s.numel()


def broadcast_state(state) -> None:
    """The data row's first params, EMA shadow and replicated optimizer state
    to the rest of the row, so the replicas start equal whatever each
    process loaded (the model ranks' vocabulary slices stay their own)."""
    from rnntransducer_tpu_torch.train.optim import replicated_state_tensors

    if not is_initialized() or state.mesh.data_width <= 1:
        return
    with torch.no_grad():
        tensors = [p.data for p in state.model.parameters()]
        if state.ema is not None:
            tensors += [state.ema[k] for k in sorted(state.ema)]
        for t in tensors + replicated_state_tensors(state.optimizer):
            state.mesh.broadcast(t, DATA_AXIS, 0)


def _flax_dim_order(model_cfg) -> Dict[str, bool]:
    from rnntransducer_tpu_torch.utils.weights import flax_layout

    return {key: transpose for _, key, _, transpose in flax_layout(model_cfg)}


def _zero_dim(shape: Tuple[int, ...], world: int, transposed: bool = False
             ) -> Optional[int]:
    """The dim a moment of ``shape`` is split along over ``world`` ranks: the
    largest dim that ``world`` divides, the first of equal ones in the JAX
    package's (flax) order of dims, which is the reverse of torch's for a
    tensor stored ``transposed``; None when no dim divides or world is 1."""
    if world <= 1 or not shape:
        return None
    order = range(len(shape) - 1, -1, -1) if transposed else range(len(shape))
    best = None
    for i in order:
        d = shape[i]
        if d > 0 and d % world == 0 and (best is None or d > shape[best]):
            best = i
    return best


def zero_split_dims(model_cfg, params: Mapping[str, torch.Tensor], world: int,
                    optimizer: str, vocab_sharded: bool = False
                    ) -> Dict[str, Optional[int]]:
    """ZeRO-1 placement of each param's moments over a data axis of
    ``world`` ranks (name -> dim or None): the moments of AdamW, lion and
    SGD are split along the largest dim that ``world`` divides
    (:func:`_zero_dim`); adafactor's row and column statistics and its
    update clipping read whole tensors, so they stay whole on every rank; so
    do the joint fc's when ``vocab_sharded`` (the JAX package's TP leaves
    keep their pure vocabulary placement).  A flax leaf stacking several
    layers is one port tensor per layer, each placed on its own."""
    if optimizer.lower() not in _SPLIT_OPTIMIZERS:
        return dict.fromkeys(params)
    transposed = _flax_dim_order(model_cfg)
    return {name: (_zero_dim(tuple(p.shape), world, transposed.get(name, False))
                   if p.is_floating_point()
                   and not (vocab_sharded and name in TP_LEAVES) else None)
            for name, p in params.items()}


def moment_bytes(optimizer) -> int:
    """Bytes of the optimizer state this rank holds."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))


__all__ = ["BUCKET_BYTES", "DATA_AXIS", "MODEL_AXIS", "Mesh", "STAGE_AXIS", "TIME_AXIS",
           "TP_LEAVES", "VocabShard", "vocab_sizes", "all_gather_shards", "all_reduce_mean",
           "all_reduce_sum", "broadcast_state", "copy_to", "gather_rows", "gather_vocab", "lane_devices",
           "local_rows", "make_mesh", "mesh_of", "mesh_shape", "moment_bytes", "reduce_from", "vocab_slice",
           "zero_split_dims"]
