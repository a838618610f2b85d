"""The data axis (port of the data-parallel half of
``rnntransducer_tpu/parallel/mesh.py``).

The JAX package splits each global batch over a ``data`` mesh axis; the
params stay replicated and XLA inserts the gradient psum.  Here each rank
is a process with one device:

* every rank walks the same global batch sequence and takes the rows
  ``idxs[rank::world]`` of each batch (:func:`local_rows`), as the JAX
  loop's processes do;
* :func:`all_reduce_mean` sums the float32 grads over the ranks in buckets
  of bounded size and divides by the width, once per step: the JAX psum of
  the mean-reduced loss (every rank holds the same number of rows);
* :func:`broadcast_state` copies rank 0's params, EMA and replicated
  optimizer state to every rank once after a state is created or restored;
* ZeRO-1 (``train.shard_optimizer_state``): :func:`zero_split_dims` is the
  placement rule of the JAX package's ``_is_adam_moment`` / ``_zero_spec``
  / ``_leaf_spec``; :func:`all_gather_shards` puts the updated slices back
  together.

The model axis, ``pipeline.py`` and ``wavefront.py`` are not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from rnntransducer_tpu_torch.parallel.distributed import (host_group, is_initialized,
                                                          rank, world_size)

DATA_AXIS = "data"

# largest bucket of one collective: bounds the flat copy a full-width model's
# 0.6 GB of float32 grads would otherwise need
BUCKET_BYTES = 64 << 20

# the optimizer moments ZeRO-1 splits: AdamW's mu / nu, lion's mu and SGD's
# trace in the JAX package's optax state; adafactor's statistics stay whole
_SPLIT_OPTIMIZERS = ("adamw", "lion", "sgd")


def local_rows(idxs, rank_: Optional[int] = None, world: Optional[int] = None):
    """This rank's rows of a global batch's indices: ``idxs[rank::world]``.
    Every rank gets ``len(idxs) // world`` of them; a batch that does not
    split evenly raises, since the mean of the ranks' means is the global
    mean only over equal shares."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    if len(idxs) % world:
        raise ValueError(f"a global batch of {len(idxs)} rows does not split over "
                         f"{world} ranks")
    return idxs[rank_::world]


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


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` (float32, on this rank's device) replaced in place by their
    mean over the ranks: a SUM in buckets of at most BUCKET_BYTES, then a
    division by the width.  A no-op without a process group."""
    if not is_initialized():
        return tensors
    world = world_size()
    for idx in _buckets(tensors):
        if len(idx) == 1 and tensors[idx[0]].is_contiguous():
            flat = tensors[idx[0]]
            dist.all_reduce(flat)
            flat.div_(world)
            continue
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
            offset += n
    return tensors


def all_gather_shards(params: Sequence[torch.Tensor], shards: Sequence[torch.Tensor],
                      dims: Sequence[int]) -> None:
    """Each ``params[i]`` set, in place, to the ranks' ``shards[i]`` laid side
    by side along ``dims[i]`` (rank r's slice at r * shard size), one
    all-gather per bucket."""
    world = world_size()
    for idx in _buckets(shards):
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat)
        for r, part in enumerate(parts):
            offset = 0
            for i in idx:
                s = shards[i]
                c = s.shape[dims[i]]
                params[i].narrow(dims[i], r * c, c).copy_(
                    part[offset:offset + s.numel()].view(s.shape))
                offset += s.numel()


def _broadcast(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` to every rank (host tensors over the
    host group)."""
    for t in tensors:
        dist.broadcast(t, 0, group=host_group() if t.device.type == "cpu" else None)


def broadcast_state(state) -> None:
    """Rank 0's params, EMA shadow and replicated optimizer state to every
    rank, so the replicas start equal whatever each process loaded."""
    from rnntransducer_tpu_torch.train.optim import replicated_state_tensors

    if not is_initialized():
        return
    with torch.no_grad():
        tensors = [p.data for p in state.model.parameters()]
        if state.ema is not None:
            tensors += [state.ema[k] for k in sorted(state.ema)]
        _broadcast(tensors + replicated_state_tensors(state.optimizer))


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
                    optimizer: str) -> Dict[str, Optional[int]]:
    """ZeRO-1 placement of each param's moments (name -> dim or None): the
    moments of AdamW, lion and SGD are split along the largest dim that
    ``world`` divides (:func:`_zero_dim`); adafactor's row and column
    statistics and its update clipping read whole tensors, so they stay
    whole on every rank.  A flax leaf stacking several layers is one port
    tensor per layer, each placed on its own."""
    if optimizer.lower() not in _SPLIT_OPTIMIZERS:
        return dict.fromkeys(params)
    transposed = _flax_dim_order(model_cfg)
    return {name: (_zero_dim(tuple(p.shape), world, transposed.get(name, False))
                   if p.is_floating_point() else None)
            for name, p in params.items()}


def moment_bytes(optimizer) -> int:
    """Bytes of the optimizer state this rank holds."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))


__all__ = ["BUCKET_BYTES", "DATA_AXIS", "all_gather_shards", "all_reduce_mean",
           "broadcast_state", "local_rows", "moment_bytes", "zero_split_dims"]
