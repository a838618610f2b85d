"""Multi-process start-up (port of ``rnntransducer_tpu/parallel/distributed.py``).

The JAX package starts several hosts with ``jax.distributed.initialize``;
the original repository starts one process per card with torchrun and NCCL
(``scripts/run_train.sh:9``, ``train.py:45`` there).  Here every process
drives one device and joins one ``torch.distributed`` process group: NCCL
for a CUDA device, gloo for the CPU.  Without arguments :func:`initialize`
reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), the counterpart of JAX's auto-detection on pods; without
either it does nothing, and a single process trains alone.

Beside the device group, a gloo group carries the host-side agreements
(the preemption flag, validation sums, checkpoint barriers and generator
states), so that none of them waits for the device's queue.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the gloo group of host-side agreements (the default group when it is gloo)
_host_group = None


def _topology() -> dict:
    world = world_size()
    return {"process_index": rank(), "process_count": world,
            "local_devices": 1, "global_devices": world}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Optional[Union[str, torch.device]] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> dict:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvousing at ``coordinator_address`` (host:port,
    reached as ``tcp://host:port``); with no arguments, from torchrun's
    environment; with neither, a no-op.  ``device`` is this process's device
    (default CUDA): the backend is NCCL for a CUDA device, gloo for the CPU,
    unless ``backend`` names one (gloo also runs collectives on CUDA tensors,
    through the host).  ``timeout_s`` bounds every collective (torch's
    default where None).  Returns the JAX function's topology dict."""
    global _host_group
    if coordinator_address is None and num_processes is None and process_id is None:
        if not all(k in os.environ for k in _TORCHRUN_ENV):
            return _topology()
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("coordinator_address, num_processes and process_id go "
                         "together (or none of them, under torchrun)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    _host_group = None if backend == "gloo" else dist.new_group(backend="gloo", **kw)
    return _topology()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank: 0 without a process group."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of processes: 1 without a process group."""
    return dist.get_world_size() if is_initialized() else 1


def host_group():
    """The gloo group for host-side collectives on CPU tensors."""
    return _host_group


def host_all_reduce(values, op: str = "sum") -> torch.Tensor:
    """``values`` (numbers) reduced over every process on the host (float64
    SUM or MAX); as they are without a process group."""
    t = torch.tensor(values, dtype=torch.float64)
    if is_initialized():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=host_group())
    return t


def host_all_gather(obj) -> list:
    """Every process's ``obj`` (picklable), in rank order."""
    if not is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=host_group())
    return out
