"""Data parallelism across processes (port of the data axis of
``rnntransducer_tpu/parallel/``): one process per device, one process group."""

from rnntransducer_tpu_torch.parallel.distributed import (initialize, is_initialized,
                                                          rank, shutdown, world_size)
from rnntransducer_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce_mean,
                                                   broadcast_state, local_rows,
                                                   moment_bytes, zero_split_dims)

__all__ = ["DATA_AXIS", "all_reduce_mean", "broadcast_state", "initialize",
           "is_initialized", "local_rows", "moment_bytes", "rank", "shutdown",
           "world_size", "zero_split_dims"]
