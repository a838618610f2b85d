"""Parallelism across processes, one device each (port of
``rnntransducer_tpu/parallel/``): the mesh ``data × [time | stage] ×
[model]`` of a process group, the vocab-sharded joint's regions, the GPipe
encoder pipeline and the time-sharded wavefront; and the lane devices of a
sharded streaming runner, driven by one process."""

from rnntransducer_tpu_torch.parallel.distributed import (initialize, is_initialized,
                                                          rank, shutdown, world_size)
from rnntransducer_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS,
                                                   TIME_AXIS, Mesh, all_reduce_mean,
                                                   broadcast_state, lane_devices,
                                                   local_rows, make_mesh,
                                                   moment_bytes, zero_split_dims)
from rnntransducer_tpu_torch.parallel.pipeline import (make_stage_mesh, pipeline_encode,
                                                       pipeline_scan)
from rnntransducer_tpu_torch.parallel.wavefront import (make_time_mesh,
                                                        pad_time_to_multiple,
                                                        wavefront_encode, wavefront_scan)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "STAGE_AXIS", "TIME_AXIS",
           "all_reduce_mean", "broadcast_state", "initialize", "is_initialized",
           "lane_devices", "local_rows", "make_mesh", "make_stage_mesh", "make_time_mesh", "moment_bytes", "pad_time_to_multiple",
           "pipeline_encode", "pipeline_scan", "rank", "shutdown", "wavefront_encode",
           "wavefront_scan", "world_size", "zero_split_dims"]
