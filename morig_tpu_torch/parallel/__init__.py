"""Data- and tensor-parallel training over torch.distributed — counterpart
of morig_tpu/parallel/: `mesh` (the mesh, the collectives and the batch
reductions the modules and losses call), `sharding` (building the mesh,
launching the ranks, placing batches and states) and `dryrun` (one sharded
DeformPoseStage step)."""
from morig_tpu_torch.parallel.mesh import (DeviceMesh, active, batch_mean, batch_sum, current,
                                           data_sum, rand)

__all__ = ["DeviceMesh", "active", "batch_mean", "batch_sum", "current", "data_sum", "rand"]
