"""Device-mesh parallelism over ``torch.distributed`` (counterpart of
dpivae_tpu/parallel/), one process per device:

- **dp**: every rank takes its rows of each training batch and of the
  validation set; params stay replicated and the gradients are summed
  over the axis in one collective per step (``train.train_model(mesh=)``).
- **sweep**: a sweep's members are split over the axis, each rank trains
  its own and the results are gathered (``sweep.train_sweep(mesh=)``).

A multi-rank job is launched by ``torch.distributed.run`` (NCCL between
cards) or, on the CPU, by ``torch.multiprocessing.spawn`` of gloo ranks;
a process started on its own makes a one-rank mesh.
"""

from dpivae_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    feed_process_local,
    launch_command,
    launched_world_size,
    make_global_mesh,
    make_mesh,
    replicated,
    shard_batch,
    sharded_train_step,
)
