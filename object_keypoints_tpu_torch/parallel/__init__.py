"""Data parallelism: process groups, the data devices and the collectives
(counterpart of ``object_keypoints_tpu/parallel``; the ``model`` axis is not
ported)."""

from object_keypoints_tpu_torch.parallel.mesh import (
    all_reduce_,
    all_reduce_autograd,
    batch_sharding,
    broadcast_,
    create_mesh,
    destroy_distributed,
    initialize_distributed,
    is_distributed,
    rank,
    world_size,
)

__all__ = [
    "all_reduce_",
    "all_reduce_autograd",
    "batch_sharding",
    "broadcast_",
    "create_mesh",
    "destroy_distributed",
    "initialize_distributed",
    "is_distributed",
    "rank",
    "world_size",
]
