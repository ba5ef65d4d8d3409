"""Data parallelism (the JAX package's parallel/): a 1-axis device mesh for
serving, and data-parallel training steps under a torch.distributed
process group."""

from .mesh import (  # noqa: F401
    Mesh,
    is_rank0,
    make_mesh,
    pad_batch_to_devices,
    rank,
    replicate,
    shard_batch,
    sync_batch_shapes,
    world_size,
)
