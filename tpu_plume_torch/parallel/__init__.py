from tpu_plume_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
    shard_gail_carry,
    shard_loop_carry,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_gail_carry",
    "shard_loop_carry",
]
