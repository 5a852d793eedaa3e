from aimnetcentral_tpu_torch.parallel.collectives import all_reduce_mean  # noqa: F401
from aimnetcentral_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    make_spatial_mesh,
    replicate,
    shard_system,
    spawn,
    world_mesh,
)
