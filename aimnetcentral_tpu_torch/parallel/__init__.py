from aimnetcentral_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    init_distributed,
    make_mesh,
    make_spatial_mesh,
    replicate,
    shard_system,
    spawn,
)
