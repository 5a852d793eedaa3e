from aimnetcentral_tpu_torch.models.aimnet2 import (  # noqa: F401
    AEVConfig,
    AIMNet2Config,
    aimnet2_apply,
    aimnet2_init,
)
