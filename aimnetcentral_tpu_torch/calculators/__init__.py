from aimnetcentral_tpu_torch.calculators.calculator import AIMNet2Calculator  # noqa: F401
