from aimnetcentral_tpu_torch.calculators.calculator import AIMNet2Calculator  # noqa: F401
from aimnetcentral_tpu_torch.calculators.ensemble import EnsembleCalculator, stack_params  # noqa: F401
