"""Training data of the port (and the package's data files: the D3 and
element tables, the model registry)."""

from aimnetcentral_tpu_torch.data.sgdataset import (  # noqa: F401
    DataGroup,
    SizeGroupedDataset,
    SizeGroupedSampler,
)
