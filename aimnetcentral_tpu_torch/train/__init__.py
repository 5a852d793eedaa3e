"""Training-side tools of the port; so far the v2 artifact exporter."""

from aimnetcentral_tpu_torch.train.export import export_model  # noqa: F401
