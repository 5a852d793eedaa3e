"""Training of the port: the loss, metrics, SAE regression, trackers, the
train step, the Trainer and the v2 artifact exporter."""

from aimnetcentral_tpu_torch.train.export import export_model  # noqa: F401
