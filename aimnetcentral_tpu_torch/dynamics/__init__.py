"""Dynamics on the binned periodic engine: MD (``MDDriver``), FIRE
relaxation and extended-XYZ trajectories."""

from aimnetcentral_tpu_torch.dynamics.md import MDConfig, MDDriver  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.optimize import fire_relax  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.trajectory import TrajectoryWriter, read_frames  # noqa: F401
