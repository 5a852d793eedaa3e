"""Dynamics on every layout: MD (``MDDriver``: binned and indexed
engines), FIRE relaxation, extended-XYZ trajectories, harmonic
vibrations, transition-state search and climbing-image NEB."""

from aimnetcentral_tpu_torch.dynamics.md import MDConfig, MDDriver  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.neb import linear_band, neb, neb_core  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.optimize import fire_relax  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.saddle import min_mode_search, ts_search  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.trajectory import TrajectoryWriter, read_frames  # noqa: F401
from aimnetcentral_tpu_torch.dynamics.vibrations import (  # noqa: F401
    frequencies_from_calculator,
    harmonic_frequencies,
)
