"""Long-range constants and switches (counterpart of
aimnetcentral_tpu/models/lr.py:29 and :231-238)."""

import torch

from aimnetcentral_tpu_torch import constants

FACTOR = constants.half_Hartree * constants.Bohr  # ordered-pair Coulomb prefactor


def _s5_switch(d_bohr: torch.Tensor, r_on_bohr: float, r_off_bohr: float) -> torch.Tensor:
    """Quintic S5 switch-off from 1 at ``r_on`` to 0 at ``r_off`` (Bohr)."""
    if r_off_bohr <= r_on_bohr:
        return torch.ones_like(d_bohr)
    t = torch.clamp((d_bohr - r_on_bohr) / (r_off_bohr - r_on_bohr), 0.0, 1.0)
    switch = 1.0 - (10.0 * t**3 - 15.0 * t**4 + 6.0 * t**5)
    return torch.where(d_bohr <= r_on_bohr, torch.ones_like(switch), switch)
