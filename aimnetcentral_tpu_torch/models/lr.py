"""Long-range constants (counterpart of aimnetcentral_tpu/models/lr.py:29)."""

from aimnetcentral_tpu_torch import constants

FACTOR = constants.half_Hartree * constants.Bohr  # ordered-pair Coulomb prefactor
