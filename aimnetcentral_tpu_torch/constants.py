"""Physical constants (counterpart of aimnetcentral_tpu/constants.py:20-25).

Unit system: energies in eV, distances in Angstrom, charges in e.
"""

Hartree = 27.211386024367243  # eV
half_Hartree = 0.5 * Hartree
Bohr = 0.5291772105638411  # Angstrom
Bohr_inv = 1.0 / Bohr
