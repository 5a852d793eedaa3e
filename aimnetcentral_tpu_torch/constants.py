"""Physical constants, masses and the DFT-D3 tables (counterpart of
aimnetcentral_tpu/constants.py:20-25 and :36-64).

Unit system: energies in eV, distances in Angstrom, charges in e, masses in
amu, time in ASE units (``x fs * fs`` is ASE time).  The element and D3
tables are the port's own byte-identical copies of the JAX package's
``data/element_tables.npz`` and ``data/d3_tables.npz``.
"""

from __future__ import annotations

import functools
import os

import numpy as np

# from ase.units (reference aimnet/constants.py:4-9)
kB = 8.617330337217213e-05  # eV / K
fs = 0.09822694788464063  # ASE time unit conversion: x [fs] * fs = ASE time
Hartree = 27.211386024367243  # eV
half_Hartree = 0.5 * Hartree
Bohr = 0.5291772105638411  # Angstrom
Bohr_inv = 1.0 / Bohr

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@functools.cache
def _element_tables() -> dict[str, np.ndarray]:
    with np.load(os.path.join(_DATA_DIR, "element_tables.npz")) as z:
        return {k: z[k].copy() for k in z}


def get_masses() -> np.ndarray:
    """Atomic masses (amu) indexed by atomic number; index 0 is the dummy atom."""
    return _element_tables()["masses"]


def get_gfn1_rep() -> tuple[np.ndarray, np.ndarray]:
    """GFN1-xTB short-range repulsion (alpha, Z_eff) tables, indices 0..86."""
    t = _element_tables()
    return t["gfn1_repa"], t["gfn1_repb"]


def get_r4r2() -> np.ndarray:
    """D3 sqrt(0.5 sqrt(Z) <r4>/<r2>) table of the D3TS head."""
    return _element_tables()["r4r2"]


@functools.cache
def get_d3_tables() -> dict[str, np.ndarray]:
    """DFT-D3 reference data: c6ab (95, 95, 5, 5), cn_ref (95, 95, 5, 5),
    rcov (95,), r4r2 (95,), all float32, indexed by atomic number (index 0
    is the padding atom)."""
    with np.load(os.path.join(_DATA_DIR, "d3_tables.npz")) as z:
        return {k: z[k].copy() for k in z}
