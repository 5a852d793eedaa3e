"""ASE and PySisyphus adapters (counterpart of
aimnetcentral_tpu/calculators/ase_adapter.py).

Import-gated: ASE is an optional dependency.  ``AIMNet2ASE`` implements
energy / forces / free_energy / charges / stress / dipole_moment (and
spin_charges for NSE models), charge and multiplicity with ``atoms.info``
taking precedence over the constructor's, and ``get_hessian`` for
Sella-style transition-state searches.  ``AIMNet2Pysis`` converts to and
from PySisyphus's Bohr and Hartree, with a coordinate-keyed cache.

Both take an ``AIMNet2Calculator`` (or anything with its call signature);
``AIMNet2ASE`` also takes a registry name or an artifact path and builds
the calculator itself, on the card unless ``device="cpu"`` is passed
through.  A Hessian request runs on the indexed layout, as
``AIMNet2Calculator.eval(hessian=True)`` does.
"""

from __future__ import annotations

import numpy as np

from aimnetcentral_tpu_torch import constants

try:
    from ase.calculators.calculator import Calculator, all_changes

    ASE_AVAILABLE = True
except ImportError:  # pragma: no cover
    ASE_AVAILABLE = False

    class Calculator:  # type: ignore[no-redef]
        pass

    all_changes = []

# element symbols up to Kr, index = atomic number (PySisyphus passes symbols)
_PYSIS_SYMBOLS = {
    s: z
    for z, s in enumerate(
        "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn "
        "Fe Co Ni Cu Zn Ga Ge As Se Br Kr".split()
    )
}


class AIMNet2ASE(Calculator):
    implemented_properties = [
        "energy",
        "forces",
        "free_energy",
        "charges",
        "stress",
        "dipole_moment",
    ]

    def __init__(self, base_calc, charge: float = 0.0, mult: float | None = None, **calc_kwargs):
        """``base_calc``: a calculator, or a registry name / artifact path
        loaded into ``AIMNet2Calculator(base_calc, **calc_kwargs)`` (for
        example ``device="cpu"``, ``precision="fast"``)."""
        if not ASE_AVAILABLE:
            raise ImportError("ase is required for AIMNet2ASE")
        super().__init__()
        if isinstance(base_calc, str):
            from aimnetcentral_tpu_torch.calculators.calculator import AIMNet2Calculator

            base_calc = AIMNet2Calculator(base_calc, **calc_kwargs)
        elif calc_kwargs:
            raise TypeError(f"calculator options {sorted(calc_kwargs)} need a model name or path, not a calculator")
        self.base_calc = base_calc
        self.charge = charge
        self.mult = mult
        self._last_charge_mult = None
        if getattr(base_calc, "is_nse", False):
            # the instance's own list: the class's stays closed-shell
            self.__dict__["implemented_properties"] = [
                *self.__class__.implemented_properties,
                "spin_charges",
            ]

    @property
    def is_nse(self) -> bool:
        return bool(getattr(self.base_calc, "is_nse", False))

    def _charge_mult(self, atoms):
        """``atoms.info`` takes precedence over the constructor's values;
        ``mult`` (AIMNet2 style) and ``spin`` (MACE style) both name the
        multiplicity 2S+1."""
        charge = atoms.info.get("charge", self.charge)
        mult = atoms.info.get("mult", atoms.info.get("spin", self.mult))
        return charge, mult

    def set_charge(self, charge):
        """Set the default total charge and drop cached results; a
        geometry's ``atoms.info['charge']`` still wins."""
        self.charge = charge
        self.results = {}

    def set_mult(self, mult):
        """Set the default multiplicity 2S+1 and drop cached results."""
        self.mult = mult
        self.results = {}

    def check_state(self, atoms, tol=1e-15):
        """ASE's own check watches the geometry only: a changed
        ``atoms.info['charge' / 'mult' / 'spin']`` also asks for a new
        calculation."""
        base = getattr(super(), "check_state", None)
        state = list(base(atoms, tol=tol)) if base is not None else []
        if self._charge_mult(atoms) != self._last_charge_mult:
            if "info" not in state:
                state.append("info")
        return state

    def _data(self, atoms):
        charge, mult = self._charge_mult(atoms)
        data = {
            "coord": atoms.get_positions().astype(np.float32),
            "numbers": atoms.get_atomic_numbers(),
            "charge": charge,
        }
        if mult is not None:
            data["mult"] = mult
        if atoms.pbc.any():
            data["cell"] = np.asarray(atoms.get_cell(), dtype=np.float32)
        return data

    def calculate(self, atoms=None, properties=("energy",), system_changes=all_changes):
        super().calculate(atoms, properties, system_changes)
        atoms = self.atoms
        self._last_charge_mult = self._charge_mult(atoms)
        need_stress = "stress" in properties and atoms.pbc.any()
        out = self.base_calc(self._data(atoms), forces=True, stress=need_stress)
        self.results["energy"] = float(out["energy"][0])
        self.results["free_energy"] = self.results["energy"]
        if "forces" in out:
            self.results["forces"] = np.asarray(out["forces"], dtype=np.float64)
        if "charges" in out:
            q = np.asarray(out["charges"], dtype=np.float64)
            self.results["charges"] = q
            self.results["dipole_moment"] = (q[:, None] * atoms.get_positions()).sum(0)
        if "spin_charges" in out:
            self.results["spin_charges"] = np.asarray(out["spin_charges"])
        if need_stress and "stress" in out:
            s = np.asarray(out["stress"][0], dtype=np.float64)
            s = 0.5 * (s + s.T)
            # ASE's Voigt order: xx, yy, zz, yz, xz, xy
            self.results["stress"] = np.array([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]])

    def get_dipole_moment(self, atoms):
        """The point-charge dipole of the model's partial charges."""
        if "charges" not in self.results:
            self.calculate(atoms, properties=("energy",))
        q = np.asarray(self.results["charges"], dtype=np.float64)
        return (q[:, None] * atoms.get_positions()).sum(0)

    def get_spin_charges(self, atoms=None):
        """Per-atom spin populations; NSE models only."""
        if "spin_charges" not in self.results:
            raise RuntimeError("spin_charges is not available. Use an NSE model (e.g. 'aimnet2nse').")
        return self.results["spin_charges"]

    def get_hessian(self, atoms=None):
        """The (3N, 3N) Hessian, for Sella."""
        atoms = atoms if atoms is not None else self.atoms
        if atoms is None:
            raise ValueError("get_hessian requires atoms (none attached)")
        out = self.base_calc(self._data(atoms), hessian=True)
        n = len(atoms)
        return np.asarray(out["hessian"], dtype=np.float64).reshape(3 * n, 3 * n)


class AIMNet2Pysis:
    """The PySisyphus calculator: energy, forces and Hessian in Hartree and
    Bohr, with the result of the last coordinates kept."""

    def __init__(self, base_calc, charge: float = 0.0, mult: float = 1.0):
        self.base_calc = base_calc
        self.charge = charge
        self.mult = mult
        self._bohr = constants.Bohr
        self._hartree = constants.Hartree
        self._cache_key = None
        self._cache = None

    def _eval(self, elem, coords_bohr, **kw):
        key = (tuple(elem), coords_bohr.tobytes(), tuple(sorted(kw)))
        if key == self._cache_key:
            return self._cache
        numbers = np.array([_PYSIS_SYMBOLS[e.capitalize()] for e in elem])
        coord = (coords_bohr.reshape(-1, 3) * self._bohr).astype(np.float32)
        data = {"coord": coord, "numbers": numbers, "charge": self.charge, "mult": self.mult}
        out = self.base_calc(data, **kw)
        self._cache_key, self._cache = key, out
        return out

    def get_energy(self, elem, coords):
        out = self._eval(elem, np.asarray(coords))
        return {"energy": float(out["energy"][0]) / self._hartree}

    def get_forces(self, elem, coords):
        out = self._eval(elem, np.asarray(coords), forces=True)
        f = np.asarray(out["forces"]) * self._bohr / self._hartree
        return {"energy": float(out["energy"][0]) / self._hartree, "forces": f.reshape(-1)}

    def get_hessian(self, elem, coords):
        out = self._eval(elem, np.asarray(coords), hessian=True)
        n = len(elem)
        h = np.asarray(out["hessian"]).reshape(3 * n, 3 * n) * self._bohr**2 / self._hartree
        return {"energy": float(out["energy"][0]) / self._hartree, "hessian": h}


def run_pysis() -> None:
    """Console entry: register ``aimnet`` in PySisyphus's CALC_DICT and hand
    over to its runner.  Installed as the ``aimnet2pysis-torch`` script."""
    try:
        import pysisyphus.run
    except ImportError as e:  # pragma: no cover - optional extra
        raise ImportError("run_pysis requires PySisyphus (`pip install pysisyphus`).") from e

    pysisyphus.run.CALC_DICT["aimnet"] = AIMNet2Pysis
    pysisyphus.run.run()
