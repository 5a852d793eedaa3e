"""Harmonic vibrational analysis from the calculator's dense Hessian
(counterpart of aimnetcentral_tpu/dynamics/vibrations.py).

Mass-weighted normal modes and frequencies, double-harmonic IR intensities
(all displaced geometries in one batched calculator request: at or above
``binned_threshold`` atoms a gas-phase batch runs on the molecule-bin
layout, so the kernels carry it) and ideal-gas RRHO thermochemistry.
Host-side numpy once the Hessian is in hand: the (3N, 3N)
eigendecomposition is a one-shot post-processing step, not a device hot
path.

Conventions: Hessian in eV/A^2 (calculator output, (N,3,N,3)), masses in
amu; frequencies returned in cm^-1, with IMAGINARY modes reported as
negative numbers (the usual quantum-chemistry convention).
"""

from __future__ import annotations

import numpy as np

from aimnetcentral_tpu_torch import constants

# sqrt(eV / (amu * A^2)) -> angular frequency, over 2*pi*c in cm/s:
#   sqrt(1.602176634e-19 J / (1.66053906892e-27 kg * 1e-20 m^2))
#     = 9.82269e13 rad/s per sqrt(eV/amu/A^2)
#   / (2*pi * 2.99792458e10 cm/s) = 521.471 cm^-1
EV_AMU_A2_TO_CM1 = 521.4708


def harmonic_frequencies(
    hessian: np.ndarray,
    masses: np.ndarray,
    project_translations: bool = True,
    coord: np.ndarray | None = None,
    project_rotations: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Mass-weighted normal-mode analysis.

    Parameters
    ----------
    hessian : (N, 3, N, 3) or (3N, 3N) second derivatives in eV/A^2
    masses : (N,) atomic masses in amu
    project_translations : project the 3 exact translational null vectors
        out of the mass-weighted Hessian before diagonalizing
    coord : (N, 3) Cartesian coordinates in A — required when
        ``project_rotations`` is set (rotation vectors depend on geometry)
    project_rotations : additionally project the 3 (2 for linear molecules)
        rotational vectors.  Only valid AT STATIONARY POINTS, where rotations
        are exact null directions; at a non-stationary geometry they are not,
        so the default is off.  Thermochemistry (``rrho_thermochemistry``)
        applies at stationary points and should use rotation-projected
        frequencies so the rigid-rotor terms are not double-counted by
        rotational pseudo-frequencies leaking above the vibrational cutoff.

    Returns
    -------
    freqs_cm1 : (3N,) frequencies in cm^-1, ascending; imaginary modes are
        returned as negative values
    modes : (3N, N, 3) Cartesian displacement of each mode (mass-weighted
        eigenvectors un-weighted by 1/sqrt(m), normalized)
    """
    masses = np.asarray(masses, dtype=np.float64)
    n = masses.shape[0]
    h = np.asarray(hessian, dtype=np.float64).reshape(3 * n, 3 * n)
    h = 0.5 * (h + h.T)
    inv_sqrt_m = np.repeat(1.0 / np.sqrt(masses), 3)
    hw = h * inv_sqrt_m[:, None] * inv_sqrt_m[None, :]

    vecs = []
    sm = np.sqrt(masses)
    if project_translations:
        # translation vectors in mass-weighted coords: sqrt(m_i) * e_ax
        for ax in range(3):
            t = np.zeros(3 * n)
            t[ax::3] = sm
            vecs.append(t)
    if project_rotations:
        if coord is None:
            raise ValueError("project_rotations requires coord")
        r = np.asarray(coord, dtype=np.float64).reshape(n, 3)
        com = (masses[:, None] * r).sum(0) / masses.sum()
        r = r - com
        # rotation vectors in mass-weighted coords: sqrt(m_i) * (e_ax x r_i)
        for ax in range(3):
            e = np.zeros(3)
            e[ax] = 1.0
            vecs.append((sm[:, None] * np.cross(e, r)).reshape(-1))
    if vecs:
        # modified Gram-Schmidt: translations have disjoint support (stay
        # exactly orthonormal); rotations are orthogonalized against them.
        # Rank-deficient directions (linear molecules have only 2 independent
        # rotations; single atoms none) drop out via the norm guard.
        basis: list[np.ndarray] = []
        for v in vecs:
            scale = np.linalg.norm(v)
            for _ in range(2):  # double pass for numerical orthogonality
                for b in basis:
                    v = v - (b @ v) * b
            nrm = np.linalg.norm(v)
            if nrm > 1e-8 * max(scale, 1.0):
                basis.append(v / nrm)
        if basis:  # all-degenerate (e.g. single atom, rotations only)
            t = np.stack(basis)
            p = np.eye(3 * n) - t.T @ t
            hw = p @ hw @ p

    w, v = np.linalg.eigh(hw)
    freqs = np.sign(w) * np.sqrt(np.abs(w)) * EV_AMU_A2_TO_CM1
    modes = (v.T * inv_sqrt_m[None, :]).reshape(3 * n, n, 3)
    norm = np.linalg.norm(modes.reshape(3 * n, -1), axis=1, keepdims=True)
    modes = modes / np.clip(norm, 1e-30, None)[:, :, None]
    return freqs, modes


def frequencies_from_calculator(
    calc,
    data: dict,
    project_translations: bool = True,
    project_rotations: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Convenience: dense Hessian via the calculator, then normal modes."""
    out = calc(data, hessian=True)
    h = out["hessian"]
    if isinstance(h, list):
        raise ValueError("vibrational analysis takes ONE structure at a time")
    numbers = np.asarray(data["numbers"]).reshape(-1)
    masses = np.asarray(constants.get_masses(), dtype=np.float64)[numbers]
    return harmonic_frequencies(
        h,
        masses,
        project_translations,
        coord=np.asarray(data["coord"], dtype=np.float64).reshape(-1, 3),
        project_rotations=project_rotations,
    )


# -- IR intensities ------------------------------------------------------------

# |d mu/dQ|^2 conversion: 1 (D/A)^2/amu = 42.2561 km/mol (the standard
# double-harmonic absolute-intensity factor N_A*pi/(3c^2)), and
# 1 e = 4.80320 D/A, so 1 e^2/amu -> 4.80320^2 * 42.2561 km/mol.
KM_MOL_PER_E2_AMU = 4.80320**2 * 42.2561  # = 974.86


def ir_intensities(
    calc,
    data: dict,
    modes: np.ndarray,
    delta: float = 0.01,
) -> np.ndarray:
    """Double-harmonic IR intensities (km/mol) for the given normal modes.

    Dipole derivatives are central finite differences of the model dipole
    along each Cartesian mode (the same displaced-geometry scheme as
    ase.vibrations.Infrared); ALL displaced geometries evaluate in ONE
    batched calculator call.  The dipole is the model's own ``dipole``
    observable when the architecture has a dipole head, else the
    charges-based sum q_i * r_i — either way the charge response dq/dr is
    included because the charges themselves are re-predicted at each
    displaced geometry.

    Parameters
    ----------
    calc : AIMNet2Calculator
    data : single-molecule input dict (gas phase)
    modes : (K, N, 3) Cartesian normal modes from ``harmonic_frequencies``
    delta : FD displacement amplitude along each (unit-norm) mode, in A
    """
    coord0 = np.asarray(data["coord"], dtype=np.float64).reshape(-1, 3)
    numbers = np.asarray(data["numbers"]).reshape(-1)
    n = numbers.shape[0]
    modes = np.asarray(modes, dtype=np.float64).reshape(-1, n, 3)
    k = modes.shape[0]
    masses = np.asarray(constants.get_masses(), dtype=np.float64)[numbers]

    displaced = []
    for sign in (+1.0, -1.0):
        for d in modes:
            mol = dict(data)
            mol["coord"] = (coord0 + sign * delta * d).astype(np.float32)
            displaced.append(mol)
    out = calc(displaced)

    if "dipole" in out:
        mu = np.asarray(out["dipole"], dtype=np.float64).reshape(2 * k, 3)
    else:
        q = np.asarray(out["charges"], dtype=np.float64).reshape(2 * k, n)
        coords = np.stack([np.asarray(m["coord"], dtype=np.float64) for m in displaced])
        mu = (q[:, :, None] * coords).sum(axis=1)

    dmu_ds = (mu[:k] - mu[k:]) / (2.0 * delta)  # e, per unit Cartesian mode
    # convert to the mass-weighted normal coordinate Q_k: the MW-normalized
    # eigenvector is v = c * modes * sqrt(m) with c = 1/||modes*sqrt(m)||,
    # and dmu/dQ = c * dmu/ds
    c = 1.0 / np.linalg.norm(modes * np.sqrt(masses)[None, :, None], axis=(1, 2))
    dmu_dq = dmu_ds * c[:, None]  # e / sqrt(amu)
    return KM_MOL_PER_E2_AMU * (dmu_dq**2).sum(axis=1)


# -- ideal-gas RRHO thermochemistry --------------------------------------------

# SI values for the translational/rotational partition functions
_H_SI = 6.62607015e-34  # J s
_KB_SI = 1.380649e-23  # J / K
_AMU_SI = 1.66053906892e-27  # kg
_EV_SI = 1.602176634e-19  # J
_HC_EV_CM = 1.239841984e-4  # h*c in eV * cm


def rrho_thermochemistry(
    freqs_cm1: np.ndarray,
    numbers: np.ndarray,
    coord: np.ndarray,
    temperature: float = 298.15,
    pressure: float = 101325.0,
    symmetry_number: int = 1,
    mult: float = 1.0,
    freq_cutoff_cm1: float = 10.0,
) -> dict:
    """Ideal-gas rigid-rotor harmonic-oscillator thermochemistry.

    The standard gas-phase partition-function treatment (the workflow the
    reference delegates to ase.thermochemistry.IdealGasThermo): vibrational
    terms from the harmonic frequencies (imaginary and sub-cutoff modes are
    EXCLUDED and reported in ``n_skipped_modes``), translational
    Sackur-Tetrode, classical rigid rotor from the inertia tensor (linear /
    nonlinear / monatomic handled), electronic spin degeneracy.

    Pass frequencies computed with ``project_rotations=True`` (valid at the
    stationary points where this treatment applies) so rotational
    pseudo-frequencies cannot leak into the vibrational sum.  As a second
    line of defense the vibrational mode count is capped at 3N-6 (3N-5 for
    linear molecules, 0 for atoms) by dropping the LOWEST real modes beyond
    the cap — those are the rotational contaminants when projection was
    skipped — mirroring ase.thermochemistry.IdealGasThermo's requirement of
    exactly 3N-6 vibrational energies.

    Returns a dict of energies in eV and entropies in eV/K:
    ``zpe``, ``u_vib`` (incl. ZPE), ``u_trans``, ``u_rot``, ``h`` (thermal
    enthalpy correction, ex electronic energy), ``s_trans/s_rot/s_vib/s_el``,
    ``s``, ``g`` (= h - T*s).
    """
    T = float(temperature)
    kT = constants.kB * T  # eV
    numbers = np.asarray(numbers).reshape(-1)
    coord = np.asarray(coord, dtype=np.float64).reshape(-1, 3)
    masses = np.asarray(constants.get_masses(), dtype=np.float64)[numbers]

    # rigid-body classification first (the vibrational cap needs linearity)
    com = (masses[:, None] * coord).sum(0) / masses.sum()
    r = coord - com
    inertia = np.einsum("i,ij,ik->jk", masses, r, r)
    inertia = np.diag(np.full(3, np.trace(inertia))) - inertia  # amu A^2
    moments = np.clip(np.linalg.eigvalsh(inertia), 0.0, None)
    tol = 1e-3 * max(moments.max(), 1.0)
    monatomic = numbers.shape[0] == 1 or moments.max() < 1e-12
    linear = (not monatomic) and moments[0] < tol

    # vibrational
    freqs = np.asarray(freqs_cm1, dtype=np.float64).reshape(-1)
    vib = np.sort(freqs[freqs > freq_cutoff_cm1])
    n = numbers.shape[0]
    n_vib_max = 0 if monatomic else (3 * n - 5 if linear else 3 * n - 6)
    if vib.shape[0] > n_vib_max:
        # rotational / translational contaminants above the cutoff: drop the
        # lowest real modes down to the RRHO mode count (see docstring).
        # This heuristic misfires when a GENUINE soft mode (floppy torsion)
        # lies below a contaminant — pass projected frequencies
        # (harmonic_frequencies(..., project_rotations=True)) to avoid the
        # ambiguity entirely; warn so the silent drop is visible.
        import warnings

        warnings.warn(
            f"{vib.shape[0] - n_vib_max} low modes dropped to reach the "
            f"{n_vib_max}-mode RRHO count; if the input frequencies were "
            "not rotation-projected, genuine soft modes may be dropped in "
            "favor of rotational contaminants - recompute with "
            "harmonic_frequencies(project_rotations=True)",
            stacklevel=2,
        )
        vib = vib[vib.shape[0] - n_vib_max :]
    n_skipped = int(freqs.shape[0] - vib.shape[0])
    e_modes = vib * _HC_EV_CM  # eV
    zpe = 0.5 * e_modes.sum()
    x = e_modes / kT
    u_vib = zpe + (e_modes / np.expm1(x)).sum()
    s_vib = constants.kB * (x / np.expm1(x) - np.log1p(-np.exp(-x))).sum()

    # translational (Sackur-Tetrode, V = kB T / p)
    m_kg = masses.sum() * _AMU_SI
    lam = _H_SI / np.sqrt(2.0 * np.pi * m_kg * _KB_SI * T)  # m
    v_m3 = _KB_SI * T / float(pressure)
    q_trans = v_m3 / lam**3
    s_trans = constants.kB * (np.log(q_trans) + 2.5)
    u_trans = 1.5 * kT

    # rotational (classical RR from the principal moments computed above)
    moments_si = moments * _AMU_SI * 1e-20  # kg m^2
    sigma = max(int(symmetry_number), 1)
    if monatomic:
        q_rot = 1.0
        u_rot = 0.0
    elif linear:  # one vanishing principal moment
        q_rot = 8.0 * np.pi**2 * moments_si[2] * _KB_SI * T / (sigma * _H_SI**2)
        u_rot = kT
    else:
        b = 8.0 * np.pi**2 * _KB_SI * T / _H_SI**2
        q_rot = (np.sqrt(np.pi) / sigma) * np.sqrt(b**3 * np.prod(moments_si))
        u_rot = 1.5 * kT
    s_rot = constants.kB * (np.log(max(q_rot, 1.0e-300)) + (u_rot / kT if kT else 0.0))

    s_el = constants.kB * np.log(max(float(mult), 1.0))

    h = u_trans + u_rot + u_vib + kT  # + pV term
    s = s_trans + s_rot + s_vib + s_el
    return {
        "zpe": float(zpe),
        "u_vib": float(u_vib),
        "u_trans": float(u_trans),
        "u_rot": float(u_rot),
        "h": float(h),
        "s_trans": float(s_trans),
        "s_rot": float(s_rot),
        "s_vib": float(s_vib),
        "s_el": float(s_el),
        "s": float(s),
        "g": float(h - T * s),
        "n_skipped_modes": n_skipped,
        "temperature": T,
        "pressure": float(pressure),
    }
