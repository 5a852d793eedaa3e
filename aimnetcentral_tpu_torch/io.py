"""Structure file readers, XYZ and a minimal CIF, with no ASE dependency (a
copy of aimnetcentral_tpu/io.py, which imports no JAX; the port keeps its
own so that it imports nothing of the JAX package).

The CIF reader covers cell parameters, the ``_symmetry_equiv_pos_as_xyz``
operator list and fractional atom sites, expanded to the full P1 cell with
duplicate sites merged.  It is not a general CIF parser (no disorder
handling, no multi-data-block support beyond "first block wins").
"""

from __future__ import annotations

import re

import numpy as np

ELEMENT_SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te "
    "I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir "
    "Pt Au Hg Tl Pb Bi Po At Rn"
).split()
SYMBOL_TO_Z = {s: z for z, s in enumerate(ELEMENT_SYMBOLS)}


def symbol_to_z(symbol: str) -> int:
    """Element symbol -> atomic number; tolerates CIF-style suffixes (C1, O2-)."""
    m = re.match(r"([A-Z][a-z]?)", symbol)
    if not m or m.group(1) not in SYMBOL_TO_Z:
        raise ValueError(f"unknown element symbol: {symbol!r}")
    return SYMBOL_TO_Z[m.group(1)]


def read_xyz(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Plain/extended XYZ: returns (coord (N,3) f32 Angstrom, numbers (N,) i64)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    numbers, coords = [], []
    for line in lines[2 : 2 + n]:
        parts = line.split()
        numbers.append(
            SYMBOL_TO_Z[parts[0]] if parts[0] in SYMBOL_TO_Z else int(parts[0])
        )
        coords.append([float(x) for x in parts[1:4]])
    return np.array(coords, dtype=np.float32), np.array(numbers, dtype=np.int64)


def _cif_number(tok: str) -> float:
    """CIF numeric token: strip the parenthesized standard uncertainty."""
    return float(re.sub(r"\(.*?\)", "", tok))


def cell_from_parameters(
    a: float, b: float, c: float, alpha: float, beta: float, gamma: float
) -> np.ndarray:
    """Crystallographic cell matrix (rows = lattice vectors, Angstrom):
    a along x, b in the xy plane."""
    al, be, ga = np.radians([alpha, beta, gamma])
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c**2 - cx**2 - cy**2, 0.0))
    return np.array(
        [
            [a, 0.0, 0.0],
            [b * np.cos(ga), b * np.sin(ga), 0.0],
            [cx, cy, cz],
        ],
        dtype=np.float64,
    )


def _parse_symop(op: str) -> tuple[np.ndarray, np.ndarray]:
    """'-X,1/2+Y,1/2-Z' -> (rotation (3,3), translation (3,))."""
    rot = np.zeros((3, 3))
    trans = np.zeros(3)
    axes = {"x": 0, "y": 1, "z": 2}
    for i, comp in enumerate(op.lower().replace(" ", "").split(",")):
        # split into signed terms
        for term in re.findall(r"[+-]?[^+-]+", comp):
            sign = -1.0 if term.startswith("-") else 1.0
            term = term.lstrip("+-")
            if term and term[-1] in axes:
                coeff = term[:-1].rstrip("*")
                factor = 1.0
                if coeff:
                    num, _, den = coeff.partition("/")
                    factor = float(num) / float(den) if den else float(num)
                rot[i, axes[term[-1]]] += sign * factor
            elif term:
                num, _, den = term.partition("/")
                trans[i] += sign * (float(num) / float(den) if den else float(num))
    return rot, trans


def read_cif(path: str) -> dict:
    """Parse a CIF into a P1 structure.

    Returns ``{"coord" (N,3) f32 cartesian Angstrom, "numbers" (N,) i64,
    "cell" (3,3) f32, "frac" (N,3) f64}``; symmetry operators are applied and
    coincident images merged (fractional tolerance 1e-3, periodic metric).
    """
    with open(path) as f:
        lines = [ln.rstrip() for ln in f]

    params: dict[str, float] = {}
    symops: list[str] = []
    sites: list[tuple[str, float, float, float]] = []

    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        m = re.match(r"(_cell_(?:length|angle)_\w+)\s+(\S+)", ln)
        if m:
            params[m.group(1)] = _cif_number(m.group(2))
            i += 1
            continue
        if ln == "loop_":
            # collect the header tags
            tags = []
            j = i + 1
            while j < len(lines) and lines[j].strip().startswith("_"):
                tags.append(lines[j].strip().split()[0])
                j += 1
            # collect data rows until the next tag/loop/empty-block boundary
            rows = []
            while j < len(lines):
                row = lines[j].strip()
                if not row or row.startswith(("_", "loop_", "#", "data_")):
                    break
                if row.startswith(";"):  # multi-line text field: skip block
                    j += 1
                    while j < len(lines) and not lines[j].startswith(";"):
                        j += 1
                    j += 1
                    continue
                rows.append(row.split())
                j += 1
            if any(t.startswith("_symmetry_equiv_pos_as_xyz") for t in tags) or any(
                t.startswith("_space_group_symop_operation_xyz") for t in tags
            ):
                col = next(
                    k
                    for k, t in enumerate(tags)
                    if "equiv_pos_as_xyz" in t or "symop_operation_xyz" in t
                )
                for r in rows:
                    # the operator may be quoted or contain no spaces
                    tok = " ".join(r[col:]) if col == len(tags) - 1 else r[col]
                    symops.append(tok.strip("'\""))
            elif any(t == "_atom_site_fract_x" for t in tags):
                idx = {t: k for k, t in enumerate(tags)}
                sym_col = idx.get("_atom_site_type_symbol", idx.get("_atom_site_label"))
                for r in rows:
                    if len(r) < len(tags):
                        continue
                    sites.append(
                        (
                            r[sym_col],
                            _cif_number(r[idx["_atom_site_fract_x"]]),
                            _cif_number(r[idx["_atom_site_fract_y"]]),
                            _cif_number(r[idx["_atom_site_fract_z"]]),
                        )
                    )
            i = j
            continue
        i += 1

    required = [
        "_cell_length_a",
        "_cell_length_b",
        "_cell_length_c",
        "_cell_angle_alpha",
        "_cell_angle_beta",
        "_cell_angle_gamma",
    ]
    if not all(k in params for k in required) or not sites:
        raise ValueError(f"incomplete CIF: {path}")
    cell = cell_from_parameters(*(params[k] for k in required))
    if not symops:
        symops = ["x,y,z"]

    ops = [_parse_symop(op) for op in symops]
    frac_all, z_all = [], []
    for sym, fx, fy, fz in sites:
        z = symbol_to_z(sym)
        base = np.array([fx, fy, fz])
        for rot, trans in ops:
            pos = (rot @ base + trans) % 1.0
            frac_all.append(pos)
            z_all.append(z)
    frac = np.array(frac_all)
    z_arr = np.array(z_all, dtype=np.int64)

    # merge coincident images (periodic fractional metric)
    keep: list[int] = []
    for k in range(len(frac)):
        dup = False
        for m_ in keep:
            d = frac[k] - frac[m_]
            d -= np.round(d)
            if np.abs(d).max() < 1e-3 and z_arr[k] == z_arr[m_]:
                dup = True
                break
        if not dup:
            keep.append(k)
    frac = frac[keep]
    z_arr = z_arr[keep]
    coord = frac @ cell
    return {
        "coord": coord.astype(np.float32),
        "numbers": z_arr,
        "cell": cell.astype(np.float32),
        "frac": frac,
    }
