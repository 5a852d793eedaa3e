"""Extended-XYZ trajectory writing/reading for the MD driver (the port's own
copy of aimnetcentral_tpu/dynamics/trajectory.py; numpy only, same text).

Frames are emitted host-side at chunk boundaries (``MDDriver.run(traj=...)``)
in the caller's atom order (``MDState.atom_id`` undoes the slot permutation).

Format: standard extxyz — natoms line, a ``key=value`` comment line with
``Lattice`` and ``Properties=species:S:1:pos:R:3``, then one
``symbol x y z`` row per atom.  Readable by ASE/OVITO/MDAnalysis.
"""

from __future__ import annotations

import numpy as np

_SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn "
    "Fe Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd "
    "In Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu "
    "Hf Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn"
).split()


class TrajectoryWriter:
    """Append-mode extxyz writer; use as a context manager or call
    ``close()`` explicitly."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self._fh = open(path, "a" if append else "w")
        self.frames_written = 0

    def write(
        self,
        numbers: np.ndarray,
        coord: np.ndarray,
        cell: np.ndarray | None = None,
        comment: dict | None = None,
    ) -> None:
        numbers = np.asarray(numbers).reshape(-1)
        coord = np.asarray(coord, dtype=np.float64).reshape(-1, 3)
        fields = []
        if cell is not None:
            flat = " ".join(f"{v:.8f}" for v in np.asarray(cell, np.float64).ravel())
            fields.append(f'Lattice="{flat}" pbc="T T T"')
        fields.append("Properties=species:S:1:pos:R:3")
        for k, v in (comment or {}).items():
            fields.append(f"{k}={v}")
        lines = [str(len(numbers)), " ".join(fields)]
        for z, (x, y, zz) in zip(numbers, coord):
            lines.append(f"{_SYMBOLS[int(z)]} {x:.8f} {y:.8f} {zz:.8f}")
        self._fh.write("\n".join(lines) + "\n")
        self._fh.flush()
        self.frames_written += 1

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


def read_frames(path: str) -> list[dict]:
    """Parse an extxyz file back into frames (numbers, coord, cell?, the
    comment key=values as strings) — for tests and quick analysis."""
    sym_to_z = {s: z for z, s in enumerate(_SYMBOLS)}
    frames = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i])
        comment = lines[i + 1]
        numbers = np.zeros(n, np.int32)
        coord = np.zeros((n, 3), np.float64)
        for j in range(n):
            parts = lines[i + 2 + j].split()
            numbers[j] = sym_to_z[parts[0]]
            coord[j] = [float(p) for p in parts[1:4]]
        frame: dict = {"numbers": numbers, "coord": coord}
        if 'Lattice="' in comment:
            lat = comment.split('Lattice="', 1)[1].split('"', 1)[0]
            frame["cell"] = np.fromstring(lat, sep=" ").reshape(3, 3)
        for tok in comment.replace('pbc="T T T"', "").split():
            if "=" in tok and not tok.startswith(("Lattice", "Properties")):
                k, v = tok.split("=", 1)
                frame[k] = v
        frames.append(frame)
        i += 2 + n
    return frames
