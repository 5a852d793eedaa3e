"""Self-atomic-energy (SAE) regression (counterpart of
aimnetcentral_tpu/train/sae.py), numpy only.

Per-element linear regression of molecular energies on element counts, with
2/98-percentile outlier trimming of per-atom energies before the final fit.
"""

from __future__ import annotations

import numpy as np

from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset


def calc_sae(
    ds: SizeGroupedDataset,
    key_energy: str = "energy",
    key_numbers: str = "numbers",
    trim_percentile: float = 2.0,
) -> dict[int, float]:
    """Returns {atomic_number: sae_energy}."""
    energies = ds.concatenate(key_energy).astype(np.float64)
    ntyp = int(max(g[key_numbers].max() for g in ds.groups)) + 1
    eye = np.eye(ntyp)
    counts = np.concatenate([eye[g[key_numbers]].sum(-2) for g in ds.groups]).astype(np.float64)

    sae = np.linalg.lstsq(counts, energies, rcond=None)[0]

    # trim outliers by per-atom residual and refit
    natoms = counts.sum(-1)
    resid_per_atom = (energies - counts @ sae) / np.maximum(natoms, 1)
    lo, hi = np.percentile(resid_per_atom, [trim_percentile, 100 - trim_percentile])
    keep = (resid_per_atom >= lo) & (resid_per_atom <= hi)
    if keep.sum() >= counts.shape[1]:
        sae = np.linalg.lstsq(counts[keep], energies[keep], rcond=None)[0]

    present = np.nonzero(counts.sum(0))[0]
    return {int(i): float(sae[i]) for i in present}
