"""Size-grouped dataset, sampler and batch assembly (counterpart of
aimnetcentral_tpu/data/sgdataset.py).

``DataGroup``, ``SizeGroupedDataset`` and ``SizeGroupedSampler`` keep the
JAX package's numpy logic as it is (h5 and ``???.npz``-directory loading,
rank sharding, ``random_split``, ``cv_split``, ``merge_groups``, per-atom
SAE shifts, the sampler's seeded shuffles, its ``molecules``/``atoms``
batch modes and ``batches_per_epoch`` cap), so the same seed gives the same
index sequences.  Batches are padded to one shape per size group (fixed
molecules a batch and atoms a molecule), as in the JAX package.  The two
batch builders return the port's ``System`` on a given device:
``make_batch_system_packed`` the molecule-bin layout
(``builders.system_molecule_bins``), on which training runs the conv and
pair kernels, and ``make_batch_system`` the flat all-pairs indexed layout.
``h5py`` is imported only to read or write an h5 file.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Iterator

import numpy as np
import torch

from aimnetcentral_tpu_torch.builders import system_molecule_bins
from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.ops.neighbors import allpairs_nbmat
from aimnetcentral_tpu_torch.system import System


class DataGroup:
    """Dict of same-length numpy arrays for one molecule size
    (reference aimnet/data/sgdataset.py:11-165)."""

    def __init__(self, data, keys=None, shard: tuple[int, int] | None = None):
        self._data: dict[str, np.ndarray] = {}
        if isinstance(data, str):
            with np.load(data) as z:
                items = {k: z[k] for k in (keys or z.files)}
        elif hasattr(data, "items"):  # dict or h5 group
            items = {
                k: np.asarray(v)
                for k, v in data.items()
                if keys is None or k in keys
            }
        else:
            raise TypeError(f"cannot build DataGroup from {type(data)}")
        sl = slice(shard[0], None, shard[1]) if shard else slice(None)
        lengths = set()
        for k, v in items.items():
            v = np.asarray(v)[sl]
            self._data[k] = v
            lengths.add(len(v))
        if len(lengths) > 1:
            raise ValueError(f"arrays have mismatched lengths: {lengths}")

    def __len__(self):
        return len(next(iter(self._data.values()))) if self._data else 0

    def __getitem__(self, k):
        return self._data[k]

    def __setitem__(self, k, v):
        self._data[k] = np.asarray(v)

    def __contains__(self, k):
        return k in self._data

    def keys(self):
        return set(self._data.keys())

    def items(self):
        return self._data.items()

    def sample(self, idx) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self._data.items()}

    def random_split(self, *fractions: float, seed=None) -> list["DataGroup"]:
        """Shuffled partition into ``len(fractions)+1`` groups; the last
        group holds the remainder when fractions sum to < 1
        (reference aimnet/data/sgdataset.py:105-114)."""
        if not (0 < sum(fractions) <= 1) or any(f <= 0 for f in fractions):
            raise ValueError(
                "fractions must be positive and sum to at most 1"
            )
        idx = np.random.default_rng(seed).permutation(len(self))
        cuts = np.round(np.cumsum(fractions) * len(self)).astype(np.int64)
        return [
            DataGroup(self.sample(part)) for part in np.array_split(idx, cuts)
        ]

    def cv_split(self, cv: int = 5, seed=None) -> list[tuple["DataGroup", "DataGroup"]]:
        """``cv`` (train, val) folds over a shuffled partition
        (reference aimnet/data/sgdataset.py:116-128)."""
        parts = self.random_split(*([1.0 / cv] * cv), seed=seed)[:cv]
        folds = []
        for i in range(cv):
            rest = [p for j, p in enumerate(parts) if j != i and len(p)]
            train = DataGroup(
                {
                    k: np.concatenate([p[k] for p in rest], axis=0)
                    for k in self.keys()
                }
            )
            folds.append((train, parts[i]))
        return folds


class SizeGroupedDataset:
    """Groups keyed by molecule size (reference aimnet/data/sgdataset.py:166-435)."""

    def __init__(
        self,
        data=None,
        keys: list[str] | None = None,
        shard: tuple[int, int] | None = None,
    ):
        self._data: dict[int, DataGroup] = {}
        self._meta: dict[str, Any] = {}
        if isinstance(data, str):
            if os.path.isdir(data):
                self.load_datadir(data, keys=keys, shard=shard)
            else:
                self.load_h5(data, keys=keys, shard=shard)
        elif isinstance(data, dict):
            for k, v in data.items():
                self[int(k)] = v if isinstance(v, DataGroup) else DataGroup(v, keys=keys)

    # -- loading ------------------------------------------------------------

    def load_datadir(self, path, keys=None, shard=None):
        for f in sorted(glob(os.path.join(path, "???.npz"))):
            self[int(os.path.basename(f)[:3])] = DataGroup(f, keys=keys, shard=shard)

    def load_h5(self, path, keys=None, shard=None):
        import h5py

        with h5py.File(path, "r") as f:
            for k, g in f.items():
                self[int(k)] = DataGroup(g, keys=keys, shard=shard)
            self._meta = dict(f.attrs)

    def save_h5(self, path):
        import h5py

        with h5py.File(path, "w") as f:
            for k, g in self.items():
                grp = f.create_group(f"{k:03d}")
                for key, v in g.items():
                    grp.create_dataset(key, data=v)

    # -- splitting ------------------------------------------------------------

    def random_split(self, *fractions: float, seed=None) -> list["SizeGroupedDataset"]:
        """Per-size-group shuffled partition (reference
        aimnet/data/sgdataset.py:265-274); empty splits drop the group.

        Returns exactly ``len(fractions)`` datasets — reference semantics,
        so ``train, val = ds.random_split(0.9, 0.1)`` unpacks — the
        remainder rows (when fractions sum to < 1) are discarded here
        (``DataGroup.random_split`` keeps them as a trailing group)."""
        split_groups = {k: g.random_split(*fractions, seed=seed) for k, g in self.items()}
        return [
            SizeGroupedDataset(
                {k: parts[i] for k, parts in split_groups.items() if len(parts[i])}
            )
            for i in range(len(fractions))
        ]

    def cv_split(self, cv: int = 5, seed=None) -> list[tuple["SizeGroupedDataset", "SizeGroupedDataset"]]:
        """(train, val) cross-validation folds (reference sgdataset.py:276-285)."""
        folds_by_group = {k: g.cv_split(cv, seed=seed) for k, g in self.items()}
        out = []
        for i in range(cv):
            train = SizeGroupedDataset(
                {k: f[i][0] for k, f in folds_by_group.items() if len(f[i][0])}
            )
            val = SizeGroupedDataset(
                {k: f[i][1] for k, f in folds_by_group.items() if len(f[i][1])}
            )
            out.append((train, val))
        return out

    # -- mapping protocol ---------------------------------------------------

    def __setitem__(self, k: int, v: DataGroup):
        self._data[k] = v

    def __getitem__(self, k: int) -> DataGroup:
        return self._data[k]

    def __len__(self):
        return sum(len(g) for g in self._data.values())

    def keys(self) -> list[int]:
        return sorted(self._data)

    def items(self):
        return [(k, self._data[k]) for k in self.keys()]

    @property
    def groups(self) -> list[DataGroup]:
        return [self._data[k] for k in self.keys()]

    def datakeys(self) -> set[str]:
        return next(iter(self._data.values())).keys() if self._data else set()

    def concatenate(self, key: str) -> np.ndarray:
        return np.concatenate([g[key] for g in self.groups])

    def apply(self, fn):
        for g in self.groups:
            fn(g)

    # -- transforms ---------------------------------------------------------

    def apply_peratom_shift(
        self, key_in="energy", key_out="energy", numbers_key="numbers", sap_dict=None
    ) -> dict[int, float]:
        """Subtract per-element linear-regression energies
        (reference aimnet/data/sgdataset.py:360-381)."""
        if sap_dict is None:
            e = self.concatenate(key_in)
            ntyp = int(max(g[numbers_key].max() for g in self.groups)) + 1
            eye = np.eye(ntyp)
            counts = np.concatenate(
                [eye[g[numbers_key]].sum(-2) for g in self.groups]
            )
            sap = np.linalg.lstsq(counts, e, rcond=None)[0]
            present = np.nonzero(counts.sum(0))[0]
        else:
            ntyp = max(sap_dict) + 1
            sap = np.full(ntyp, np.nan)
            for k, v in sap_dict.items():
                sap[k] = v
            present = list(sap_dict)

        def fn(g):
            g[key_out] = g[key_in] - sap[g[numbers_key]].sum(axis=-1)

        self.apply(fn)
        return {int(i): float(sap[i]) for i in present}

    def merge_groups(self, max_groups: int | None = None, atom_pad: int = 0):
        """Coarsen size groups by zero-padding to fewer bucket sizes
        (reference aimnet/data/sgdataset.py:309-351) — fewer jit shapes."""
        if max_groups is None or len(self._data) <= max_groups:
            return self
        sizes = self.keys()
        buckets = np.array_split(np.asarray(sizes), max_groups)
        merged: dict[int, dict[str, np.ndarray]] = {}
        for bucket in buckets:
            if len(bucket) == 0:
                continue
            target = int(bucket.max()) + atom_pad
            parts: dict[str, list[np.ndarray]] = {}
            for size in bucket:
                g = self._data[int(size)]
                pad_n = target - int(size)
                for k, v in g.items():
                    if v.ndim >= 2 and v.shape[1] == size:
                        pad_width = [(0, 0), (0, pad_n)] + [(0, 0)] * (v.ndim - 2)
                        v = np.pad(v, pad_width)
                    parts.setdefault(k, []).append(v)
            merged[target] = {k: np.concatenate(vs) for k, vs in parts.items()}
        self._data = {k: DataGroup(v) for k, v in merged.items()}
        return self

    # -- batch assembly -----------------------------------------------------

    def make_batch_system_packed(
        self, size: int, sample: dict[str, np.ndarray], pad_mols: int | None = None,
        device: str | torch.device = "cuda",
    ) -> tuple[System, dict[str, torch.Tensor]]:
        """Molecule-bin twin of :meth:`make_batch_system`.

        Builds the "one molecule per bin" binned layout
        (builders.system_molecule_bins): molecule-major rows padded to
        capacity C = size rounded up to a multiple of 8.  Labels come in the
        same slot layout (forces (pad_mols*C, 3), charges (pad_mols*C,),
        energy (pad_mols,)), as float32 tensors on ``device``.
        """
        dev = resolve_device(device)
        b = len(sample["numbers"])
        pad_mols = pad_mols or b
        c = max(8, int(np.ceil(size / 8)) * 8)

        mols = []
        for i in range(b):
            m = {"coord": sample["coord"][i], "numbers": sample["numbers"][i]}
            if "charge" in sample:
                m["charge"] = float(sample["charge"][i])
            if "mult" in sample:
                m["mult"] = float(sample["mult"][i])
            mols.append(m)
        system = system_molecule_bins(mols, dev, capacity=c, pad_mols=pad_mols)

        def slot_atoms(x):
            out = np.zeros((pad_mols * c,) + x.shape[2:], dtype=x.dtype)
            view = out[: b * c].reshape((b, c) + x.shape[2:])
            view[:, :size] = x
            return out

        labels: dict[str, np.ndarray] = {}
        if "energy" in sample:
            e = np.zeros(pad_mols, dtype=np.float32)
            e[:b] = sample["energy"].astype(np.float32)
            labels["energy"] = e
        if "forces" in sample:
            labels["forces"] = slot_atoms(sample["forces"].astype(np.float32))
        if "charges" in sample:
            labels["charges"] = slot_atoms(sample["charges"].astype(np.float32))
        return system, {k: torch.as_tensor(v, device=dev) for k, v in labels.items()}

    def make_batch_system(
        self, size: int, sample: dict[str, np.ndarray], pad_mols: int | None = None,
        device: str | torch.device = "cuda",
    ) -> tuple[System, dict[str, torch.Tensor]]:
        """A flat indexed System and its labels from a group sample.

        Static shapes: ``pad_mols`` molecules of ``size`` atoms + 1 trailing
        pad row, with the all-pairs neighbor matrix.  Labels come in the SAME
        flat layout (forces (N_pad, 3), charges (N_pad,), energy
        (pad_mols,)), as float32 tensors on ``device``.
        """
        dev = resolve_device(device)
        b = len(sample["numbers"])
        pad_mols = pad_mols or b
        n_pad = pad_mols * size + 1

        def flat_atoms(x, fill=0.0):
            out = np.full((n_pad,) + x.shape[2:], fill, dtype=x.dtype)
            out[: b * size] = x.reshape((b * size,) + x.shape[2:])
            return out

        numbers = flat_atoms(sample["numbers"].astype(np.int64))
        coord = flat_atoms(sample["coord"].astype(np.float32), fill=1.0)
        mol_idx = np.full(n_pad, pad_mols, dtype=np.int64)
        mol_idx[: b * size] = np.repeat(np.arange(b, dtype=np.int64), size)
        # padded atoms inside real molecules keep their molecule id (masked
        # contributions), padded molecules go to the trash segment
        mol_sizes = [size] * b
        nbmat = allpairs_nbmat(mol_sizes + [size] * (pad_mols - b), n_pad)

        charge = np.zeros(pad_mols, dtype=np.float32)
        if "charge" in sample:
            charge[:b] = sample["charge"].astype(np.float32)
        mult = None
        if "mult" in sample:
            mult = np.ones(pad_mols, dtype=np.float32)
            mult[:b] = sample["mult"].astype(np.float32)

        system = System(
            coord=torch.as_tensor(coord, device=dev),
            numbers=torch.as_tensor(numbers, device=dev),
            charge=torch.as_tensor(charge, device=dev),
            mol_idx=torch.as_tensor(mol_idx, device=dev),
            nbmat=torch.as_tensor(nbmat.astype(np.int64), device=dev),
            mult=torch.as_tensor(mult, device=dev) if mult is not None else None,
        )

        labels: dict[str, np.ndarray] = {}
        if "energy" in sample:
            e = np.zeros(pad_mols, dtype=np.float32)
            e[:b] = sample["energy"].astype(np.float32)
            labels["energy"] = e
        if "forces" in sample:
            labels["forces"] = flat_atoms(sample["forces"].astype(np.float32))
        if "charges" in sample:
            labels["charges"] = flat_atoms(sample["charges"].astype(np.float32))
        return system, {k: torch.as_tensor(v, device=dev) for k, v in labels.items()}


class SizeGroupedSampler:
    """Batch sampler (reference aimnet/data/sgdataset.py:437-496)."""

    def __init__(
        self,
        ds: SizeGroupedDataset,
        batch_size: int,
        batch_mode: str = "molecules",
        shuffle: bool = False,
        batches_per_epoch: int = -1,
        seed: int | None = None,
    ):
        if batch_mode not in ("molecules", "atoms"):
            raise ValueError(f"unknown batch_mode {batch_mode}")
        self.ds = ds
        self.batch_size = batch_size
        self.batch_mode = batch_mode
        self.shuffle = shuffle
        self.batches_per_epoch = batches_per_epoch
        self.seed = seed
        self._epoch = 0

    def mols_per_batch(self, size: int) -> int:
        if self.batch_mode == "molecules":
            return self.batch_size
        return max(1, self.batch_size // size)

    def _num_batches(self, size: int, g: DataGroup) -> int:
        return int(np.ceil(len(g) / self.mols_per_batch(size)))

    def __len__(self):
        if self.batches_per_epoch > 0:
            return self.batches_per_epoch
        return sum(self._num_batches(k, g) for k, g in self.ds.items())

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        rng = np.random.default_rng(
            None if self.seed is None else self.seed + self._epoch
        )
        self._epoch += 1
        samples: list[tuple[int, np.ndarray]] = []
        for size, g in self.ds.items():
            n = len(g)
            if n == 0:
                continue
            idx = np.arange(n)
            if self.shuffle:
                rng.shuffle(idx)
            nb = min(n, self._num_batches(size, g))
            samples.extend(
                (size, part) for part in np.array_split(idx, nb) if len(part)
            )
        if self.shuffle:
            rng.shuffle(samples)
        if self.batches_per_epoch > 0:
            if len(samples) > self.batches_per_epoch:
                samples = samples[: self.batches_per_epoch]
            elif samples:
                extra = self.batches_per_epoch - len(samples)
                samples.extend(
                    samples[i] for i in rng.choice(len(samples), extra, replace=True)
                )
        return iter(samples)
