"""The port's dataset, sampler and batch builders against the JAX
package's (CPU).

JAX's dataset and sampler tests (tests/test_train.py: the sampler's shapes
and modes, the batch layout, SAE regression, ``merge_groups``, sharding,
the ``batches_per_epoch`` cap, seeded shuffles, empty groups,
``random_split``, ``cv_split``, the h5 round trip) run on both packages
from the same numpy data: the index sequences are equal, the groups' arrays
equal, and the batch Systems (molecule bins and indexed) equal field for
field, labels included.
"""

import numpy as np
import pytest

pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.data.sgdataset import DataGroup as JGroup  # noqa: E402
from aimnetcentral_tpu.data.sgdataset import SizeGroupedDataset as JDataset  # noqa: E402
from aimnetcentral_tpu.data.sgdataset import SizeGroupedSampler as JSampler  # noqa: E402
from aimnetcentral_tpu.train.sae import calc_sae as j_calc_sae  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import DataGroup as TGroup  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset as TDataset  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedSampler as TSampler  # noqa: E402
from aimnetcentral_tpu_torch.train.sae import calc_sae as t_calc_sae  # noqa: E402
from test_train import _synthetic_ds  # noqa: E402


def _both(seed=0, **kw):
    """The synthetic dataset of JAX's tests in both packages (same arrays)."""
    j = _synthetic_ds(np.random.default_rng(seed), **kw)
    t = TDataset({k: {key: v.copy() for key, v in g.items()} for k, g in j.items()})
    return j, t


def _epoch(sampler):
    return [(size, tuple(int(i) for i in idx)) for size, idx in sampler]


def _same_dataset(j, t):
    assert j.keys() == t.keys()
    for k in j.keys():
        assert j[k].keys() == t[k].keys()
        for key in j[k].keys():
            np.testing.assert_array_equal(t[k][key], j[k][key], err_msg=f"{k}/{key}")


SAMPLERS = {
    "molecules": dict(batch_size=8),
    "shuffled": dict(batch_size=8, shuffle=True, seed=0),
    "atoms": dict(batch_size=24, batch_mode="atoms"),
    "atoms-shuffled": dict(batch_size=12, batch_mode="atoms", shuffle=True, seed=5),
    "capped": dict(batch_size=8, batches_per_epoch=4, seed=1),
    "filled": dict(batch_size=8, batches_per_epoch=11, seed=1),
    "filled-shuffled": dict(batch_size=8, batches_per_epoch=11, shuffle=True, seed=7),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_index_sequences_match_jax(name):
    """Two epochs of each sampler: the same (size, indices) sequence, the
    same length, epochs reshuffled alike."""
    j, t = _both()
    js, ts = JSampler(j, **SAMPLERS[name]), TSampler(t, **SAMPLERS[name])
    assert len(ts) == len(js)
    first = _epoch(ts)
    assert first == _epoch(js)
    assert _epoch(ts) == _epoch(js)
    assert len(first) == len(ts)


def test_sampler_modes_and_checks():
    """JAX's sampler tests on the port: shapes, the atoms budget, the
    refused mode, an empty-ish group, seeded and epoch-varying shuffles."""
    _j, t = _both()
    batches = list(TSampler(t, batch_size=8, shuffle=True, seed=0))
    assert {s for s, _ in batches} == {4, 6}
    for size, idx in TSampler(t, batch_size=12, batch_mode="atoms"):
        assert len(idx) * size <= 12 or len(idx) == 1
    with pytest.raises(ValueError, match="batch_mode"):
        TSampler(t, batch_size=8, batch_mode="bogus")
    _j, small = _both(sizes=(4,), n_per=3)
    only = list(TSampler(small, batch_size=8))
    assert len(only) == 1 and len(only[0][1]) == 3
    a, b = TSampler(t, batch_size=8, shuffle=True, seed=7), TSampler(t, batch_size=8, shuffle=True, seed=7)
    e1, e2 = _epoch(a), _epoch(a)
    assert _epoch(b) == e1 and e1 != e2


@pytest.mark.parametrize("layout", ["packed", "indexed"])
@pytest.mark.parametrize("pad", [0, 3])
def test_batch_systems_match_jax(layout, pad):
    """A group sample's System and labels equal JAX's field for field
    (charge, mult, forces and charges labels; padding molecules)."""
    j, t = _both()
    rng = np.random.default_rng(4)
    for ds in (j, t):
        g = ds[6]
        n = len(g)
        g["forces"] = np.asarray(rng.normal(size=(n, 6, 3)), np.float32) if ds is j else j[6]["forces"]
        g["charges"] = np.asarray(rng.normal(size=(n, 6)), np.float32) if ds is j else j[6]["charges"]
        g["mult"] = np.where(np.arange(n) % 2, 2.0, 1.0).astype(np.float32) if ds is j else j[6]["mult"]
        g["charge"] = np.where(np.arange(n) % 3, 0.0, 1.0).astype(np.float32) if ds is j else j[6]["charge"]
    idx = np.array([5, 0, 17, 3, 9])
    name = "make_batch_system_packed" if layout == "packed" else "make_batch_system"
    js, jl = getattr(j, name)(6, j[6].sample(idx), pad_mols=len(idx) + pad)
    ts, tl = getattr(t, name)(6, t[6].sample(idx), pad_mols=len(idx) + pad, device="cpu")
    fields = ["coord", "numbers", "charge", "mol_idx", "mult"] + (["nbmat"] if layout == "indexed" else [])
    for f in fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    if layout == "packed":
        for f in ("nbins", "capacity", "periodic", "molecule_bins"):
            assert getattr(ts.bins, f) == getattr(js.bins, f), f
        assert ts.species == js.species
    else:
        assert ts.bins is None and js.bins is None
    assert set(tl) == set(jl) == {"energy", "forces", "charges"}
    for k in jl:
        assert tl[k].dtype == ts.coord.dtype
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)


def test_batch_system_layout():
    _j, t = _both()
    system, labels = t.make_batch_system(4, t[4].sample(np.arange(5)), pad_mols=8, device="cpu")
    assert system.coord.shape == (8 * 4 + 1, 3)
    assert system.num_mol == 8
    assert labels["energy"].shape == (8,)
    assert int(system.numbers[-1]) == 0
    assert int(system.mol_idx[-1]) == 8


def test_merge_groups_match_jax():
    j, t = _both(sizes=(4, 5, 6, 7), n_per=10)
    j.merge_groups(max_groups=2)
    t.merge_groups(max_groups=2)
    assert len(t.keys()) == 2 and len(t) == 40
    _same_dataset(j, t)


def test_sharding_matches_jax():
    rng = np.random.default_rng(0)
    group = {"coord": rng.normal(size=(10, 5, 3)).astype(np.float32), "numbers": np.full((10, 5), 6),
             "energy": np.arange(10, dtype=np.float32)}
    for shard in ((0, 2), (1, 2), (2, 3)):
        np.testing.assert_array_equal(TGroup(group, shard=shard)["energy"], JGroup(group, shard=shard)["energy"])
    np.testing.assert_array_equal(TGroup(group, shard=(1, 2))["energy"], [1, 3, 5, 7, 9])


def test_splits_match_jax():
    """``random_split`` (both fraction cases) and ``cv_split``: the same
    rows in the same order, per seed; invalid fractions refused alike."""
    rng = np.random.default_rng(0)
    groups = {
        4: {"coord": rng.normal(size=(40, 4, 3)).astype(np.float32), "numbers": np.full((40, 4), 6),
            "energy": rng.normal(size=40)},
        6: {"coord": rng.normal(size=(20, 6, 3)).astype(np.float32), "numbers": np.full((20, 6), 6),
            "energy": rng.normal(size=20)},
    }
    j, t = JDataset(groups), TDataset(groups)
    for fractions, seed in (((0.5, 0.25), 1), ((0.9, 0.1), 2)):
        for jp, tp in zip(j.random_split(*fractions, seed=seed), t.random_split(*fractions, seed=seed)):
            _same_dataset(jp, tp)
    for (jt, jv), (tt, tv) in zip(j.cv_split(cv=5, seed=2), t.cv_split(cv=5, seed=2)):
        _same_dataset(jt, tt)
        _same_dataset(jv, tv)
    for bad in ((0.9, 0.3), (-0.1, 0.5)):
        with pytest.raises(ValueError):
            t.random_split(*bad)


def test_peratom_shift_and_sae_match_jax():
    """``apply_peratom_shift`` (fitted and given) and ``calc_sae`` give
    JAX's dictionaries and shifted energies."""
    j, t = _both(sizes=(5,), n_per=60)
    assert t_calc_sae(t) == pytest.approx(j_calc_sae(j), rel=1e-12)
    sae = t_calc_sae(t)
    for z in (1, 6, 8):
        assert sae[z] == pytest.approx(0.1 * z, abs=0.5)
    js, ts = j.apply_peratom_shift(), t.apply_peratom_shift()
    assert ts == pytest.approx(js, rel=1e-12)
    _same_dataset(j, t)
    j2, t2 = _both(seed=1)
    given = {1: -0.5, 6: -37.8, 8: -75.0}
    assert t2.apply_peratom_shift(sap_dict=given) == j2.apply_peratom_shift(sap_dict=given)
    _same_dataset(j2, t2)


def test_npz_dir_and_h5_load_as_jax(tmp_path):
    """A ``???.npz`` directory loads into the same groups in both packages;
    the h5 round trip (``save_h5`` / load, key subsetting) as JAX's test."""
    j, t = _both()
    for size, g in j.items():
        np.savez(tmp_path / f"{size:03d}.npz", **dict(g.items()))
    _same_dataset(JDataset(str(tmp_path)), TDataset(str(tmp_path)))
    pytest.importorskip("h5py")
    rng = np.random.default_rng(2)
    ds = TDataset({3: {"coord": rng.normal(size=(7, 3, 3)).astype(np.float32), "numbers": np.full((7, 3), 8),
                       "energy": rng.normal(size=7)}})
    path = str(tmp_path / "ds.h5")
    ds.save_h5(path)
    back = TDataset(path)
    assert back.keys() == [3]
    _same_dataset(JDataset(path), back)
    np.testing.assert_allclose(back[3]["energy"], ds[3]["energy"])
    assert TDataset(path, keys=["energy", "numbers"]).datakeys() == {"energy", "numbers"}
