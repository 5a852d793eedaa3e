"""Ensemble MD in the port against the JAX package's driver (CPU).

Two random members and the narrow DSF model of
tests/test_torch_ensemble.py on a 24-atom 9 A box:
``MDDriver(..., ensemble=True)`` on the binned engine, fused and per member
(``AIMNET_ENSEMBLE_FUSED``), at NVE and Berendsen, against the JAX
driver's fused trajectory from the same injected velocities (its
Langevin noise comes from another generator, so Langevin agrees only in
distribution); the indexed engine, fused against per member; and the
refusal of members whose AEV constants disagree.  Tolerances: the smoke
run's ``CHECK_ABS``, per-step ``epot`` and ``epot_std`` 3e-5 eV, final
coordinates 1e-5 A.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system  # noqa: E402
from aimnetcentral_tpu.dynamics import MDConfig as JMDConfig  # noqa: E402
from aimnetcentral_tpu.dynamics import MDDriver as JMDDriver  # noqa: E402
from aimnetcentral_tpu_torch import constants  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system  # noqa: E402
from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver  # noqa: E402
from test_torch_ensemble import CPU, _box, _dsf, _members  # noqa: E402

MD_ABS = {"energy": 3e-5, "coord": 1e-5}  # chip_smoke.py's CHECK_ABS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NVE = dict(dt_fs=0.2, thermostat="nve", skin=0.5, precision="exact")
BERENDSEN = dict(dt_fs=0.2, thermostat="berendsen", temperature_K=200.0, berendsen_tau_fs=20.0, skin=0.5,
                 precision="exact")
MD_STEPS = 3


def _velocities(numbers: np.ndarray) -> np.ndarray:
    sigma = np.sqrt(constants.kB * 200.0 / constants.get_masses()[numbers])[:, None]
    return (sigma * np.random.default_rng(3).normal(size=(len(numbers), 3))).astype(np.float32)


def _inject(drv, v_compact: np.ndarray, to) -> None:
    atom_id = np.asarray(drv._state.atom_id)
    real = np.asarray(drv._state.system.numbers) > 0
    v = np.zeros((len(atom_id), 3), np.float32)
    v[real] = v_compact[atom_id[real]]
    drv._state = dataclasses.replace(drv._state, veloc=to(v))


@pytest.fixture(scope="module")
def md_setup():
    models = _members(_dsf, n_e=2)
    mol = _box(12, n=24, a=9.0, species=(1, 6, 8))
    return models, mol, j_system([mol], build_nbmat=False), t_system([mol], CPU)


@pytest.fixture(scope="module", params=["nve", "berendsen"])
def jax_md(md_setup, request):
    """The JAX driver's fused ensemble trajectory (one compile a thermostat)."""
    ((jp, jc), _t), mol, jsys, _tsys = md_setup
    md = NVE if request.param == "nve" else BERENDSEN
    drv = JMDDriver(jp, jc, jsys, JMDConfig(**md), ensemble=True, seed=3)
    _inject(drv, _velocities(mol["numbers"]), jnp.asarray)
    obs = drv.run(MD_STEPS, chunk=MD_STEPS)
    return request.param, md, obs, drv.snapshot()


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "per_member"])
def test_ensemble_md_matches_jax(md_setup, jax_md, fused, monkeypatch):
    """``MDDriver(..., ensemble=True)`` on the binned engine, fused and per
    member (``AIMNET_ENSEMBLE_FUSED``), NVE and Berendsen: per-step
    ``epot``, ``epot_std`` (3e-5 eV) and the final coordinates (1e-5 A)
    against JAX's fused trajectory from the same velocities."""
    ((_jp, _jc), (tp, tc)), mol, _jsys, tsys = md_setup
    _name, md, jobs, jsnap = jax_md
    monkeypatch.setenv("AIMNET_ENSEMBLE_FUSED", fused)
    drv = MDDriver(tp, tc, tsys, MDConfig(**md), ensemble=True, seed=3, device="cpu")
    assert drv.ensemble_fused == (fused == "1") and drv.engine == "binned"
    _inject(drv, _velocities(mol["numbers"]), torch.as_tensor)
    obs = drv.run(MD_STEPS, chunk=MD_STEPS)
    assert np.isfinite(obs["epot_std"]).all() and (obs["epot_std"] > 0).all()
    np.testing.assert_allclose(obs["epot"], jobs["epot"], atol=MD_ABS["energy"])
    np.testing.assert_allclose(obs["epot_std"], jobs["epot_std"], atol=MD_ABS["energy"])
    np.testing.assert_allclose(drv.snapshot()["coord"], jsnap["coord"], atol=MD_ABS["coord"])


def test_ensemble_md_indexed_engine(md_setup, monkeypatch):
    """The indexed engine (a gas-phase cut of the box) runs ensembles both
    ways, and the fused and per-member paths agree (3e-5 eV per step,
    1e-5 A)."""
    ((_jp, _jc), (tp, tc)), mol, _jsys, _tsys = md_setup
    gas = {"coord": mol["coord"][:20], "numbers": mol["numbers"][:20]}
    runs = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("AIMNET_ENSEMBLE_FUSED", fused)
        drv = MDDriver(tp, tc, t_system([gas], CPU), MDConfig(**NVE), ensemble=True, seed=3, device="cpu")
        assert drv.engine == "indexed"
        runs[fused] = (drv.run(4, chunk=4), drv.snapshot()["coord"])
    np.testing.assert_allclose(runs["1"][0]["epot"], runs["0"][0]["epot"], atol=MD_ABS["energy"])
    np.testing.assert_allclose(runs["1"][0]["epot_std"], runs["0"][0]["epot_std"], atol=MD_ABS["energy"])
    np.testing.assert_allclose(runs["1"][1], runs["0"][1], atol=MD_ABS["coord"])


def test_members_with_other_aev_constants_are_refused(md_setup, monkeypatch):
    """The fused path reads member 0's AEV constants for all: members that
    disagree are refused with JAX's ``ValueError``; the per-member path
    (``AIMNET_ENSEMBLE_FUSED=0``) takes them."""
    ((_jp, _jc), (tp, tc)), _mol, _jsys, tsys = md_setup
    odd = {**tp, "aev": {**tp["aev"], "eta_s": tp["aev"]["eta_s"] * torch.tensor([1.0, 1.5])}}
    monkeypatch.setenv("AIMNET_ENSEMBLE_FUSED", "1")
    with pytest.raises(ValueError, match="AEV constant 'eta_s'"):
        MDDriver(odd, tc, tsys, MDConfig(**NVE), ensemble=True, device="cpu")
    monkeypatch.setenv("AIMNET_ENSEMBLE_FUSED", "0")
    assert not MDDriver(odd, tc, tsys, MDConfig(**NVE), ensemble=True, device="cpu").ensemble_fused
