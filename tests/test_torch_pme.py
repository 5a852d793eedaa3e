"""The port's particle-mesh Ewald (models/pme.py) against the JAX package
and against the port's own Ewald (CPU).

- B-spline weights, the deconvolution moduli and the mesh estimate equal
  JAX's.
- ``pme_energy`` of one system, the batched reciprocal energy and the
  charge spread against JAX's, with coordinate and cell gradients.
- PME against Ewald within ``2e-3 max(1, |E|)``, the tolerance of JAX's
  tests/test_pme.py, neutral and charged.
- ``AIMNet2Calculator`` with ``set_lrcoulomb_method("pme")`` on the binned
  layout, the indexed layout and a batch of two cells, against JAX's
  calculator (energy 1e-5 relative with a floor of 1e-5 eV, forces 1e-4
  eV/A, stress 1e-6 eV/A^3).
- The spread accumulates deterministically: two calls agree bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu import builders as jbuilders  # noqa: E402
from aimnetcentral_tpu.models import ewald as jewald  # noqa: E402
from aimnetcentral_tpu.models import pme as jpme  # noqa: E402
from aimnetcentral_tpu_torch import builders as tbuilders  # noqa: E402
from aimnetcentral_tpu_torch.models import ewald as tewald  # noqa: E402
from aimnetcentral_tpu_torch.models import pme as tpme  # noqa: E402
from test_torch_calculator import _box  # noqa: E402
from test_torch_ewald import _batch, _calcs, _compare, _energy_close, _rel_close, jax_fns, models  # noqa: E402, F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_splines_moduli_and_mesh_match_jax():
    u = np.random.default_rng(0).uniform(0.0, 1.0, size=(50, 3)).astype(np.float32)
    _rel_close(tpme.bspline4_weights(torch.tensor(u)).numpy(), np.asarray(jpme.bspline4_weights(jnp.asarray(u))), 1e-7)
    for k in (8, 9, 15, 24, 25, 50):
        np.testing.assert_array_equal(tpme._bspline_moduli(k), jpme._bspline_moduli(k))
    cells = [np.eye(3) * 12.0, np.diag([23.7, 30.1, 48.07]),
             np.array([[11.0, 0, 0], [2.0, 12.0, 0], [1.0, -1.5, 10.0]])]
    for cell in cells:
        for acc in (1e-5, 1e-6, 1e-8):
            assert tpme.estimate_pme_mesh(cell, acc) == jpme.estimate_pme_mesh(cell, acc)


def _charges(n: int, charged: bool, seed: int = 3) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 0.4
    return q if charged else q - q.mean()


@pytest.mark.parametrize("charged", [False, True])
def test_pme_energy_matches_jax_and_ewald(charged):
    """One 20-atom box at accuracy 1e-7 (JAX's tests/test_pme.py): the
    port's PME against JAX's PME (with coordinate and cell gradients) and
    against the port's Ewald."""
    n, a, acc = 20, 9.0, 1e-7
    rng = np.random.default_rng(1)
    mol = {"coord": rng.uniform(0, a, size=(n, 3)).astype(np.float32), "numbers": np.full(n, 6),
           "cell": np.eye(3, dtype=np.float32) * a}
    p = tewald.estimate_ewald_parameters(mol["cell"], n, acc)
    mesh = tpme.estimate_pme_mesh(mol["cell"], acc)
    tsys = tewald.attach_ewald(
        tbuilders.system_from_molecules([mol], CPU, n_pad=32, cutoff=4.0, lr_cutoff=p.r_cutoff, build_nbmat=True), acc
    )
    qp = np.zeros(32, np.float32)
    qp[:n] = _charges(n, charged)
    q = torch.tensor(qp)
    e_ewald = float(tewald.coulomb_periodic({"charges": q}, tsys)[0])

    def t_pme(coord, cell):
        s = tsys.replace(coord=coord, cell=cell[None])
        _eb, _rb, eta_at, rcut_at = tewald._param_views(s.ewald_eta, s.ewald_r_cutoff, 1, s.mol_idx, coord.dtype)
        e_real = tewald._real_erfc_st(coord, q[:, None], s.cell, s.mol_idx, 1, s.nbmat_lr, s.shifts_lr,
                                      eta_at, rcut_at)[0, 0]
        return tpme.pme_energy(coord, q, cell, s.numbers, s.ewald_eta[0], mesh, e_real)

    def j_recip(coord, cell):
        return jpme.pme_reciprocal_energy(coord, jnp.asarray(qp), cell, jnp.float32(p.eta), mesh)

    coord, cell = tsys.coord.clone().requires_grad_(True), tsys.cell[0].clone().requires_grad_(True)
    e_pme = t_pme(coord, cell)
    assert float(e_pme.detach()) == pytest.approx(e_ewald, abs=2e-3 * max(1.0, abs(e_ewald)))
    # the reciprocal part alone against JAX's, with its gradients
    jc, jcell = jnp.asarray(tsys.coord.numpy()), jnp.asarray(tsys.cell[0].numpy())
    je = j_recip(jc, jcell)
    jg = jax.jit(jax.grad(j_recip, argnums=(0, 1)))(jc, jcell)
    te = tpme.pme_reciprocal_energy(coord, q, cell, torch.tensor(np.float32(p.eta)), mesh)
    tg = torch.autograd.grad(te, (coord, cell))
    _energy_close(te.detach().numpy(), je)
    for t, j in zip(tg, jg):
        _rel_close(t.numpy(), np.asarray(j))


def test_batched_spread_and_energy_match_jax():
    """Two cells on one shared mesh: the spread meshes and the batched
    reciprocal energies (E = 1 and E = 2 members) against JAX's."""
    mols = _batch()
    jsys = jewald.attach_ewald(jbuilders.system_from_molecules(mols, cutoff=5.0, n_pad=80), 1e-6, pme=True)
    tsys = tewald.attach_ewald(tbuilders.system_from_molecules(mols, CPU, n_pad=80), 1e-6, pme=True)
    rng = np.random.default_rng(2)
    q2 = np.zeros((80, 2), np.float32)
    q2[:70] = rng.normal(size=(70, 2)) * 0.4
    cells_t, cells_j = tsys.cell, jsys.cell
    inv_t = tpme._inverse_cells_at(cells_t, tsys.mol_idx)
    inv_j = jnp.take(jnp.concatenate([jnp.linalg.inv(cells_j), jnp.eye(3)[None]], 0), jsys.mol_idx, axis=0)
    rho_t = tpme.pme_spread_charges(tsys.coord, torch.tensor(q2[:, 0]), inv_t, tsys.mol_idx, 2, tsys.pme_mesh)
    rho_j = jpme.pme_spread_charges(jsys.coord, jnp.asarray(q2[:, 0]), inv_j, jsys.mol_idx, 2, jsys.pme_mesh)
    _rel_close(rho_t.numpy(), np.asarray(rho_j), 1e-6)
    args_t = (tsys.coord, torch.tensor(q2), cells_t, tsys.mol_idx, 2, tsys.ewald_eta, tsys.pme_mesh)
    args_j = (jsys.coord, jnp.asarray(q2), cells_j, jsys.mol_idx, 2, jsys.ewald_eta, jsys.pme_mesh)
    _energy_close(tpme.pme_reciprocal_energy_batched_multi(*args_t).numpy(),
                  jpme.pme_reciprocal_energy_batched_multi(*args_j))
    args_t1 = (tsys.coord, torch.tensor(q2[:, 1]), cells_t, tsys.mol_idx, 2, tsys.ewald_eta, tsys.pme_mesh)
    args_j1 = (jsys.coord, jnp.asarray(q2[:, 1]), cells_j, jsys.mol_idx, 2, jsys.ewald_eta, jsys.pme_mesh)
    _energy_close(tpme.pme_reciprocal_energy_batched(*args_t1).numpy(), jpme.pme_reciprocal_energy_batched(*args_j1))
    # a deterministic accumulation: a second spread is the same bits
    again = tpme.pme_spread_charges(tsys.coord, torch.tensor(q2[:, 0]), inv_t, tsys.mol_idx, 2, tsys.pme_mesh)
    assert torch.equal(again, rho_t)


PME_INPUTS = {
    "binned": (lambda: _box(), 0, "binned"),
    "binned-charged": (lambda: {**_box(), "charge": 1.0}, 0, "binned"),
    "indexed": (lambda: _box(), 1024, "indexed"),
    "batch": (_batch, 1024, "indexed"),
}


@pytest.mark.parametrize("name", list(PME_INPUTS))
def test_calculator_pme_matches_jax(models, jax_fns, name):
    make, threshold, kind = PME_INPUTS[name]
    data = make()
    jcalc, tcalc = _calcs(models, jax_fns, "pme", threshold)
    stress = name != "batch"
    ref = jcalc.eval(data, forces=True, stress=stress)
    got = tcalc.eval(data, forces=True, stress=stress)
    _compare(got, ref, ("energy", "forces") + (("stress",) if stress else ()))
    assert tcalc._prep_cache["kind"] == kind and tcalc._prep_cache["system"].pme_mesh is not None


def test_calculator_pme_agrees_with_ewald(models, jax_fns):
    """The whole model's energy with PME against Ewald, both layouts."""
    for threshold in (0, 1024):
        _j, pme = _calcs(models, jax_fns, "pme", threshold)
        _j, ewald = _calcs(models, jax_fns, "ewald", threshold)
        e_p, e_e = pme.eval(_box())["energy"][0], ewald.eval(_box())["energy"][0]
        assert e_p == pytest.approx(e_e, abs=2e-3 * max(1.0, abs(e_e)))
