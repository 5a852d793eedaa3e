"""The port's spatial decomposition with long-range heads against the JAX
package's single-device forward on the CPU, on JAX tests/test_spatial.py's
300-atom boxes (6 x-planes): Ewald + DFT-D3 (a halo of three planes, the
D3 cutoff's) on a gloo ring of 2 ranks and on the 2 x 2 torus, PME on the
ring.  Also: the D3 energy term's extras at the radius-3 stencil of one
extended grid fit kernels D and E."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu_torch.kernels import pair_sweep as ps  # noqa: E402
from aimnetcentral_tpu_torch.models.engine_binned import _half_tables  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from torch_spatial_helpers import (  # noqa: E402
    E_TOL,
    World,
    assert_cell_grad,
    assert_forces,
    binned_pair,
    jax_reference,
    lattice_box,
    model,
    narrow_config,
)
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)


@pytest.fixture(scope="module")
def case():
    d3 = (("dftd3", jheads.DFTD3Head(s8=1.2, a1=0.4, a2=4.8, cutoff=15.0)),)
    ewald = narrow_config(jheads.LRCoulombHead(rc=4.6, method="ewald", ewald_accuracy=1e-2), d3)
    pme = narrow_config(jheads.LRCoulombHead(rc=4.6, method="pme", ewald_accuracy=1e-2))
    box = lattice_box(300, 33.0, 0.5, seed=7)
    jsys, tsys = binned_pair(box, 5.4, 3.0, ewald_accuracy=1e-2)
    assert jsys.bins.nbins[0] == 6
    pbox = lattice_box(300, 33.0, 0.4, seed=9, elements=(1, 6, 8), p=None)
    jpme, tpme = binned_pair(pbox, 5.4, 3.0, ewald_accuracy=1e-2, pme=True)
    assert tpme.pme_mesh is not None and tpme.pme_mesh == jpme.pme_mesh
    return {"jsys": jsys, "tsys": tsys, "jpme": jpme, "tpme": tpme, "ewald": model(ewald, 1), "pme": model(pme, 4)}


@pytest.fixture(scope="module")
def runs(case):
    """Both worlds run while JAX computes its references."""
    _jc, _jp, tc, tp = case["ewald"]
    w2 = World(2, [
        ("ewald", "energy", dict(system=case["tsys"], cfg=tc, params=tp, n_sp=2)),
        ("pme", "energy", dict(system=case["tpme"], cfg=case["pme"][2], params=case["pme"][3], n_sp=2)),
    ])
    w4 = World(4, [("torus", "energy", dict(system=case["tsys"], cfg=tc, params=tp, n_sp=2, n_spy=2))])
    refs = {"ewald": jax_reference(case["ewald"][0], case["ewald"][1], case["jsys"])[0],
            "pme": jax_reference(case["pme"][0], case["pme"][1], case["jpme"])[0]}
    return refs, w2.results(), w4.results()


def test_ring_ewald_d3_matches_jax(case, runs):
    refs, r2, _r4 = runs
    out = r2[0]["ewald"]
    assert out["halo"] == 3 and tuple(out["ext_nbins"]) == (9, 6, 6)
    np.testing.assert_allclose(float(out["energy"][0]), refs["ewald"]["energy"], **E_TOL)
    assert_forces(out["forces"], refs["ewald"]["grad"], case["tsys"].numbers)
    assert_cell_grad(out["cell_grad"], refs["ewald"]["cell_grad"])
    np.testing.assert_array_equal(r2[1]["ewald"]["forces"], out["forces"])


def test_ring_pme_matches_jax(case, runs):
    refs, r2, _r4 = runs
    out = r2[0]["pme"]
    np.testing.assert_allclose(float(out["energy"][0]), refs["pme"]["energy"], **E_TOL)
    assert_forces(out["forces"], refs["pme"]["grad"], case["tpme"].numbers)


def test_torus_ewald_d3_matches_jax(case, runs):
    refs, _r2, r4 = runs
    out = r4[0]["torus"]
    assert tuple(out["ext_nbins"]) == (9, 9, 6)
    np.testing.assert_allclose(float(out["energy"][0]), refs["ewald"]["energy"], **E_TOL)
    assert_forces(out["forces"], refs["ewald"]["grad"], case["tsys"].numbers)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(r4[r]["torus"]["forces"], out["forces"])


def test_d3_extras_fit_radius_three_stencil():
    """JAX sweeps every term of a shard on its one extended grid at the
    largest cutoff's radius; at 15 A over 5 A bins that is radius 3, 172
    half offsets.  Kernel E's shared memory grows with them: the D3 energy
    term's extras (four species, K = 41) still fit a block, with room to
    spare, so the port keeps JAX's one grid."""
    grid = tB.BinGrid(nbins=(10, 8, 8), capacity=40, edge_hint=5.0, periodic=True, periodic_axes=(False, True, True))
    nbr, _wraps, _inv = _half_tables(grid, tB.stencil_radius(15.0, grid))
    term = ps.D3EnergyTerm(a1=0.566, a2=3.128, s8=0.3908, s6=1.0, r_on=12.0, r_off=15.0)
    st = ps.PairStatic(b_tot=grid.total_bins, c=grid.capacity, s_tot=nbr.shape[0], k=2 * 20 + 1, cutoff=15.0)
    assert st.s_tot == 172
    ps.check_width(st, term)
    assert ps.smem_bytes(st, adjoint=True) < ps.SMEM_LIMIT // 10
