"""The port's transition-state search and NEB against the JAX package's
(CPU): tests/test_saddle.py:13 and :36, tests/test_neb.py:31, :49, :92 and
:116, each run on both packages on the same inputs.

Tolerances: the Lanczos eigenpair 1e-5 (eigenvalue, relative to the
spectrum's largest magnitude) and 1e-4 (eigenvector) against JAX's with the
same start; the analytic saddle 2e-3 A (the test's own); the analytic NEB
band 2e-3 A against JAX's (a FIRE run of hundreds of steps in float32 on
each side); on the model band, the first band's energies 1e-5 eV and forces
1e-5 eV/A against JAX's and the optimized band 1e-3 A.  ``min_mode_search``
draws its start from a ``torch.Generator``, not JAX's key, so only its
converged point is compared (ROADMAP.md section 3).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu_torch.dynamics import linear_band, neb, neb_core  # noqa: E402
from aimnetcentral_tpu_torch.dynamics.neb import band_energy_forces, neb_forces  # noqa: E402
from aimnetcentral_tpu_torch.dynamics.saddle import lanczos_min_mode, min_mode_search, ts_search  # noqa: E402

# the modules, not the functions of the same name that the package exports
jneb = importlib.import_module("aimnetcentral_tpu.dynamics.neb")
jsaddle = importlib.import_module("aimnetcentral_tpu.dynamics.saddle")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (test files run side by side
    in worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- saddle ---------------------------------------------------------------------------


def test_lanczos_matches_dense_eigh():
    """Lanczos lowest eigenpair == dense eigh on a random symmetric matrix,
    and JAX's Lanczos from the same start."""
    rng = np.random.default_rng(0)
    n = 12
    m = rng.normal(size=(3 * n, 3 * n)).astype(np.float32)
    h = (m + m.T) / 2
    evals, evecs = np.linalg.eigh(h)
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    ht = torch.tensor(h)
    lam, v = lanczos_min_mode(lambda c, x: (ht @ x.reshape(-1)).reshape(n, 3), torch.zeros((n, 3)),
                              torch.tensor(v0), torch.ones((n, 1), dtype=torch.bool), k=3 * n)
    assert abs(float(lam) - evals[0]) < 1e-3
    assert abs(float(v.reshape(-1) @ torch.tensor(evecs[:, 0]))) > 0.999
    hj = jnp.asarray(h)
    lam_j, v_j = jax.jit(lambda c, x: jsaddle.lanczos_min_mode(
        lambda cc, vv: (hj @ vv.reshape(-1)).reshape(n, 3), c, x, jnp.ones((n, 1), bool), k=3 * n))(
        jnp.zeros((n, 3), jnp.float32), jnp.asarray(v0))
    assert abs(float(lam) - float(lam_j)) < 1e-5 * np.abs(evals).max()
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)


def _energy2(coord):
    """-0.5 x^2 + 0.25 x^4 + 0.5 |rest|^2: a first-order saddle at the
    origin, minima at x = +-1 (tests/test_saddle.py)."""
    x = coord[0, 0]
    rest = (coord**2).sum() - x * x
    return -0.5 * x**2 + 0.25 * x**4 + 0.5 * rest


def test_min_mode_finds_analytic_saddle():
    coord0 = np.array([[0.6, 0.3, -0.2], [0.1, -0.4, 0.25]], dtype=np.float32)
    kw = dict(fmax=1e-4, max_steps=400, step_size=0.5, trust=0.2, lanczos_k=6)
    coord, info = min_mode_search(_energy2, torch.tensor(coord0), torch.ones((2, 1), dtype=torch.bool), **kw)
    assert info["converged"], info
    assert info["is_saddle"], info
    np.testing.assert_allclose(coord.numpy(), 0.0, atol=2e-3)
    assert info["lambda_min"] < -0.5
    coord_j, info_j = jsaddle.min_mode_search(_energy2, jnp.asarray(coord0), jnp.ones((2, 1), bool), **kw)
    np.testing.assert_allclose(coord.numpy(), np.asarray(coord_j), atol=2e-3)
    assert abs(info["lambda_min"] - info_j["lambda_min"]) < 1e-3


# -- NEB --------------------------------------------------------------------------------


def _double_well(c):
    """V(x, y) = (x^2-1)^2 + 2 (y - 0.2 (1-x^2))^2: minima at (+-1, 0),
    saddle at (0, 0.2) with V = 1, off the straight line."""
    x, y = c[0, 0], c[0, 1]
    return (x**2 - 1.0) ** 2 + 2.0 * (y - 0.2 * (1.0 - x**2)) ** 2


def _analytic_fn(band):
    b = band.detach().requires_grad_(True)
    e = torch.stack([_double_well(img) for img in b])
    (g,) = torch.autograd.grad(e.sum(), b)
    return e.detach(), -g


def _analytic_fn_j(band):
    return jax.vmap(_double_well)(band), -jax.vmap(jax.grad(_double_well))(band)


def test_neb_core_finds_off_path_saddle():
    r, p = np.array([[-1.0, 0.0, 0.0]], np.float32), np.array([[1.0, 0.0, 0.0]], np.float32)
    band0 = linear_band(torch.tensor(r), torch.tensor(p), 13)
    np.testing.assert_allclose(band0.numpy(), np.asarray(jneb.linear_band(jnp.asarray(r), jnp.asarray(p), 13)),
                               atol=1e-6)  # the two linspaces round the weights apart by an f32 unit
    kw = dict(k_spring=1.0, fmax=1e-3, max_steps=2000)
    band, energies, info = neb_core(_analytic_fn, band0, **kw)
    assert info["converged"], info
    ts = band[info["i_ts"], 0].numpy()
    np.testing.assert_allclose(ts[:2], [0.0, 0.2], atol=2e-2)
    np.testing.assert_allclose(info["barrier"], 1.0, atol=1e-2)
    assert torch.equal(band[0], band0[0]) and torch.equal(band[-1], band0[-1])
    assert float(band[:, 0, 1].max()) > 0.15
    band_j, _e_j, info_j = jneb.neb_core(_analytic_fn_j, jnp.asarray(band0.numpy()), **kw)
    assert info["i_ts"] == info_j["i_ts"]
    np.testing.assert_allclose(band.numpy(), np.asarray(band_j), atol=2e-3)


def test_neb_forces_zero_on_converged_straight_band():
    """Equally spaced images on a straight 1-D profile: springs cancel and
    the true force is parallel to the tangent, so the NEB force vanishes."""
    xs = np.linspace(-1.0, 1.0, 9, dtype=np.float32)
    band = torch.tensor(np.stack([[[x, 0.0, 0.0]] for x in xs]))
    b = band.clone().requires_grad_(True)
    e = (b[:, 0, 0] ** 2 - 1.0) ** 2
    (g,) = torch.autograd.grad(e.sum(), b)
    f_neb = neb_forces(band, e.detach(), -g, k_spring=1.0, climb=False)
    np.testing.assert_allclose(f_neb.numpy(), 0.0, atol=1e-6)
    ref = jneb.neb_forces(jnp.asarray(band.numpy()), jnp.asarray(e.detach().numpy()), jnp.asarray(-g.numpy()),
                          k_spring=1.0, climb=False)
    np.testing.assert_allclose(f_neb.numpy(), np.asarray(ref), atol=1e-6)


def _tiny_config(aimnet2, heads, modules):
    return aimnet2.AIMNet2Config(
        aev=aimnet2.AEVConfig(rc_s=5.0, nshifts_s=8),
        nfeature=4,
        d2features=True,
        ncomb_v=4,
        hidden=((32,), (32,), (32,)),
        aim_size=32,
        outputs=(
            (
                "energy_mlp",
                heads.OutputHead(n_in=32, n_out=1, key_in="aim", key_out="energy",
                                 mlp=modules.MLPSpec(hidden=(16,), last_linear=True)),
            ),
            ("atomic_sum", heads.AtomicSumHead(key_in="energy", key_out="energy")),
        ),
    )


@pytest.fixture(scope="module")
def tiny_model():
    """tests/test_neb.py's tiny model (JAX init, key 0) in both packages."""
    from aimnetcentral_tpu.models import aimnet2 as jaimnet2
    from aimnetcentral_tpu.models import heads as jheads
    from aimnetcentral_tpu.models import modules as jmodules
    from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2
    from aimnetcentral_tpu_torch.models import heads as theads
    from aimnetcentral_tpu_torch.models import modules as tmodules
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy

    jcfg = _tiny_config(jaimnet2, jheads, jmodules)
    jparams = jaimnet2.aimnet2_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jparams, jcfg), (tparams, _tiny_config(taimnet2, theads, tmodules))


BENT = np.array([[0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477]], dtype=np.float32)
WIDE = np.array([[0.0, 0.0, 0.119], [0.0, 0.95, -0.2], [0.0, -0.95, -0.2]], dtype=np.float32)


def test_neb_model_band_end_to_end(tiny_model):
    """The batched-System route on a band of water bend geometries: the
    first band's energies and forces and the optimized band against JAX's;
    endpoints frozen, the residual sane."""
    (jparams, jcfg), (tparams, tcfg) = tiny_model
    numbers = np.array([8, 1, 1])
    r, p = {"coord": BENT, "numbers": numbers}, {"coord": WIDE, "numbers": numbers}
    kw = dict(n_images=7, fmax=0.02, max_steps=300)
    band, energies, info = neb(tparams, tcfg, r, p, device="cpu", **kw)
    assert band.shape == (7, 3, 3) and energies.shape == (7,)
    assert torch.isfinite(energies).all()
    np.testing.assert_allclose(band[0].numpy(), BENT, atol=1e-6)
    np.testing.assert_allclose(band[-1].numpy(), WIDE, atol=1e-6)
    assert info["steps"] > 0 and info["fmax"] < 1.0 and 1 <= info["i_ts"] <= 5
    band_j, energies_j, info_j = jneb.neb(jparams, jcfg, r, p, **kw)
    assert info["i_ts"] == info_j["i_ts"]
    np.testing.assert_allclose(band.numpy(), np.asarray(band_j), atol=1e-3)
    np.testing.assert_allclose(energies.numpy(), np.asarray(energies_j), atol=1e-3)

    # the first band's energies and forces, one batched call on each side
    band0 = linear_band(torch.tensor(BENT), torch.tensor(WIDE), 7)
    e0, f0 = band_energy_forces(tparams, tcfg, r, 7, CPU)(band0)
    from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
    from aimnetcentral_tpu.models.aimnet2 import aimnet2_apply as j_apply

    jsys = j_system_from_molecules([r] * 7, n_pad=22)

    def j_energy(c):
        out = j_apply(jparams, jcfg, jsys.replace(coord=c), sae_external=True)["energy"]
        return out.sum(), out

    flat = jsys.coord.at[:21].set(jnp.asarray(band0.numpy()).reshape(21, 3))
    g_j, e_j = jax.grad(j_energy, has_aux=True)(flat)
    np.testing.assert_allclose(e0.numpy(), np.asarray(e_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(f0.numpy(), -np.asarray(g_j)[:21].reshape(7, 3, 3), atol=1e-5, rtol=0)


def test_neb_input_validation(tiny_model):
    _jmodel, (tparams, tcfg) = tiny_model
    a = {"coord": np.zeros((2, 3), np.float32), "numbers": np.array([1, 1])}
    b = {"coord": np.zeros((2, 3), np.float32), "numbers": np.array([1, 8])}
    with pytest.raises(ValueError, match="atom ordering"):
        neb(tparams, tcfg, a, b, device="cpu")
    c = dict(a, cell=np.eye(3, dtype=np.float32))
    with pytest.raises(ValueError, match="gas-phase"):
        neb(tparams, tcfg, a, c, device="cpu")
    with pytest.raises(ValueError, match="charge"):
        neb(tparams, tcfg, dict(a, charge=1.0), a, device="cpu")
    with pytest.raises(ValueError, match="mult"):
        neb(tparams, tcfg, a, dict(a, mult=3.0), device="cpu")
    with pytest.raises(ValueError, match="atom ordering"):
        neb(tparams, tcfg, dict(a, charge=0.0), dict(b, charge=0.0), device="cpu")


def test_ts_search_lanczos_matches_jax_on_the_model(tiny_model):
    """On the model surface (a 5-atom molecule on the indexed all-pairs
    layout): the Lanczos eigenpair from one seeded start through the port's
    HVPs against JAX's through its own, and three steps of ``ts_search``
    with finite diagnostics (random weights: nothing converges)."""
    from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
    from aimnetcentral_tpu.models.aimnet2 import aimnet2_apply as j_apply
    from aimnetcentral_tpu_torch.builders import system_from_molecules
    from aimnetcentral_tpu_torch.calculators.derivatives import make_hvp_fn
    from aimnetcentral_tpu_torch.models.aimnet2 import aimnet2_apply as t_apply

    (jparams, jcfg), (tparams, tcfg) = tiny_model
    rng = np.random.default_rng(1)
    mol = {"coord": (rng.normal(size=(5, 3)) * 1.5).astype(np.float32), "numbers": np.array([6, 1, 1, 1, 8])}
    tsys = system_from_molecules([mol], CPU, build_nbmat=True)
    jsys = j_system_from_molecules([mol])
    real_t = (tsys.numbers > 0)[:, None]
    v0 = np.where(np.asarray(real_t), rng.normal(size=(tsys.natoms, 3)), 0.0).astype(np.float32)

    hvp_t = make_hvp_fn(tcfg)
    lam, v = lanczos_min_mode(lambda c, x: hvp_t(tparams, tsys.replace(coord=c), x), tsys.coord,
                              torch.tensor(v0), real_t, k=8)

    def grad_e(c):
        return jax.grad(lambda cc: j_apply(jparams, jcfg, jsys.replace(coord=cc), sae_external=True)["energy"].sum())(c)

    lam_j, v_j = jax.jit(lambda c, x: jsaddle.lanczos_min_mode(
        lambda cc, vv: jax.jvp(grad_e, (cc,), (vv,))[1], c, x, (jsys.numbers > 0)[:, None], k=8))(
        jsys.coord, jnp.asarray(v0))
    assert abs(float(lam) - float(lam_j)) < 1e-4 * max(1.0, abs(float(lam_j)))
    np.testing.assert_allclose(np.abs(v.numpy()), np.abs(np.asarray(v_j)), atol=1e-3)

    moved, info = ts_search(tparams, tcfg, tsys, fmax=1e-6, max_steps=3, lanczos_k=8)
    assert info["steps"] == 3 and np.isfinite(info["fmax"]) and np.isfinite(info["lambda_min"])
    assert torch.isfinite(moved.coord).all()
    assert t_apply(tparams, tcfg, moved, sae_external=True)["energy"].isfinite().all()
