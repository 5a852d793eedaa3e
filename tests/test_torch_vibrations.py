"""The port's vibrational analysis against the JAX package's (CPU): the
non-slow tests of tests/test_vibrations.py, each run on both packages on
the same inputs.

The host-side numpy functions (``harmonic_frequencies``,
``rrho_thermochemistry``) agree with JAX's to 1e-10 relative on analytic
Hessians.  The model-driven ones (``frequencies_from_calculator``,
``ir_intensities``) use JAX's small model of tests/test_vibrations.py
(rc 5 A, 8 shifts, nfeature 4) with its parameters carried across by the
weights bridge: frequencies within 1e-2 cm^-1 of JAX's above 10 cm^-1
(a 1e-4 eV/A^2 Hessian difference moves a 1,000 cm^-1 mode by about
5e-3 cm^-1), IR intensities within 1e-3 km/mol plus 1e-3 relative (central
differences of float32 dipoles over 0.02 A).  ``ir_intensities`` also runs
with ``binned_threshold`` lowered, so that its displaced geometries go
onto the molecule-bin layout (kernels A and D on the card).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.dynamics import vibrations as jvib  # noqa: E402
from aimnetcentral_tpu_torch.dynamics import vibrations as tvib  # noqa: E402
from aimnetcentral_tpu_torch.dynamics import frequencies_from_calculator, harmonic_frequencies  # noqa: E402

WATER = np.array([[0.0, 0.0, 0.1193], [0.0, 0.7632, -0.477], [0.0, -0.7632, -0.477]], dtype=np.float32)
WATER_DATA = {"coord": WATER, "numbers": np.array([8, 1, 1]), "charge": 0.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (test files run side by side
    in worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_config(aimnet2, heads, modules):
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
def calcs():
    """(JAX calculator, port calculator) on tests/test_vibrations.py's small
    model, JAX init with key 3."""
    from aimnetcentral_tpu.calculators import AIMNet2Calculator as JCalculator
    from aimnetcentral_tpu.models import aimnet2 as jaimnet2
    from aimnetcentral_tpu.models import heads as jheads
    from aimnetcentral_tpu.models import modules as jmodules
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator
    from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2
    from aimnetcentral_tpu_torch.models import heads as theads
    from aimnetcentral_tpu_torch.models import modules as tmodules
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy

    jcfg = _small_config(jaimnet2, jheads, jmodules)
    tcfg = _small_config(taimnet2, theads, tmodules)
    jparams = jaimnet2.aimnet2_init(jax.random.key(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (
        JCalculator((jparams, jcfg, {"sae": {}})),
        TCalculator((tparams, tcfg, {"sae": {}}), device="cpu"),
        (tparams, tcfg),
    )


def _diatomic_hessian(k, u):
    """Analytic Hessian of a harmonic bond along unit vector u: blocks
    +/- k * (u u^T)."""
    blk = k * np.outer(u, u)
    h = np.zeros((2, 3, 2, 3))
    h[0, :, 0, :] = blk
    h[1, :, 1, :] = blk
    h[0, :, 1, :] = -blk
    h[1, :, 0, :] = -blk
    return h


def _both_frequencies(*args, **kwargs):
    """The port's harmonic_frequencies, held to JAX's on the same input."""
    got = harmonic_frequencies(*args, **kwargs)
    ref = jvib.harmonic_frequencies(*args, **kwargs)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(np.abs(got[1]), np.abs(ref[1]), rtol=1e-8, atol=1e-9)  # a mode's sign is free
    return got


def test_diatomic_matches_reduced_mass_formula():
    """omega = sqrt(k/mu): CO-like pair, k = 100 eV/A^2."""
    k = 100.0
    m = np.array([12.011, 15.999])
    freqs, modes = _both_frequencies(_diatomic_hessian(k, np.array([1.0, 0.0, 0.0])), m)
    mu = m[0] * m[1] / m.sum()
    np.testing.assert_allclose(freqs[:5], 0.0, atol=1e-6)
    np.testing.assert_allclose(freqs[5], 521.4708 * np.sqrt(k / mu), rtol=1e-10)
    stretch = modes[5]
    assert abs(stretch[0, 0]) > 0.1 and np.sign(stretch[0, 0]) != np.sign(stretch[1, 0])
    assert np.abs(stretch[:, 1:]).max() < 1e-8


def test_heavier_isotope_lower_frequency():
    u = np.array([0.0, 0.0, 1.0])
    f_h = _both_frequencies(_diatomic_hessian(50.0, u), np.array([1.008, 35.45]))[0][-1]
    f_d = _both_frequencies(_diatomic_hessian(50.0, u), np.array([2.014, 35.45]))[0][-1]
    assert f_d < f_h
    mu_h = 1.008 * 35.45 / (1.008 + 35.45)
    mu_d = 2.014 * 35.45 / (2.014 + 35.45)
    np.testing.assert_allclose(f_h / f_d, np.sqrt(mu_d / mu_h), rtol=1e-10)


def test_imaginary_mode_reported_negative():
    freqs, _ = _both_frequencies(_diatomic_hessian(-30.0, np.array([1.0, 0.0, 0.0])), np.array([12.0, 12.0]))
    assert freqs[0] < -100.0
    assert np.isfinite(freqs).all()


def test_rotation_projection_nulls_six_modes(calcs):
    """Translations and rotations projected at a non-stationary geometry:
    six null modes, 3N-6 = 3 finite ones, and the frequencies JAX's
    calculator gives."""
    jcalc, tcalc, _model = calcs
    f_t, _ = frequencies_from_calculator(tcalc, WATER_DATA)
    f_tr, _ = frequencies_from_calculator(tcalc, WATER_DATA, project_rotations=True)
    for got, kw in ((f_t, {}), (f_tr, {"project_rotations": True})):
        ref, _ = jvib.frequencies_from_calculator(jcalc, WATER_DATA, **kw)
        big = np.abs(ref) > 10.0
        np.testing.assert_allclose(got[big], ref[big], atol=1e-2, rtol=0)
    assert np.sort(np.abs(f_t))[5] > 2.0
    assert np.sort(np.abs(f_tr))[:6].max() < 1e-4
    assert (np.abs(f_tr) > 1e-2).sum() == 3
    np.testing.assert_allclose(np.abs(f_tr).max(), np.abs(f_t).max(), rtol=0.05)


def test_rotation_projection_linear_molecule_rank():
    k = 100.0
    m = np.array([12.011, 15.999])
    coord = np.array([[0.0, 0.0, 0.0], [1.128, 0.0, 0.0]])
    freqs, _ = _both_frequencies(_diatomic_hessian(k, np.array([1.0, 0.0, 0.0])), m, coord=coord,
                                 project_rotations=True)
    mu = m[0] * m[1] / m.sum()
    np.testing.assert_allclose(freqs[:5], 0.0, atol=1e-6)
    np.testing.assert_allclose(freqs[5], 521.4708 * np.sqrt(k / mu), rtol=1e-10)


def test_project_rotations_requires_coord():
    with pytest.raises(ValueError, match="coord"):
        harmonic_frequencies(_diatomic_hessian(10.0, np.array([1.0, 0, 0])), np.array([1.0, 1.0]),
                             project_rotations=True)


def _both_rrho(*args, **kwargs):
    got = tvib.rrho_thermochemistry(*args, **kwargs)
    ref = jvib.rrho_thermochemistry(*args, **kwargs)
    assert got.keys() == ref.keys()
    for key in got:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, atol=1e-15, err_msg=key)
    return got


def test_rrho_water_textbook_values():
    """Experimental water frequencies: ZPE = 0.558 eV, S_trans(298.15 K,
    1 atm) = 144.8 J/mol/K, S_rot (sigma 2) about 43.8 J/mol/K."""
    th = _both_rrho(np.array([1594.8, 3657.1, 3755.9]), [8, 1, 1], WATER.astype(np.float64), symmetry_number=2)
    assert abs(th["zpe"] - 0.5584) < 2e-3
    J_MOL_K = 96485.33212  # eV/K -> J/mol/K
    assert abs(th["s_trans"] * J_MOL_K - 144.8) < 1.5
    assert abs(th["s_rot"] * J_MOL_K - 43.8) < 1.0
    assert abs(th["g"] - (th["h"] - 298.15 * th["s"])) < 1e-12
    assert th["n_skipped_modes"] == 0


def test_project_rotations_single_atom_is_noop():
    h = np.diag([1.0, 2.0, 3.0]).reshape(1, 3, 1, 3)
    freqs, _modes = _both_frequencies(h, [39.948], coord=np.zeros((1, 3)), project_translations=False,
                                      project_rotations=True)
    assert np.isfinite(freqs).all() and freqs.shape == (3,)


def test_rrho_linear_and_monatomic():
    from aimnetcentral_tpu_torch import constants

    kT = constants.kB * 298.15
    co2 = _both_rrho(np.array([667.0, 667.0, 1333.0, 2349.0]), [8, 6, 8],
                     np.array([[0, 0, -1.16], [0, 0, 0.0], [0, 0, 1.16]]), symmetry_number=2)
    assert abs(co2["u_rot"] - kT) < 1e-12
    atom = _both_rrho(np.array([]), [18], np.zeros((1, 3)))
    assert atom["u_rot"] == 0.0 and abs(atom["s_rot"]) < 1e-15
    assert atom["zpe"] == 0.0


def test_rrho_skips_imaginary_and_low_modes():
    th = _both_rrho(np.array([-350.0, 4.0, 1500.0]), [8, 1, 1], WATER.astype(np.float64))
    assert th["n_skipped_modes"] == 2
    assert abs(th["zpe"] - 0.5 * 1500.0 * 1.239842e-4) < 1e-6


def test_rrho_caps_vibrations_at_3n_minus_6():
    coord = WATER.astype(np.float64)
    clean = _both_rrho(np.array([1594.8, 3657.1, 3755.9]), [8, 1, 1], coord, symmetry_number=2)
    with pytest.warns(UserWarning, match="project_rotations"):
        dirty = tvib.rrho_thermochemistry(np.array([25.0, 40.0, 1594.8, 3657.1, 3755.9]), [8, 1, 1], coord,
                                          symmetry_number=2)
    assert dirty["n_skipped_modes"] == 2
    for key in ("zpe", "u_vib", "s_vib", "g"):
        assert abs(dirty[key] - clean[key]) < 1e-12, key


def test_ir_translation_mode_is_dark_for_neutral(calcs):
    """A rigid translation leaves a neutral molecule's dipole unchanged:
    its intensity vanishes."""
    jcalc, tcalc, _model = calcs
    trans = np.zeros((1, 3, 3))
    trans[0, :, 0] = 1.0 / np.sqrt(3.0)
    intens = tvib.ir_intensities(tcalc, WATER_DATA, trans)
    assert intens.shape == (1,)
    assert intens[0] < 1e-3
    np.testing.assert_allclose(intens, jvib.ir_intensities(jcalc, WATER_DATA, trans), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("threshold", [1024, 4], ids=["indexed", "molecule-bins"])
def test_ir_intensities_finite_for_real_modes(calcs, threshold):
    """Every mode's intensity finite and non-negative, at least one bright
    mode, and JAX's intensities on the same modes; with the threshold at 4
    atoms the 18 displaced geometries run on the molecule-bin layout."""
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator

    jcalc, _tcalc, model = calcs
    tcalc = TCalculator(model, device="cpu", binned_threshold=threshold)
    _freqs, modes = frequencies_from_calculator(tcalc, WATER_DATA)
    intens = tvib.ir_intensities(tcalc, WATER_DATA, modes)
    assert tcalc._prep_cache["kind"] == ("packed" if threshold == 4 else "indexed")
    assert intens.shape == (9,)
    assert np.isfinite(intens).all() and (intens >= 0).all()
    assert intens.max() > 1e-3
    np.testing.assert_allclose(intens, jvib.ir_intensities(jcalc, WATER_DATA, modes), atol=1e-3, rtol=1e-3)
