"""The port's molecule-bin layout against the JAX package's (CPU).

One gas-phase molecule a bin, every sweep at radius 0
(``builders.system_molecule_bins``):

- the builder field by field, and the radius-0 tables;
- ``aimnet2_apply`` on the layout (tolerances of JAX's
  tests/test_packed_train.py::test_packed_apply_matches_indexed: energy
  2e-6 eV, charges 1e-6, coordinate gradient 1e-5);
- ``coulomb_simple_binned`` with both envelopes, the SR part subtracted or
  not, and ``coulomb_sr_binned`` with both envelopes (energy and gradients
  within 1e-5 of their largest magnitude);
- kernels D and E's walk (emulated as in tests/test_torch_pair.py) at
  radius 0, at cutoff inf and at 15 A, against the plain sweep and its
  pair count: each real atom meets every other atom of its molecule;
- ``AIMNet2Calculator`` on gas-phase batches at or above
  ``binned_threshold`` against JAX's packed calculator (energy, forces,
  charges 1e-5), the layout kept after a 2 A move of every atom, and a
  batch whose slots would be less than a quarter full going indexed;
- ``fire_relax`` on the molecule-bin and the indexed layouts against JAX's
  (coordinates 1e-5 A).

The narrow model of tests/test_torch_indexed.py (flagship and wB97M-D3 head
sets), JAX parameters carried across by the weights bridge; inputs drawn
with numpy from fixed seeds.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu import builders as jbuilders  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models import aimnet2 as jaimnet2  # noqa: E402
from aimnetcentral_tpu.models import engine_binned as jeb  # noqa: E402
from aimnetcentral_tpu_torch import builders as tbuilders  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.kernels import pair_sweep as ps  # noqa: E402
from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables  # noqa: E402
from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2  # noqa: E402
from aimnetcentral_tpu_torch.models import engine_binned as teb  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from aimnetcentral_tpu_torch.ops.nb import mol_onehot  # noqa: E402
from test_torch_indexed import _close, _mol, models  # noqa: E402, F401  (models: a fixture)
from test_torch_pair import _half_pair_count, _kernel_emulation  # noqa: E402

CPU = torch.device("cpu")
# a screening-like batch: four molecules of 5-12 atoms (capacity 16), two charged
PACKED = [_mol(11, 21), _mol(9, 22, charge=1.0), _mol(12, 23), _mol(5, 24, charge=-1.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (test files run side by side
    in worker processes; CPU repeats are bitwise with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", ["tight", "padded"])
def test_system_molecule_bins_matches_jax(shape):
    """Every field equals JAX's: molecule-major slots, padding rows at
    coordinate 1.0 with number 0 and ``mol_idx`` = num_mol, the grid; the
    padded case fixes capacity and molecule count and carries ``mult``."""
    mols = [dict(m) for m in PACKED]
    kw = {}
    if shape == "padded":
        mols[1]["mult"] = 2.0
        kw = dict(capacity=24, pad_mols=6)
    j = jbuilders.system_molecule_bins(mols, **kw)
    t = tbuilders.system_molecule_bins(mols, CPU, **kw)
    for f in ("coord", "numbers", "charge", "mol_idx", "mult"):
        jv, tv = getattr(j, f), getattr(t, f)
        assert (jv is None) == (tv is None), f
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    assert t.species == j.species
    assert (t.bins.nbins, t.bins.capacity, t.bins.periodic, t.bins.molecule_bins) == (
        j.bins.nbins, j.bins.capacity, j.bins.periodic, j.bins.molecule_bins)
    c, num_mol = t.bins.capacity, t.num_mol
    assert c == (24 if shape == "padded" else 16) and t.bins.nbins == (num_mol, 1, 1)
    # mol_onehot drops the padding rows: each molecule's column sum is its size
    onehot = mol_onehot(t.mol_idx, num_mol, torch.float64)
    pad = t.numbers == 0
    assert not onehot[:, pad].any()
    sizes = [len(m["numbers"]) for m in mols] + [0] * (num_mol - len(mols))
    np.testing.assert_array_equal(onehot.sum(1).numpy(), sizes)
    with pytest.raises(ValueError, match="capacity"):
        tbuilders.system_molecule_bins(mols, CPU, capacity=8)


@pytest.mark.parametrize("config", ["flagship", "wb97m-d3"])
def test_empty_part_is_padding_bins(models, config):
    """A data-parallel rank's part with no molecule (``pad_mols`` given):
    that many empty bins laid out as JAX lays out padding molecules
    (coordinate 1.0, number 0, ``mol_idx`` = num_mol), on which the model
    gives zero energies and a zero coordinate gradient, D3 included.  JAX's
    ``system_molecule_bins`` raises there; without ``pad_mols`` both
    packages raise."""
    padded = tbuilders.system_molecule_bins(PACKED[:1], CPU, capacity=16, pad_mols=3)
    t = tbuilders.system_molecule_bins([], CPU, capacity=16, pad_mols=2)
    np.testing.assert_array_equal(t.coord.numpy(), padded.coord[16:].numpy())
    np.testing.assert_array_equal(t.numbers.numpy(), padded.numbers[16:].numpy())
    np.testing.assert_array_equal(t.charge.numpy(), padded.charge[1:].numpy())
    assert (t.mol_idx == 2).all() and t.mult is None and t.species == ()
    assert (t.bins.nbins, t.bins.capacity, t.bins.molecule_bins) == ((2, 1, 1), 16, True)
    assert tbuilders.system_molecule_bins([], CPU, pad_mols=1).bins.capacity == 8
    with pytest.raises(ValueError):
        jbuilders.system_molecule_bins([], capacity=16, pad_mols=2)
    for build in (lambda: jbuilders.system_molecule_bins([]), lambda: tbuilders.system_molecule_bins([], CPU)):
        with pytest.raises(ValueError):
            build()
    _j, (tparams, tcfg, _a) = models[config, "simple"]
    coord = t.coord.clone().requires_grad_(True)
    out = taimnet2.aimnet2_apply(tparams, tcfg, t.replace(coord=coord), sae_external=True)
    (grad,) = torch.autograd.grad(out["energy"].sum(), coord, allow_unused=True)
    np.testing.assert_array_equal(out["energy"].detach().numpy(), np.zeros(2, np.float32))
    assert grad is None or not grad.any()


def test_radius_zero_tables():
    """A molecule-bin grid sweeps at radius 0 whatever the cutoff (inf
    included): its stencil, mirror and conv tables hold the zero offset
    alone, each bin its own candidate."""
    grid = tbuilders.system_molecule_bins(PACKED, CPU).bins
    for cutoff in (5.0, 15.0, math.inf):
        assert tB.stencil_radius(cutoff, grid) == 0
    nbr, wraps, is_zero = tB.stencil_tables(grid, 0)
    mnbr, mwrap = tB.mirror_stencil_tables(grid, 0)
    ids = np.arange(grid.total_bins)[None]
    np.testing.assert_array_equal(nbr, ids)
    np.testing.assert_array_equal(mnbr, ids)
    assert not wraps.any() and not mwrap.any() and is_zero.tolist() == [True]
    conv = build_conv_tables(grid, 0)
    assert conv["nbr"].shape == (1, grid.total_bins) and not conv["push"].any()
    nbr_h, _w, inv_h = teb._half_tables(grid, 0)
    np.testing.assert_array_equal(nbr_h, ids)
    np.testing.assert_array_equal(inv_h, ids)


def _port_packed(mols):
    return tbuilders.system_molecule_bins(mols, CPU)


@pytest.mark.parametrize("config", ["flagship", "wb97m-d3"])
def test_packed_apply_matches_jax(models, config):
    """``aimnet2_apply`` on the packed layout: per-molecule energy, charges
    and the coordinate gradient of the summed energy."""
    (jparams, jcfg, _a), (tparams, tcfg, _b) = models[config, "simple"]
    jsys = jbuilders.system_molecule_bins(PACKED)
    tsys = _port_packed(PACKED)

    def j_energy(coord):
        out = jaimnet2.aimnet2_apply(jparams, jcfg, jsys.replace(coord=coord), sae_external=True)
        return out["energy"].sum(), out

    (_e, jout), jgrad = jax.jit(jax.value_and_grad(j_energy, has_aux=True))(jsys.coord)
    coord = tsys.coord.clone().requires_grad_(True)
    tout = taimnet2.aimnet2_apply(tparams, tcfg, tsys.replace(coord=coord), sae_external=True)
    (tgrad,) = torch.autograd.grad(tout["energy"].sum(), coord)
    np.testing.assert_allclose(tout["energy"].detach().numpy(), np.asarray(jout["energy"]), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tout["charges"].detach().numpy(), np.asarray(jout["charges"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5)
    assert tgrad.abs().max() > 1e-3  # the gradient is not trivially zero


@pytest.mark.parametrize("subtract_sr", [True, False])
@pytest.mark.parametrize("envelope", ["exp", "cosine"])
def test_coulomb_simple_binned_matches_jax(envelope, subtract_sr):
    """Per-molecule energies and their coordinate and charge gradients."""
    jsys = jbuilders.system_molecule_bins(PACKED)
    tsys = _port_packed(PACKED)
    rng = np.random.default_rng(8)
    q = (rng.normal(size=tsys.natoms) * 0.3).astype(np.float32) * (tsys.numbers.numpy() > 0)
    w = rng.normal(size=tsys.num_mol).astype(np.float32)

    def j_loss(coord, qj):
        e = jeb.coulomb_simple_binned(jsys.replace(coord=coord), qj, 4.6, envelope, subtract_sr)
        return (e * w).sum(), e

    (_l, je), jg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(jsys.coord, jnp.asarray(q))
    coord = tsys.coord.clone().requires_grad_(True)
    qt = torch.tensor(q, requires_grad=True)
    te = teb.coulomb_simple_binned(tsys.replace(coord=coord), qt, 4.6, envelope, subtract_sr)
    tg = torch.autograd.grad((te * torch.tensor(w)).sum(), (coord, qt))
    _close(te, je)
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])
    with pytest.raises(ValueError, match="molecule-bin"):
        teb.coulomb_simple_binned(tsys.replace(bins=tB.BinGrid((4, 1, 1), 16, 5.0, False)), qt, 4.6, envelope,
                                  subtract_sr)


@pytest.mark.parametrize("envelope", ["exp", "cosine"])
def test_coulomb_sr_binned_matches_jax(envelope):
    """The SR Coulomb of v2 artifacts on molecule bins: per-molecule
    energies and their coordinate and charge gradients."""
    jsys = jbuilders.system_molecule_bins(PACKED)
    tsys = _port_packed(PACKED)
    rng = np.random.default_rng(10)
    q = (rng.normal(size=tsys.natoms) * 0.3).astype(np.float32) * (tsys.numbers.numpy() > 0)
    w = rng.normal(size=tsys.num_mol).astype(np.float32)

    def j_loss(coord, qj):
        e = jeb.coulomb_sr_binned(jsys.replace(coord=coord), qj, 4.6, envelope)
        return (e * w).sum(), e

    (_l, je), jg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(jsys.coord, jnp.asarray(q))
    coord = tsys.coord.clone().requires_grad_(True)
    qt = torch.tensor(q, requires_grad=True)
    te = teb.coulomb_sr_binned(tsys.replace(coord=coord), qt, 4.6, envelope)
    tg = torch.autograd.grad((te * torch.tensor(w)).sum(), (coord, qt))
    _close(te, je)
    _close(tg[0], jg[0])
    _close(tg[1], jg[1])


@pytest.mark.parametrize("term_name", ["coulomb_simple", "dsf", "d3_cn", "coulomb_sr"])
def test_radius_zero_walk_matches_plain(term_name):
    """Kernels D and E's walk at radius 0 (cutoff inf for simple Coulomb,
    15 A for DSF and the D3 coordination number) against the plain forward,
    its autograd and the plain pair count: with cutoff inf every real row
    contracts every other real atom of its molecule."""
    mols = PACKED + [_mol(40, 25)]  # capacity 40
    tsys = _port_packed(mols)
    rng = np.random.default_rng(9)
    real = (tsys.numbers > 0).float()
    q = torch.tensor(rng.normal(size=tsys.natoms) * 0.3, dtype=torch.float32) * real
    rcov = torch.tensor(rng.uniform(0.5, 2.0, size=tsys.natoms), dtype=torch.float32)
    term, cutoff, extras = {
        "coulomb_simple": (ps.CoulombSimpleTerm(rc=4.6), math.inf, {"q": q}),
        "dsf": (ps.DSFTerm(alpha=0.2, dsf_rc=15.0, rc=4.6), 15.0, {"q": q}),
        "d3_cn": (ps.D3CNTerm(), 15.0, {"rcov": rcov}),
        "coulomb_sr": (ps.CoulombSRTerm(rc=4.6), 4.6, {"q": q}),
    }[term_name]
    layout = "sr" if term_name == "coulomb_sr" else "lr"  # no LR twin: the one grid either way
    st, ops = teb.pair_operands(tsys, cutoff, term, extras, layout=layout)
    assert (st.s_tot, st.b_tot, st.c) == (1, len(mols), 40) and st.cutoff == cutoff
    args = {k: ops[k] for k in ("coord", "mask", "ext", "shift", "nbr", "inv")}
    ct = torch.tensor(rng.normal(size=(st.b_tot, st.c)), dtype=torch.float32)
    emu_out, emu_grads, counts = _kernel_emulation(st, term, ops, ct)
    _close(emu_out, ps.pair_forward_plain(st, term, **args))
    for e, r in zip(emu_grads, ps.pair_backward_plain(st, term, **args, ct=ct)):
        np.testing.assert_allclose(e.numpy(), r.numpy(), rtol=0, atol=3e-5 * max(float(r.abs().max()), 1e-30))
    plain = ps.pair_counts_plain(st, **{k: args[k] for k in args if k != "ext"})
    assert torch.equal(counts, plain)
    assert int(counts.sum()) == 2 * _half_pair_count(st, ops) > 0
    if term_name == "coulomb_simple":
        sizes = torch.tensor([len(m["numbers"]) for m in mols])
        want = torch.where(tsys.numbers > 0, (sizes - 1).repeat_interleave(st.c), 0)
        assert torch.equal(plain, want)
        assert torch.isfinite(emu_out).all()


# -- the calculator ---------------------------------------------------------------------


def _moved(mols, scale: float = 2.0, seed: int = 12):
    """Every atom moved by ``scale`` A in a random direction."""
    rng = np.random.default_rng(seed)
    out = []
    for m in mols:
        step = rng.normal(size=m["coord"].shape)
        step *= scale / np.linalg.norm(step, axis=1, keepdims=True)
        out.append({**m, "coord": (m["coord"] + step).astype(np.float32)})
    return out


@pytest.mark.parametrize("config", ["flagship", "wb97m-d3"])
def test_calculator_packed_matches_jax(models, config):
    """A gas-phase batch at or above ``binned_threshold`` runs on the
    molecule-bin layout (no ``NotImplementedError``) and gives JAX's packed
    calculator's energies, forces and charges; after a 2 A move of every
    atom the layout is kept, and the result equals a fresh build bit for bit
    and JAX's within the same limits."""
    jmodel, tmodel = models[config, "simple"]
    jcalc = JCalculator(jmodel, binned_threshold=32)
    calc = TCalculator(tmodel, device="cpu", binned_threshold=32)
    ref = jcalc.eval(PACKED, forces=True)
    got = calc.eval(PACKED, forces=True)
    assert jcalc._prep_cache["kind"] == calc._prep_cache["kind"] == "packed"
    layout = calc._prep_cache["system"]
    assert layout.bins.molecule_bins and layout.nbmat is None
    for k in ("energy", "forces", "charges"):
        assert got[k].shape == np.asarray(ref[k]).shape
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    moved = _moved(PACKED)
    got2 = calc.eval(moved, forces=True)
    assert calc._prep_cache["system"] is layout  # kept whatever the move
    fresh = TCalculator(tmodel, device="cpu", binned_threshold=32).eval(moved, forces=True)
    for k in ("energy", "forces", "charges"):
        np.testing.assert_array_equal(got2[k], fresh[k], err_msg=k)
        np.testing.assert_allclose(got2[k], jcalc.eval(moved, forces=True)[k], rtol=0, atol=1e-5, err_msg=k)
    assert np.abs(got2["forces"] - got["forces"]).max() > 1e-3  # the move moved the answer


def test_calculator_sparse_batch_goes_indexed(models):
    """A batch whose molecule bins would be less than a quarter full (one
    40-atom molecule among seven of 2 atoms: 8 x 40 slots for 54 atoms)
    goes onto the indexed layout, as JAX's does, with its results."""
    jmodel, tmodel = models["flagship", "simple"]
    pair = [{"coord": np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.1]], np.float32) + k, "numbers": np.array([6, 8]),
             "charge": 0.0} for k in range(7)]
    mols = [_mol(40, 26)] + pair
    jcalc = JCalculator(jmodel, binned_threshold=32)
    calc = TCalculator(tmodel, device="cpu", binned_threshold=32)
    ref = jcalc.eval(mols, forces=True)
    got = calc.eval(mols, forces=True)
    assert jcalc._prep_cache["kind"] == calc._prep_cache["kind"] == "indexed"
    assert calc._prep_cache["system"].bins is None
    for k in ("energy", "forces", "charges"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("layout", ["packed", "indexed"])
def test_fire_relax_matches_jax(models, layout):
    """10 FIRE steps on the molecule-bin layout and on the indexed
    all-pairs layout (JAX's ``fire_relax`` takes any System): coordinates
    within 1e-5 A."""
    from aimnetcentral_tpu.dynamics import fire_relax as j_fire
    from aimnetcentral_tpu_torch.dynamics import fire_relax

    (jparams, jcfg, _a), (tparams, tcfg, _b) = models["flagship", "simple"]
    mols = PACKED[:3]
    if layout == "packed":
        jsys, tsys = jbuilders.system_molecule_bins(mols), _port_packed(mols)
    else:
        jsys = jbuilders.system_from_molecules(mols, n_pad=48)
        tsys = tbuilders.system_from_molecules(mols, CPU, 48, build_nbmat=True)
    relaxed, info = fire_relax(tparams, tcfg, tsys, fmax=0.0, max_steps=10)
    jrelaxed, jinfo = j_fire(jparams, jcfg, jsys, fmax=0.0, max_steps=10)
    assert info["steps"] == jinfo["steps"] == 10
    real = tsys.numbers.numpy() > 0
    assert np.abs(relaxed.coord.numpy() - tsys.coord.numpy())[real].max() > 1e-3
    np.testing.assert_allclose(relaxed.coord.numpy()[real], np.asarray(jrelaxed.coord)[real], atol=1e-5)
    np.testing.assert_allclose(info["fmax"], jinfo["fmax"], rtol=1e-4)
