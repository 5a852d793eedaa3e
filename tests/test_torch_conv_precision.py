"""The conv precision modes of kernels A and B against the JAX package (CPU).

The JAX package contracts its conv kernels in one of three modes
(``conv_stencil._mxu_dot``: "f32", "f32x3", "bf16"), chosen by
``conv_precision`` and ``AIMNET_CONV_PRECISION``; the calculators' tiers
map to them (``precision_tiers``).  The port runs them in the tensor-core
builds of kernels A and B (csrc/conv_mma.cuh), whose plain versions
emulate each mode's rounding.  Here, on the CPU:

- the tier mapping, ``check_conv_precision`` and the variable raise and
  warn as JAX's do;
- ``round_tf32`` is ``cvt.rna.tf32.f32`` on hand-made bit patterns;
- the plain versions of A and B in each mode (outputs and coordinate
  gradients of one conv pass, the 40-atom box of tests/test_pallas_conv.py)
  against JAX's exact conv: "bf16" and "tf32" within JAX's own bf16 limits
  (2e-2 of max |out|, 3e-2 of max |grad|, test_pallas_conv.py:129-143),
  "3xtf32" within 1e-5 of the largest magnitude;
- ``precision="balanced"`` through both calculators on the CPU: the same
  forces within 1e-5 eV/A, and both warn that the mode is not honoured
  off the kernel.

The kernels against their plain twins in each mode: tests/test_torch_gpu.py.
"""

import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules  # noqa: E402
from aimnetcentral_tpu.calculators import calculator as jcalc  # noqa: E402
from aimnetcentral_tpu.kernels import conv_stencil as jstencil  # noqa: E402
from aimnetcentral_tpu.models import aimnet2 as jaimnet2  # noqa: E402
from aimnetcentral_tpu.models.engine_binned import conv_pass_binned  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules  # noqa: E402
from aimnetcentral_tpu_torch.calculators import calculator as tcalc  # noqa: E402
from aimnetcentral_tpu_torch.kernels import conv_pass as tcp  # noqa: E402
from aimnetcentral_tpu_torch.kernels import conv_stencil as tcs  # noqa: E402
from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

CPU = torch.device("cpu")
G_DIM, F_DIM, RC, ETA = 16, 16, 5.0, 14.5
JAX_BF16 = (2e-2, 3e-2)  # JAX's bf16 limits: outputs, gradients (of the largest magnitude)
SPLIT_REL = 1e-5  # 3xTF32 against exact


# ---------------------------------------------------------------------------
# the tiers, the check and the variable


@pytest.mark.parametrize("tier", ["exact", "balanced", "fast"])
def test_precision_tiers_match_jax(tier):
    assert tcalc.precision_tiers(tier) == jcalc.precision_tiers(tier)


@pytest.mark.parametrize("tier", ["Exact", "high", "", "f32x3"])
def test_precision_tiers_refuse_as_jax(tier):
    with pytest.raises(ValueError) as jerr:
        jcalc.precision_tiers(tier)
    with pytest.raises(ValueError) as terr:
        tcalc.precision_tiers(tier)
    assert str(terr.value) == str(jerr.value)


def _checked(check, engine, mode):
    """``check(engine, mode)``'s exception or warnings (their messages)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            check(engine, mode)
        except ValueError as exc:
            return "raise", str(exc)
    return "warn", [str(w.message) for w in caught]


@pytest.mark.parametrize("mode", [None, "f32", "f32x3", "bf16", "f16", "F32", 3])
def test_check_conv_precision_matches_jax(mode):
    """Off the kernel (JAX's XLA engine, the port's plain versions on the
    CPU and its indexed layout) a mode warns with JAX's words; on it (JAX's
    Pallas engine, the port's kernels) it passes quietly; a mode outside
    the three raises JAX's ``ValueError``."""
    for j_engine, t_engine in (("xla", "plain"), ("xla", "indexed"), ("pallas", "kernel")):
        j_kind, j_out = _checked(jaimnet2.check_conv_precision, j_engine, mode)
        t_kind, t_out = _checked(taimnet2.check_conv_precision, t_engine, mode)
        assert t_kind == j_kind
        if t_kind == "raise":
            assert t_out == j_out
        else:
            assert [m.replace(repr(t_engine), repr(j_engine)) for m in t_out] == j_out
            assert len(t_out) == (1 if mode is not None and t_engine != "kernel" else 0)


def test_conv_precision_variable_matches_jax(monkeypatch):
    """``AIMNET_CONV_PRECISION`` where the kernels read it: JAX's
    ``_mxu_dtype`` and the port's resolver refuse the same values with the
    same words; on the CPU neither reads it."""
    cuda = torch.device("cuda")  # the resolver's rule only: nothing is allocated
    for bad in ("f16", "FP32", ""):
        monkeypatch.setenv("AIMNET_CONV_PRECISION", bad)
        with pytest.raises(ValueError) as jerr:
            jstencil._mxu_dtype(bad)
        with pytest.raises(ValueError) as terr:
            tcp.resolve_conv_mode(None, cuda)
        assert str(terr.value) == str(jerr.value)
        assert tcp.resolve_conv_mode(None, CPU) == "fp32"
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for env, tf32, want in (("f32", True, "tf32"), ("f32", False, "fp32"), ("f32x3", True, "3xtf32"),
                                ("f32x3", False, "3xtf32"), ("bf16", False, "bf16")):
            monkeypatch.setenv("AIMNET_CONV_PRECISION", env)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            assert tcp.resolve_conv_mode(None, cuda) == want
            assert tcp.resolve_conv_mode(env, cuda) == want
            assert tcp.resolve_conv_mode(env, CPU) == "fp32"
        monkeypatch.delenv("AIMNET_CONV_PRECISION")
        torch.backends.cuda.matmul.allow_tf32 = True
        assert tcp.resolve_conv_mode(None, cuda) == "tf32"  # the default "f32" under the fast tier's ambient
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


# ---------------------------------------------------------------------------
# cvt.rna.tf32.f32


def _bits(values):
    return torch.tensor(np.array(values, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _as_bits(x):
    return x.view(torch.int32).numpy().view(np.uint32).tolist()


CVT_RNA = [  # (input bits, cvt.rna.tf32.f32 bits): round to nearest, ties away from zero, 10 mantissa bits
    (0x3F800000, 0x3F800000),  # 1.0
    (0x3F800FFF, 0x3F800000),  # below half: down
    (0x3F801000, 0x3F802000),  # a tie on an even mantissa: away from zero (nearest even would go down)
    (0x3F803000, 0x3F804000),  # a tie on an odd one
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0x3F801001, 0x3F802000),  # above half: up
    (0x3FFFF000, 0x40000000),  # the carry into the exponent
    (0x7F7FEFFF, 0x7F7FE000),  # the largest value that stays finite
    (0x7F7FF000, 0x7F800000),  # a tie above the largest TF32: infinity
    (0x7F7FFFFF, 0x7F800000),  # the largest finite f32: infinity
    (0xFF7FFFFF, 0xFF800000),  # and its negative
    (0x00000001, 0x00000000),  # the smallest subnormal: zero
    (0x00000FFF, 0x00000000),  # subnormal below half
    (0x00001000, 0x00002000),  # subnormal tie: away
    (0x807FF000, 0x80800000),  # a negative subnormal tie: the smallest negative normal
    (0x007FFFFF, 0x00800000),  # the largest subnormal: the smallest normal
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
]


def test_round_tf32_is_cvt_rna():
    x = _bits([b for b, _ in CVT_RNA])
    assert _as_bits(tcs.round_tf32(x)) == [r for _, r in CVT_RNA]
    assert torch.isnan(tcs.round_tf32(torch.tensor([float("nan")]))).all()


def test_round_bf16_is_nearest_even():
    x = _bits([0x3F808000, 0x3F818000, 0x3F808001, 0xBF808000, 0x00008000])
    assert _as_bits(tcs.round_bf16(x)) == [0x3F800000, 0x3F820000, 0x3F810000, 0xBF800000, 0x00000000]


def test_3xtf32_split_keeps_22_bits():
    """hi + lo of the 3xTF32 split carries each value to 2^-22 (JAX's bf16
    split: 2^-17), and the plain contraction drops only lo . lo."""
    x = torch.tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = tcs.round_tf32(x)
    lo = tcs.round_tf32(x - hi)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0**-22
    assert torch.equal(tcs.round_tf32(hi), hi) and torch.equal(tcs.round_tf32(lo), lo)


# ---------------------------------------------------------------------------
# the plain versions in each mode against JAX's exact conv


@pytest.fixture(scope="module")
def conv_case():
    """tests/test_pallas_conv.py's case: 40 atoms in a 12 A box on 2x2x2
    bins, the same numpy draws, on both packages."""
    rng = np.random.default_rng(7)
    n, a = 40, 12.0
    coord = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=n)
    cell = np.eye(3, dtype=np.float32) * a
    mol = {"coord": coord, "numbers": numbers, "cell": cell}
    sysj, _p, ovf = jB.to_binned_system(j_system_from_molecules([mol], build_nbmat=False),
                                        jB.plan_bins(cell, n, 5.2, safety=3.0))
    syst, _p2, _o = tB.to_binned_system(t_system_from_molecules([mol], CPU), tB.plan_bins(cell, n, 5.2, safety=3.0))
    assert int(ovf) == 0
    big_l = syst.natoms
    feats = {
        "a": (rng.normal(size=(big_l, F_DIM, G_DIM)) * 0.3).astype(np.float32),
        "q": (rng.normal(size=(big_l, 1)) * 0.1).astype(np.float32),
        "agh_a": (rng.normal(size=(F_DIM, G_DIM, 12)) * 0.2).astype(np.float32),
        "agh_q": (rng.normal(size=(1, G_DIM, 12)) * 0.2).astype(np.float32),
    }
    aev = {"rc_s": np.float32(RC), "eta_s": np.float32(ETA),
           "shifts_s": np.linspace(0.8, 5.0, 17, dtype=np.float32)[:16]}

    def loss_j(c):
        out_a, out_q = conv_pass_binned(sysj.replace(coord=c), {k: jnp.asarray(v) for k, v in aev.items()},
                                        *(jnp.asarray(feats[k]) for k in ("a", "q", "agh_a", "agh_q")),
                                        True, rc_static=RC)
        return (out_a**2).sum() + (out_q**2).sum(), (out_a, out_q)

    with jax.default_matmul_precision("highest"):
        (_l, outs), grad = jax.value_and_grad(loss_j, has_aux=True)(sysj.coord)
    ref = {"a": np.asarray(outs[0]), "q": np.asarray(outs[1]), "grad": np.asarray(grad)}
    return syst, aev, feats, ref


def _port_pass(case, mode, monkeypatch):
    """One conv pass of the port on the CPU with kernels A and B's plain
    versions in ``mode``, and the gradient of the same loss."""
    syst, aev, feats, _ref = case
    monkeypatch.setattr(tcp, "resolve_conv_mode", lambda _prec, _dev: mode)
    coord = syst.coord.clone().requires_grad_(True)
    out_a, out_q = tcp.conv_pass(syst.replace(coord=coord), {k: torch.tensor(v) for k, v in aev.items()},
                                 *(torch.tensor(feats[k]) for k in ("a", "q", "agh_a", "agh_q")), rc_static=RC)
    (grad,) = torch.autograd.grad((out_a**2).sum() + (out_q**2).sum(), coord)
    return {"a": out_a.detach().numpy(), "q": out_q.detach().numpy(), "grad": grad.numpy()}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def mode_errors(conv_case):
    """Each mode's error against JAX's exact conv: outputs a and q and the
    coordinate gradient, over their largest magnitudes."""
    mp = pytest.MonkeyPatch()
    try:
        errs = {}
        for mode in tcs.CONV_MODES:
            got = _port_pass(conv_case, mode, mp)
            errs[mode] = {k: _rel(got[k], conv_case[3][k]) for k in got}
    finally:
        mp.undo()
    return errs


@pytest.mark.parametrize("mode", ["bf16", "tf32", "3xtf32", "fp32"])
def test_plain_modes_against_jax_exact(mode_errors, mode):
    """The plain A and B in each mode against JAX's exact conv: the
    rounding modes within JAX's bf16 limits, the split within 1e-5."""
    errs = mode_errors[mode]
    out_lim, grad_lim = JAX_BF16 if mode in ("bf16", "tf32") else (SPLIT_REL, SPLIT_REL)
    assert errs["a"] <= out_lim and errs["q"] <= out_lim and errs["grad"] <= grad_lim, errs


def test_mode_errors_are_ordered(mode_errors):
    """bf16 (8 bits) is coarser than one TF32 pass (11), which is coarser
    than the split (22) by far: the modes are not the same computation."""
    worst = {m: max(e.values()) for m, e in mode_errors.items()}
    assert worst["bf16"] > 2 * worst["tf32"] > 200 * worst["3xtf32"], worst


def test_modes_reach_the_wrappers(conv_case, monkeypatch):
    """``ConvAcc`` hands its mode to both wrappers, forward and backward,
    and each counts its launches by build (here the plain versions run:
    the tensors lie on the CPU, so nothing is counted)."""
    seen = []
    for name in ("conv_stencil_forward", "conv_stencil_backward"):
        orig = getattr(tcp, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            seen.append((_name, kw.get("mode")))
            return _orig(*args, **kw)

        monkeypatch.setattr(tcp, name, spy)
    _port_pass(conv_case, "3xtf32", monkeypatch)
    assert sorted(set(seen)) == [("conv_stencil_backward", "3xtf32"), ("conv_stencil_forward", "3xtf32")]
    assert set(tcs.conv_stencil_forward.builds) == set(tcs.CONV_MODES) == {"fp32", "tf32", "3xtf32", "bf16"}


def test_second_order_tangents_refuse_a_rounding_mode(conv_case):
    """The K3 tangents differentiate the plain version twice in "fp32" (at
    "3xtf32" under exact matmuls, as JAX's twin pins HIGHEST); the rounding
    modes have no second derivative to offer and say so."""
    syst = conv_case[0]
    st = tcs.ConvStatic(b_tot=syst.bins.total_bins, c=syst.bins.capacity, g=1, f=1, s_tot=1)
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="second-order"):
        tcs.conv_backward_plain(st, z, z, z, z, z, z, z, z, create_graph=True, mode="tf32")


# ---------------------------------------------------------------------------
# the calculators' balanced tier on the CPU


@pytest.fixture(scope="module")
def narrow_models():
    from aimnetcentral_tpu.models import AIMNet2Config as JConfig
    from aimnetcentral_tpu.models import aimnet2_init as j_init
    from aimnetcentral_tpu.models import heads as jheads
    from aimnetcentral_tpu.models import modules as jmodules
    from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig
    from aimnetcentral_tpu_torch.models import heads as theads
    from aimnetcentral_tpu_torch.models import modules as tmodules
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy
    from test_torch_calculator import _config

    jcfg = _config(JConfig, jheads, jmodules)
    tcfg = _config(TConfig, theads, tmodules)
    jparams = j_init(jax.random.key(0), jcfg)
    return (jparams, jcfg), (params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"), tcfg)


def test_balanced_calculator_matches_jax_and_warns(narrow_models):
    """``precision="balanced"`` on the CPU: JAX's conv runs on its XLA
    engine and the port's on the plain versions, both at exact f32 and both
    warning that "f32x3" is not honoured there; the forces agree within
    1e-5 eV/A, and equal each package's ``exact`` tier."""
    from test_torch_calculator import _box

    data = _box()
    (jmodel, tmodel) = narrow_models
    res = {}
    for pkg, calc_cls, model in (("jax", jcalc.AIMNet2Calculator, jmodel), ("torch", tcalc.AIMNet2Calculator, tmodel)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bal = calc_cls(model, binned_threshold=0, precision="balanced", **kw).eval(data, forces=True)
        exact = calc_cls(model, binned_threshold=0, precision="exact", **kw).eval(data, forces=True)
        msgs = [str(w.message) for w in caught if "conv_precision='f32x3'" in str(w.message)]
        assert msgs, f"{pkg}: no warning"
        np.testing.assert_allclose(bal["forces"], exact["forces"], atol=1e-6)
        res[pkg] = bal
    np.testing.assert_allclose(res["torch"]["forces"], res["jax"]["forces"], atol=1e-5)
    np.testing.assert_allclose(res["torch"]["energy"], res["jax"]["energy"], rtol=1e-5)
