"""The port's pair sweep (kernels/pair_sweep.py, the plain versions of
kernels D and E) against the JAX package's XLA sweep, and each pair term's
hand derivatives against torch.autograd (CPU).  The CUDA kernels against
the plain versions: tests/test_torch_gpu.py.

Grids: SR 3x3x3 bins at radius 1 (nz >= 2r+1, the JAX Pallas kernel's
banded case), SR 2x2x2 and LR 1x1x1 (nz < 2r+1: bins recur at several
offsets as periodic images), and LR 5x5x5 at radius 2 (banded).
Tolerances (those of tests/test_pair_sweep.py): per-atom sums within 1e-5
of their largest magnitude, gradients within 3e-5; hand derivatives within
1e-6 of the largest magnitude.
"""

from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
from aimnetcentral_tpu.models import engine_binned as jeb
from aimnetcentral_tpu.ops import binned as jB
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules
from aimnetcentral_tpu_torch.kernels import pair_sweep as ps
from aimnetcentral_tpu_torch.models import engine_binned as teb
from aimnetcentral_tpu_torch.ops import binned as tB

CPU = torch.device("cpu")
j_to_binned_system = jax.jit(jB.to_binned_system, static_argnums=(1, 2))

# (atoms, box edge A, SR bin edge, pair cutoff, layout)
CASES = {
    "sr_banded": (120, 18.0, 5.5, 5.0, "sr"),
    "sr_images": (40, 12.0, 5.2, 5.0, "sr"),
    "lr_images": (60, 12.0, 5.2, 15.0, "lr"),
    "lr_banded": (150, 38.0, 5.2, 15.0, "lr"),
}
V_TEST = 10  # width of the D3 vectors in the sweep tests (two species' worth)


def _close(actual, desired, rel):
    desired = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64), desired,
                               atol=rel * float(np.abs(desired).max()))


def _jax_dsf_fn(term: ps.DSFTerm):
    """The pair function the JAX package's coulomb_dsf_binned sweeps."""
    grabbed = {}

    def grab(system, cutoff, e_fn, extras=None, layout="sr", **_kw):
        grabbed["fn"] = e_fn
        return jnp.zeros(system.coord.shape[0])

    sysj = j_system_from_molecules([{"coord": np.zeros((2, 3)), "numbers": [1, 1]}], build_nbmat=False)
    with mock.patch.object(jeb, "pair_energy_binned", grab):
        jeb.coulomb_dsf_binned(sysj, jnp.zeros(sysj.natoms), term.rc, term.alpha, term.dsf_rc,
                               term.envelope, term.subtract_sr)
    return grabbed["fn"]


def _terms(cutoff):
    r_on = 0.8 * cutoff
    return {
        "dsf_exp": (ps.DSFTerm(alpha=0.2, dsf_rc=cutoff, rc=4.6), None),
        "dsf_cosine": (ps.DSFTerm(alpha=0.2, dsf_rc=cutoff, rc=4.6, envelope="cosine"), None),
        "d3_cn": (ps.D3CNTerm(), jeb.d3_cn_fn()),
        "d3_energy": (
            ps.D3EnergyTerm(a1=0.566, a2=3.128, s8=0.3908, r_on=r_on, r_off=cutoff),
            jeb.d3_e_fn(0.566, 3.128, 0.3908, 1.0, r_on, cutoff),
        ),
    }


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    n, a, edge, cutoff, layout = CASES[request.param]
    rng = np.random.default_rng(13)
    coord = rng.uniform(-0.2 * a, 1.2 * a, size=(n, 3)).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=n)
    cell = np.eye(3, dtype=np.float32) * a
    mol = {"coord": coord, "numbers": numbers, "charge": 0.0, "cell": cell}
    jg, tg = jB.plan_bins(cell, n, edge, safety=3.0), tB.plan_bins(cell, n, edge, safety=3.0)
    jl = jB.plan_lr_bins(cell, n, 15.0, safety=1.5) if layout == "lr" else None
    tl = tB.plan_lr_bins(cell, n, 15.0, safety=1.5) if layout == "lr" else None
    bj, _pj, ovf = j_to_binned_system(j_system_from_molecules([mol], build_nbmat=False), jg, jl)
    bt, _pt, _ot = tB.to_binned_system(t_system_from_molecules([mol], CPU), tg, tl)
    assert int(ovf) == 0
    grid = bt.lr_bins if layout == "lr" else bt.bins
    radius = tB.stencil_radius(cutoff, grid)
    expected_banded = request.param.endswith("banded")
    assert (grid.nbins[2] >= 2 * radius + 1) == expected_banded
    L = bt.natoms
    real = (bt.numbers.numpy() > 0).astype(np.float32)
    p = rng.uniform(0.0, 1.0, size=(L, V_TEST)).astype(np.float32)
    m = rng.uniform(0.0, 5.0, size=(V_TEST, V_TEST))
    extras = {
        "q": (rng.normal(size=L) * 0.3).astype(np.float32) * real,
        "rcov": rng.uniform(0.5, 2.0, size=L).astype(np.float32),
        "p": p,
        "r": (p @ (m + m.T)).astype(np.float32),  # c6_ij = p_i . r_j symmetric
        "rr": rng.uniform(1.0, 3.0, size=L).astype(np.float32),  # also on padding rows
        "w": rng.normal(size=L).astype(np.float32),  # cotangent of the sums
    }
    return bj, bt, cutoff, layout, extras


@pytest.mark.parametrize("term_name", ["dsf_exp", "dsf_cosine", "d3_cn", "d3_energy"])
def test_plain_sweep_matches_jax(case, term_name):
    """Per-atom sums and their coordinate, extras and cell gradients."""
    bj, bt, cutoff, layout, ex = case
    term, j_fn = _terms(cutoff)[term_name]
    if j_fn is None:
        j_fn = _jax_dsf_fn(term)
    keys = list(term.vector_keys) + [term.scalar_key]
    w = ex["w"]

    def j_loss(coord, cell, extras):
        out = jeb.pair_energy_binned(bj.replace(coord=coord, cell=cell), cutoff, j_fn, extras,
                                     layout, allow_pallas=False)
        return (out * w).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        bj.coord, bj.cell, {k: jnp.asarray(ex[k]) for k in keys}
    )
    coord = bt.coord.clone().requires_grad_(True)
    cell = bt.cell.clone().requires_grad_(True)
    extras = {k: torch.tensor(ex[k], requires_grad=True) for k in keys}
    t_out = teb.pair_energy_binned(bt.replace(coord=coord, cell=cell), cutoff, term, extras, layout)
    t_grads = torch.autograd.grad((t_out * torch.tensor(w)).sum(), [coord, cell] + list(extras.values()))

    _close(t_out.detach().numpy(), j_out, 1e-5)
    _close(t_grads[0].numpy(), j_grads[0], 3e-5)
    _close(t_grads[1].numpy(), j_grads[1], 3e-5)
    for k, g in zip(keys, t_grads[2:]):
        _close(g.numpy(), j_grads[2][k], 3e-5)


def _kernel_emulation(st, term, ops, ct, ti):
    """What csrc/pair_fwd.cu and csrc/pair_bwd.cu compute, written out in
    torch: per offset and row tile of ``ti`` receivers, the receiver sums
    and adjoints and the candidate side rows (the pair cotangent ct_i +
    ct_j, ct_i alone at the zero offset), with each term's hand
    derivatives; then the wrappers' reassembly.  Holds the kernels'
    algorithm and the reassembly against the plain versions on the CPU."""
    coord, mask, ext, shift, nbr = (ops[k] for k in ("coord", "mask", "ext", "shift", "nbr"))
    b, c, v = st.b_tot, st.c, st.v
    nt = -(-c // ti)
    out, gc, ge = torch.zeros(b, c), torch.zeros(b, c, 3), torch.zeros(b, c, v + 1)
    me = torch.zeros(st.s_tot, b, nt, c)
    gmc, gme = torch.zeros(st.s_tot, b, nt, 3, c), torch.zeros(st.s_tot, b, nt, v + 1, c)
    for s in range(st.s_tot):
        n = nbr[s].long()
        diff = (coord[n] + shift[s][:, None, :])[:, None, :, :] - coord[:, :, None, :]
        vp = (mask > 0.5)[:, :, None] & (mask[n] > 0.5)[:, None, :]
        if s == 0:
            vp = vp & ~torch.eye(c, dtype=torch.bool)[None]
        d = torch.sqrt(torch.where(vp, (diff * diff).sum(-1), 1.0))
        vp = vp & (d < st.cutoff)
        g, gd, gsi, gsj = term.g_grad(d, ext[..., -1][:, :, None], ext[n][..., -1][:, None, :], vp)
        cc = torch.einsum("bix,bjx->bij", ext[..., :v], ext[n][..., v : 2 * v]) if v else 1.0
        e = torch.where(vp, cc * g, 0.0)
        cbar = torch.where(vp, ct[:, :, None] + float(s > 0) * ct[n][:, None, :], 0.0)
        f = (cbar * cc * gd / d)[..., None] * diff  # candidate side; the receiver's is -f
        wm = cbar * g  # the bilinear weight
        out += e.sum(2)
        gc -= f.sum(2)
        ge[..., v] += (cbar * cc * gsi).sum(2)
        if v:
            ge[..., :v] += torch.einsum("bij,bjx->bix", wm, ext[n][..., v : 2 * v])
        for t in range(nt):
            rows = slice(t * ti, (t + 1) * ti)
            if s > 0:
                me[s, :, t] = e[:, rows].sum(1)
            gmc[s, :, t] = f[:, rows].sum(1).transpose(1, 2)
            gme[s, :, t, v] = (cbar * cc * gsj)[:, rows].sum(1)
            if v:
                gme[s, :, t, :v] = torch.einsum("bij,bix->bxj", wm[:, rows], ext[:, rows, :v])
    return (ps.assemble_forward(ops["inv"], out, me),
            ps.assemble_backward(ops["inv"], gc, ge, gmc, gme))


@pytest.mark.parametrize("term_name", ["dsf_exp", "d3_cn", "d3_energy"])
def test_kernel_algorithm_matches_plain(case, term_name):
    """Kernels D and E's algorithm in uneven row tiles of 7, against the
    plain forward and its autograd."""
    _bj, bt, cutoff, layout, ex = case
    term = _terms(cutoff)[term_name][0]
    extras = {k: torch.tensor(ex[k]) for k in list(term.vector_keys) + [term.scalar_key]}
    st, ops = teb.pair_operands(bt, cutoff, term, extras, layout)
    args = {k: ops[k] for k in ("coord", "mask", "ext", "shift", "nbr", "inv")}
    ct = torch.tensor(np.random.default_rng(6).normal(size=(st.b_tot, st.c)).astype(np.float32))
    emu_out, emu_grads = _kernel_emulation(st, term, ops, ct, ti=7)
    _close(emu_out.numpy(), ps.pair_forward_plain(st, term, **args).numpy(), 1e-5)
    for e, r in zip(emu_grads, ps.pair_backward_plain(st, term, **args, ct=ct)):
        _close(e.numpy(), r.numpy(), 3e-5)


def test_second_order_raises(case):
    """The adjoint is first order only: grad-of-grad must raise, not lie."""
    _bj, bt, cutoff, layout, ex = case
    term = _terms(cutoff)["d3_cn"][0]
    st, ops = teb.pair_operands(bt, cutoff, term, {"rcov": torch.tensor(ex["rcov"])}, layout)
    coord = ops["coord"].clone().requires_grad_(True)
    out = ps.PairAcc.apply(coord, ops["ext"], ops["shift"], st, term, ops["mask"], ops["nbr"], ops["inv"])
    (g,) = torch.autograd.grad((out * out).sum(), coord, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


def _distances(term) -> np.ndarray:
    """Random distances plus each term's edges: the clamps, its envelope's
    end, the S5 switch region and the cutoff."""
    rng = np.random.default_rng(3)
    d = list(rng.uniform(0.4, 18.0, size=200))
    if isinstance(term, ps.DSFTerm):
        rc = term.rc
        d += [rc * (1.0 - 1e-6), rc, rc - 1e-3, rc + 1e-3, term.dsf_rc - 1e-3, term.dsf_rc + 0.5]
    elif isinstance(term, ps.D3CNTerm):
        d += [1e-13, 0.5e-12, 0.2, 15.0]
    else:
        d += [1e-13, term.r_on, term.r_on - 1e-3, term.r_on + 1e-3, 0.5 * (term.r_on + term.r_off),
              term.r_off, term.r_off - 1e-3, term.r_off + 1e-3, 20.0]
    return np.asarray(d)


HAND_TERMS = {
    "dsf_exp": ps.DSFTerm(alpha=0.2, dsf_rc=15.0, rc=4.6),
    "dsf_cosine": ps.DSFTerm(alpha=0.2, dsf_rc=15.0, rc=4.6, envelope="cosine"),
    "dsf_no_sr": ps.DSFTerm(alpha=0.2, dsf_rc=15.0, rc=4.6, subtract_sr=False),
    "d3_cn": ps.D3CNTerm(),
    "d3_energy": ps.D3EnergyTerm(a1=0.566, a2=3.128, s8=0.3908, r_on=12.0, r_off=15.0),
}


@pytest.mark.parametrize("name", list(HAND_TERMS))
def test_hand_derivatives_match_autograd(name):
    """``g_grad`` (the formulas of csrc/pair_terms.cuh) against autograd of
    ``g``, the function the plain versions differentiate.  In float64: the
    point is the formulas (in float32 two evaluation orders of DSF's
    cancelling terms differ by more than 1e-6 of the largest value; the
    kernels' float32 arithmetic is held to the plain versions on the card)."""
    dtype = torch.float64
    term = HAND_TERMS[name]
    dist = _distances(term)
    rng = np.random.default_rng(4)
    d = torch.tensor(dist, dtype=dtype, requires_grad=True)
    si = torch.tensor(rng.uniform(0.5, 3.0, size=d.shape), dtype=dtype, requires_grad=True)
    sj = torch.tensor(rng.uniform(0.5, 3.0, size=d.shape), dtype=dtype, requires_grad=True)
    valid = torch.ones(d.shape, dtype=torch.bool)
    g = term.g(d, si, sj, valid)
    auto = torch.autograd.grad(g.sum(), (d, si, sj))
    hand = term.g_grad(d.detach(), si.detach(), sj.detach(), valid)
    _close(hand[0].numpy(), g.detach().numpy(), 1e-6)
    for h, a in zip(hand[1:], auto):
        _close(h.numpy(), a.numpy(), 1e-6)
        assert torch.isfinite(h).all()


def test_non_pairs_keep_d3_gradients_finite():
    """The padding atom's r4r2 is 0: a non-pair's rr is taken as 1, so its
    zero cotangent never meets sqrt's infinite slope."""
    term = HAND_TERMS["d3_energy"]
    d = torch.tensor([3.0, 3.0], requires_grad=True)
    si = torch.tensor([0.0, 2.0], requires_grad=True)
    sj = torch.tensor([2.0, 2.0], requires_grad=True)
    valid = torch.tensor([False, True])
    g = torch.where(valid, term.g(d, si, sj, valid), 0.0)
    grads = torch.autograd.grad(g.sum(), (d, si, sj))
    assert all(torch.isfinite(x).all() for x in grads)
    assert float(grads[1][0]) == 0.0


def test_tiles_cover_any_capacity_and_bound_the_extras():
    """Candidates are walked in tiles of 32 and receivers in tiles of at
    most 32, so the capacity never limits the kernels; shared memory bounds
    the extras width: the widest K that fits each kernel is taken, one more
    raises."""
    for c in (8, 80, 120, 1000):
        st = ps.PairStatic(b_tot=216, c=c, s_tot=63, k=41, cutoff=15.0)
        assert 1 <= ps.row_tile(st, ps.fwd_smem_bytes) <= ps.ROWS
        assert 1 <= ps.row_tile(st, ps.bwd_smem_bytes) <= ps.ROWS
    for smem in (ps.fwd_smem_bytes, ps.bwd_smem_bytes):
        v = 0
        while smem(ps.PairStatic(216, 80, 63, 2 * (v + 1) + 1, 15.0), 1) <= ps.SMEM_LIMIT:
            v += 1
        ps.row_tile(ps.PairStatic(216, 80, 63, 2 * v + 1, 15.0), smem)
        with pytest.raises(ValueError, match="extras"):
            ps.row_tile(ps.PairStatic(216, 80, 63, 2 * (v + 1) + 1, 15.0), smem)
        assert v >= 5 * 94  # every element of the D3 tables at once
