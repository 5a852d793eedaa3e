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
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

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
        "alpha": rng.uniform(0.5, 3.0, size=L).astype(np.float32),  # SRRep's and D3TS's, > 0 everywhere
        "zeff": rng.uniform(1.0, 14.0, size=L).astype(np.float32),
        "c6": rng.uniform(1.0, 30.0, size=L).astype(np.float32) * real,
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


def _walk(st, ops):
    """The pairs of csrc/pair_walk.cuh's walk: the full stencil from each
    receiver's side in the kernels' order (the zero offset, the upper half
    through ``nbr``, the lower half through ``inv`` with the displacement
    rounded as its half-stencil view rounds it; an offset skipped where the
    candidate bin's box of real atoms lies beyond the cutoff, which must
    drop no pair), the real pairs within the cutoff compacted into each
    receiver's queue in (offset, slot) order, each on lane ``position %
    32``.  Returns ``(recv, offs, cand, diff, lane, counts)``."""
    coord, mask, shift, nbr, inv = (ops[k] for k in ("coord", "mask", "shift", "nbr", "inv"))
    b, c, s_tot = st.b_tot, st.c, st.s_tot
    n_rows = b * c
    real = mask > 0.5
    slot = torch.arange(c)
    box = ps.bin_boxes(coord, mask)
    d2_max = _d2_limit(st.cutoff)
    recv, offs, cand, diffs = [], [], [], []
    for o in range(2 * s_tot - 1):
        lower = o >= s_tot
        h = o - s_tot + 1 if lower else o
        n = (inv[h] if lower else nbr[h]).long()
        has = (n >= 0) & (n < b)
        n = torch.where(has, n, 0)
        sh = shift[h][n if lower else torch.arange(b)][:, None, None, :]
        xi, xj = coord[:, :, None, :], coord[n][:, None, :, :]
        diff = -((xi + sh) - xj) if lower else (xj + sh) - xi  # (B, Ci, Cj, 3)
        dx, dy, dz = diff.unbind(-1)
        ok = real[:, :, None] & real[n][:, None, :] & has[:, None, None]
        d2 = (dx * dx + dy * dy) + dz * dz
        assert torch.equal(torch.sqrt(d2) < st.cutoff, d2 < d2_max)
        ok &= d2 < d2_max
        sgn = -1.0 if lower else 1.0
        lo, hi = box[n][:, None, :3] + sgn * sh[:, 0], box[n][:, None, 3:] + sgn * sh[:, 0]
        e = torch.clamp(torch.maximum(lo - coord, coord - hi), min=0.0)  # (B, Ci, 3)
        far = (e * e).sum(-1) > 1.0001 * d2_max + 1e-6
        assert not (ok & far[:, :, None]).any()  # the skip drops no pair
        ok &= ~far[:, :, None]
        if o == 0:
            ok &= slot[:, None] != slot[None, :]
        bi, ii, jj = ok.nonzero(as_tuple=True)
        recv.append(bi * c + ii)
        offs.append(torch.full_like(bi, o))
        cand.append(n[bi] * c + jj)
        diffs.append(diff[bi, ii, jj])
    recv, offs, cand, diff = (torch.cat(x) for x in (recv, offs, cand, diffs))
    order = torch.argsort((recv * (2 * s_tot) + offs) * n_rows + cand, stable=True)  # the queue order
    recv, offs, cand, diff = recv[order], offs[order], cand[order], diff[order]
    counts = torch.bincount(recv, minlength=n_rows)
    first = torch.cumsum(counts, 0) - counts
    lane = (torch.arange(len(recv)) - first[recv]) % 32
    return recv, offs, cand, diff, lane, counts


def _lanes(n_rows, recv, lane, x):
    """Each lane's partial sums, then the butterfly over the lanes."""
    acc = torch.zeros((n_rows, 32) + x.shape[1:])
    acc.index_put_((recv, lane), x, accumulate=True)
    return acc.sum(1)


def _kernel_emulation(st, term, ops, ct):
    """What csrc/pair_walk.cuh computes (kernels D and E), written out in
    torch: the pairs of ``_walk``, with the o = 0 / upper / lower
    conventions and each term's hand derivatives, the lanes' partial sums
    added in lane order, the per-(receiver, half offset) shift rows, and
    the wrapper's sum of those rows over each bin's atoms.  Returns
    ``(out, (grad_coord, grad_ext, grad_shift), pair counts per receiver
    row)``."""
    b, c, v, s_tot, k = st.b_tot, st.c, st.v, st.s_tot, st.k
    n_rows = b * c
    recv, offs, cand, diff, lane, counts = _walk(st, ops)
    e_flat, ct_flat = ops["ext"].reshape(n_rows, k), ct.reshape(-1)
    d = torch.sqrt((diff * diff).sum(-1))
    si, sj = e_flat[recv, 2 * v :], e_flat[cand, 2 * v :]
    if st.ns == 1:
        si, sj = si[:, 0], sj[:, 0]
    valid = torch.ones_like(d, dtype=torch.bool)
    g, gd, gsi, _gsj = term.g_grad(d, si, sj, valid)
    if v:
        cij = (e_flat[recv, :v] * e_flat[cand, v : 2 * v]).sum(-1)
        cji = (e_flat[cand, :v] * e_flat[recv, v : 2 * v]).sum(-1)
    else:
        cij = cji = torch.ones_like(d)
    kind = torch.where(offs == 0, 0, torch.where(offs < s_tot, 1, 2))
    cti, ctj = ct_flat[recv], ct_flat[cand]
    zero = torch.zeros_like(d)
    cp = torch.where(kind == 0, cti, torch.where(kind == 1, cti + ctj, zero))  # on c_ij
    cq = torch.where(kind == 0, ctj, torch.where(kind == 2, cti + ctj, zero))  # on c_ji
    eff = cp * cij + cq * cji

    def lanes(x):
        return _lanes(n_rows, recv, lane, x)

    out = lanes(torch.where(kind == 2, cji, cij) * g)
    grad_coord = lanes(-(eff * gd / d)[:, None] * diff)
    grad_ext = torch.zeros(n_rows, k)
    grad_ext[:, 2 * v :] = lanes((eff * gsi)[:, None] if st.ns == 1 else eff[:, None] * gsi)
    if v:
        grad_ext[:, :v].index_add_(0, recv, (cp * g)[:, None] * e_flat[cand, v : 2 * v])
        grad_ext[:, v : 2 * v].index_add_(0, recv, (cq * g)[:, None] * e_flat[cand, :v])
    rows = torch.zeros(n_rows, s_tot, 3)
    upper = kind < 2
    rows.index_put_((recv[upper], offs[upper]), ((cp * cij * gd / d)[:, None] * diff)[upper], accumulate=True)
    grad_shift = rows.reshape(b, c, s_tot, 3).sum(1).transpose(0, 1)
    return (out.reshape(b, c), (grad_coord.reshape(b, c, 3), grad_ext.reshape(b, c, k), grad_shift),
            counts)


def _member_emulation(st, term, ops, ct):
    """The member form of csrc/pair_walk.cuh in torch: the pairs of
    ``_walk``; per pair each member's value and hand derivatives
    (``MemberTerm.g_grad``: one shared factor, E products), E lanes' sums
    a receiver, the pair cotangent ``ct_i,m + ct_j,m`` on every kind of
    offset, the shift rows from ``cp_m`` (``ct_i,m`` at o = 0, the pair's
    on the upper half).  Returns ``(out (B, C, E), (grad_coord, grad_ext,
    grad_shift), counts)``."""
    b, c, s_tot, k = st.b_tot, st.c, st.s_tot, st.k
    n_rows = b * c
    recv, offs, cand, diff, lane, counts = _walk(st, ops)
    e_flat, ct_flat = ops["ext"].reshape(n_rows, k), ct.reshape(n_rows, -1)
    d = torch.sqrt((diff * diff).sum(-1))
    g, gd, jac = term.g_grad(d, e_flat[recv], e_flat[cand], torch.ones_like(d, dtype=torch.bool))
    kind = torch.where(offs == 0, 0, torch.where(offs < s_tot, 1, 2))[:, None]
    cti, ctj = ct_flat[recv], ct_flat[cand]
    eff = cti + ctj  # (P, E)
    cp = torch.where(kind == 0, cti, torch.where(kind == 1, eff, torch.zeros_like(eff)))
    out = _lanes(n_rows, recv, lane, g)
    grad_coord = _lanes(n_rows, recv, lane, -((eff * gd).sum(-1) / d)[:, None] * diff)
    grad_ext = _lanes(n_rows, recv, lane, (eff[..., None] * jac).sum(1))
    rows = torch.zeros(n_rows, s_tot, 3)
    upper = kind[:, 0] < 2
    rows.index_put_((recv[upper], offs[upper]), (((cp * gd).sum(-1) / d)[:, None] * diff)[upper], accumulate=True)
    grad_shift = rows.reshape(b, c, s_tot, 3).sum(1).transpose(0, 1)
    return (out.reshape(b, c, -1), (grad_coord.reshape(b, c, 3), grad_ext.reshape(b, c, k), grad_shift), counts)


def _d2_limit(c: float) -> float:
    """csrc/pair_walk.cuh::d2_limit: the least f32 x with sqrt(x) >= c."""
    c, x = np.float32(c), np.float32(c) * np.float32(c)
    while x > 0 and np.sqrt(np.nextafter(x, np.float32(0))) >= c:
        x = np.nextafter(x, np.float32(0))
    while np.sqrt(x) < c:
        x = np.nextafter(x, np.float32(np.inf))
    return float(x)


def _half_pair_count(st, ops) -> int:
    """Unordered real pairs within the cutoff as the plain sweep tests them."""
    coord, mask, shift, nbr = ops["coord"], ops["mask"], ops["shift"], ops["nbr"]
    total = 0
    for s in range(st.s_tot):
        n = nbr[s].clamp(min=0).long()
        diff = (coord[n] + shift[s][:, None, :])[:, None, :, :] - coord[:, :, None, :]
        ok = (mask > 0.5)[:, :, None] & (mask[n] > 0.5)[:, None, :] & (nbr[s] >= 0)[:, None, None]
        ok &= torch.sqrt((diff * diff).sum(-1)) < st.cutoff
        if s == 0:  # both orderings of each pair
            ok &= ~torch.eye(st.c, dtype=torch.bool)[None]
            total += int(ok.sum()) // 2
        else:
            total += int(ok.sum())
    return total


@pytest.mark.parametrize(
    "term_name", ["dsf_exp", "d3_cn", "d3_energy", "coulomb_sr", "ewald_real", "srrep", "d3ts"]
)
def test_kernel_algorithm_matches_plain(case, term_name):
    """Kernels D and E's algorithm (full stencil from the receiver's side,
    compacted pairs in lanes of 32) against the plain forward and its
    autograd, and the pairs it contracts against the plain count.  The SR
    Coulomb term sweeps at its own rc (4.6 A), below the grids' edges, as
    does SRRep (4.0 A); SRRep (two scalars an atom) and D3TS (three) check
    every scalar's adjoint."""
    _bj, bt, cutoff, layout, ex = case
    if term_name == "coulomb_sr":
        term, cutoff = ps.CoulombSRTerm(rc=4.6), 4.6
    elif term_name == "srrep":
        term, cutoff = ps.SRRepTerm(rc=4.0, cutoff_fn="cosine_cutoff"), 4.0
    elif term_name == "ewald_real":
        term = ps.EwaldRealTerm(eta=cutoff / 5.26, rc=4.6, subtract_sr=True)
    elif term_name == "d3ts":
        term = ps.D3TSTerm(a1=0.49, a2=3.5, s8=0.78)
    else:
        term = _terms(cutoff)[term_name][0]
    extras = {k: torch.tensor(ex[k]) for k in list(term.vector_keys) + list(term.scalar_keys)}
    st, ops = teb.pair_operands(bt, cutoff, term, extras, layout)
    args = {k: ops[k] for k in ("coord", "mask", "ext", "shift", "nbr", "inv")}
    ct = torch.tensor(np.random.default_rng(6).normal(size=(st.b_tot, st.c)).astype(np.float32))
    emu_out, emu_grads, counts = _kernel_emulation(st, term, ops, ct)
    _close(emu_out.numpy(), ps.pair_forward_plain(st, term, **args).numpy(), 1e-5)
    ref = ps.pair_backward_plain(st, term, **args, ct=ct)
    for e, r in zip(emu_grads, ref):
        _close(e.numpy(), r.numpy(), 3e-5)
    if st.v:  # the p and r columns each, not only their sum
        for cols in (slice(0, st.v), slice(st.v, 2 * st.v)):
            _close(emu_grads[1][..., cols].numpy(), ref[1][..., cols].numpy(), 3e-5)
    assert torch.equal(counts, ps.pair_counts_plain(st, **{k: args[k] for k in args if k != "ext"}))
    assert int(counts.sum()) == 2 * _half_pair_count(st, ops) > 0


@pytest.mark.parametrize("name", ["ewald_real", "srrep", "d3ts"])
def test_long_range_terms_binned_match_jax(case, name):
    """``ewald_real_binned`` (LR layout), ``srrep_binned`` (SR layout) and
    ``d3ts_binned`` (LR layout) against JAX's: per-molecule energy and its
    coordinate gradient, and the gradient of the charges, of the GFN1 table
    or of the dispersion parameters, within 1e-5 of their largest magnitude (3e-5 for
    the gradients)."""
    bj, bt, cutoff, _layout, ex = case
    eta = cutoff / 5.26  # the real-space cutoff of accuracy 1e-6 is 5.26 eta
    table = jnp.asarray(np.random.default_rng(8).uniform(1.0, 3.0, size=(95,)).astype(np.float32))
    gfn1 = jnp.asarray(np.stack([np.random.default_rng(9).uniform(0.5, 2.5, 95),
                                 np.random.default_rng(10).uniform(1.0, 14.0, 95)], -1).astype(np.float32))
    dp = np.stack([ex["c6"], ex["alpha"]], -1)

    def j_energy(coord, x):
        s = bj.replace(coord=coord)
        if name == "ewald_real":
            e = jeb.ewald_real_binned(s, x, float(np.float32(eta)), cutoff)
        elif name == "srrep":
            e = jeb.srrep_binned(s, x, 4.0, "cosine_cutoff")
        else:
            e = jeb.d3ts_binned(s, {"r4r2": table}, x, 0.49, 3.5, 0.78)
        return e.sum(), e

    x0 = {"ewald_real": ex["q"], "srrep": np.asarray(gfn1), "d3ts": dp}[name]
    (_e, je), jg = jax.value_and_grad(j_energy, argnums=(0, 1), has_aux=True)(bj.coord, jnp.asarray(x0))
    coord = bt.coord.clone().requires_grad_(True)
    xt = torch.tensor(x0, requires_grad=True)
    s = bt.replace(coord=coord)
    if name == "ewald_real":
        te = teb.ewald_real_binned(s, xt, float(np.float32(eta)), cutoff)
    elif name == "srrep":
        te = teb.srrep_binned(s, xt, 4.0, "cosine_cutoff")
    else:
        te = teb.d3ts_binned(s, {"r4r2": torch.tensor(np.asarray(table))}, xt, 0.49, 3.5, 0.78)
    tg = torch.autograd.grad(te.sum(), (coord, xt))
    _close(te.detach().numpy(), je, 1e-5)
    _close(tg[0].numpy(), jg[0], 3e-5)
    _close(tg[1].numpy(), jg[1], 3e-5)
    assert float(np.abs(np.asarray(je)).max()) > 0.0


@pytest.mark.parametrize("envelope", ["exp", "cosine"])
def test_coulomb_sr_binned_matches_jax(case, envelope):
    """``coulomb_sr_binned`` on the SR grid (spatial, periodic) against JAX's:
    per-molecule energy and its coordinate and charge gradients, within
    1e-5 of their largest magnitude."""
    bj, bt, _cutoff, _layout, ex = case
    q = ex["q"]

    def j_energy(coord, qj):
        e = jeb.coulomb_sr_binned(bj.replace(coord=coord), qj, 4.6, envelope)
        return e.sum(), e

    (_e, je), jg = jax.value_and_grad(j_energy, argnums=(0, 1), has_aux=True)(bj.coord, jnp.asarray(q))
    coord = bt.coord.clone().requires_grad_(True)
    qt = torch.tensor(q, requires_grad=True)
    te = teb.coulomb_sr_binned(bt.replace(coord=coord), qt, 4.6, envelope)
    tg = torch.autograd.grad(te.sum(), (coord, qt))
    _close(te.detach().numpy(), je, 1e-5)
    _close(tg[0].numpy(), jg[0], 1e-5)
    _close(tg[1].numpy(), jg[1], 1e-5)
    assert float(np.abs(np.asarray(je)).max()) > 0.0


def test_second_order_raises(case):
    """Grad-of-grad through PairAcc (it raised while the adjoint was first
    order only, hence the name): the K3 rule gives the JAX plain sweep's
    second derivative of ``sum(cn^2)`` in the coordinates, within 3e-5 of
    its largest magnitude (the first-order gradients' tolerance)."""
    bj, bt, cutoff, layout, ex = case
    term, j_fn = _terms(cutoff)["d3_cn"]
    rcov = ex["rcov"]

    def j_inner(coord):
        out = jeb.pair_energy_binned(bj.replace(coord=coord), cutoff, j_fn, {"rcov": jnp.asarray(rcov)},
                                     layout, allow_pallas=False)
        return (out * out).sum()

    ref = jax.jit(jax.grad(lambda c: jax.grad(j_inner)(c).sum()))(bj.coord)
    coord = bt.coord.clone().requires_grad_(True)
    out = teb.pair_energy_binned(bt.replace(coord=coord), cutoff, term, {"rcov": torch.tensor(rcov)}, layout)
    (g,) = torch.autograd.grad((out * out).sum(), coord, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), coord)
    assert torch.isfinite(gg).all()
    _close(gg.numpy(), ref, 3e-5)


def _distances(term) -> np.ndarray:
    """Random distances plus each term's edges: the clamps, its envelope's
    end, the S5 switch region and the cutoff."""
    rng = np.random.default_rng(3)
    d = list(rng.uniform(0.4, 18.0, size=200))
    if isinstance(term, ps.DSFTerm):
        rc = term.rc
        d += [rc * (1.0 - 1e-6), rc, rc - 1e-3, rc + 1e-3, term.dsf_rc - 1e-3, term.dsf_rc + 0.5]
    elif isinstance(term, (ps.CoulombSimpleTerm, ps.CoulombSRTerm)):
        rc = term.rc
        d += [rc * (1.0 - 1e-6), rc, rc - 1e-3, rc + 1e-3, 40.0]
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
    "simple_exp": ps.CoulombSimpleTerm(rc=4.6),
    "simple_cosine": ps.CoulombSimpleTerm(rc=4.6, envelope="cosine"),
    "simple_no_sr": ps.CoulombSimpleTerm(rc=4.6, subtract_sr=False),
    "sr_exp": ps.CoulombSRTerm(rc=4.6),
    "sr_cosine": ps.CoulombSRTerm(rc=4.6, envelope="cosine"),
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


def test_kernel_widths():
    """One warp per receiver row takes any capacity; the extras' width is
    bounded by the vector columns a lane of kernel E holds: V = 70 (all 14
    elements of the released models, five references each) is taken at the
    10,000-atom LR shapes and at a wider stencil, V = MAX_V too, one more
    column raises, as do extras that are not [p, r, s]."""
    d3, cn = HAND_TERMS["d3_energy"], HAND_TERMS["d3_cn"]
    for c in (8, 80, 120, 1000):
        st = ps.PairStatic(b_tot=216, c=c, s_tot=63, k=2 * 70 + 1, cutoff=15.0)
        ps.check_width(st, d3)
        assert ps.blocks(st) * ps.WARPS >= 216 * c
    for s_tot, v in ((63, 70), (172, 70), (63, ps.MAX_V)):
        st = ps.PairStatic(b_tot=216, c=80, s_tot=s_tot, k=2 * v + 1, cutoff=15.0)
        ps.check_width(st, d3)
        assert ps.smem_bytes(st, adjoint=True) <= ps.SMEM_LIMIT
    with pytest.raises(ValueError, match="V <= "):
        ps.check_width(ps.PairStatic(216, 80, 63, 2 * (ps.MAX_V + 1) + 1, 15.0), d3)
    with pytest.raises(ValueError, match="extras"):
        ps.check_width(ps.PairStatic(216, 80, 63, 3, 15.0), cn)
    assert ps.bwd_scratch_bytes(ps.PairStatic(216, 80, 63, 41, 15.0)) == 216 * 80 * 63 * 3 * 4


def _member_term(name: str, cutoff: float, n: int):
    """The member form of a term of the sweep tests, with the cutoff it
    sweeps at."""
    base = {
        "dsf": ps.DSFTerm(alpha=0.2, dsf_rc=cutoff, rc=4.6),
        "coulomb_simple": ps.CoulombSimpleTerm(rc=4.6),
        "coulomb_sr": ps.CoulombSRTerm(rc=4.6),
        "ewald_real": ps.EwaldRealTerm(eta=cutoff / 5.26, rc=4.6, subtract_sr=True),
        "d3ts": ps.D3TSTerm(a1=0.49, a2=3.5, s8=0.78),
    }[name]
    return ps.MemberTerm(base, n), (4.6 if name == "coulomb_sr" else cutoff)


def _member_extras(ex: dict, n: int) -> dict[str, torch.Tensor]:
    """Per-member charges, C6 and alpha (L, n) from the case's seeded
    draws, and the shared r4r2 (L,)."""
    rng = np.random.default_rng(21)
    L = len(ex["q"])
    real = (np.abs(ex["q"]) > 0).astype(np.float32)
    return {
        "q": torch.tensor((rng.normal(size=(L, n)) * 0.3).astype(np.float32) * real[:, None]),
        "c6": torch.tensor(rng.uniform(1.0, 30.0, size=(L, n)).astype(np.float32)),
        "alpha": torch.tensor(rng.uniform(0.5, 3.0, size=(L, n)).astype(np.float32)),
        "rr": torch.tensor(ex["rr"]),
    }


@pytest.mark.parametrize("name", ["dsf", "coulomb_simple", "coulomb_sr", "ewald_real", "d3ts"])
def test_member_kernel_algorithm_matches_plain(case, name):
    """The member form of kernels D and E (one geometry and shared factor a
    pair, E = 3 outputs a receiver) against its plain version and the
    plain version's autograd, the pairs it contracts against the plain
    count, and each member's sums against the single term swept with that
    member's extras: sums 1e-5, gradients 3e-5 of their largest magnitude."""
    _bj, bt, cutoff, layout, ex = case
    term, cutoff = _member_term(name, cutoff, 3)
    extras = _member_extras(ex, 3)
    st, ops = teb.pair_operands(bt, cutoff, term, extras, layout)
    assert st.members == 3 and st.k == len(term.shared_keys) + 3 * len(term.member_keys)
    args = {k: ops[k] for k in ("coord", "mask", "ext", "shift", "nbr", "inv")}
    ct = torch.tensor(np.random.default_rng(6).normal(size=(st.b_tot, st.c, 3)).astype(np.float32))
    emu_out, emu_grads, counts = _member_emulation(st, term, ops, ct)
    plain = ps.pair_forward_plain(st, term, **args)
    assert plain.shape == (st.b_tot, st.c, 3)
    _close(emu_out.numpy(), plain.numpy(), 1e-5)
    for e, r in zip(emu_grads, ps.pair_backward_plain(st, term, **args, ct=ct)):
        _close(e.numpy(), r.numpy(), 3e-5)
    assert torch.equal(counts, ps.pair_counts_plain(st, **{k: args[k] for k in args if k != "ext"}))
    for m in range(3):
        single = {k: (v[:, m] if v.dim() == 2 else v) for k, v in extras.items()}
        st1, ops1 = teb.pair_operands(bt, cutoff, term.term, single, layout)
        one = ps.pair_forward_plain(st1, term.term, **{k: ops1[k] for k in args})
        _close(plain[..., m].numpy(), one.numpy(), 1e-5)
    assert float(plain.abs().max()) > 0.0


@pytest.mark.parametrize("name", ["dsf", "coulomb_sr", "ewald_real", "d3ts"])
def test_multi_sweeps_match_jax(case, name):
    """``coulomb_dsf_binned_multi``, ``coulomb_sr_binned_multi``,
    ``ewald_real_binned_multi`` and ``d3ts_binned_multi`` (E = 3) against
    JAX's: per-member energies and the gradients of the coordinates and of
    the member-stacked charges or dispersion parameters, for a seeded
    cotangent of the members' energies; 1e-5 of the largest magnitude (3e-5
    for the gradients)."""
    bj, bt, cutoff, _layout, ex = case
    ext = _member_extras(ex, 3)
    eta = cutoff / 5.26
    table = np.random.default_rng(8).uniform(1.0, 3.0, size=(95,)).astype(np.float32)
    w = np.random.default_rng(9).normal(size=(1, 3)).astype(np.float32)
    x0 = (torch.stack([ext["c6"], ext["alpha"]], -1) if name == "d3ts" else ext["q"]).numpy()

    def run(mod, s, x, tab):
        if name == "dsf":
            return mod.coulomb_dsf_binned_multi(s, x, 4.6, 0.2, cutoff, "exp", True)
        if name == "coulomb_sr":
            return mod.coulomb_sr_binned_multi(s, x, 4.6, "exp")
        if name == "ewald_real":
            return mod.ewald_real_binned_multi(s, x, float(np.float32(eta)), cutoff)
        return mod.d3ts_binned_multi(s, {"r4r2": tab}, x, 0.49, 3.5, 0.78)

    def j_loss(coord, x):
        e = run(jeb, bj.replace(coord=coord), x, jnp.asarray(table))
        return (e * w).sum(), e

    (_l, je), jg = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(bj.coord, jnp.asarray(x0))
    coord = bt.coord.clone().requires_grad_(True)
    xt = torch.tensor(x0, requires_grad=True)
    te = run(teb, bt.replace(coord=coord), xt, torch.tensor(table))
    tg = torch.autograd.grad((te * torch.tensor(w)).sum(), (coord, xt))
    assert te.shape == (1, 3)
    _close(te.detach().numpy(), je, 1e-5)
    _close(tg[0].numpy(), jg[0], 3e-5)
    _close(tg[1].numpy(), jg[1], 3e-5)


@pytest.mark.parametrize("name", ["dsf", "coulomb_simple", "coulomb_sr", "ewald_real", "d3ts"])
def test_member_hand_derivatives_match_autograd(name):
    """``MemberTerm.g_grad`` (the formulas of csrc/pair_terms.cuh's member
    functors: each member's value, dg/dd and the receiver's packed scalars'
    Jacobian) against autograd of ``MemberTerm.g`` in float64, member by
    member, within 1e-6 of the largest magnitude."""
    term, _cut = _member_term(name, 15.0, 3)
    rng = np.random.default_rng(5)
    n_pairs, k = 200, len(term.scalar_keys)
    d = torch.tensor(rng.uniform(0.8, 14.0, size=n_pairs), dtype=torch.float64, requires_grad=True)
    si = torch.tensor(rng.uniform(0.5, 3.0, size=(n_pairs, k)), dtype=torch.float64, requires_grad=True)
    sj = torch.tensor(rng.uniform(0.5, 3.0, size=(n_pairs, k)), dtype=torch.float64)
    valid = torch.ones(n_pairs, dtype=torch.bool)
    g = term.g(d, si, sj, valid)
    hg, hd, jac = term.g_grad(d.detach(), si.detach(), sj, valid)
    _close(hg.numpy(), g.detach().numpy(), 1e-6)
    for m in range(3):
        ad, asi = torch.autograd.grad(g[:, m].sum(), (d, si), retain_graph=True)
        _close(hd[:, m].numpy(), ad.numpy(), 1e-6)
        _close(jac[:, m].numpy(), asi.numpy(), 1e-6)


def test_member_kernel_limits():
    """The member form takes 1 to MAX_MEMBERS = 8 members of the five
    terms (accumulators a lane of D and E); its extras are [shared, member
    scalars]; E's shared memory and shift rows do not grow with E."""
    for name in ("dsf", "coulomb_simple", "coulomb_sr", "ewald_real", "d3ts"):
        term, _c = _member_term(name, 15.0, ps.MAX_MEMBERS)
        k = len(term.scalar_keys)
        st = ps.PairStatic(b_tot=216, c=80, s_tot=63, k=k, cutoff=15.0, ns=k, members=ps.MAX_MEMBERS)
        ps.check_width(st, term)
        assert ps.smem_bytes(st, adjoint=True) <= ps.SMEM_LIMIT
        assert ps.bwd_scratch_bytes(st) == ps.bwd_scratch_bytes(ps.PairStatic(216, 80, 63, 1, 15.0))
    assert len(_member_term("d3ts", 15.0, 8)[0].scalar_keys) == 1 + 2 * 8
    with pytest.raises(ValueError, match="members"):
        ps.MemberTerm(ps.D3TSTerm(a1=0.49, a2=3.5, s8=0.78), ps.MAX_MEMBERS + 1)
    with pytest.raises(ValueError, match="no member form"):
        ps.MemberTerm(ps.D3CNTerm(), 2)
    term, _c = _member_term("dsf", 15.0, 4)
    with pytest.raises(ValueError, match="members"):
        ps.check_width(ps.PairStatic(216, 80, 63, 4, 15.0, ns=4, members=3), term)
