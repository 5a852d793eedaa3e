"""The port's stencil ConvSV against the JAX package (CPU).  The CUDA
kernels against their plain versions: tests/test_torch_gpu.py.

The case is the 40-atom 12 A periodic box of tests/test_pallas_conv.py
(2x2x2 bins: every bin recurs at several offsets as a periodic image), plus
the same atoms on a single bin.  Tolerance: 1e-5 of the output's largest
magnitude (f32 sums in another order)."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
from aimnetcentral_tpu.kernels import conv_pallas as jcp
from aimnetcentral_tpu.ops import binned as jB
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules
from aimnetcentral_tpu_torch.kernels import conv_stencil as tcs
from aimnetcentral_tpu_torch.kernels.conv_pass import ConvAcc, build_conv_tables, conv_pass
from aimnetcentral_tpu_torch.ops import binned as tB

CPU = torch.device("cpu")
REL = 1e-5
G_DIM, F_DIM = 16, 16
ETA, RC = 14.5, 5.0


def _close(actual, desired, rel=REL):
    desired = np.asarray(desired)
    scale = float(np.abs(desired).max())
    np.testing.assert_allclose(np.asarray(actual), desired, atol=rel * scale)


@pytest.fixture(scope="module", params=[5.2, 12.0], ids=["2x2x2", "1x1x1"])
def case(request):
    rng = np.random.default_rng(7)
    n, a = 40, 12.0
    coord = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=n)
    cell = np.eye(3, dtype=np.float32) * a
    mol = {"coord": coord, "numbers": numbers, "cell": cell}
    jgrid = jB.plan_bins(cell, n, request.param, safety=3.0)
    tgrid = tB.plan_bins(cell, n, request.param, safety=3.0)
    sysj, _p, ovf = jax.jit(jB.to_binned_system, static_argnums=(1, 2))(
        j_system_from_molecules([mol], build_nbmat=False), jgrid, None
    )
    syst, _p2, _o2 = tB.to_binned_system(t_system_from_molecules([mol], CPU), tgrid)
    assert int(ovf) == 0
    L = syst.natoms
    feats = {
        "a": (rng.normal(size=(L, F_DIM, G_DIM)) * 0.3).astype(np.float32),
        "q": (rng.normal(size=(L, 1)) * 0.1).astype(np.float32),
        "agh_a": (rng.normal(size=(F_DIM, G_DIM, 12)) * 0.2).astype(np.float32),
        "agh_q": (rng.normal(size=(1, G_DIM, 12)) * 0.2).astype(np.float32),
        "a_gm": (rng.normal(size=(L, G_DIM * (F_DIM + 1))) * 0.3).astype(np.float32),
        "gbar": rng.normal(size=(L * 4, G_DIM * (F_DIM + 1))).astype(np.float32),
    }
    return sysj, syst, feats


def _aev_np():
    return {
        "rc_s": np.float32(RC),
        "eta_s": np.float32(ETA),
        "shifts_s": np.linspace(0.8, 5.0, 17, dtype=np.float32)[:16],
    }


def _port_operands(syst, feats):
    """The port's kernel operands for features with F = 17 per g block."""
    grid = syst.bins
    radius = tB.stencil_radius(RC, grid)
    tab = build_conv_tables(grid, radius)
    b, c = grid.total_bins, grid.capacity
    f = F_DIM + 1
    st = tcs.ConvStatic(b_tot=b, c=c, g=G_DIM, f=f, s_tot=tab["nbr"].shape[0])
    shift = torch.tensor(tab["push"]) + torch.tensor(tab["wraps"]) @ syst.cell[0]
    ops = dict(
        a_gmajor=torch.tensor(feats["a_gm"]).reshape(b, c, G_DIM * f),
        coord=syst.coord.reshape(b, c, 3),
        mask=(syst.numbers > 0).float().reshape(b, c),
        shift=shift,
        nbr=torch.tensor(tab["nbr"]),
        shifts_g=torch.tensor(_aev_np()["shifts_s"]),
        scal=torch.tensor([ETA, RC]),
    )
    return st, ops, torch.tensor(tab["mnbr"]), radius


def _jax_twin(sysj, feats, radius):
    grid = sysj.bins
    b, c = grid.total_bins, grid.capacity
    f = F_DIM + 1
    tab = jcp.build_conv_tables(grid, radius, sysj.cell[0])
    st = jcp.ConvStatic(b_tot=b, c=c, g=G_DIM, f=f, gamma=1, s_tot=tab["s_tot"])
    coord_t = jnp.concatenate(
        [sysj.coord.reshape(b, c, 3).transpose(0, 2, 1), jnp.zeros((b, 1, c), jnp.float32)], axis=1
    )
    mask = (sysj.numbers > 0).astype(jnp.float32).reshape(b, 1, c)
    shifts_g = jnp.asarray(_aev_np()["shifts_s"]).reshape(1, G_DIM)
    scal = jnp.asarray([[ETA, RC, 0.0, 0.0]], jnp.float32)
    a_gm = jnp.asarray(feats["a_gm"]).reshape(b, c, G_DIM * f)

    def twin(a_, c_, s_):
        return jcp._conv_acc_xla(st, a_, c_, s_, mask, tab["nbr"], shifts_g, scal)

    return twin, (a_gm, coord_t, tab["shift_cart"])


def test_plain_forward_matches_jax_twin(case):
    sysj, syst, feats = case
    st, ops, _mnbr, radius = _port_operands(syst, feats)
    twin, args = _jax_twin(sysj, feats, radius)
    ref = np.asarray(twin(*args)).reshape(st.b_tot, 4, st.c, -1)
    _close(tcs.conv_forward_plain(st, **ops).numpy(), ref)


def test_conv_pass_matches_jax_plain(case):
    sysj, syst, feats = case
    aev_np = _aev_np()
    ref_a, ref_q = jcp.conv_pass_pallas(
        sysj, {k: jnp.asarray(v) for k, v in aev_np.items()}, jnp.asarray(feats["a"]),
        jnp.asarray(feats["q"]), jnp.asarray(feats["agh_a"]), jnp.asarray(feats["agh_q"]),
        rc_static=RC, interpret_xla=True,
    )
    out_a, out_q = conv_pass(
        syst, {k: torch.tensor(v) for k, v in aev_np.items()}, torch.tensor(feats["a"]),
        torch.tensor(feats["q"]), torch.tensor(feats["agh_a"]), torch.tensor(feats["agh_q"]),
        rc_static=RC,
    )
    _close(out_a.numpy(), ref_a)
    _close(out_q.numpy(), ref_q)


def test_autograd_matches_jax_vjp(case):
    """The autograd.Function's gradients (a, coord, lattice shift)."""
    sysj, syst, feats = case
    st, ops, mnbr, radius = _port_operands(syst, feats)
    twin, args = _jax_twin(sysj, feats, radius)
    gbar = feats["gbar"].reshape(st.b_tot, 4, st.c, -1)
    ga_j, gc_j, gs_j = jax.jit(lambda ct: jax.vjp(twin, *args)[1](ct))(
        jnp.asarray(gbar.reshape(st.b_tot, 4 * st.c, -1))
    )

    leaves = {k: ops[k].clone().requires_grad_(True) for k in ("a_gmajor", "coord", "shift")}
    out = ConvAcc.apply(
        leaves["a_gmajor"], leaves["coord"], leaves["shift"], st, ops["mask"], ops["nbr"], mnbr,
        ops["shifts_g"], ops["scal"],
    )
    ga, gc, gs = torch.autograd.grad(out, list(leaves.values()), torch.tensor(gbar))
    _close(ga.numpy(), ga_j)
    _close(gc.numpy(), np.asarray(gc_j)[:, :3].transpose(0, 2, 1))
    _close(gs.numpy(), np.asarray(gs_j)[..., :3])


def _kernel_b_emulation(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar):
    """What csrc/conv_bwd.cu computes, written out in torch: the
    receiver-centric mirror sweep with the chain rule by hand, then the
    wrapper's gather.  Holds the kernel's algorithm and the gather against
    autograd on the CPU."""
    b, c, g, f = st.b_tot, st.c, st.g, st.f
    eta, rc = float(scal[0]), float(scal[1])
    a4 = a_gmajor.reshape(b, c, g, f)
    gb4 = gbar.reshape(b, 4, c, g, f)
    grad_a = torch.zeros(b, c, g, f)
    dc_recv = torch.zeros(b, c, 3)
    pgrad = torch.zeros(st.s_tot, b, 3, c)
    for s in range(st.s_tot):
        p = mnbr[s].long()
        live = (p >= 0).float()
        p = p.clamp(min=0)
        xi = coord[p] - shift[s][p][:, None, :]
        diff = coord[:, None, :, :] - xi[:, :, None, :]  # (B, Ci partner, Cj receiver, 3)
        vp = (mask[p] > 0.5)[:, :, None] & (mask > 0.5)[:, None, :]
        if s == 0:
            vp = vp & ~torch.eye(c, dtype=torch.bool)[None]
        d = torch.sqrt(torch.where(vp, (diff * diff).sum(-1), torch.ones(())))
        within = vp & (d < rc)
        arg = torch.clamp(d, max=rc) * (math.pi / rc)
        fc = torch.where(within, 0.5 * (torch.cos(arg) + 1.0), 0.0)
        fcp = torch.where(within, -0.5 * (math.pi / rc) * torch.sin(arg), 0.0)
        u = diff / d[..., None]
        dd = d[..., None] - shifts_g
        e = torch.exp(-eta * dd * dd)
        gs = e * fc[..., None]
        dgs = e * (fcp[..., None] - 2.0 * eta * dd * fc[..., None])
        gbp = gb4[p]
        wbar = torch.einsum("bkigf,bjgf->bkijg", gbp, a4)
        gsbar = wbar[:, 0] + sum(wbar[:, k + 1] * u[..., k, None] for k in range(3))
        ubar = torch.stack([(wbar[:, k + 1] * gs).sum(-1) for k in range(3)], dim=-1)
        dbar = (gsbar * dgs).sum(-1)
        w = torch.stack([gs] + [gs * u[..., k, None] for k in range(3)], dim=1)
        grad_a += torch.einsum("bkijg,bkigf->bjgf", w, gbp) * live[:, None, None, None]
        uu = (ubar * u).sum(-1, keepdim=True)
        rbar = within[..., None] * (dbar[..., None] * u + (ubar - uu * u) / d[..., None])
        dc_recv += rbar.sum(1) * live[:, None, None]
        pgrad[s] = -rbar.sum(2).transpose(1, 2) * live[:, None, None]
    dc, ds = tcs.gather_partner_adjoints(st, nbr, dc_recv, pgrad)
    return grad_a.reshape(b, c, g * f), dc, ds


def test_kernel_b_algorithm_matches_autograd(case):
    _sysj, syst, feats = case
    st, ops, mnbr, _radius = _port_operands(syst, feats)
    gbar = torch.tensor(feats["gbar"]).reshape(st.b_tot, 4, st.c, -1)
    ref = tcs.conv_backward_plain(st, **ops, gbar=gbar)
    emu = _kernel_b_emulation(st, **ops, mnbr=mnbr, gbar=gbar)
    for e, r in zip(emu, ref):
        _close(e.numpy(), r.numpy())


def test_second_order_raises(case):
    """The adjoint is first order only: grad-of-grad must raise, not lie."""
    _sysj, syst, feats = case
    st, ops, mnbr, _radius = _port_operands(syst, feats)
    coord = ops["coord"].clone().requires_grad_(True)
    out = ConvAcc.apply(
        ops["a_gmajor"], coord, ops["shift"], st, ops["mask"], ops["nbr"], mnbr,
        ops["shifts_g"], ops["scal"],
    )
    (g,) = torch.autograd.grad((out * out).sum(), coord, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


@pytest.mark.parametrize("f", [16, 17, 33])
def test_kernel_tiles_fit_the_card(f):
    """The wrappers' tile choice keeps every capacity the planner can give
    inside the kernels' register and shared-memory budgets."""
    for c in range(8, 257, 8):
        st = tcs.ConvStatic(b_tot=1, c=c, g=G_DIM, f=f, s_tot=27)
        ti = tcs.fwd_tile(st)
        assert ti * f <= tcs.MAX_OUT_PER_THREAD * tcs.THREADS
        assert tcs.fwd_smem_bytes(st, ti) <= tcs.SMEM_LIMIT
        tj, ti = tcs.bwd_tiles(st)
        assert tj <= 64 and ti <= c and tj * ti <= tcs.MAX_PAIRS_PER_THREAD * tcs.THREADS
        assert tcs.bwd_smem_bytes(st, tj, ti) <= tcs.SMEM_LIMIT
    st = tcs.ConvStatic(b_tot=512, c=40, g=G_DIM, f=17, s_tot=27)
    assert tcs.fwd_tile(st) == 40 and tcs.bwd_tiles(st) == (40, 40)  # one tile at the flagship's grid
