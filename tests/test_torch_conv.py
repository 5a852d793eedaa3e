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
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

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


def _kernel_a_emulation(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal):
    """What csrc/conv_fwd.cu computes, written out in torch: per offset the
    real pairs within rc are picked out, their geometry is formed once per
    pair, gs once per pair and column c = (g, f), and each pair adds
    ``W_k a[j, c]`` to its receiver's four rows.  Returns the output and
    the pairs each receiver row contracted."""
    b, c, gf = st.b_tot, st.c, st.g * st.f
    eta, rc = float(scal[0]), float(scal[1])
    col_sg = shifts_g[torch.arange(gf) // st.f]
    a_rows = a_gmajor.reshape(b * c, gf)
    out = torch.zeros(b * c, 4, gf)
    counts = torch.zeros(b * c, dtype=torch.int64)
    for s in range(st.s_tot):
        n = nbr[s].long()
        nn = n.clamp(min=0)
        diff = (coord[nn] + shift[s][:, None, :])[:, None, :, :] - coord[:, :, None, :]
        vp = (mask > 0.5)[:, :, None] & (mask[nn] > 0.5)[:, None, :] & (n >= 0)[:, None, None]
        if s == 0:
            vp = vp & ~torch.eye(c, dtype=torch.bool)[None]
        d = torch.sqrt(torch.where(vp, (diff * diff).sum(-1), torch.ones(())))
        bi, ii, jj = (vp & (d < rc)).nonzero(as_tuple=True)  # the ballot: slots ascending
        dp = d[bi, ii, jj]
        u = diff[bi, ii, jj] / dp[:, None]
        fc = 0.5 * (torch.cos(dp * (math.pi / rc)) + 1.0)
        gs = torch.exp(-eta * (dp[:, None] - col_sg) ** 2) * fc[:, None]  # (P, G*F)
        w = torch.stack([gs] + [gs * u[:, k, None] for k in range(3)], dim=1)
        rows = bi * c + ii
        out.index_add_(0, rows, w * a_rows[nn[bi] * c + jj][:, None, :])
        counts.index_add_(0, rows, torch.ones_like(rows))
    return out.reshape(b, c, 4, gf).transpose(1, 2), counts


def _kernel_b_emulation(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar):
    """What csrc/conv_bwd.cu computes, written out in torch: the
    receiver-centric mirror sweep over the real pairs within rc only, the
    ubar/dbar sums taken over the columns c = (g, f) at once, the chain rule
    by hand, the partner rows of each tile of WARPS receiver atoms, then the
    wrapper's tile sum and gather.  Holds the kernel's algorithm and the
    reassembly against autograd on the CPU."""
    b, c, gf = st.b_tot, st.c, st.g * st.f
    nj = tcs.bwd_tiles(st)
    eta, rc = float(scal[0]), float(scal[1])
    col_sg = shifts_g[torch.arange(gf) // st.f]
    a_rows = a_gmajor.reshape(b * c, gf)
    gb4 = gbar.reshape(b, 4, c, gf)
    grad_a = torch.zeros(b * c, gf)
    dc_recv = torch.zeros(b * c, 3)
    pgrad = torch.zeros(st.s_tot, b, nj, 3, c)
    counts = torch.zeros(b * c, dtype=torch.int64)
    for s in range(st.s_tot):
        p = mnbr[s].long()
        pp = p.clamp(min=0)
        xi = coord[pp] - shift[s][pp][:, None, :]
        diff = coord[:, :, None, :] - xi[:, None, :, :]  # (B, Cj receiver, Ci partner, 3)
        vp = (mask > 0.5)[:, :, None] & (mask[pp] > 0.5)[:, None, :] & (p >= 0)[:, None, None]
        if s == 0:
            vp = vp & ~torch.eye(c, dtype=torch.bool)[None]
        d = torch.sqrt(torch.where(vp, (diff * diff).sum(-1), torch.ones(())))
        bj, jj, ii = (vp & (d < rc)).nonzero(as_tuple=True)  # the ballot: slots ascending
        dp = d[bj, jj, ii]
        u = diff[bj, jj, ii] / dp[:, None]
        arg = dp * (math.pi / rc)
        fc = (0.5 * (torch.cos(arg) + 1.0))[:, None]
        fcp = (-0.5 * (math.pi / rc) * torch.sin(arg))[:, None]
        dd = dp[:, None] - col_sg
        e = torch.exp(-eta * dd * dd)
        gs, dgs = e * fc, e * (fcp - 2.0 * eta * dd * fc)  # (P, G*F)
        gk = gb4[pp[bj], :, ii]  # (P, 4, G*F)
        rows = bj * c + jj
        grad_a.index_add_(0, rows, gs * (gk[:, 0] + sum(u[:, k, None] * gk[:, k + 1] for k in range(3))))
        wb = gk * a_rows[rows][:, None, :]
        ub = (wb[:, 1:] * gs[:, None, :]).sum(-1)  # (P, 3)
        db = ((wb[:, 0] + sum(wb[:, k + 1] * u[:, k, None] for k in range(3))) * dgs).sum(-1)
        uu = (ub * u).sum(-1, keepdim=True)
        rb = db[:, None] * u + (ub - uu * u) / dp[:, None]
        dc_recv.index_add_(0, rows, rb)
        part = torch.zeros(b * nj * c, 3)
        part.index_add_(0, (bj * nj + jj // tcs.WARPS) * c + ii, -rb)
        pgrad[s] = part.reshape(b, nj, c, 3).transpose(2, 3)
        counts.index_add_(0, rows, torch.ones_like(rows))
    dc, ds = tcs.gather_partner_adjoints(st, nbr, dc_recv.reshape(b, c, 3), pgrad.sum(2))
    return (grad_a.reshape(b, c, gf), dc, ds), counts


def test_kernel_a_algorithm_matches_plain(case):
    _sysj, syst, feats = case
    st, ops, mnbr, _radius = _port_operands(syst, feats)
    out, counts = _kernel_a_emulation(st, **ops)
    _close(out.numpy(), tcs.conv_forward_plain(st, **ops).numpy())
    # the receiver-centric sweep of B walks the same ordered pairs
    _emu, counts_b = _kernel_b_emulation(
        st, **ops, mnbr=mnbr, gbar=torch.zeros(st.b_tot, 4, st.c, st.g * st.f)
    )
    plain = tcs.pair_counts_plain(st, ops["coord"], ops["mask"], ops["shift"], ops["nbr"], ops["scal"])
    assert torch.equal(counts, plain) and torch.equal(counts_b, plain) and int(plain.sum()) > 0
    assert int(counts[ops["mask"].reshape(-1) < 0.5].sum()) == 0


def test_kernel_b_algorithm_matches_autograd(case):
    _sysj, syst, feats = case
    st, ops, mnbr, _radius = _port_operands(syst, feats)
    gbar = torch.tensor(feats["gbar"]).reshape(st.b_tot, 4, st.c, -1)
    ref = tcs.conv_backward_plain(st, **ops, gbar=gbar)
    emu, _counts = _kernel_b_emulation(st, **ops, mnbr=mnbr, gbar=gbar)
    for e, r in zip(emu, ref):
        _close(e.numpy(), r.numpy())


def test_second_order_raises(case):
    """Grad-of-grad through ConvAcc (it raised while the adjoint was first
    order only, hence the name): the K3 rules give the JAX twin's second
    derivative, ``d/dcoord sum(d/dcoord sum(out^2))``, within 1e-5 of its
    largest magnitude."""
    sysj, syst, feats = case
    st, ops, mnbr, radius = _port_operands(syst, feats)
    twin, (a_gm, _coord_t, shift_cart) = _jax_twin(sysj, feats, radius)

    def j_inner(c):  # c (B, C, 3) -> the twin's coordinate frame
        coord_t = jnp.concatenate([c.transpose(0, 2, 1), jnp.zeros((st.b_tot, 1, st.c), jnp.float32)], axis=1)
        return (twin(a_gm, coord_t, shift_cart) ** 2).sum()

    c0 = jnp.asarray(ops["coord"].numpy())
    ref = jax.jit(jax.grad(lambda c: jax.grad(j_inner)(c).sum()))(c0)

    coord = ops["coord"].clone().requires_grad_(True)
    out = ConvAcc.apply(
        ops["a_gmajor"], coord, ops["shift"], st, ops["mask"], ops["nbr"], mnbr,
        ops["shifts_g"], ops["scal"],
    )
    (g,) = torch.autograd.grad((out * out).sum(), coord, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), coord)
    assert torch.isfinite(gg).all()
    _close(gg.numpy(), ref)


@pytest.mark.parametrize("f", [16, 17, 33])
def test_kernel_tiles_fit_the_card(f):
    """The wrappers' launch shapes keep every capacity the planner can give
    inside the kernels' register and shared-memory budgets."""
    for c in range(8, 257, 8):
        st = tcs.ConvStatic(b_tot=1, c=c, g=G_DIM, f=f, s_tot=27)
        cols = tcs.lane_columns(st)
        assert cols in tcs.LANE_COLUMNS and st.g * st.f <= 32 * cols
        assert tcs.fwd_blocks(st) * tcs.WARPS >= st.b_tot * c
        assert tcs.bwd_tiles(st) * tcs.WARPS >= c
        assert tcs.bwd_smem_bytes(st) <= tcs.SMEM_LIMIT
    # a fused ensemble's member-stacked rows take column tiles: four
    # flagship members (16 x 4 x 17 = 1,088 columns) two tiles of 544, the
    # NSE model's four members (1,152) three of 384, eight members up to
    # 4,352 columns; one column more is refused
    for f_st, tiles, width in ((4 * 17, 2, 544), (4 * 18, 3, 384), (8 * 17, 4, 544), (8 * 18, 5, 480)):
        st = tcs.ConvStatic(b_tot=512, c=40, g=G_DIM, f=f_st, s_tot=27)
        assert tcs.col_tiles(st) == (tiles, width, 17) and tiles * width >= G_DIM * f_st
        assert tcs.bwd_smem_bytes(st) <= tcs.SMEM_LIMIT
    assert tcs.col_tiles(tcs.ConvStatic(1, 40, G_DIM, 272, 27))[:2] == (tcs.MAX_COL_TILES, 544)
    with pytest.raises(ValueError, match="G\\*F <= 4352"):
        tcs.lane_columns(tcs.ConvStatic(b_tot=1, c=40, g=G_DIM, f=273, s_tot=27))
    # the flagship's grid: 20,480 receiver rows in 2,560 blocks for A, 512 x 5
    # blocks for B, nine columns a lane
    st = tcs.ConvStatic(b_tot=512, c=40, g=G_DIM, f=17, s_tot=27)
    assert tcs.lane_columns(st) == 9 and tcs.fwd_blocks(st) == 2560 and tcs.bwd_tiles(st) == 5
    assert tcs.col_tiles(st) == (1, 272, 9)  # one tile: the single model's launch
    # the molecule-bin layout of 64 molecules (capacity 120, radius 0: one
    # offset): 7,680 receiver rows in 960 blocks for A, 64 x 15 blocks of B
    # with 23,040 B of shared memory
    st = tcs.ConvStatic(b_tot=64, c=120, g=G_DIM, f=17, s_tot=1)
    assert tcs.lane_columns(st) == 9 and tcs.fwd_blocks(st) == 960 and tcs.bwd_tiles(st) == 15
    assert tcs.bwd_smem_bytes(st) == 23_040


SM_SMEM = 233_472  # bytes of shared memory an H100 SM gives its resident blocks


@pytest.mark.parametrize("f", [16, 17, 33, 68])
def test_tensor_core_launches_fit_the_card(f):
    """The tensor-core builds' launch geometry (pure functions of the
    shapes, csrc/conv_mma.cuh): for every capacity the planner can give,
    each launch of A and B (B's constants' build too) fits the card's
    shared memory and grid limits, or is refused with ValueError before any
    launch; the flagship's request grid and the molecule bins get the blocks
    the design expects."""
    for c in range(8, 257, 8):
        for s_tot in (1, 27, 125):
            st = tcs.ConvStatic(b_tot=512, c=c, g=G_DIM, f=f, s_tot=s_tot)
            passes = tcs.mma_row_groups(st)  # of a bin of C real atoms
            assert passes == -(-c // tcs.MMA_ROW_CAP) and (passes - 1) * tcs.MMA_ROW_CAP < c
            assert tcs.mma_fwd_tiles(st) == 4 * -(-f // 24) and tcs.mma_bwd_tiles(st) == 2 * -(-f // 24)
            # the live-candidate scan before either build: a record of three
            # mask classes and their prefix sums a (bin, pass)
            w = -(-c // 32)
            assert tcs.mma_scan_words(st) == 3 * s_tot * w + 3 * (s_tot + 1)
            assert tcs.mma_scan_smem_bytes(st) <= tcs.SMEM_LIMIT
            for mode in tcs.MMA_MODES:
                fwd, bwd = tcs.mma_fwd_smem_bytes(st, mode), tcs.mma_bwd_smem_bytes(st, mode)
                assert fwd <= tcs.SMEM_LIMIT and bwd <= tcs.SMEM_LIMIT
                tcs._check_mma_launch(st, mode, "A")
                tcs._check_mma_launch(st, mode, "B")
                if f <= tcs.MMA_F_TILE:
                    tcs._check_mma_launch(st, mode, "B", constants=True)
                    # a single model's widths: two blocks of each an SM
                    if c <= 64 and s_tot <= 27:
                        assert 2 * (max(fwd, bwd) + 1024) <= SM_SMEM
                else:
                    with pytest.raises(ValueError, match="column tile"):
                        tcs._check_mma_launch(st, mode, "B", constants=True)
    # what the builds refuse: the constants' build beyond one column tile,
    # more offsets than the live masks' shared memory holds
    with pytest.raises(ValueError, match="column tile"):
        tcs._check_mma_launch(tcs.ConvStatic(64, 48, 17, 16, 1), "tf32", "B", constants=True)
    huge = tcs.ConvStatic(b_tot=8, c=256, g=G_DIM, f=17, s_tot=7_000)
    for kernel in ("A", "B"):
        with pytest.raises(ValueError, match="shared memory"):
            tcs._check_mma_launch(huge, "bf16", kernel)
    # the flagship's request grid (512 bins, C = 40, 27 offsets, F = 17): a
    # block a (bin, tile), so A's 4 shift tiles make 2,048 blocks of 108,196
    # bytes and B's 2 make 1,024 of 111,604 (NJ = 1); a bin of up to 32 real
    # atoms in one pass (about 20 at this density), 40 in two
    st = tcs.ConvStatic(b_tot=512, c=40, g=G_DIM, f=17, s_tot=27)
    assert st.b_tot * tcs.mma_fwd_tiles(st) == 2048 and st.b_tot * tcs.mma_bwd_tiles(st) == 1024
    assert tcs.mma_row_groups(st) == 2
    assert tcs.mma_fwd_smem_bytes(st, "tf32") == 108_196 and tcs.mma_bwd_smem_bytes(st, "tf32") == 111_604
    # the scan's records: 246 words a (bin, pass), 2,164 bytes a scan block
    assert tcs.mma_scan_words(st) == 246 and tcs.mma_scan_smem_bytes(st) == 2_164
    # MD's grid (9 x 9 x 9, C = 32): one pass; molecule bins (C = 120, one
    # offset): up to four passes of one block a molecule and tile
    assert tcs.mma_row_groups(tcs.ConvStatic(729, 32, G_DIM, 17, 27)) == 1
    st = tcs.ConvStatic(b_tot=64, c=120, g=G_DIM, f=17, s_tot=1)
    assert tcs.mma_row_groups(st) == 4
    assert st.b_tot * tcs.mma_fwd_tiles(st) == 256 and st.b_tot * tcs.mma_bwd_tiles(st) == 128
    # a fused ensemble's rows (G*F = 1,088): 3 column tiles of 24 by 4 / 8 shifts
    st = tcs.ConvStatic(b_tot=512, c=40, g=G_DIM, f=68, s_tot=27)
    assert (tcs.mma_fwd_tiles(st), tcs.mma_bwd_tiles(st)) == (12, 6)


def test_column_tiles_partition_the_adjoint(case):
    """Kernels A and B cut a fused ensemble's member-stacked row (here four
    members of F = 17, 1,088 columns: two tiles of 544) into column tiles
    that walk the same pairs: the forward and the feature adjoint are per
    column, and the coordinate and lattice-shift adjoints are sums over the
    columns, so each tile's partial is the adjoint of its own columns and
    the tiles' partials add up to the whole row's (what the wrapper adds in
    a fixed order).  Within 1e-5 of the largest magnitude."""
    _sysj, syst, feats = case
    st1, ops, _mnbr, _radius = _port_operands(syst, feats)
    b, c, f = st1.b_tot, st1.c, 4 * (F_DIM + 1)
    st = tcs.ConvStatic(b_tot=b, c=c, g=G_DIM, f=f, s_tot=st1.s_tot)
    tiles, width, _m = tcs.col_tiles(st)
    assert (tiles, width) == (2, 544)
    rng = np.random.default_rng(17)
    one = ops["a_gmajor"].reshape(b, c, G_DIM, F_DIM + 1)
    ops["a_gmajor"] = torch.cat([one * s for s in (1.0, -0.5, 0.8, 1.2)], dim=-1).reshape(b, c, G_DIM * f)
    gbar = torch.tensor(rng.normal(size=(b, 4, c, G_DIM * f)).astype(np.float32))
    out = tcs.conv_forward_plain(st, **ops)
    full = tcs.conv_backward_plain(st, **ops, gbar=gbar)
    col = torch.arange(G_DIM * f)
    parts = []
    for t in range(tiles):
        keep = ((col >= t * width) & (col < (t + 1) * width)).float()
        tile_ops = dict(ops, a_gmajor=ops["a_gmajor"] * keep)
        _close((tcs.conv_forward_plain(st, **tile_ops) * keep).numpy(), (out * keep).numpy())
        part = tcs.conv_backward_plain(st, **tile_ops, gbar=gbar * keep)
        _close((part[0] * keep).numpy(), (full[0] * keep).numpy())
        parts.append(part)
    for i in (1, 2):  # coordinates, lattice shifts
        _close((parts[0][i] + parts[1][i]).numpy(), full[i].numpy())
