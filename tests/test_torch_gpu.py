"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips.  The file imports neither JAX nor the JAX package, so it also runs
on a machine without them:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets JAX up.)  Tolerance: 1e-5 of the
output's largest magnitude (f32 sums in another order).
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from aimnetcentral_tpu_torch import constants

from aimnetcentral_tpu_torch.builders import system_from_molecules, system_molecule_bins
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver
from aimnetcentral_tpu_torch.kernels import conv_pass as cp
from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
from aimnetcentral_tpu_torch.kernels import pair_sweep as ps
from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables
from aimnetcentral_tpu_torch.models import AIMNet2Config, aimnet2_init
from aimnetcentral_tpu_torch.models import engine_binned as eb
from aimnetcentral_tpu_torch.models.heads import (
    AtomicShiftHead,
    AtomicSumHead,
    DFTD3Head,
    LRCoulombHead,
    OutputHead,
    SRRepHead,
    head_init,
)
from aimnetcentral_tpu_torch.models.modules import MLPSpec
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.ops.nb import mol_sum

pytestmark = pytest.mark.gpu
CPU = torch.device("cpu")
G_DIM = 16
ETA, RC = 14.5, 5.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(actual, desired, rel=1e-5):
    desired = desired.detach().cpu().numpy()
    np.testing.assert_allclose(actual.detach().cpu().numpy(), desired, atol=rel * np.abs(desired).max())


EDGE_BOX, EDGE_CAP = 15.6, 10
FULL_BIN, EMPTY_BIN, FAR_BINS = 0, 13, (3, 6)  # (0,0,0), (1,1,1); (0,1,0) and (0,2,0)


def _edge_molecule(rng):
    """A 15.6 A box on 3x3x3 bins of edge 5.2 for the edges of the pair
    compaction: bin (0,0,0) filled to its capacity of 10, the centre bin
    empty, the neighbours (0,1,0) and (0,2,0) with every pair beyond rc
    (their atoms at least 10.1 A apart in y), two
    atoms exactly rc apart (x = 10.5 and 15.5, both exact in f32), and 24
    more atoms in the other bins."""
    full = rng.uniform(0.3, 4.9, size=(EDGE_CAP, 3))
    lo = np.column_stack([rng.uniform(0.5, 4.5, 3), rng.uniform(5.25, 5.35, 3), rng.uniform(0.5, 4.5, 3)])
    hi = np.column_stack([rng.uniform(0.5, 4.5, 3), rng.uniform(15.45, 15.55, 3), rng.uniform(0.5, 4.5, 3)])
    at_rc = np.array([[10.5, 13.0, 13.0], [15.5, 13.0, 13.0]])
    skip = {(0, 0, 0), (1, 1, 1), (0, 1, 0), (0, 2, 0), (2, 2, 2)}
    rest = []
    while len(rest) < 24:
        x = rng.uniform(0.1, EDGE_BOX - 0.1, size=3)
        if tuple((x // 5.2).astype(int)) not in skip:
            rest.append(x)
    coord = np.concatenate([full, lo, hi, at_rc, np.array(rest)]).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=len(coord))
    return {"coord": coord, "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * EDGE_BOX}


def _cluster(n, seed=0, spacing=2.2):
    """The ``n`` atoms nearest the centre of a jittered CHNO lattice."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil((3 * n) ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    coord = (grid + rng.uniform(-0.15, 0.15, size=grid.shape)) * spacing
    numbers = rng.choice([1, 6, 7, 8], size=len(grid), p=[0.5, 0.35, 0.05, 0.1])
    keep = np.argsort(np.linalg.norm(coord - coord.mean(0), axis=1), kind="stable")[:n]
    return {"coord": coord[keep].astype(np.float32), "numbers": numbers[keep]}


def _packed(seed: int = 11):
    """Five gas-phase molecules of 5-120 atoms on the molecule-bin layout:
    capacity 120, radius 0."""
    return system_molecule_bins([_cluster(n, seed + n) for n in (113, 40, 5, 120, 77)], CPU)


def _operands(layout: str, f: int, seed: int = 7):
    """Kernel operands on the CPU: a 40-atom box on 2x2x2 or 1x1x1
    periodic bins, a gas-phase 3x2x2 grid (steps without a candidate), the
    edges box of :func:`_edge_molecule`, whose slots are then reversed
    in every bin (its real atoms a suffix of the slots, not a prefix), or
    the molecule-bin layout of :func:`_packed` (one offset, C = 120)."""
    rng = np.random.default_rng(seed)
    n, a = 40, 12.0
    coord = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=n)
    if layout == "packed":
        sysb = _packed()
        grid = sysb.bins
    elif layout == "gas":
        mol = {"coord": coord * np.array([1.0, 0.7, 0.7], np.float32), "numbers": numbers}
        grid = B.BinGrid(nbins=(3, 2, 2), capacity=16, edge_hint=4.0, periodic=False)
    elif layout == "edges":
        mol = _edge_molecule(rng)
        grid = B.BinGrid(nbins=(3, 3, 3), capacity=EDGE_CAP, edge_hint=5.2, periodic=True)
    else:
        mol = {"coord": coord, "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}
        # capacity 16 on 2x2x2 bins; 136 on one bin, which the kernels
        # split into uneven atom tiles
        edge, safety = {"2x2x2": (5.2, 3.0), "1x1x1": (12.0, 3.4)}[layout]
        grid = B.plan_bins(mol["cell"], n, edge, safety=safety)
    if layout != "packed":
        sysb, _perm, ovf = B.to_binned_system(system_from_molecules([mol], CPU), grid)
        assert not ovf.any()
    tab = build_conv_tables(grid, B.stencil_radius(RC, grid))
    b, c = grid.total_bins, grid.capacity
    shift = torch.tensor(tab["push"])
    if sysb.cell is not None:
        shift = shift + torch.tensor(tab["wraps"]) @ sysb.cell[0]
    st = cs.ConvStatic(b_tot=b, c=c, g=G_DIM, f=f, s_tot=tab["nbr"].shape[0])
    ops = dict(
        a_gmajor=torch.tensor((rng.normal(size=(b, c, G_DIM * f)) * 0.3).astype(np.float32)),
        coord=sysb.coord.reshape(b, c, 3).contiguous(),
        mask=(sysb.numbers > 0).float().reshape(b, c),
        shift=shift,
        nbr=torch.tensor(tab["nbr"]),
        shifts_g=torch.tensor(np.linspace(0.8, 5.0, 17, dtype=np.float32)[:16]),
        scal=torch.tensor([ETA, RC]),
    )
    gbar = torch.tensor(rng.normal(size=(b, 4, c, G_DIM * f)).astype(np.float32))
    if layout == "edges":
        for key in ("a_gmajor", "coord", "mask"):
            ops[key] = ops[key].flip(1).contiguous()
        gbar = gbar.flip(2).contiguous()
    return st, ops, torch.tensor(tab["mnbr"]), gbar


def _to(dev, ops):
    return {k: v.to(dev).contiguous() for k, v in ops.items()}


LAYOUTS = ["2x2x2", "1x1x1", "gas", "edges", "packed"]


@pytest.mark.parametrize("f", [16, 17, 33])  # 33: the kernels' second build (17 columns a lane)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_a_matches_plain(cuda_device, layout, f):
    st, ops, _mnbr, _gbar = _operands(layout, f)
    out = cs.conv_stencil_forward(st, **_to(cuda_device, ops))
    torch.cuda.synchronize()
    _close(out, cs.conv_forward_plain(st, **ops))


@pytest.mark.parametrize("f", [16, 17, 33])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_b_matches_plain(cuda_device, layout, f):
    st, ops, mnbr, gbar = _operands(layout, f)
    got = cs.conv_stencil_backward(
        st, **_to(cuda_device, ops), mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device)
    )
    torch.cuda.synchronize()
    for g, r in zip(got, cs.conv_backward_plain(st, **ops, gbar=gbar)):
        _close(g, r)


STACKED_F = [68, 72, 136]  # four members of F = 17 and 18 (1,088 and 1,152 columns), eight of F = 17


@pytest.mark.parametrize("f", STACKED_F)
@pytest.mark.parametrize("layout", ["2x2x2", "gas", "edges", "packed"])
def test_kernel_a_matches_plain_at_stacked_widths(cuda_device, layout, f):
    """A fused ensemble's member-stacked rows: kernel A in column tiles."""
    st, ops, _mnbr, _gbar = _operands(layout, f)
    assert cs.col_tiles(st)[0] > 1
    out = cs.conv_stencil_forward(st, **_to(cuda_device, ops))
    torch.cuda.synchronize()
    _close(out, cs.conv_forward_plain(st, **ops))


@pytest.mark.parametrize("f", STACKED_F)
@pytest.mark.parametrize("layout", ["2x2x2", "gas", "edges", "packed"])
def test_kernel_b_matches_plain_at_stacked_widths(cuda_device, layout, f):
    """Kernel B in column tiles: the tiles' coordinate and shift partials
    added by the wrapper, and the kernel as deterministic as one tile."""
    st, ops, mnbr, gbar = _operands(layout, f)
    dev_ops = _to(cuda_device, ops)
    args = dict(mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device))
    got = cs.conv_stencil_backward(st, **dev_ops, **args)
    torch.cuda.synchronize()
    for g, r in zip(got, cs.conv_backward_plain(st, **ops, gbar=gbar)):
        _close(g, r)
    for x, y in zip(got, cs.conv_stencil_backward(st, **dev_ops, **args)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("f", [16, 17, 33])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_b_constants_match_plain(cuda_device, layout, f):
    """Kernel B's constants' build: its five adjoints (the AEV constants'
    among them) against autograd of the plain version, and bit for bit on
    a repeat; the first three equal the build without the constants."""
    st, ops, mnbr, gbar = _operands(layout, f)
    dev_ops = _to(cuda_device, ops)
    args = dict(mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device))
    got = cs.conv_stencil_backward_constants(st, **dev_ops, **args)
    torch.cuda.synchronize()
    want = cs.conv_backward_plain(st, **ops, gbar=gbar, constants=True)
    assert len(got) == len(want) == 5
    for g, r in zip(got, want):
        _close(g, r)
    for x, y in zip(got, cs.conv_stencil_backward_constants(st, **dev_ops, **args)):
        assert torch.equal(x, y)
    for x, y in zip(got[:3], cs.conv_stencil_backward(st, **dev_ops, **args)):
        _close(x, y.cpu())


def test_kernel_b_constants_take_one_column_tile(cuda_device):
    """The constants' build takes a single model's widths only: a row of
    column tiles raises, and launches nothing."""
    st, ops, mnbr, gbar = _operands("2x2x2", STACKED_F[0])
    before = cs.conv_stencil_backward_constants.launches
    with pytest.raises(ValueError, match="column tile"):
        cs.conv_stencil_backward_constants(st, **_to(cuda_device, ops), mnbr=mnbr.to(cuda_device),
                                           gbar=gbar.to(cuda_device))
    assert cs.conv_stencil_backward_constants.launches == before


def test_kernels_are_deterministic(cuda_device):
    """No float atomics: two runs agree bit for bit."""
    st, ops, mnbr, gbar = _operands("2x2x2", 17)
    dev_ops = _to(cuda_device, ops)
    args = dict(mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device))
    assert torch.equal(cs.conv_stencil_forward(st, **dev_ops), cs.conv_stencil_forward(st, **dev_ops))
    for x, y in zip(cs.conv_stencil_backward(st, **dev_ops, **args),
                    cs.conv_stencil_backward(st, **dev_ops, **args)):
        assert torch.equal(x, y)


def test_edges_layout_has_its_edges(cuda_device):
    """The edges box holds what it is built for, and on it both kernels walk
    exactly the real pairs within rc of each receiver row."""
    st, ops, mnbr, gbar = _operands("edges", 17)
    mask = ops["mask"]
    assert int(mask[FULL_BIN].sum()) == st.c == EDGE_CAP  # filled to capacity
    assert int(mask[EMPTY_BIN].sum()) == 0
    lo, hi = FAR_BINS
    assert mask[lo, 0] < 0.5 and mask[lo, -1] > 0.5  # padding slots before real ones
    real = lambda b: ops["coord"][b][mask[b] > 0.5]  # noqa: E731
    met = 0
    for s in range(st.s_tot):
        if int(ops["nbr"][s, lo]) == hi:
            d = torch.cdist(real(lo), real(hi) + ops["shift"][s, lo])
            assert float(d.min()) > RC + 1.0  # every pair of the two bins beyond rc
            met += 1
    assert met > 0
    at_rc = torch.tensor([[10.5, 13.0, 13.0], [15.5, 13.0, 13.0]])
    flat = ops["coord"].reshape(-1, 3)
    slots = [int(((flat - x).abs().sum(-1) == 0).nonzero()[0]) for x in at_rc]
    assert float((flat[slots[0]] - flat[slots[1]]).norm()) == RC

    plain = cs.pair_counts_plain(st, ops["coord"], ops["mask"], ops["shift"], ops["nbr"], ops["scal"])
    dev_ops = _to(cuda_device, ops)
    counts_a = torch.zeros(st.b_tot * st.c, dtype=torch.int32, device=cuda_device)
    counts_b = torch.zeros_like(counts_a)
    cs.conv_stencil_forward(st, **dev_ops, pair_counts=counts_a)
    cs.conv_stencil_backward(st, **dev_ops, mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device),
                             pair_counts=counts_b)
    torch.cuda.synchronize()
    assert torch.equal(counts_a.cpu().long(), plain) and torch.equal(counts_b.cpu().long(), plain)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    st, ops, _mnbr, _gbar = _operands("2x2x2", 16)
    dev_ops = _to(cuda_device, ops)
    with pytest.raises(ValueError, match="a_gmajor"):
        cs.conv_stencil_forward(st, **{**dev_ops, "a_gmajor": dev_ops["a_gmajor"].double()})
    with pytest.raises(ValueError, match="coord"):
        cs.conv_stencil_forward(st, **{**dev_ops, "coord": dev_ops["coord"].transpose(0, 1)})


def _narrow_model(device, d3=False, seed=0):
    outputs = (
        ("energy_mlp", OutputHead(n_in=16, n_out=1, key_in="aim", key_out="energy",
                                  mlp=MLPSpec(hidden=(16, 16)))),
        ("atomic_shift", AtomicShiftHead(key_in="energy", key_out="energy")),
        ("atomic_sum", AtomicSumHead(key_in="energy", key_out="energy")),
        ("lrcoulomb", LRCoulombHead(rc=4.6, key_in="charges", key_out="energy")),
    )
    if d3:
        outputs += (("external_dftd3", DFTD3Head(s8=0.3908, a1=0.566, a2=3.128, cutoff=15.0)),)
    cfg = AIMNet2Config(
        nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16, outputs=outputs
    )
    return aimnet2_init(cfg, seed=seed, device=device), cfg


def _box(n=60, a=12.0, seed=0):
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    coord = (grid + 0.5) * (a / m) + rng.uniform(-0.15, 0.15, size=(n, 3)) * (a / m)
    numbers = rng.choice([1, 6, 7, 8], size=n, p=[0.5, 0.35, 0.05, 0.1])
    return {"coord": coord.astype(np.float32), "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}


def test_calculator_card_matches_cpu(cuda_device):
    params, cfg = _narrow_model(CPU)
    cpu = AIMNet2Calculator((params, cfg), device="cpu", binned_threshold=0).eval(
        _box(), forces=True, stress=True
    )
    cs.conv_stencil_forward.launches = cs.conv_stencil_backward.launches = 0
    card = AIMNet2Calculator((params, cfg), device=cuda_device, binned_threshold=0).eval(
        _box(), forces=True, stress=True
    )
    assert cs.conv_stencil_forward.launches == 3
    assert cs.conv_stencil_backward.launches == 3
    np.testing.assert_allclose(card["energy"], cpu["energy"], rtol=1e-5)
    np.testing.assert_allclose(card["charges"], cpu["charges"], atol=1e-5)
    np.testing.assert_allclose(card["forces"], cpu["forces"], atol=1e-5)
    np.testing.assert_allclose(card["stress"], cpu["stress"], atol=1e-6)


def _train_batch(device, n_mol=6, seed=3):
    """A packed batch of gas-phase clusters of 5-16 atoms with random
    energy, force and charge labels."""
    from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset

    rng = np.random.default_rng(seed)
    size = 16
    mols = [_cluster(size, seed + k) for k in range(n_mol)]
    sample = {
        "coord": np.stack([m["coord"] for m in mols]),
        "numbers": np.stack([m["numbers"] for m in mols]),
        "charge": np.zeros(n_mol, np.float32),
        "energy": rng.normal(size=n_mol).astype(np.float32),
        "forces": (rng.normal(size=(n_mol, size, 3)) * 0.3).astype(np.float32),
        "charges": (rng.normal(size=(n_mol, size)) * 0.1).astype(np.float32),
    }
    return SizeGroupedDataset({size: sample}).make_batch_system_packed(size, sample, device=device)


def test_train_step_card_matches_cpu(cuda_device):
    """One force-loss step on molecule bins at the exact tier, card
    against CPU: the loss and the global norm (1e-5 relative), every
    leaf's gradient (1e-4 of its largest magnitude); A 3, B's constants'
    build 6 (the forces and the parameter gradient's first order), D 1,
    E 2 (the forces and the energy term's first order), B's other build 0;
    a calculator request afterwards launches no constants' build."""
    from aimnetcentral_tpu_torch.train import step as tstep
    from aimnetcentral_tpu_torch.train.loss import LossConfig, MTLoss

    params, cfg = _narrow_model(CPU)
    out = {}
    for dev in (CPU, cuda_device):
        system, labels = _train_batch(dev)
        state = tstep.init_train_state(_params_to(params, dev), tstep.make_optimizer())
        leaves = [leaf for _p, leaf in state.trainable]
        loss = MTLoss(LossConfig())
        with ambient_matmul_context("highest"):
            pred = tstep.predict(state.params, cfg, system, True, create_graph=True)
            grads = torch.autograd.grad(loss(pred, labels, system)[0], leaves, allow_unused=True)
        for fn in (cs.conv_stencil_forward, cs.conv_stencil_backward, cs.conv_stencil_backward_constants,
                   ps.pair_sweep_forward, ps.pair_sweep_backward):
            fn.launches = 0
        step = tstep.make_train_step(cfg, loss, tstep.make_optimizer(), precision="exact")
        state, metrics = step(state, system, labels)
        counts = [fn.launches for fn in (cs.conv_stencil_forward, cs.conv_stencil_backward,
                                         cs.conv_stencil_backward_constants, ps.pair_sweep_forward,
                                         ps.pair_sweep_backward)]
        out[dev.type] = ({k: float(v) for k, v in metrics.items()}, [g.cpu() for g in grads], counts)
    assert out["cpu"][2] == [0, 0, 0, 0, 0]
    assert out["cuda"][2] == [3, 0, 6, 1, 2]
    for k, v in out["cpu"][0].items():
        assert out["cuda"][0][k] == pytest.approx(v, rel=1e-5), k
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        _close(g, r, rel=1e-4)
    calc = AIMNet2Calculator((_params_to(params, cuda_device), cfg), device=cuda_device, binned_threshold=16)
    calc.eval([_cluster(16, 3), _cluster(12, 4)], forces=True)
    assert calc._prep_cache["kind"] == "packed"
    assert cs.conv_stencil_backward_constants.launches == 6  # none more


def _params_to(tree, dev):
    from aimnetcentral_tpu_torch.models.bridge import params_to

    return params_to(tree, dev)


@pytest.mark.parametrize("method", ["ewald", "pme"])
def test_calculator_long_range_card_matches_cpu(cuda_device, method):
    """Ewald and PME on the binned layout: one D and one E launch a request
    (the real-space sum with the SR part inside), the card against the CPU;
    a repeated request is the same bits (PME's spread accumulates in a
    fixed order)."""
    params, cfg = _narrow_model(CPU)
    calcs = [AIMNet2Calculator((params, cfg), device=d, binned_threshold=0) for d in ("cpu", cuda_device)]
    for c in calcs:
        c.set_lrcoulomb_method(method)
    cpu = calcs[0].eval(_box(), forces=True, stress=True)
    ps.pair_sweep_forward.launches = ps.pair_sweep_backward.launches = 0
    card = calcs[1].eval(_box(), forces=True, stress=True)
    assert (ps.pair_sweep_forward.launches, ps.pair_sweep_backward.launches) == (1, 1)
    np.testing.assert_allclose(card["energy"], cpu["energy"], rtol=1e-5)
    np.testing.assert_allclose(card["forces"], cpu["forces"], atol=1e-4)
    np.testing.assert_allclose(card["stress"], cpu["stress"], atol=1e-6)
    again = calcs[1].eval(_box(), forces=True, stress=True)
    for key in ("energy", "forces", "stress"):
        np.testing.assert_array_equal(again[key], card[key])


def test_calculator_card_matches_cpu_with_d3(cuda_device):
    """The wb97m-d3 head set: D and E run three times each (DSF, D3 CN, D3
    energy), A and B three times each."""
    params, cfg = _narrow_model(CPU, d3=True)
    cpu = AIMNet2Calculator((params, cfg), device="cpu", binned_threshold=0).eval(
        _box(), forces=True, stress=True
    )
    counters = (cs.conv_stencil_forward, cs.conv_stencil_backward,
                ps.pair_sweep_forward, ps.pair_sweep_backward)
    for fn in counters:
        fn.launches = 0
    card = AIMNet2Calculator((params, cfg), device=cuda_device, binned_threshold=0).eval(
        _box(), forces=True, stress=True
    )
    assert [fn.launches for fn in counters] == [3, 3, 3, 3]
    np.testing.assert_allclose(card["energy"], cpu["energy"], rtol=1e-5)
    np.testing.assert_allclose(card["charges"], cpu["charges"], atol=1e-5)
    np.testing.assert_allclose(card["forces"], cpu["forces"], atol=1e-5)
    np.testing.assert_allclose(card["stress"], cpu["stress"], atol=1e-6)


# ---------------------------------------------------------------------------
# kernels D and E


def _pair_case(layout: str, term_name: str, seed: int = 5, members: int = 0):
    """Pair-sweep operands on the CPU.  ``banded``: 120 atoms in an 18 A box
    on 3x3x3 SR bins, cutoff 5 A (radius 1, nz >= 2r+1); ``images``: 60
    atoms in a 12 A box on its 1x1x1 LR grid, cutoff 15 A (radius 2: the
    bin meets itself at every offset); ``wide``: the same 60 atoms on one SR
    bin of capacity 272; ``edges``: the box of :func:`_edge_molecule` at
    cutoff rc (a full bin, an empty bin, a bin pair beyond the cutoff, two
    atoms exactly the cutoff apart, capacity 10), every bin's slots then
    reversed; ``gas``: 40 atoms on a gas-phase 3x2x2 grid at radius 2
    (steps without a candidate bin); ``packed``: the molecule-bin layout of
    :func:`_packed` at radius 0, cutoff inf for simple Coulomb (every pair
    of a molecule) and 15 A for the other terms.  ``coulomb_sr`` (the SR
    Coulomb of v2 artifacts) sweeps at its own rc, 4.6 A, on every layout.
    ``d3_energy_v70`` is the D3 energy
    term with random factorised vectors of V = 70, the width of all 14
    elements of the released models.  ``ewald_real`` takes eta = cutoff /
    5.26 (the real-space cutoff of accuracy 1e-6) and subtracts the SR
    envelope at 4.6 A; ``srrep`` (GFN1 repulsion, two scalars an atom) sweeps
    at rc = 4 A with the cosine cutoff; ``d3ts`` (three scalars: the
    network's C6 and alpha, random and positive, and r4r2) at the layout's
    cutoff.  With ``members`` the term's member form: per-member charges,
    or C6 and alpha, and the cotangent (B, C, members)."""
    rng = np.random.default_rng(seed)
    lr = None
    if layout == "packed":
        sysb, cutoff = _packed(), (math.inf if term_name == "coulomb_simple" else 15.0)
    elif layout == "edges":
        mol, cutoff = _edge_molecule(rng), RC
        grid = B.BinGrid(nbins=(3, 3, 3), capacity=EDGE_CAP, edge_hint=5.2, periodic=True)
    elif layout == "gas":
        n, cutoff = 40, 5.0
        coord = rng.uniform(0, 12.0, size=(n, 3)).astype(np.float32) * np.array([1.0, 0.7, 0.7], np.float32)
        mol = {"coord": coord, "numbers": rng.choice([1, 6, 7, 8], size=n)}
        grid = B.BinGrid(nbins=(3, 2, 2), capacity=16, edge_hint=4.0, periodic=False)
    else:
        n, a, cutoff = {"banded": (120, 18.0, 5.0), "images": (60, 12.0, 15.0), "wide": (60, 12.0, 5.0)}[layout]
        coord = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
        numbers = rng.choice([1, 6, 7, 8], size=n)
        mol = {"coord": coord, "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}
        cell = mol["cell"]
        if layout == "wide":
            grid = B.BinGrid(nbins=(1, 1, 1), capacity=272, edge_hint=12.0, periodic=True)
        else:
            grid = B.plan_bins(cell, n, 5.5, safety=3.0)
        lr = B.plan_lr_bins(cell, n, 15.0, safety=3.0) if layout == "images" else None
    if layout != "packed":
        sysb, _perm, ovf = B.to_binned_system(system_from_molecules([mol], CPU), grid, lr)
        assert not ovf.any()
    if term_name == "coulomb_sr":
        cutoff = 4.6
    elif term_name == "srrep":
        cutoff = 4.0
    where = "lr" if layout == "images" else "sr"
    tables = head_init(None, DFTD3Head(s8=0.3908, a1=0.566, a2=3.128), CPU)
    d3e = ps.D3EnergyTerm(a1=0.566, a2=3.128, s8=0.3908, r_on=0.8 * cutoff, r_off=cutoff)
    if term_name in ("dsf", "coulomb_simple", "coulomb_sr"):
        if term_name == "dsf":
            term = ps.DSFTerm(alpha=0.2, dsf_rc=cutoff, rc=4.6)
        elif term_name == "coulomb_sr":
            term = ps.CoulombSRTerm(rc=4.6, envelope="cosine" if layout == "edges" else "exp")
        else:
            term = ps.CoulombSimpleTerm(rc=4.6)
        extras = {"q": torch.tensor(rng.normal(size=sysb.natoms).astype(np.float32) * 0.3)
                  * (sysb.numbers > 0)}
    elif term_name == "ewald_real":
        term = ps.EwaldRealTerm(eta=cutoff / 5.26, rc=4.6, subtract_sr=True)
        extras = {"q": torch.tensor(rng.normal(size=sysb.natoms).astype(np.float32) * 0.3)
                  * (sysb.numbers > 0)}
    elif term_name == "srrep":
        term = ps.SRRepTerm(rc=4.0, cutoff_fn="cosine_cutoff")
        gfn1 = head_init(None, SRRepHead(), CPU)["gfn1_ab"][sysb.numbers]
        extras = {"alpha": gfn1[:, 0], "zeff": gfn1[:, 1]}
    elif term_name == "d3ts":
        term = ps.D3TSTerm(a1=0.49, a2=3.5, s8=0.78)
        extras = {"c6": torch.tensor(rng.uniform(2.0, 40.0, size=sysb.natoms).astype(np.float32)),
                  "alpha": torch.tensor(rng.uniform(3.0, 15.0, size=sysb.natoms).astype(np.float32)),
                  "rr": tables["r4r2"][sysb.numbers]}
    elif term_name == "d3_cn":
        term = ps.D3CNTerm()
        extras = {"rcov": tables["rcov"][sysb.numbers]}
    elif term_name == "d3_energy_v70":
        term = d3e
        p = rng.uniform(0.0, 1.0, size=(sysb.natoms, 70))
        m = rng.uniform(0.0, 5.0, size=(70, 70))
        extras = {"p": torch.tensor(p, dtype=torch.float32),
                  "r": torch.tensor(p @ (m + m.T) / 70.0, dtype=torch.float32),
                  "rr": tables["r4r2"][sysb.numbers]}
    else:
        term = d3e
        cn = eb.pair_sum_binned(sysb, cutoff, ps.D3CNTerm(), {"rcov": tables["rcov"][sysb.numbers]}, where)
        extras = eb.d3_pair_extras(sysb.species, sysb.numbers, cn, tables)
    if members:
        term = ps.MemberTerm(term, members)
        n = sysb.natoms
        for key in term.member_keys:
            lo, hi = {"q": (-1.0, 1.0), "c6": (2.0, 40.0), "alpha": (3.0, 15.0)}[key]
            vals = torch.tensor(rng.uniform(lo, hi, size=(n, members)).astype(np.float32))
            extras[key] = vals * (sysb.numbers > 0)[:, None] if key == "q" else vals
    st, ops = eb.pair_operands(sysb, cutoff, term, extras, where)
    ops = {k: v.detach() for k, v in ops.items()}
    if layout == "edges":  # real atoms a suffix of each bin's slots, not a prefix
        for key in ("coord", "mask", "ext"):
            ops[key] = ops[key].flip(1).contiguous()
    ct = torch.tensor(rng.normal(size=st.out_shape).astype(np.float32))
    return st, term, ops, ct


PAIR_LAYOUTS = ["banded", "images", "wide", "edges", "gas", "packed"]
PAIR_TERMS = ["dsf", "coulomb_simple", "coulomb_sr", "d3_cn", "d3_energy", "ewald_real", "srrep", "d3ts"]


@pytest.mark.parametrize("term_name", PAIR_TERMS)
@pytest.mark.parametrize("layout", PAIR_LAYOUTS)
def test_kernel_d_matches_plain(cuda_device, layout, term_name):
    st, term, ops, _ct = _pair_case(layout, term_name)
    out = ps.pair_sweep_forward(st, term, **_to(cuda_device, ops))
    torch.cuda.synchronize()
    _close(out, ps.pair_forward_plain(st, term, **ops))


@pytest.mark.parametrize("term_name", PAIR_TERMS)
@pytest.mark.parametrize("layout", PAIR_LAYOUTS)
def test_kernel_e_matches_plain(cuda_device, layout, term_name):
    st, term, ops, ct = _pair_case(layout, term_name)
    got = ps.pair_sweep_backward(st, term, **_to(cuda_device, ops), ct=ct.to(cuda_device))
    torch.cuda.synchronize()
    ref = ps.pair_backward_plain(st, term, **ops, ct=ct)
    for g, r in zip(got, ref):
        _close(g, r)
    if st.v:  # the p and r columns of the extras adjoint each
        for cols in (slice(0, st.v), slice(st.v, 2 * st.v)):
            _close(got[1][..., cols], ref[1][..., cols])


MEMBER_TERMS = ["dsf", "coulomb_simple", "coulomb_sr", "ewald_real", "d3ts"]


@pytest.mark.parametrize("members", [3, 8])
@pytest.mark.parametrize("term_name", MEMBER_TERMS)
@pytest.mark.parametrize("layout", ["banded", "images", "edges", "gas", "packed"])
def test_member_kernels_match_plain(cuda_device, layout, term_name, members):
    """The member forms of kernels D and E (one output per ensemble member)
    against their plain versions, the pairs contracted against the plain
    count, and a repeat bit for bit."""
    st, term, ops, ct = _pair_case(layout, term_name, members=members)
    dev_ops = _to(cuda_device, ops)
    counts = torch.zeros(st.b_tot * st.c, dtype=torch.int32, device=cuda_device)
    out = ps.pair_sweep_forward(st, term, **dev_ops, pair_counts=counts)
    got = ps.pair_sweep_backward(st, term, **dev_ops, ct=ct.to(cuda_device))
    torch.cuda.synchronize()
    assert out.shape == (st.b_tot, st.c, members)
    _close(out, ps.pair_forward_plain(st, term, **ops))
    for g, r in zip(got, ps.pair_backward_plain(st, term, **ops, ct=ct)):
        _close(g, r)
    plain = ps.pair_counts_plain(st, **{k: ops[k] for k in ("coord", "mask", "shift", "nbr", "inv")})
    assert torch.equal(counts.long().cpu(), plain)
    assert torch.equal(out, ps.pair_sweep_forward(st, term, **dev_ops))
    for x, y in zip(got, ps.pair_sweep_backward(st, term, **dev_ops, ct=ct.to(cuda_device))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_member"])
def test_ensemble_calculator_card_matches_cpu(cuda_device, fused):
    """A three-member ensemble of the narrow model on the binned layout:
    the card against the CPU (energy 1e-5 relative, forces 1e-4 eV/A,
    energy_std 1e-5 of max(1, |E|)); the fused request launches A and B
    three times and D and E once, the per-member request once per member."""
    from aimnetcentral_tpu_torch.calculators import EnsembleCalculator, stack_params

    members = [_narrow_model(CPU, seed=s) for s in range(3)]
    params = stack_params([m[0] for m in members])
    cfg = members[0][1]
    data = _box()
    calcs = {dev: EnsembleCalculator((params, cfg), device=dev, fused=fused, binned_threshold=0)
             for dev in ("cpu", "cuda")}
    wrappers = (cs.conv_stencil_forward, cs.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward)
    for fn in wrappers:
        fn.launches = 0
    card = calcs["cuda"].eval(data, forces=True)
    torch.cuda.synchronize()
    n = 1 if fused else 3
    assert [fn.launches for fn in wrappers] == [3 * n, 3 * n, n, n]
    cpu = calcs["cpu"].eval(data, forces=True)
    np.testing.assert_allclose(card["energy"], cpu["energy"], rtol=1e-5)
    np.testing.assert_allclose(card["forces"], cpu["forces"], atol=1e-4)
    scale = max(1.0, float(np.abs(cpu["energy"]).max()))
    np.testing.assert_allclose(card["energy_std"], cpu["energy_std"], atol=1e-5 * scale)


@pytest.mark.parametrize("layout", ["images", "edges"])
def test_pair_kernels_take_v70(cuda_device, layout):
    """The D3 energy at V = 70 (K = 141): D and E against the plain versions."""
    st, term, ops, ct = _pair_case(layout, "d3_energy_v70")
    assert st.v == 70
    dev_ops = _to(cuda_device, ops)
    out = ps.pair_sweep_forward(st, term, **dev_ops)
    got = ps.pair_sweep_backward(st, term, **dev_ops, ct=ct.to(cuda_device))
    torch.cuda.synchronize()
    _close(out, ps.pair_forward_plain(st, term, **ops))
    ref = ps.pair_backward_plain(st, term, **ops, ct=ct)
    for g, r in zip(got, ref):
        _close(g, r)
    for cols in (slice(0, 70), slice(70, 140)):
        _close(got[1][..., cols], ref[1][..., cols])


@pytest.mark.parametrize("layout", PAIR_LAYOUTS + ["packed-inf"])
def test_pair_kernels_count_the_plain_pairs(cuda_device, layout):
    """Each receiver row contracts exactly its real pairs within the cutoff,
    met from both ends: kernels D and E's own counts against the plain
    (``packed-inf``: simple Coulomb at cutoff inf, every other real atom of
    the receiver's molecule)."""
    if layout == "packed-inf":
        st, term, ops, ct = _pair_case("packed", "coulomb_simple")
        sizes = torch.tensor([113, 40, 5, 120, 77])
        want = torch.where(ops["mask"].reshape(-1) > 0.5, (sizes - 1).repeat_interleave(st.c), 0)
    else:
        st, term, ops, ct = _pair_case(layout, "d3_energy")
        want = None
    plain = ps.pair_counts_plain(st, ops["coord"], ops["mask"], ops["shift"], ops["nbr"], ops["inv"])
    dev_ops = _to(cuda_device, ops)
    counts_d = torch.zeros(st.b_tot * st.c, dtype=torch.int32, device=cuda_device)
    counts_e = torch.zeros_like(counts_d)
    ps.pair_sweep_forward(st, term, **dev_ops, pair_counts=counts_d)
    ps.pair_sweep_backward(st, term, **dev_ops, ct=ct.to(cuda_device), pair_counts=counts_e)
    torch.cuda.synchronize()
    assert int(plain.sum()) > 0
    assert torch.equal(counts_d.cpu().long(), plain) and torch.equal(counts_e.cpu().long(), plain)
    if want is not None:
        assert torch.equal(plain, want)


def test_pair_kernels_are_deterministic(cuda_device):
    st, term, ops, ct = _pair_case("images", "d3_energy")
    dev_ops = _to(cuda_device, ops)
    ct = ct.to(cuda_device)
    assert torch.equal(ps.pair_sweep_forward(st, term, **dev_ops), ps.pair_sweep_forward(st, term, **dev_ops))
    for x, y in zip(ps.pair_sweep_backward(st, term, **dev_ops, ct=ct),
                    ps.pair_sweep_backward(st, term, **dev_ops, ct=ct)):
        assert torch.equal(x, y)


def test_pair_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    st, term, ops, ct = _pair_case("banded", "dsf")
    dev_ops = _to(cuda_device, ops)
    with pytest.raises(ValueError, match="ext"):
        ps.pair_sweep_forward(st, term, **{**dev_ops, "ext": dev_ops["ext"].double()})
    with pytest.raises(ValueError, match="nbr"):
        ps.pair_sweep_forward(st, term, **{**dev_ops, "nbr": dev_ops["nbr"].long()})
    with pytest.raises(ValueError, match="ct"):
        ps.pair_sweep_backward(st, term, **dev_ops, ct=ct.to(cuda_device)[:, :1])
    st, term, ops, ct = _pair_case("images", "d3_energy_v70")
    v = ps.MAX_V + 1
    wide = ps.PairStatic(b_tot=st.b_tot, c=st.c, s_tot=st.s_tot, k=2 * v + 1, cutoff=st.cutoff)
    ext = torch.zeros((st.b_tot, st.c, 2 * v + 1), device=cuda_device)
    with pytest.raises(ValueError, match="V <= "):
        ps.pair_sweep_forward(wide, term, **{**_to(cuda_device, ops), "ext": ext})


def test_pair_energy_binned_launches_the_kernels(cuda_device):
    """On CUDA tensors the sweep is kernel D and its backward kernel E: the
    plain version does not run on the card."""
    rng = np.random.default_rng(2)
    mol = _box(seed=2)
    grid = B.plan_bins(mol["cell"], 60, 5.5, safety=3.0)
    lr = B.plan_lr_bins(mol["cell"], 60, 15.0, safety=3.0)
    sysb, _perm, _ovf = B.to_binned_system(system_from_molecules([mol], cuda_device), grid, lr)
    q = torch.tensor(rng.normal(size=sysb.natoms).astype(np.float32), device=cuda_device)
    coord = sysb.coord.clone().requires_grad_(True)
    ps.pair_sweep_forward.launches = ps.pair_sweep_backward.launches = 0
    e = eb.coulomb_dsf_binned(sysb.replace(coord=coord), q, 4.6, 0.2, 15.0, "exp", True)
    torch.autograd.grad(e.sum(), coord)
    assert (ps.pair_sweep_forward.launches, ps.pair_sweep_backward.launches) == (1, 1)


# ---------------------------------------------------------------------------
# precision tiers and MD


def test_cellmul_is_exact_under_tf32(cuda_device):
    """The geometry contraction stays within f32 rounding of an f64 product
    while TF32 matmuls are on (the ``fast`` tier); a TF32 product would be
    off by about 1e-3 relative."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    coord = 50.0 * torch.rand((4096, 3), generator=gen, device=cuda_device)
    cell = torch.eye(3, device=cuda_device) * 13.1 + 0.7 * torch.rand((3, 3), generator=gen, device=cuda_device)
    with ambient_matmul_context("default"):
        assert torch.backends.cuda.matmul.allow_tf32
        got = cellmul(coord, cell)
        strained = cellmul(cell[None], cell[None])[0]
    ref = coord.double() @ cell.double()
    assert float((got.double() - ref).abs().max()) <= 4 * 2.0**-24 * float(ref.abs().max())
    ref2 = cell.double() @ cell.double()
    assert float((strained.double() - ref2).abs().max()) <= 4 * 2.0**-24 * float(ref2.abs().max())


def test_mol_sum_is_exact_under_tf32(cuda_device):
    """Per-molecule sums (energies, NSE charges) keep full f32 under the
    ``fast`` tier's TF32 flag, forward and backward."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((4096, 8), generator=gen, device=cuda_device).requires_grad_(True)
    mol_idx = torch.randint(0, 3, (4096,), generator=gen, device=cuda_device)
    g = torch.randn((2, 8), generator=gen, device=cuda_device)
    with ambient_matmul_context("default"):
        out = mol_sum(x, mol_idx, 2)
        (grad,) = torch.autograd.grad(out, x, g)
    ref = torch.stack([x.double()[mol_idx == m].sum(0) for m in range(2)])
    scale = torch.stack([x.double().abs()[mol_idx == m].sum(0) for m in range(2)])
    assert bool(((out.double() - ref).abs() <= 1e-6 * scale).all())
    ref_g = torch.cat([g, torch.zeros_like(g[:1])])[mol_idx]
    assert torch.equal(grad, ref_g)


def test_tier_context_restores_the_flag_after_an_exception(cuda_device):
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with pytest.raises(RuntimeError, match="inside"):
            with ambient_matmul_context("default"):
                assert torch.backends.cuda.matmul.allow_tf32
                raise RuntimeError("inside the fast tier")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        with ambient_matmul_context("highest"):
            assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _md_run(device, precision="exact", thermostat="nve", steps=10):
    """A 60-atom MD run from the same injected 300 K velocities (numpy, seed
    3): the observables, the final frame and the driver."""
    params, cfg = _narrow_model(CPU)  # the same weights on both devices: the driver moves them
    mol = _box()
    system = system_from_molecules([mol], device, n_pad=64)
    drv = MDDriver(params, cfg, system, MDConfig(dt_fs=0.5, thermostat=thermostat, skin=0.2,
                                                 precision=precision), device=device)
    masses = np.clip(constants.get_masses()[system.numbers.cpu().numpy()], 1.0, None)  # padding rows: 1
    sigma = np.sqrt(constants.kB * 300.0 / masses)[:, None]
    v0 = torch.tensor((sigma * np.random.default_rng(3).normal(size=(64, 3))).astype(np.float32), device=device)
    real = drv._state.system.numbers > 0
    drv._state = dataclasses.replace(drv._state, veloc=torch.where(real[:, None], v0[drv._state.atom_id], 0.0))
    obs = drv.run(steps, chunk=5)
    return obs, drv.snapshot(), drv


def _md_engine_run(device, engine: str, steps=10):
    """10 NVE steps at the exact tier on the indexed engine (the 60-atom box
    with its DSF cutoff at 8 A, or a 40-atom gas-phase cluster) or on the
    gas-phase binned engine (the cluster, DSF Coulomb), from the same
    injected 300 K velocities: the observables, the final frame and the
    driver."""
    params, cfg = _narrow_model(CPU)
    periodic = engine == "indexed-periodic"
    head = {"dsf_rc": 8.0} if periodic else ({"method": "dsf"} if engine == "binned-gas" else {})
    cfg = dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, **head) if isinstance(h, LRCoulombHead) else h) for n, h in cfg.outputs))
    mol = _box() if periodic else _cluster(40, 2)
    system = system_from_molecules([mol], device, n_pad=64)
    md = MDConfig(dt_fs=0.5, thermostat="nve", skin=0.2, lr_skin=0.5, precision="exact")
    drv = MDDriver(params, cfg, system, md, engine=engine.split("-")[0], device=device)
    masses = np.clip(constants.get_masses()[system.numbers.cpu().numpy()], 1.0, None)
    sigma = np.sqrt(constants.kB * 300.0 / masses)[:, None]
    v0 = torch.tensor((sigma * np.random.default_rng(3).normal(size=(64, 3))).astype(np.float32), device=device)
    real = drv._state.system.numbers > 0
    drv._state = dataclasses.replace(drv._state, veloc=torch.where(real[:, None], v0[drv._state.atom_id], 0.0))
    obs = drv.run(steps, chunk=5)
    return obs, drv.snapshot(), drv


@pytest.mark.parametrize("engine", ["indexed-gas", "indexed-periodic", "binned-gas"])
def test_md_engines_card_match_cpu(cuda_device, engine):
    """The indexed engine (cell lists built on the card inside the step; no
    kernel launch) and the gas-phase binned engine (A, B three times and D,
    E once an evaluation): 10 NVE steps at the exact tier, per-step
    potential energy within 1e-5 relative, final coordinates within 1e-4 A,
    and a second run on the card equal bit for bit."""
    counters = (cs.conv_stencil_forward, cs.conv_stencil_backward,
                ps.pair_sweep_forward, ps.pair_sweep_backward)
    cpu, snap_cpu, _ = _md_engine_run(CPU, engine)
    for fn in counters:
        fn.launches = 0
    card, snap_card, drv = _md_engine_run(cuda_device, engine)
    evals = 10 + 1  # the steps and the initial forces
    want = [3 * evals, 3 * evals, evals, evals] if engine == "binned-gas" else [0, 0, 0, 0]
    assert [fn.launches for fn in counters] == want
    assert drv.rebins >= 1
    np.testing.assert_allclose(card["epot"], cpu["epot"], rtol=1e-5)
    np.testing.assert_allclose(snap_card["coord"], snap_cpu["coord"], atol=1e-4)
    again, snap_again, _ = _md_engine_run(cuda_device, engine)
    np.testing.assert_array_equal(snap_again["coord"], snap_card["coord"])
    np.testing.assert_array_equal(again["epot"], card["epot"])


def test_md_repeats_bit_for_bit(cuda_device):
    """Langevin MD on the card, twice from the same seed: the kernels have
    no float atomics and the generator restarts, so the runs are equal."""
    a, snap_a, _ = _md_run(cuda_device, precision=None, thermostat="langevin")
    b, snap_b, _ = _md_run(cuda_device, precision=None, thermostat="langevin")
    np.testing.assert_array_equal(snap_a["coord"], snap_b["coord"])
    np.testing.assert_array_equal(a["epot"], b["epot"])


def test_md_card_matches_cpu(cuda_device):
    """10 NVE steps at the exact tier: per-step potential energy within 1e-5
    relative, final coordinates within 1e-4 A; the kernels ran every step."""
    counters = (cs.conv_stencil_forward, cs.conv_stencil_backward,
                ps.pair_sweep_forward, ps.pair_sweep_backward)
    cpu, snap_cpu, _ = _md_run(CPU)
    for fn in counters:
        fn.launches = 0
    card, snap_card, drv = _md_run(cuda_device)
    evals = 10 + 1  # the steps and the initial forces
    assert [fn.launches for fn in counters] == [3 * evals, 3 * evals, evals, evals]
    assert drv.rebins >= 1
    np.testing.assert_allclose(card["epot"], cpu["epot"], rtol=1e-5)
    np.testing.assert_allclose(snap_card["coord"], snap_cpu["coord"], atol=1e-4)


GAS_INPUTS = {  # name -> (input, binned_threshold, stress, Coulomb method)
    "molecule": (_cluster(23, 1), 1024, False, "simple"),
    "batch": ([_cluster(n, 2 + n) for n in (7, 19, 12)], 1024, False, "simple"),
    "box": (_box(), 1024, True, "simple"),
    "box-split": (_box(), 1024, True, "simple"),  # D3 cutoff 8 A: a Coulomb and a D3 list
    "cluster-dsf": (_cluster(80, 4), 64, False, "dsf"),
    "packed": ([_cluster(n, 30 + n) for n in (40, 57, 74, 91)], 128, False, "simple"),
}


@pytest.mark.parametrize("name", list(GAS_INPUTS))
def test_gas_and_indexed_requests_card_match_cpu(cuda_device, name):
    """Molecules, a batch and a small box on the indexed layout (no kernel
    launch; the box with a shared LR list, and with split Coulomb and D3
    lists), a gas-phase DSF cluster on the binned grid and a batch on the
    molecule-bin layout (A, B, D and E three times a request; simple
    Coulomb at radius 0 on the latter), wB97M-D3 head set: card against CPU
    (energy 1e-5 relative or 1e-5 eV, forces 1e-4 eV/A, stress 1e-6
    eV/A^3), and a repeated request equal bit for bit."""
    data, threshold, stress, method = GAS_INPUTS[name]
    params, cfg = _narrow_model(CPU, d3=True)
    cfg = dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, method=method) if isinstance(h, LRCoulombHead) else h) for n, h in cfg.outputs))
    if name == "box-split":
        cfg = dataclasses.replace(cfg, outputs=tuple(
            (n, dataclasses.replace(h, cutoff=8.0) if isinstance(h, DFTD3Head) else h) for n, h in cfg.outputs))
    cpu = AIMNet2Calculator((params, cfg), device="cpu", binned_threshold=threshold).eval(
        data, forces=True, stress=stress)
    counters = (cs.conv_stencil_forward, cs.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward)
    for fn in counters:
        fn.launches = 0
    calc = AIMNet2Calculator((params, cfg), device=cuda_device, binned_threshold=threshold)
    card = calc.eval(data, forces=True, stress=stress)
    again = calc.eval(data, forces=True, stress=stress)
    binned = name in ("cluster-dsf", "packed")
    system = calc._prep_cache["system"]
    assert (system.bins is not None) == binned
    assert (calc._prep_cache["kind"] == "packed") == (name == "packed")
    assert (system.nbmat_dftd3 is not None) == (name == "box-split")
    # two requests; on the grid D and E sweep DSF, the D3 CN and the D3 energy
    assert [fn.launches for fn in counters] == ([6, 6, 6, 6] if binned else [0, 0, 0, 0])
    for key in card:
        np.testing.assert_array_equal(card[key], again[key])
    np.testing.assert_allclose(card["energy"], cpu["energy"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card["forces"], cpu["forces"], atol=1e-4)
    if stress:
        np.testing.assert_allclose(card["stress"], cpu["stress"], atol=1e-6)


# ---------------------------------------------------------------------------
# second order: the K3 route and the dense Hessian


@contextlib.contextmanager
def _plain_route():
    """The binned engine's kernel wrappers swapped for their plain versions:
    the all-plain route the K3 route is held to on the card (the port
    itself never takes a plain version for a CUDA tensor)."""
    saved = (cp.conv_stencil_forward, cp.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward)
    cp.conv_stencil_forward = cs.conv_forward_plain
    cp.conv_stencil_backward = (
        lambda st, a, c, mask, shift, nbr, _mnbr, shifts_g, scal, gbar:
        cs.conv_backward_plain(st, a, c, mask, shift, nbr, shifts_g, scal, gbar)
    )
    ps.pair_sweep_forward, ps.pair_sweep_backward = ps.pair_forward_plain, ps.pair_backward_plain
    try:
        yield
    finally:
        cp.conv_stencil_forward, cp.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward = saved


@pytest.mark.parametrize("layout", ["binned", "packed"])
def test_k3_route_matches_plain_route(cuda_device, layout):
    """An HVP on the binned box (DSF) and on molecule bins (simple Coulomb),
    wB97M-D3 head set: kernels A, B, D and E as the primals (the tangents on
    the plain versions) against the all-plain route on the card, within
    1e-4 of the largest magnitude (second-order sums in another order), and
    the CPU's HVP.  Launches: A 3 and D 3 (one a conv pass or a sweep); B 6,
    since reverse-over-reverse runs the first adjoint again in the second
    backward wherever a cotangent of the first depends on the sweep's
    output (every conv pass), and E 4, the D3 coordination number's sweep
    again (the D3 energy's weights depend on it)."""
    from aimnetcentral_tpu_torch.calculators.derivatives import make_hvp_fn

    params, cfg = _narrow_model(CPU, d3=True)
    if layout == "binned":
        data, threshold = _box(), 0
    else:
        data, threshold = [_cluster(n, 30 + n) for n in (40, 57, 74, 91)], 128
    hvs = {}
    for dev in (CPU, cuda_device):
        calc = AIMNet2Calculator((params, cfg), device=dev, binned_threshold=threshold)
        system = calc.prepare_system(data)
        assert calc._prep_cache["kind"] == layout
        real = (system.numbers > 0)[:, None].cpu()
        v = torch.where(real, torch.randn(system.coord.shape, generator=torch.Generator().manual_seed(3)), 0.0)
        hvp = make_hvp_fn(calc._effective_cfg(system.cell is not None))
        counters = (cs.conv_stencil_forward, cs.conv_stencil_backward, ps.pair_sweep_forward,
                    ps.pair_sweep_backward)
        for fn in counters:
            fn.launches = 0
        with ambient_matmul_context("highest"):
            hvs[dev.type] = hvp(calc.params, system, v.to(dev))
            if dev.type == "cuda":
                assert [fn.launches for fn in counters] == [3, 6, 3, 4]
                with _plain_route():
                    plain = hvp(calc.params, system, v.to(dev))
                assert [fn.launches for fn in counters] == [3, 6, 3, 4]
    assert torch.isfinite(hvs["cuda"]).all()
    _close(hvs["cuda"], plain, 1e-4)
    _close(hvs["cuda"], hvs["cpu"], 1e-4)


def test_hessian_card_matches_cpu_and_repeats(cuda_device):
    """A 23-atom molecule's dense Hessian (wB97M-D3 head set, indexed
    all-pairs layout) on the card against the CPU (1e-4 eV/A^2), finite and
    symmetric, and two card runs equal bit for bit."""
    params, cfg = _narrow_model(CPU, d3=True)
    mol = _cluster(23, 1)
    cpu = AIMNet2Calculator((params, cfg), device="cpu").eval(mol, hessian=True)
    calc = AIMNet2Calculator((params, cfg), device=cuda_device)
    card = calc.eval(mol, hessian=True)
    again = calc.eval(mol, hessian=True)
    assert calc._prep_cache["kind"] == "indexed"
    np.testing.assert_array_equal(card["hessian"], again["hessian"])
    h = card["hessian"].reshape(69, 69)
    assert np.isfinite(h).all() and np.abs(h - h.T).max() < 1e-4
    np.testing.assert_allclose(card["hessian"], cpu["hessian"], atol=1e-4, rtol=0)


def test_binned_dense_hessian_card_matches_cpu(cuda_device):
    """``make_eval_fn(hessian=True)`` on a binned System (which the
    calculator never sends there, but a caller may): one unit row at a
    time, since the kernels' wrappers take no vmap-batched tensors; the card
    against the CPU within 1e-4 eV/A^2 and against the indexed layout's
    Hessian of the same box."""
    from aimnetcentral_tpu_torch.calculators.derivatives import make_eval_fn

    params, cfg = _narrow_model(CPU)
    rng = np.random.default_rng(4)
    box = {"coord": rng.uniform(0.0, 7.0, size=(6, 3)).astype(np.float32), "numbers": rng.choice([1, 6, 8], size=6),
           "cell": np.eye(3, dtype=np.float32) * 7.0}
    hs = {}
    for dev in (CPU, cuda_device):
        calc = AIMNet2Calculator((params, cfg), device=dev, binned_threshold=0)
        system = calc.prepare_system(box)
        assert system.bins is not None
        with ambient_matmul_context("highest"):
            h = make_eval_fn(calc._effective_cfg(True), hessian=True)(calc.params, system)["hessian"]
        slots = torch.as_tensor(calc._last_perm[(system.numbers > 0).cpu().numpy()])
        real = torch.nonzero(system.numbers > 0).reshape(-1).cpu()
        order = real[torch.argsort(slots)]  # the input order of the real slots
        hs[dev.type] = h.cpu()[order][:, :, order]
    ref = AIMNet2Calculator((params, cfg), device="cpu").eval(box, hessian=True)["hessian"]
    np.testing.assert_allclose(hs["cuda"].numpy(), hs["cpu"].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(hs["cpu"].numpy(), ref, atol=1e-4, rtol=0)


# -- the integrations: ASE, PySisyphus, TorchSim, the CLI and the observables -------------

# chip_smoke.py's absolute limits of a card-against-CPU check
CHECK_ABS = {"energy": 3e-5, "forces": 1e-5, "stress": 2e-8}
COUNTERS = (cs.conv_stencil_forward, cs.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward)


def _launches_of(fn) -> list[int]:
    """The four kernels' launches while ``fn`` runs."""
    for c in COUNTERS:
        c.launches = 0
    fn()
    return [c.launches for c in COUNTERS]


def _within_check_abs(card: dict, cpu: dict, keys=("energy", "forces", "stress")):
    for k in keys:
        if k in cpu:
            np.testing.assert_allclose(np.asarray(card[k]), np.asarray(cpu[k]), rtol=0, atol=CHECK_ABS[k], err_msg=k)


def test_ase_adapter_card_matches_cpu(cuda_device):
    """AIMNet2ASE on the 60-atom box (binned, stress; wb97m-d3 heads: A, B
    and D, E three times a request) and get_hessian of a molecule (indexed,
    no launch), the card against the CPU."""
    from torch_fakes import FakeAtoms, fake_ase

    params, cfg = _narrow_model(CPU, d3=True)
    box = _box()
    mol = _cluster(12, 5)
    res = []
    with fake_ase("aimnetcentral_tpu_torch.calculators.ase_adapter") as (mod,):
        for dev in (CPU, cuda_device):
            ase_calc = mod.AIMNet2ASE(AIMNet2Calculator((params, cfg), device=dev, binned_threshold=0))
            atoms = FakeAtoms(box["coord"], box["numbers"], cell=box["cell"], pbc=True)
            launches = _launches_of(lambda: ase_calc.calculate(atoms, properties=("energy", "forces", "stress")))
            assert launches == ([3, 3, 3, 3] if dev.type == "cuda" else [0, 0, 0, 0])
            hess = []
            assert _launches_of(lambda: hess.append(ase_calc.get_hessian(FakeAtoms(mol["coord"], mol["numbers"])))) \
                == [0, 0, 0, 0]
            res.append(({k: np.asarray(v) for k, v in ase_calc.results.items()}, hess[0]))
    (cpu, h_cpu), (card, h_card) = res
    _within_check_abs(card, cpu)
    np.testing.assert_allclose(h_card, h_cpu, rtol=0, atol=1e-4)


def test_pysis_adapter_card_matches_cpu(cuda_device):
    from aimnetcentral_tpu_torch.calculators.ase_adapter import AIMNet2Pysis

    params, cfg = _narrow_model(CPU, d3=True)
    mol = _cluster(23, 1)
    elem = [("X", "H", "He", "Li", "Be", "B", "C", "N", "O")[z] for z in mol["numbers"]]
    coords = mol["coord"].astype(np.float64).reshape(-1) / constants.Bohr
    cpu, card = (AIMNet2Pysis(AIMNet2Calculator((params, cfg), device=dev)).get_forces(elem, coords)
                 for dev in (CPU, cuda_device))
    scale = constants.Bohr / constants.Hartree
    assert abs(card["energy"] - cpu["energy"]) <= CHECK_ABS["energy"] / constants.Hartree
    np.testing.assert_allclose(card["forces"], cpu["forces"], rtol=0, atol=CHECK_ABS["forces"] * scale)


@pytest.mark.parametrize("case", ["packed", "binned"])
def test_torchsim_adapter_card_matches_cpu(cuda_device, case):
    """A batch of molecules on the molecule-bin layout and a periodic box
    with stress on the binned one, positions on the card: the outputs are
    CUDA tensors in float64, within ``CHECK_ABS`` of the CPU's."""
    from aimnetcentral_tpu_torch.calculators.torchsim_adapter import AIMNet2TorchSim
    from torch_fakes import FakeSimState

    params, cfg = _narrow_model(CPU, d3=True)
    if case == "packed":
        mols = [_cluster(n, 30 + n) for n in (40, 57, 74, 91)]
        pos = np.concatenate([m["coord"] for m in mols])
        numbers = np.concatenate([m["numbers"] for m in mols])
        sys_idx = np.repeat(np.arange(len(mols)), [len(m["numbers"]) for m in mols])
        extra, threshold = {"system_idx": sys_idx}, 128
    else:
        box = _box()
        pos, numbers, threshold = box["coord"], box["numbers"], 0
        extra = {"cell": box["cell"].T, "pbc": True}
    outs = []
    for dev in (CPU, cuda_device):
        calc = AIMNet2Calculator((params, cfg), device=dev, binned_threshold=threshold)
        state = FakeSimState(positions=torch.tensor(pos, device=dev), atomic_numbers=torch.tensor(numbers, device=dev),
                             **{k: (torch.tensor(v, device=dev) if isinstance(v, np.ndarray) else v)
                                for k, v in extra.items()})
        adapter = AIMNet2TorchSim(calc, compute_stress=case == "binned")
        launches = _launches_of(lambda: outs.append(adapter(state)))
        assert calc._prep_cache["kind"] == case
        assert launches == ([3, 3, 3, 3] if dev.type == "cuda" else [0, 0, 0, 0])
        for k, v in outs[-1].items():
            assert v.device.type == dev.type and v.dtype == torch.float64, k
    cpu, card = ({k: v.cpu().numpy() for k, v in out.items()} for out in outs)
    _within_check_abs(card, cpu)


def test_cli_sp_card_matches_cpu(cuda_device, tmp_path):
    """The ``sp`` command's body on a port-exported artifact: the card's
    printed energy and largest force equal the CPU's to the printed
    digits (within ``CHECK_ABS``)."""
    from aimnetcentral_tpu_torch import cli
    from aimnetcentral_tpu_torch.train.export import export_model

    params, cfg = _narrow_model(CPU, d3=True)
    path = str(tmp_path / "m.pt")
    export_model(params, cfg, path, sae={1: -13.6, 6: -1029.8, 7: -1485.3, 8: -2042.6},
                 implemented_species=[1, 6, 7, 8])
    mol = _cluster(23, 1)
    xyz = tmp_path / "mol.xyz"
    symbols = {1: "H", 6: "C", 7: "N", 8: "O"}
    xyz.write_text(f"{len(mol['numbers'])}\n\n" + "".join(
        f"{symbols[int(z)]} {x:.8f} {y:.8f} {w:.8f}\n" for z, (x, y, w) in zip(mol["numbers"], mol["coord"])))
    cpu, card = (cli.run_sp(path, str(xyz), device=dev) for dev in ("cpu", cuda_device.type))

    def number(ls, key):
        return float(next(ln for ln in ls if ln.startswith(key)).split(":")[1])

    for key, tol in (("energy (eV)", CHECK_ABS["energy"]), ("max |force| (eV/A)", CHECK_ABS["forces"])):
        assert abs(number(card, key) - number(cpu, key)) <= tol + 1e-6, key


def test_validate_torch_card_reproduces_the_baseline(cuda_device):
    """tools/validate_torch.py on the card against the committed baseline
    (1e-5 eV, 1e-4 eV/A, charges 1e-5)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "validate_torch.py")
    spec = importlib.util.spec_from_file_location("validate_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.check(device="cuda")


def test_spatial_ring_card_matches_single_device(cuda_device, tmp_path):
    """A ring of two ranks (parallel/spatial.py) on the card, the backend
    the hardware gives (gloo staged through the host on one card, NCCL on
    two): energy and the assembled forces of a 400-atom DSF box against the
    single-device port on the same binned system, within the JAX package's
    tests/test_spatial.py limits."""
    from torch_spatial_worker import run_world

    from aimnetcentral_tpu_torch.models import aimnet2_apply
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.models.heads import auto_switch_simple_to_dsf

    params, cfg = _narrow_model(CPU)
    cfg = auto_switch_simple_to_dsf(cfg)
    cfg = dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, dsf_rc=9.0) if isinstance(h, LRCoulombHead) else h) for n, h in cfg.outputs))
    box = _box(400, 22.0, seed=3)
    system = system_from_molecules([box], CPU)
    sysb, _perm, ovf = B.to_binned_system(system, B.plan_bins(box["cell"], 400, 5.3, safety=2.5))
    assert int(ovf.sum()) == 0 and sysb.bins.nbins[0] == 4
    (out, _rank1) = run_world(2, [("ring", "energy", dict(system=sysb, cfg=cfg, params=params, n_sp=2))],
                              str(tmp_path), device="cuda")
    out = out["ring"]
    card = sysb.to(cuda_device)
    with ambient_matmul_context("highest"):
        c = card.coord.detach().requires_grad_(True)
        e = aimnet2_apply(params_to(params, cuda_device), cfg, card.replace(coord=c), sae_external=True)["energy"].sum()
        (g,) = torch.autograd.grad(e, c)
    np.testing.assert_allclose(float(out["energy"][0]), float(e), rtol=2e-6, atol=2e-5)
    real = sysb.numbers.numpy() > 0
    g = g.cpu().numpy()
    assert np.abs(out["forces"] + g)[real].max() < 3e-5 * np.abs(g).max() + 3e-6
