"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips.  The file imports neither JAX nor the JAX package, so it also runs
on a machine without them:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets JAX up.)  Tolerance: 1e-5 of the
output's largest magnitude (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from aimnetcentral_tpu_torch.builders import system_from_molecules
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables
from aimnetcentral_tpu_torch.models import AIMNet2Config, aimnet2_init
from aimnetcentral_tpu_torch.models.heads import (
    AtomicShiftHead,
    AtomicSumHead,
    LRCoulombHead,
    OutputHead,
)
from aimnetcentral_tpu_torch.models.modules import MLPSpec
from aimnetcentral_tpu_torch.ops import binned as B

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


def _operands(layout: str, f: int, seed: int = 7):
    """Kernel operands on the CPU: a 40-atom box on 2x2x2 or 1x1x1
    periodic bins, or a gas-phase 3x2x2 grid (steps without a candidate)."""
    rng = np.random.default_rng(seed)
    n, a = 40, 12.0
    coord = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=n)
    if layout == "gas":
        mol = {"coord": coord * np.array([1.0, 0.7, 0.7], np.float32), "numbers": numbers}
        grid = B.BinGrid(nbins=(3, 2, 2), capacity=16, edge_hint=4.0, periodic=False)
    else:
        mol = {"coord": coord, "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}
        # capacity 16 on 2x2x2 bins; 136 on one bin, which the kernels
        # split into uneven atom tiles
        edge, safety = {"2x2x2": (5.2, 3.0), "1x1x1": (12.0, 3.4)}[layout]
        grid = B.plan_bins(mol["cell"], n, edge, safety=safety)
    sysb, _perm, ovf = B.to_binned_system(system_from_molecules([mol], CPU), grid)
    assert int(ovf) == 0
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
    return st, ops, torch.tensor(tab["mnbr"]), gbar


def _to(dev, ops):
    return {k: v.to(dev).contiguous() for k, v in ops.items()}


LAYOUTS = ["2x2x2", "1x1x1", "gas"]


@pytest.mark.parametrize("f", [16, 17])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_a_matches_plain(cuda_device, layout, f):
    st, ops, _mnbr, _gbar = _operands(layout, f)
    out = cs.conv_stencil_forward(st, **_to(cuda_device, ops))
    torch.cuda.synchronize()
    _close(out, cs.conv_forward_plain(st, **ops))


@pytest.mark.parametrize("f", [16, 17])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_b_matches_plain(cuda_device, layout, f):
    st, ops, mnbr, gbar = _operands(layout, f)
    got = cs.conv_stencil_backward(
        st, **_to(cuda_device, ops), mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device)
    )
    torch.cuda.synchronize()
    for g, r in zip(got, cs.conv_backward_plain(st, **ops, gbar=gbar)):
        _close(g, r)


def test_kernels_are_deterministic(cuda_device):
    """No float atomics: two runs agree bit for bit."""
    st, ops, mnbr, gbar = _operands("2x2x2", 17)
    dev_ops = _to(cuda_device, ops)
    args = dict(mnbr=mnbr.to(cuda_device), gbar=gbar.to(cuda_device))
    assert torch.equal(cs.conv_stencil_forward(st, **dev_ops), cs.conv_stencil_forward(st, **dev_ops))
    for x, y in zip(cs.conv_stencil_backward(st, **dev_ops, **args),
                    cs.conv_stencil_backward(st, **dev_ops, **args)):
        assert torch.equal(x, y)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    st, ops, _mnbr, _gbar = _operands("2x2x2", 16)
    dev_ops = _to(cuda_device, ops)
    with pytest.raises(ValueError, match="a_gmajor"):
        cs.conv_stencil_forward(st, **{**dev_ops, "a_gmajor": dev_ops["a_gmajor"].double()})
    with pytest.raises(ValueError, match="coord"):
        cs.conv_stencil_forward(st, **{**dev_ops, "coord": dev_ops["coord"].transpose(0, 1)})


def _narrow_model(device):
    cfg = AIMNet2Config(
        nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16,
        outputs=(
            ("energy_mlp", OutputHead(n_in=16, n_out=1, key_in="aim", key_out="energy",
                                      mlp=MLPSpec(hidden=(16, 16)))),
            ("atomic_shift", AtomicShiftHead(key_in="energy", key_out="energy")),
            ("atomic_sum", AtomicSumHead(key_in="energy", key_out="energy")),
            ("lrcoulomb", LRCoulombHead(rc=4.6, key_in="charges", key_out="energy")),
        ),
    )
    return aimnet2_init(cfg, seed=0, device=device), cfg


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
