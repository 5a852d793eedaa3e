"""Shared pieces of the spatial-decomposition tests: JAX's test boxes
(tests/test_spatial.py), built by both packages on the same slot layout,
a narrow model carried into the port, JAX's single-device references, and
gloo worlds run beside them (imports JAX; the spawned ranks do not)."""

import dataclasses
import tempfile
import threading

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
from aimnetcentral_tpu.models import aimnet2_apply, aimnet2_init
from aimnetcentral_tpu.models import heads as jheads
from aimnetcentral_tpu.models.aimnet2 import AEVConfig, AIMNet2Config
from aimnetcentral_tpu.models.ewald import attach_ewald as j_attach_ewald
from aimnetcentral_tpu.models.modules import MLPSpec
from aimnetcentral_tpu.ops import binned as jB
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules
from aimnetcentral_tpu_torch.models.ewald import attach_ewald as t_attach_ewald
from aimnetcentral_tpu_torch.ops import binned as tB
from torch_spatial_worker import run_world
from torch_train_helpers import port_object, port_params

CPU = torch.device("cpu")
E_TOL = dict(rtol=2e-6, atol=2e-5)  # JAX tests/test_spatial.py's energy limits


def narrow_config(coulomb: jheads.LRCoulombHead, extra=()) -> AIMNet2Config:
    """The flagship head chain at narrow widths."""
    return AIMNet2Config(
        aev=AEVConfig(nshifts_s=8), nfeature=4, ncomb_v=4, hidden=((32,), (32,), (32,)), aim_size=32,
        outputs=(
            ("energy_mlp", jheads.OutputHead(n_in=32, n_out=1, key_in="aim", key_out="energy",
                                             mlp=MLPSpec(hidden=(16,)))),
            ("atomic_shift", jheads.AtomicShiftHead(key_in="energy", key_out="energy")),
            ("atomic_sum", jheads.AtomicSumHead(key_in="energy", key_out="energy")),
            ("lrcoulomb", coulomb),
        ) + tuple(extra),
    )


def lattice_box(n, a, jitter, seed, elements=(1, 6, 7, 8), p=(0.5, 0.35, 0.05, 0.1)):
    """JAX test_spatial.py's boxes: ``n`` atoms on a jittered cubic
    lattice in a cube of edge ``a``."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1 / 3)))
    pts = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1).reshape(-1, 3)[:n]
    coord = ((pts + 0.5) * (a / m)).astype(np.float32)
    coord += rng.uniform(-jitter, jitter, coord.shape).astype(np.float32)
    numbers = rng.choice(elements, size=n, p=p)
    return {"coord": coord, "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}


def binned_pair(mol, edge, safety, ewald_accuracy=None, pme=False, mult=None):
    """The box on the binned layout in both packages (the same slot
    permutation, bit for bit), with Ewald's discretisation attached."""
    cell = mol["cell"]
    n = len(mol["numbers"])
    jsys = j_system_from_molecules([mol], build_nbmat=False)
    jsys, _perm, ovf = jB.to_binned_system(jsys, jB.plan_bins(cell, n, edge, safety=safety))
    assert int(ovf) == 0
    tsys = t_system_from_molecules([mol], CPU)
    tsys, _perm, t_ovf = tB.to_binned_system(tsys, tB.plan_bins(cell, n, edge, safety=safety))
    assert int(t_ovf.sum()) == 0
    np.testing.assert_array_equal(tsys.numbers.numpy(), np.asarray(jsys.numbers))
    if ewald_accuracy is not None:
        jsys = j_attach_ewald(jsys, ewald_accuracy, pme=pme)
        tsys = t_attach_ewald(tsys, ewald_accuracy, pme=pme)
    if mult is not None:
        jsys = jsys.replace(mult=jnp.asarray([mult], jnp.float32))
        tsys = tsys.replace(mult=torch.tensor([mult], dtype=torch.float32))
    return jsys, tsys


def model(cfg, seed):
    """JAX's random weights for ``cfg`` and both packages' forms of it
    (simple Coulomb becomes DSF under PBC in both)."""
    cfg = jheads.auto_switch_simple_to_dsf(cfg)
    params = aimnet2_init(jax.random.key(seed), cfg)
    return cfg, params, port_object(cfg), port_params(params)


def jax_reference(cfg, params, jsys):
    """JAX's single-device forward on the binned box: the energy, its
    gradients in the coordinates and the cell, and the observables."""

    def energy(coord, cell):
        out = aimnet2_apply(params, cfg, jsys.replace(coord=coord, cell=cell[None]), sae_external=True)
        aux = {k: out[k] for k in ("charges", "spin_charges", "dipole", "quadrupole") if k in out}
        return out["energy"].sum(), aux

    fn = jax.jit(jax.value_and_grad(energy, argnums=(0, 1), has_aux=True))
    (e, aux), (g, g_cell) = fn(jsys.coord, jsys.cell[0])
    ref = {"energy": float(e), "grad": np.asarray(g), "cell_grad": np.asarray(g_cell)}
    ref.update({k: np.asarray(v) for k, v in aux.items()})
    return ref, fn


def verlet_reference(fn, jsys, veloc0, masses, dt_fs, steps, langevin=None):
    """JAX's single-device velocity Verlet from SpatialMDDriver's
    initial state, with ``fn`` of :func:`jax_reference` (epot a step).
    ``langevin = (friction_fs, temperature_K, noises)``: after each step,
    JAX's Langevin update (``dynamics/md.py``) with that step's (N, 3)
    standard normal draw."""
    from aimnetcentral_tpu import constants

    coord, veloc = jsys.coord, jnp.asarray(veloc0)
    m = jnp.asarray(masses)[:, None]
    real = (jsys.numbers > 0)[:, None]
    dt = dt_fs * constants.fs
    (_e, _aux), (g, _gc) = fn(coord, jsys.cell[0])
    epots = []
    for k in range(steps):
        v_half = veloc + 0.5 * dt * jnp.where(real, -g / m, 0.0)
        coord = coord + dt * v_half
        (e, _aux), (g, _gc) = fn(coord, jsys.cell[0])
        veloc = v_half + 0.5 * dt * jnp.where(real, -g / m, 0.0)
        if langevin is not None:
            friction_fs, temperature_k, noises = langevin
            c1 = jnp.exp(-(friction_fs / constants.fs) * dt)
            sigma = jnp.sqrt((1.0 - c1 * c1) * constants.kB * temperature_k / m)
            veloc = jnp.where(real, c1 * veloc + sigma * jnp.asarray(noises[k]), 0.0)
        epots.append(float(e))
    return np.array(epots)


class World:
    """A gloo world of CPU ranks running ``tasks`` in a thread, so that the
    test process computes JAX's references meanwhile; ``results()`` joins
    it and returns every rank's results."""

    def __init__(self, world_size, tasks):
        self._dir = tempfile.TemporaryDirectory()
        self._out, self._err = None, None

        def target():
            try:
                self._out = run_world(world_size, tasks, self._dir.name)
            except Exception as exc:  # re-raised in results()
                self._err = exc

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def results(self):
        self._thread.join(timeout=600)
        assert not self._thread.is_alive(), "the gloo world did not finish"
        self._dir.cleanup()
        if self._err is not None:
            raise self._err
        return self._out


def assert_forces(got, grad_ref, numbers):
    """JAX test_spatial.py's force limit: 3e-5 of the largest force + 3e-6,
    on the real atoms."""
    real = np.asarray(numbers) > 0
    scale = max(float(np.abs(grad_ref).max()), 1e-9)
    d = np.abs(got + grad_ref)[real]
    assert d.max() < 3e-5 * scale + 3e-6, (d.max(), scale)


def assert_cell_grad(got, ref):
    """JAX test_spatial.py's cell-gradient limit."""
    scale = max(float(np.abs(ref).max()), 1e-9)
    np.testing.assert_allclose(got, ref, atol=5e-5 * scale + 5e-6)


def replace_head(cfg, kind, **kw):
    return dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, **kw) if h.kind == kind else h) for n, h in cfg.outputs))
