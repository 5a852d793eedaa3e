"""The port's spatial decomposition against the JAX package's sharded
function itself, ``parallel/spatial.py::make_spatial_energy_fn``, on JAX's
virtual CPU mesh: energy and forces on the 400-atom DSF box, a ring of two
and the 2 x 2 torus.  Marked slow, as JAX's tests/test_spatial.py is: its
``shard_map`` compiles take minutes on the CPU.  The fast lane holds the
port to JAX's single-device forward instead (tests/test_torch_spatial.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.parallel.spatial import (  # noqa: E402
    make_spatial_energy_fn,
    make_spatial_mesh,
    plan_spatial,
)
from torch_spatial_helpers import (  # noqa: E402
    E_TOL,
    World,
    assert_forces,
    binned_pair,
    lattice_box,
    model,
    narrow_config,
)

pytestmark = pytest.mark.slow

MESHES = ((2, 1), (2, 2))


@pytest.fixture(scope="module")
def runs():
    jsys, tsys = binned_pair(lattice_box(400, 22.0, 0.4, seed=3), 5.3, 2.5)
    jc, jp, tc, tp = model(narrow_config(jheads.LRCoulombHead(rc=4.6, dsf_rc=9.0)), 0)
    world = World(4, [(f"{n}x{m}", "energy", dict(system=tsys, cfg=tc, params=tp, n_sp=n, n_spy=m))
                      for n, m in MESHES])
    refs = {}
    for n, m in MESHES:
        efn = make_spatial_energy_fn(jc, plan_spatial(jsys, jc, n, m), make_spatial_mesh(n, m))
        e, g = jax.value_and_grad(lambda c: efn(jp, c, jsys.numbers, jsys.charge, jsys.cell[0]))(jsys.coord)
        refs[f"{n}x{m}"] = (float(e), np.asarray(g))
    return refs, world.results()[0], tsys.numbers


@pytest.mark.parametrize("shape", [f"{n}x{m}" for n, m in MESHES])
def test_port_matches_jax_sharded_function(runs, shape):
    refs, out, numbers = runs
    e, g = refs[shape]
    np.testing.assert_allclose(float(out[shape]["energy"][0]), e, **E_TOL)
    assert_forces(out[shape]["forces"], g, numbers)
