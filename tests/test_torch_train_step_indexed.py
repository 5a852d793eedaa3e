"""The port's train step against the JAX package's on the indexed layout
(all-pairs neighbor matrices): the checks of tests/test_torch_train_step.py,
which holds the molecule-bin layout, in a file of their own so that each
file's JAX compiles stay under a minute."""

import pytest

pytest.importorskip("jax")  # the card's machine has no JAX

import test_torch_train_step as base  # noqa: E402
from test_torch_train_step import _one_torch_thread, model  # noqa: E402, F401  (fixtures)

LAYOUTS = ("indexed",)


@pytest.fixture(scope="module")
def jax_steps(model):  # noqa: F811
    return base.run_jax_steps(model, LAYOUTS)


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("with_forces", [True, False], ids=["forces", "energy"])
def test_train_step_matches_jax_indexed(model, jax_steps, with_forces, precision):  # noqa: F811
    base.check_step(model, jax_steps, LAYOUTS[0], with_forces, precision)
