"""The port's legacy ``.jpt`` models on the binned layout against the JAX
package's (CPU): test_torch_legacy.py's six hand-made archives, the 60-atom
periodic box of test_torch_loader.py, energies, charges and forces within
its limits (1e-5 relative energy, 1e-5 eV/A).  The flagship's embedded
simple Coulomb runs as DSF in the box, as JAX switches it.

JAX's reference is its indexed layout (a third of its binned layout's
compile time), except for two head sets.  The long-range heads are held to
JAX's binned layout: D3TS on the indexed layout sums the whole LR list,
which reaches the layout's reuse skin beyond 15 A, where the binned layout
stops at 15 A (3.0e-3 eV on this box, in both packages; ROADMAP.md section
3).  JAX's binned engine refuses the model without ``d2features``, which is
held to its indexed layout.
"""

import pytest

pytest.importorskip("jax")  # the card's machine has no JAX

from test_torch_legacy import (  # noqa: E402, F401  (fixtures: archives, loaded, _one_torch_thread)
    CONFIGS,
    _data,
    _one_torch_thread,
    archives,
    legacy_matches_jax,
    loaded,
)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_legacy_box_matches_jax(archives, loaded, name):  # noqa: F811
    legacy_matches_jax(archives[name][0], loaded[name][0], name, _data(name, "box")[0], ((0, "binned"),),
                       jax_threshold=0 if name == "lr-heads" else 1 << 30)
