"""The port's own copies of config.py and io.py against the JAX package's,
on the same YAML, XYZ and CIF files written into ``tmp_path``: equal
results, and the same exception types where JAX raises."""

import numpy as np
import pytest

pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu import config as jconfig  # noqa: E402
from aimnetcentral_tpu import io as jio  # noqa: E402
from aimnetcentral_tpu_torch import config as tconfig  # noqa: E402
from aimnetcentral_tpu_torch import io as tio  # noqa: E402

XYZ = """5
methane, extended comment line
C 0.000 0.000 0.000
H 0.629 0.629 0.629
H -0.629 -0.629 0.629
1 -0.629 0.629 -0.629
H 0.629 -0.629 -0.629
"""

# a monoclinic P21/c cell with two sites, one on a special position, a
# quoted operator list and a multi-line text field
CIF = """data_test
_cell_length_a 4.9821(3)
_cell_length_b 12.5624(8)
_cell_length_c 11.8156(7)
_cell_angle_alpha 90
_cell_angle_beta 91.1262(10)
_cell_angle_gamma 90
_publ_section_title
;
a title over
two lines
;
loop_
_symmetry_equiv_pos_as_xyz
'x, y, z'
'-x, 1/2+y, 1/2-z'
'-x, -y, -z'
'x, 1/2-y, 1/2+z'
loop_
_atom_site_label
_atom_site_type_symbol
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
C1 C 0.1234(5) 0.2345(3) 0.3456(2)
O1 O 0.5 0.5 0.5
H1 H 0.7 0.1 0.9
"""

CONFIGS = {
    "template_path": ("cfg.yaml", "lr: '{{ lr }}'\nhidden: [{{ width }}, {{ width }}]\nname: run-{{ tag }}\n",
                      {"lr": 1e-3, "width": 128, "tag": "a"}),
    "nested": ("train.yaml", "model: model.yaml\nepochs: 3\n", None),
    "missing_nested": ("bad.yaml", "model: nope.yaml\n", None),
}


def _both(fn_t, fn_j, *args, **kw):
    try:
        want = fn_j(*args, **kw)
    except Exception as e:  # the outcome under test
        with pytest.raises(type(e)):
            fn_t(*args, **kw)
        return None
    got = fn_t(*args, **kw)
    return got, want


@pytest.mark.parametrize("case", list(CONFIGS))
def test_load_yaml_matches_jax(tmp_path, case):
    name, text, hyper = CONFIGS[case]
    (tmp_path / "model.yaml").write_text("class: aimnet.models.AIMNet2\nkwargs: {nfeature: 16}\n")
    (tmp_path / name).write_text(text)
    res = _both(tconfig.load_yaml, jconfig.load_yaml, str(tmp_path / name), hyper)
    if case == "missing_nested":
        assert res is None
        return
    assert res[0] == res[1]
    off = _both(tconfig.load_yaml, jconfig.load_yaml, str(tmp_path / name), hyper, allow_file_references=False)
    assert off[0] == off[1]


def test_load_yaml_tree_matches_jax():
    src = {"opt": {"lr": "{{ lr }}"}, "tags": ["{{ tag }}", "literal"]}
    got, want = _both(tconfig.load_yaml, jconfig.load_yaml, src, {"lr": 0.01, "tag": "t"})
    assert got == want and src["opt"]["lr"] == "{{ lr }}"


def test_read_xyz_matches_jax(tmp_path):
    (tmp_path / "m.xyz").write_text(XYZ)
    (c_t, z_t), (c_j, z_j) = _both(tio.read_xyz, jio.read_xyz, str(tmp_path / "m.xyz"))
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(z_t, z_j)
    assert c_t.dtype == np.float32 and z_t.tolist() == [6, 1, 1, 1, 1]


def test_read_cif_matches_jax(tmp_path):
    (tmp_path / "s.cif").write_text(CIF)
    got, want = _both(tio.read_cif, jio.read_cif, str(tmp_path / "s.cif"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["numbers"]) == 4 + 2 + 4  # the special position merges to two images
    (tmp_path / "bad.cif").write_text("data_x\n_cell_length_a 3.0\n")
    assert _both(tio.read_cif, jio.read_cif, str(tmp_path / "bad.cif")) is None


@pytest.mark.parametrize("params", [(3.0, 4.0, 5.0, 90.0, 90.0, 90.0), (4.98, 12.56, 11.82, 90.0, 91.13, 90.0),
                                    (5.0, 6.0, 7.0, 80.0, 95.0, 110.0)])
def test_cell_from_parameters_matches_jax(params):
    got, want = _both(tio.cell_from_parameters, jio.cell_from_parameters, *params)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("symbol", ["C", "C1", "Cl", "O2-", "Xx"])
def test_symbol_to_z_matches_jax(symbol):
    res = _both(tio.symbol_to_z, jio.symbol_to_z, symbol)
    assert res is None if symbol == "Xx" else res[0] == res[1]
