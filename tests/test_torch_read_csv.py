"""The port's ``read_csv`` (the JAX module's, gates and all, its native
route the port's own build of ``csrc/csvloader.cpp``) against the JAX
package's ``read_csv`` on both routes, over the JAX tests' gate cases
(``tests/test_data.py``): CRLF and blank lines, a missing field, padded
and scientific values, quotes, hex floats, underscore literals, non-ASCII
bytes, tabs, bare CR, whitespace-only lines, duplicate and excluded
names, a field past 63 characters, a body past 64 KiB (the threaded
parse) and a ragged row.  Each route of the port gives the bits of the
same route of the JAX package, the gates route each file the same way in
both packages, and the two routes agree.  The JAX package's native route
is its ``csrc/csvloader.cpp`` built for these tests
(``torch_jax_native``), whatever the checkout's in-place builds hold."""

import numpy as np
import pytest
import torch

from distkeras_tpu.data import datasets as jds
from distkeras_tpu_torch.data import datasets
from torch_jax_native import load as load_jax_native

torch.set_num_threads(1)

CASES = {
    "plain": b"a,b,label,c\n1.5,2,1,-3e2\n4,5.25,0,6\n7,8,1,9\n",
    "crlf-blank-missing": (b"x1,x2,label\r\n1.5, -2e-3 ,0\r\n\r\n"
                           b",4.25,1\r\n3.75,0.5,1\r\n"),
    "quoted": b'a,label\n"1.0",0\n"2.0",1\n',
    "hex": b"a,label\n0x10,0\n",
    "underscore": b"a,label\n1_5,0\n",
    "tab": b"a,label\n1,0\n\t\n2,1\n",
    "non-ascii": b"a,label\n1,0\n\xff,1\n",
    "bare-cr": b"a,label\n1,0\r2,1\n",
    "whitespace-line": b"a,label\n1,0\n   \n2,1\n",
    "duplicate-names": b"a,a,label\n1,2,0\n",
    "excluded-name": b"print,label\n1,0\n",
    "comment": b"a,label\n1,0\n# note\n2,1\n",
    "long-field": ("a,label\n" + "0" * 70 + "1.5,1\n").encode(),
    "higgs-layout": None,   # label + 28 features, 600 rows (> 64 KiB)
}


def _higgs_layout(rows=600, seed=0):
    """A CSV of the Higgs layout: the label, then 28 features."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 28))
    y = rng.integers(0, 2, rows)
    head = ",".join(["label"] + [f"f{i}" for i in range(28)])
    body = "\n".join(f"{v}," + ",".join(repr(float(a)) for a in row)
                     for v, row in zip(y, x))
    return (head + "\n" + body + "\n").encode(), x, y


def _file(tmp_path, case):
    raw = CASES[case]
    if raw is None:
        raw = _higgs_layout()[0]
    p = tmp_path / f"{case}.csv"
    p.write_bytes(raw)
    return p


@pytest.fixture(autouse=True)
def jax_native_csv(monkeypatch):
    """The JAX package's parser from its own build, not the tree's."""
    monkeypatch.setattr(jds, "_native_csv", load_jax_native("csvloader"))


def _read(mod, path, route, monkeypatch, **kw):
    with monkeypatch.context() as m:
        if route == "genfromtxt":
            m.setattr(mod, "_native_csv", None)
        return mod.read_csv(str(path), "label", **kw)


def _assert_bits(got, want):
    for col in ("features", "label"):
        assert got[col].dtype == want[col].dtype
        assert got[col].shape == want[col].shape
        np.testing.assert_array_equal(got[col].view(np.uint8),
                                      want[col].view(np.uint8))


def _features(case):
    return {"excluded-name": ["print_"]}.get(case)


@pytest.mark.parametrize("route", ["native", "genfromtxt"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_route_equals_the_jax_packages(tmp_path, monkeypatch, case,
                                            route):
    path = _file(tmp_path, case)
    kw = {"feature_columns": _features(case)}
    try:
        want = _read(jds, path, route, monkeypatch, **kw)
    except ValueError as e:  # tabs and non-ASCII: genfromtxt refuses them
        with pytest.raises(type(e)):
            _read(datasets, path, route, monkeypatch, **kw)
        return
    _assert_bits(_read(datasets, path, route, monkeypatch, **kw), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_gates_route_each_file_as_the_jax_package(tmp_path, case):
    """Header and body gates decide the same route in both packages, and
    the native route's values equal genfromtxt's."""
    raw = _file(tmp_path, case).read_bytes()
    first = raw[:raw.find(b"\n") + 1]
    names = [c.strip() for c in first.decode("utf-8", "replace").strip()
             .split(",")]
    eligible = datasets._header_eligible(names, ",")
    assert eligible == jds._header_eligible(names, ",")
    if not eligible:
        return
    mine = datasets._native_parse(raw, names, ",", len(first))
    theirs = jds._native_parse(raw, names, ",", len(first))
    assert (mine is None) == (theirs is None)
    if mine is not None:
        for n in names:
            np.testing.assert_array_equal(mine[n], theirs[n])


@pytest.mark.parametrize("case", ["plain", "crlf-blank-missing",
                                  "whitespace-line", "long-field",
                                  "higgs-layout"])
def test_the_native_route_equals_genfromtxt(tmp_path, monkeypatch, case):
    path = _file(tmp_path, case)
    nat = _read(datasets, path, "native", monkeypatch)
    ref = _read(datasets, path, "genfromtxt", monkeypatch)
    _assert_bits(nat, ref)


def test_the_higgs_layout_reads_exactly(tmp_path):
    raw, x, y = _higgs_layout(seed=1)
    assert len(raw) > (1 << 16)  # the threaded parse
    p = tmp_path / "higgs.csv"
    p.write_bytes(raw)
    ds = datasets.read_csv(str(p), "label")
    np.testing.assert_array_equal(ds["features"], x.astype(np.float32))
    np.testing.assert_array_equal(ds["label"], y)
    assert datasets._native_csv.__name__ == "distkeras_tpu_torch._csvloader"


@pytest.mark.parametrize("header_gate", [["my col", "label"],
                                         ["a", "a", "label"],
                                         ["print", "label"]])
def test_header_gates_refuse_as_the_jax_package(header_gate):
    assert not datasets._header_eligible(header_gate, ",")
    assert not jds._header_eligible(header_gate, ",")
    assert not datasets._header_eligible(["a", "label"], " ")
    assert datasets._header_eligible(["a", "label"], ",")


def test_a_ragged_row_raises_on_the_native_route(tmp_path):
    bad = tmp_path / "ragged.csv"
    bad.write_text("a,b,label\n1,2,0\n1,2\n")
    with pytest.raises(ValueError, match="fields"):
        datasets.read_csv(str(bad), "label")
