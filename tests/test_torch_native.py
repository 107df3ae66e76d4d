"""The port's native PEG against the JAX package's: both compile
``native/ldpcnative.cpp`` and must build the same codes (exact alists);
the port builds into ``build/torch_native/`` and never falls back to the
Python PEG."""

import pytest

from ldpcsimulation_tpu import native as jnative
from ldpcsimulation_tpu.codes import construct as jcon
from ldpcsimulation_tpu_torch import native
from ldpcsimulation_tpu_torch.codes import peg
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)


def _alist_fields(a):
    return (a.n, a.m, a.nlist, a.mlist, a.q, a.nvals, a.mvals)


@pytest.mark.parametrize("n,m,dv,seed", [
    (96, 48, 3, 0), (200, 100, 3, 7), (1000, 500, 4, 3), (4376, 282, 4, 11),
])
def test_peg_native_equals_jax(n, m, dv, seed):
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")
    got = native.peg_native(n, m, dv, seed=seed)
    assert _alist_fields(got) == _alist_fields(
        jnative.peg_native(n, m, dv, seed=seed))
    assert all(len(c) == dv for c in got.nlist)


def test_peg_backends_route_as_jax():
    """"auto" takes the native PEG for regular codes with n > 2000 and the
    Python one below; "native" always for regular dv; an irregular dv
    sequence stays in Python, as in the JAX package."""
    assert _alist_fields(peg(2048, 384, 6, seed=8)) == _alist_fields(
        jcon.peg(2048, 384, 6, seed=8))
    assert _alist_fields(peg(60, 30, 3, seed=2, backend="native")) == (
        _alist_fields(jcon.peg(60, 30, 3, seed=2, backend="native")))
    assert _alist_fields(peg(60, 30, 3, seed=2)) == _alist_fields(
        jcon.peg(60, 30, 3, seed=2, backend="python"))
    assert _alist_fields(peg(60, 30, 3, seed=2)) != _alist_fields(
        peg(60, 30, 3, seed=2, backend="native"))
    dv = [2, 3] * 15
    assert _alist_fields(peg(30, 15, dv, seed=1, backend="native")) == (
        _alist_fields(jcon.peg(30, 15, dv, seed=1, backend="native")))
    with pytest.raises(ValueError, match="backend"):
        peg(30, 15, 3, backend="fortran")


def test_build_lands_in_build_dir_and_reads_the_source():
    src = native.SOURCE.read_bytes()
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert path.exists() and native.build() == path  # built once
    assert not list(native.BUILD_DIR.glob("*.tmp"))
    assert native.SOURCE.read_bytes() == src


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-x")
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.peg_native(50, 25, 3)
    assert not (tmp_path / "torch_native").exists() or not list(
        (tmp_path / "torch_native").iterdir())


def test_peg_native_rejects_bad_shapes():
    with pytest.raises(RuntimeError, match="rc=1"):
        native.peg_native(4, 10, 1)  # n * dv < m
    a = native.peg_native(40, 20, 2)
    assert a.num_edges == 80 and min(len(r) for r in a.mlist) >= 1
