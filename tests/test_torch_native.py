"""The port's native meshio loader (utils/native.py) vs the JAX package's
and the port's pure-Python tet_grid: the same grid and adjacency, a build
into the port's own build directory that concurrent builds cannot
corrupt, and None when the library cannot be had."""

import threading

import numpy as np
import pytest

from dmesh2_renderer_tpu.utils import native as jax_native
from dmesh2_renderer_tpu_torch.utils import meshes as TM
from dmesh2_renderer_tpu_torch.utils import native

needs_cxx = pytest.mark.skipif(native.load() is None, reason="no C++ toolchain")


@needs_cxx
@pytest.mark.parametrize("res,extent", [(3, 1.2), (4, 1.0)])
def test_native_tet_grid_matches_jax_and_python(res, extent, tmp_path,
                                                monkeypatch):
    """Equal to the JAX package's native module, and to the port's
    pure-Python tet_grid (vertices within the 1e-6 of tests/test_native.py:
    the native path computes them in float32). The JAX module builds its
    library into ``tmp_path`` here, so this never races tests/test_native.py
    for the repository's csrc/build/libmeshio.so."""
    monkeypatch.setattr(jax_native, "_LIB", str(tmp_path / "libmeshio.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_failed", False)
    assert jax_native.load() is not None
    nv, nt = native.tet_grid(res, extent)
    nf, nft, ntf = native.tet_adjacency(nt)
    jv, jt = jax_native.tet_grid(res, extent)
    np.testing.assert_array_equal(nv, jv)
    np.testing.assert_array_equal(nt, jt)
    for got, want in zip((nf, nft, ntf), jax_native.tet_adjacency(jt)):
        np.testing.assert_array_equal(got, want)
    pv, pt, pf, pft, ptf = TM.tet_grid(res, extent)
    np.testing.assert_allclose(nv, pv, atol=1e-6)
    for got, want in zip((nt, nf, nft, ntf), (pt, pf, pft, ptf)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@needs_cxx
def test_native_adjacency_invariants():
    _, nt = native.tet_grid(4, 1.0)
    faces, face_tets, tet_faces = native.tet_adjacency(nt)
    assert (face_tets[:, 0] >= 0).all()
    assert ((face_tets[:, 1] == -1) | (face_tets[:, 1] >= 0)).all()
    assert (tet_faces >= 0).all() and (tet_faces < faces.shape[0]).all()
    assert (face_tets[:, 1] >= 0).sum() > 0
    assert all(len(set(row)) == 4 for row in tet_faces[:16])


@needs_cxx
def test_build_lands_in_the_port_build_dir_and_survives_concurrent_builds(
        tmp_path, monkeypatch):
    """The library is built under dmesh2_renderer_tpu_torch/csrc/build (not
    the repository's csrc/build, which the JAX package's loader writes);
    eight builds at once leave one loadable library and no temporaries."""
    path = native.library_path()
    assert path.parent.parts[-3:] == ("dmesh2_renderer_tpu_torch", "csrc", "build")
    assert path.exists()
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    out = native.library_path()
    errors = []

    def build():
        try:
            native._build(out)
        except Exception as e:  # collected and raised below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in tmp_path.iterdir()] == [out.name]
    import ctypes
    assert ctypes.CDLL(str(out)).tet_count_faces is not None


def test_missing_source_or_compiler_returns_none(monkeypatch, tmp_path):
    """As in the JAX package, no library means None, not an exception."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_SRC", tmp_path / "missing.cpp")
    assert native.load() is None
    assert native.tet_grid(2, 1.0) is None
    assert native.tet_adjacency(np.zeros((1, 4), np.int32)) is None
