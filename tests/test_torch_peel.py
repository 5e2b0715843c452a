"""The port's depth peel (ops/peel.py) and its scene utilities vs the JAX
package: tet_grid, check_layered_args, pack_peel_stream and the plain peel
against the JAX peel_layers (Pallas in interpret mode) on identical
streams, tile ranges and rays."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops import peel as JP
from dmesh2_renderer_tpu.ops.binning import bin_faces as jax_bin_faces
from dmesh2_renderer_tpu.ops.binning import unblock_stream
from dmesh2_renderer_tpu.ops.reference import face_depth01
from dmesh2_renderer_tpu.utils import meshes as JM
from dmesh2_renderer_tpu.utils.validate import check_layered_args as jax_check
from dmesh2_renderer_tpu_torch.ops import peel as TP
from dmesh2_renderer_tpu_torch.utils import meshes as TM
from dmesh2_renderer_tpu_torch.utils.validate import check_layered_args
from tests._torch_port import to_numpy

# A ragged frame (3 x 3 tiles, the last column and row partly outside).
W, H, B = 40, 36, 2


def _jax_python_tet_grid(res):
    """The JAX package's pure-Python tet_grid (the path the port copies),
    with its native C++ path bypassed as tests/test_native.py does."""
    from dmesh2_renderer_tpu.utils import native

    lib, failed = native._lib, native._failed
    try:
        native._lib, native._failed = None, True
        return JM.tet_grid(res)
    finally:
        native._lib, native._failed = lib, failed


@pytest.mark.parametrize("res", [1, 2, 3])
def test_tet_grid_matches_jax(res):
    """Equal to the JAX package's Python path; equal to whatever path
    ``tet_grid`` takes in the JAX package except that its native C++ path
    computes the vertex coordinates in float32 (within the 1e-6 of
    tests/test_native.py)."""
    got = TM.tet_grid(res)
    for g, w in zip(got, _jax_python_tet_grid(res)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    want = JM.tet_grid(res)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _layered_args(res=1):
    verts, tets, faces, face_tets, tet_faces = TM.tet_grid(res)
    exist = np.ones(faces.shape[0], np.int32)
    return [verts, faces, tets, face_tets, tet_faces, exist]


# argument position -> a malformed replacement
BAD_ARGS = {
    "verts": (0, lambda a: a[0][:, :2]),
    "faces": (1, lambda a: a[1][:, :2]),
    "tets": (2, lambda a: a[2][:, :3]),
    "face_tets": (3, lambda a: a[3][:-1]),
    "tet_faces": (4, lambda a: a[4][:-1]),
    "faces_existence": (5, lambda a: a[5][:-1]),
}


@pytest.mark.parametrize("name", sorted(BAD_ARGS))
def test_check_layered_args_matches_jax(name):
    args = _layered_args()
    check_layered_args(*args)
    jax_check(*args)
    pos, make_bad = BAD_ARGS[name]
    args[pos] = make_bad(args)
    with pytest.raises(ValueError) as got:
        check_layered_args(*args)
    with pytest.raises(ValueError) as want:
        jax_check(*args)
    assert str(got.value) == str(want.value)
    assert name in str(got.value)


@functools.lru_cache(maxsize=1)
def _binned_scene():
    """tet_grid(2), a third of the faces deleted, two views, binned by min
    depth as the peel pipeline does, on the JAX side. Returns numpy arrays
    and the JAX stream."""
    verts, _, faces, _, _ = JM.tet_grid(2)
    exist = np.ones(faces.shape[0], np.int32)
    exist[::3] = 0
    mv, proj = JM.orbit_cameras(B)
    ray_o, ray_d = JG.init_rays(jnp.asarray(mv), jnp.asarray(proj), W, H)
    vndc, vimg = JG.compute_verts_ndc_image(jnp.asarray(verts), jnp.asarray(mv),
                                            jnp.asarray(proj), W, H)
    tris = JG.face_aa_triangles(vimg, jnp.asarray(faces))
    _, min_depth, _, alive = face_depth01(vndc, jnp.asarray(faces))
    binning = jax_bin_faces(tris.verts, min_depth, alive,
                            jnp.zeros((B, 2), jnp.int32), W, H, 1 << 13, 64,
                            num_giant_faces=64)
    stream = JP.pack_peel_stream(binning.entry_bf, jnp.asarray(verts),
                                 jnp.asarray(faces), jnp.asarray(exist))
    arrays = dict(entry_bf=np.array(binning.entry_bf), verts=verts,
                  faces=faces, exist=exist,
                  starts=np.array(binning.tile_starts),
                  counts=np.array(binning.tile_counts),
                  ray_o=np.array(ray_o[:, 0, 0, :]), ray_d=np.array(ray_d))
    return arrays, stream


def _port_args(a):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    return (t["entry_bf"], t["faces"], t["verts"], t["exist"], t["starts"],
            t["counts"], t["ray_o"], t["ray_d"], W, H)


def test_pack_peel_stream_matches_jax():
    a, stream = _binned_scene()
    got = TP.pack_peel_stream(torch.as_tensor(a["entry_bf"]),
                              torch.as_tensor(a["verts"]),
                              torch.as_tensor(a["faces"]),
                              torch.as_tensor(a["exist"]))
    want = np.asarray(unblock_stream(stream))
    assert got.shape == (a["entry_bf"].shape[0], TP.PREC_WIDTH)
    np.testing.assert_array_equal(to_numpy(got), want)


@functools.lru_cache(maxsize=4)
def _jax_peel(num_layers):
    a, stream = _binned_scene()
    layers, counts = JP.peel_layers(
        stream, jnp.asarray(a["starts"]), jnp.asarray(a["counts"]),
        jnp.asarray(a["ray_o"]), jnp.asarray(a["ray_d"]), W, H, num_layers,
        interpret=True)
    return np.asarray(layers), np.asarray(counts)


@pytest.mark.parametrize("num_layers", [1, 3, 8])
def test_plain_peel_matches_jax(num_layers):
    """Same stream, tile ranges and (JAX's own) rays: the plain peel
    repeats the JAX kernel's arithmetic, so layers and counts are equal."""
    a, _ = _binned_scene()
    want_l, want_c = _jax_peel(num_layers)
    work = {}
    layers, counts = TP.peel_layers_plain(*_port_args(a), num_layers, work=work)
    assert layers.dtype == torch.int32 and counts.dtype == torch.int32
    assert tuple(layers.shape) == (B, H, W, num_layers)
    np.testing.assert_array_equal(to_numpy(layers), want_l)
    np.testing.assert_array_equal(to_numpy(counts), want_c)
    assert want_c.max() == num_layers
    # the wrapper takes the plain version on CPU tensors
    got = TP.peel_layers(*_port_args(a), num_layers)
    assert all(torch.equal(x, y) for x, y in zip(got, (layers, counts)))
    assert 0 < int(work["hits"]) <= int(work["pairs"])
    assert int(work["pairs"]) <= int(work["entries"]) * 256


def test_plain_peel_on_a_subset_of_tiles():
    """``tiles=`` peels only those tiles, in groups of any size, and leaves
    every other pixel at -1 layers and 0 counts."""
    a, _ = _binned_scene()
    full_l, full_c = TP.peel_layers_plain(*_port_args(a), 3)
    tiles = torch.tensor([0, 4, 8, 9, 17], dtype=torch.int32)
    sub_l, sub_c = TP.peel_layers_plain(*_port_args(a), 3, tiles=tiles, group=2)
    mask = torch.zeros((B, 3, 3), dtype=torch.bool)
    mask.view(-1)[tiles.long()] = True
    mask = mask.repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :H, :W]
    assert torch.equal(sub_l[mask], full_l[mask])
    assert torch.equal(sub_c[mask], full_c[mask])
    assert (sub_l[~mask] == -1).all() and (sub_c[~mask] == 0).all()
    assert int(sub_c[mask].max()) > 0


@pytest.mark.parametrize("case", ["same_block", "across_blocks"])
def test_tie_rule_matches_jax(case):
    """Two ids of one vertex triple hit at bit-identical t. Inside one
    128-entry block the tie collapses to one layer with the larger id;
    split across two blocks both are kept, the earlier block's first."""
    f = 131
    verts = np.zeros((3 * f, 3), np.float32)
    faces = np.arange(3 * f, dtype=np.int32).reshape(f, 3)
    tri = np.array([[-1.0, -1.0, 0.2], [1.0, -1.0, 0.2], [0.0, 1.0, 0.2]],
                   np.float32)
    verts[:] = np.tile(tri, (f, 1))
    verts[3 * 130:] = tri - [0, 0, 0.5]       # face 130: one layer further
    exist = np.zeros(f, np.int32)
    dup = (3, 4) if case == "same_block" else (127, 128)
    faces[dup[1]] = faces[dup[0]]              # the same triple under two ids
    exist[list(dup) + [130]] = 1
    # One 16x16 tile, all 131 entries in id order, then sentinels.
    entry_bf = np.full(256, f, np.int32)
    entry_bf[:f] = np.arange(f)
    starts, counts = np.array([0], np.int32), np.array([f], np.int32)
    pos = [int(np.nonzero(entry_bf == d)[0][0]) for d in dup]
    same = pos[0] // 128 == pos[1] // 128
    assert same == (case == "same_block")
    ray_o = np.array([[0.0, 0.0, 3.0]], np.float32)
    ray_d = np.zeros((1, 16, 16, 3), np.float32)
    ray_d[..., 2] = -1.0

    want = JP.peel_layers(
        JP.pack_peel_stream(jnp.asarray(entry_bf), jnp.asarray(verts),
                            jnp.asarray(faces), jnp.asarray(exist)),
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(ray_o),
        jnp.asarray(ray_d), 16, 16, 3, interpret=True)
    got = TP.peel_layers(*(torch.as_tensor(x) for x in (
        entry_bf, faces, verts, exist, starts, counts, ray_o, ray_d)), 16, 16, 3)
    expect = ([dup[1], 130, -1] if same else [dup[0], dup[1], 130])
    for layers, cnt in (got, want):
        layers, cnt = to_numpy(layers), to_numpy(cnt)
        np.testing.assert_array_equal(layers[0, 8, 8], expect)
        assert cnt[0, 8, 8] == (2 if same else 3)
    np.testing.assert_array_equal(to_numpy(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))


def test_num_layers_outside_the_kernel_instances_raises():
    """The kernel is instantiated for 1, 2, 4, 8 and 16 slots; a call asks
    for the smallest that covers it, and above 16 it raises."""
    assert [TP.peel_instance(n) for n in (1, 2, 3, 5, 8, 9, 16)] == \
        [1, 2, 4, 8, 8, 16, 16]
    with pytest.raises(ValueError, match="largest slot count"):
        TP.peel_instance(17)
    a, _ = _binned_scene()
    with pytest.raises(ValueError, match="num_layers"):
        TP.peel_layers(*_port_args(a), 0)
