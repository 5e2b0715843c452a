"""The port's depth peel (ops/peel.py) and its scene utilities vs the JAX
package: tet_grid, check_layered_args, pack_peel_stream and the plain peel
against the JAX peel_layers (Pallas in interpret mode) on identical
streams, tile ranges and rays; the kernel's skip bound (mirrored in
ops/peel.py) on adversarial faces and rays, the plain peel with the
kernel's skip rule and insertion gate applied, and their work counts
against numpy; above 96 layers, on sheet stacks over several tiles, the
plain peel's count of filled slots and its prefix property, and the CPU
path of peel_layers."""

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
from dmesh2_renderer_tpu_torch import geometry as TG
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


# Two views from inside tet_grid(3): the first eye lies on the grid planes
# x = -0.4 and z = 0.4, so faces there are seen edge-on (their plane passes
# through the camera) and rays graze the planes next to them.
INSIDE_EYES = ((-0.4, 0.1, 0.4), (0.3, -0.2, -0.1))
INSIDE_TARGETS = ((1.0, 0.35, -0.9), (-1.0, 0.6, 0.5))


def _inside_cameras():
    mv = np.stack([JM.look_at(e, c) for e, c in zip(INSIDE_EYES, INSIDE_TARGETS)])
    proj = np.stack([JM.perspective(70.0, W / H)] * B)
    return mv, proj


@functools.lru_cache(maxsize=3)
def _binned_scene(inside=False, res=None):
    """tet_grid(2), a third of the faces deleted, two orbit views (or
    tet_grid(3) seen from inside, ``INSIDE_EYES``; or tet_grid(res) seen
    from inside, whose grid planes pass through the eyes for even res),
    binned by min depth as the peel pipeline does, on the JAX side. Returns
    numpy arrays and the JAX stream."""
    verts, _, faces, _, _ = JM.tet_grid(res or (3 if inside else 2))
    exist = np.ones(faces.shape[0], np.int32)
    exist[::3] = 0
    mv, proj = _inside_cameras() if inside else JM.orbit_cameras(B)
    ray_o, ray_d = JG.init_rays(jnp.asarray(mv), jnp.asarray(proj), W, H)
    vndc, vimg = JG.compute_verts_ndc_image(jnp.asarray(verts), jnp.asarray(mv),
                                            jnp.asarray(proj), W, H)
    tris = JG.face_aa_triangles(vimg, jnp.asarray(faces))
    _, min_depth, _, alive = face_depth01(vndc, jnp.asarray(faces))
    binning = jax_bin_faces(tris.verts, min_depth, alive,
                            jnp.zeros((B, 2), jnp.int32), W, H,
                            1 << 13 if res is None else 1 << 16, 64,
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


@functools.lru_cache(maxsize=8)
def _jax_peel(num_layers, inside=False, res=None):
    a, stream = _binned_scene(inside, res)
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


def _displaced_tie_scene():
    """One 16x16 tile of 260 entries in id order (blocks 0-127, 128-255,
    256-259): faces 5 and 130 share one vertex triple (t = 2.8 on the centre
    ray), face 257 lies nearer (t = 2.3). Numpy arrays in peel_layers'
    argument order, then the expected layers of the centre pixel."""
    f = 260
    tri = np.array([[-1.0, -1.0, 0.2], [1.0, -1.0, 0.2], [0.0, 1.0, 0.2]], np.float32)
    verts = np.tile(tri, (f, 1))
    verts[3 * 257:3 * 258] = tri + [0, 0, 0.5]
    faces = np.arange(3 * f, dtype=np.int32).reshape(f, 3)
    faces[130] = faces[5]
    exist = np.zeros(f, np.int32)
    exist[[5, 130, 257]] = 1
    entry_bf = np.full(384, f, np.int32)
    entry_bf[:f] = np.arange(f)
    ray_o = np.array([[0.0, 0.0, 3.0]], np.float32)
    ray_d = np.zeros((1, 16, 16, 3), np.float32)
    ray_d[..., 2] = -1.0
    return ((entry_bf, faces, verts, exist, np.array([0], np.int32),
             np.array([f], np.int32), ray_o, ray_d), [257, 130, 5])


@pytest.mark.parametrize("num_layers", [3, 17, 32])
def test_displaced_slot_passes_its_ties_as_in_jax(num_layers):
    """Blocks 0 and 1 leave the slots [5, 130] (a tie across blocks: the
    later after the earlier). Block 2 inserts the nearer 257: the slot it
    displaces, 5, is carried past 130, which it ties, so the layers are
    [257, 130, 5], as the JAX kernel gives (a stable merge would give
    [257, 5, 130]); in the register (L = 3) and the wide (L > 16) range."""
    args, expect = _displaced_tie_scene()
    entry_bf, faces, verts, exist, starts, counts, ray_o, ray_d = args
    want = JP.peel_layers(
        JP.pack_peel_stream(jnp.asarray(entry_bf), jnp.asarray(verts),
                            jnp.asarray(faces), jnp.asarray(exist)),
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(ray_o),
        jnp.asarray(ray_d), 16, 16, 3, interpret=True)
    np.testing.assert_array_equal(np.asarray(want[0])[0, 8, 8], expect)
    got = TP.peel_layers(*(torch.as_tensor(x) for x in args), 16, 16, num_layers)
    assert to_numpy(got[0])[0, 8, 8].tolist() == expect + [-1] * (num_layers - 3)
    np.testing.assert_array_equal(to_numpy(got[0])[..., :3], np.asarray(want[0]))
    np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))


def test_num_layers_outside_the_kernel_instances_raises():
    """The kernel's register instances have 1, 2, 4, 8 and 16 slots; a call
    asks for the smallest that covers it. Above 16 a call runs with exactly
    L slots: the wide instance up to MAX_WIDE_LAYERS, the deep one above, so
    every L >= 1 has an instance; only L < 1 raises, on the CPU too."""
    assert [TP.peel_instance(n) for n in (1, 2, 3, 5, 8, 9, 16)] == \
        [1, 2, 4, 8, 8, 16, 16]
    assert [TP.peel_instance(n) for n in (17, 96, 97, 200)] == [17, 96, 97, 200]
    assert TP.MAX_WIDE_LAYERS == 96
    with pytest.raises(ValueError, match="num_layers must be >= 1"):
        TP.peel_instance(0)
    a, _ = _binned_scene()
    with pytest.raises(ValueError, match="num_layers"):
        TP.peel_layers(*_port_args(a), 0)


def test_wide_instance_counts_its_launches_apart():
    """peel.cu's wide instance has a launch count of its own, beside the
    register instances', as has its deep instance; the two are one body
    built with two pairs of tiers, launched through one C function (apart
    from the register instances') that picks them by the slot count; a
    failed launch raises under its own name."""
    from dmesh2_renderer_tpu_torch.ops import _kernels

    assert _kernels.PEEL_WIDE.source == _kernels.PEEL.source
    assert _kernels.PEEL_DEEP.source == _kernels.PEEL.source
    assert _kernels.PEEL_WIDE.launch == _kernels.PEEL_DEEP.launch == "peel_tiered_launch"
    assert _kernels.PEEL_WIDE.argtypes == _kernels.PEEL_DEEP.argtypes
    assert _kernels.COUNTED == _kernels.KERNELS + (_kernels.PEEL_WIDE,
                                                   _kernels.PEEL_DEEP)
    before = (_kernels.PEEL.launches, _kernels.PEEL_WIDE.launches)
    _kernels.PEEL_WIDE.launched(0)
    assert (_kernels.PEEL.launches, _kernels.PEEL_WIDE.launches) == \
        (before[0], before[1] + 1)

    class Lib:
        @staticmethod
        def cuda_error_string(err):
            return b"invalid argument"

    saved = _kernels.PEEL._lib
    _kernels.PEEL._lib = Lib()
    try:
        with pytest.raises(RuntimeError, match="peel_wide kernel launch failed"):
            _kernels.PEEL_WIDE.launched(1)
    finally:
        _kernels.PEEL._lib = saved
        _kernels.PEEL_WIDE.launches = before[1]
    assert _kernels.PEEL_WIDE.launches == before[1]


# tet_grid(6) from inside: up to 20 hits per ray, so L > 16 is filled.
DENSE = dict(inside=True, res=6)


@pytest.mark.parametrize("num_layers", [17, 32])
def test_plain_peel_beyond_16_layers_matches_jax(num_layers):
    """The plain peel above 16 layers, on a scene whose rays hit more than
    16 faces. The JAX peel_layers in interpret mode unrolls its slot merge
    L x L: XLA compiles it in seconds at L = 16 but did not finish within
    20 minutes at L = 32 on a CPU. So it is run at L = 16 and the first 16
    layers are held against it (the carried top-L
    is a prefix of the top-L' for L < L', the rule both packages and the
    kernel keep); every layer is held against an independent numpy merge of
    the JAX rule (:func:`_numpy_peel`), which itself equals the JAX kernel
    at L = 16. The pruned plain version gives the same."""
    a, _ = _binned_scene(**DENSE)
    want_l16, want_c16 = _jax_peel(16, **DENSE)
    _, np_l16, np_c16 = _numpy_peel(a, 16)
    np.testing.assert_array_equal(np_l16, want_l16)
    np.testing.assert_array_equal(np_c16, want_c16)
    _, np_l, np_c = _numpy_peel(a, num_layers)
    for prune in (False, True):
        layers, counts = TP.peel_layers_plain(*_port_args(a), num_layers,
                                              prune=prune)
        assert tuple(layers.shape) == (B, H, W, num_layers)
        np.testing.assert_array_equal(to_numpy(layers), np_l)
        np.testing.assert_array_equal(to_numpy(counts), np_c)
        np.testing.assert_array_equal(to_numpy(layers)[..., :16], want_l16)
        np.testing.assert_array_equal(np.minimum(to_numpy(counts), 16), want_c16)
    # 230 pixels hit more than 16 faces, up to 20
    assert int((np_c > 16).sum()) > 200 and np_c.max() == min(num_layers, 20)


# ---------------------------------------------------------------------------
# The kernel's skip bound (csrc/peel.cu, mirrored in ops/peel.py).

def _adversarial_pairs(case, n=400, seed=0):
    """Faces (n, 3, 3), one ray origin and n rays, ray i aimed at a point
    of face i, made with numpy from ``seed`` (float32):

    * ``plane_through_camera``: each face's plane passes within 10^-9..10^-3
      of the origin, so the rays aimed at it are nearly in its plane;
    * ``grazing``: planes at 10^-6..1 from the origin with the faces 5..50
      away along them, so the rays meet them at small angles;
    * ``slivers``: the third vertex 10^-8..10^-2 (relative) off the line of
      the other two;
    * ``random``: faces and aim points scattered in front of the origin.

    Rays are normalised as ``init_rays`` does (``d / (|d| + 1e-6)``).
    """
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 1.0, 3)

    def basis():
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        p = np.cross(nrm, rng.normal(size=(n, 3)))
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        return nrm, p, np.cross(nrm, p)

    if case in ("plane_through_camera", "grazing"):
        nrm, p, q = basis()
        if case == "plane_through_camera":
            h = 10.0 ** rng.uniform(-9, -3, (n, 1)) * rng.choice([-1, 1], (n, 1))
            xy = rng.uniform(-3.0, 3.0, (n, 3, 2))
        else:
            h = 10.0 ** rng.uniform(-6, 0, (n, 1))
            xy = rng.uniform(5.0, 50.0, (n, 1, 2)) + rng.uniform(-2.0, 2.0, (n, 3, 2))
        tri = (o + h * nrm)[:, None, :] + xy[..., :1] * p[:, None] + xy[..., 1:] * q[:, None]
    elif case == "slivers":
        nrm, p, _ = basis()
        v0 = o + rng.uniform(1.0, 5.0, (n, 1)) * nrm
        v1 = v0 + rng.uniform(0.1, 2.0, (n, 1)) * p
        eps = 10.0 ** rng.uniform(-8, -2, (n, 1))
        v2 = v0 + rng.uniform(-1.0, 2.0, (n, 1)) * (v1 - v0) + eps * np.cross(nrm, p)
        tri = np.stack([v0, v1, v2], 1)
    else:
        tri = o + rng.uniform(-2.0, 2.0, (n, 1, 3)) + rng.normal(scale=0.5, size=(n, 3, 3))
    bary = rng.dirichlet([1.0, 1.0, 1.0], n)
    aim = (bary[:, :, None] * tri).sum(1) + rng.normal(scale=1e-4, size=(n, 3))
    d = (aim - o).astype(np.float32)
    d = d / (np.linalg.norm(d, axis=1, keepdims=True) + np.float32(1e-6))
    return tri.astype(np.float32), o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("case", ["plane_through_camera", "grazing", "slivers",
                                  "random"])
def test_skip_bound_holds_for_every_hit(case):
    """Every (face, ray) pair, with the kernel's float32 arithmetic in its
    operation order: every hit has t >= skip_bound (lb). The rays aimed at
    their own faces give many hits, grazing ones and ones through faces
    seen edge-on among them; the bound is not vacuous where the geometry
    allows it."""
    tri, o, d = (torch.as_tensor(x) for x in _adversarial_pairs(case))
    v0, v1, v2 = tri[:, 0, :, None], tri[:, 1, :, None], tri[:, 2, :, None]
    e1x, e1y, e1z = (v1 - v0).unbind(1)                       # (F, 1) each
    e2x, e2y, e2z = (v2 - v0).unbind(1)
    t0x, t0y, t0z = (o[:, None] - v0).unbind(1)
    qvx = t0y * e1z - t0z * e1y
    qvy = t0z * e1x - t0x * e1z
    qvz = t0x * e1y - t0y * e1x
    qe2 = qvx * e2x + qvy * e2y + qvz * e2z
    lb = TP.skip_bound(e1x, e1y, e1z, e2x, e2y, e2z, qe2)
    rdx, rdy, rdz = d[None, :, 0], d[None, :, 1], d[None, :, 2]  # (1, N)
    assert bool((rdx * rdx + rdy * rdy + rdz * rdz <= TP.RAY_NORM2_MAX).all())
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    denom = pvx * e1x + pvy * e1y + pvz * e1z
    ok = denom != 0.0
    inv = 1.0 / torch.where(ok, denom, torch.ones_like(denom))
    tt = qe2 * inv
    u = (pvx * t0x + pvy * t0y + pvz * t0z) * inv
    v = (qvx * rdx + qvy * rdy + qvz * rdz) * inv
    hit = ok & (tt >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt < 3.0e38)
    lbb = lb.expand_as(tt)
    n = tri.shape[0]
    assert int(hit.diagonal().sum()) > n // 10
    assert bool((tt[hit] >= lbb[hit]).all()), float((lbb[hit] - tt[hit]).max())
    if case == "random":
        # the bound reaches most of t for some hit: it is not vacuous (for
        # grazing rays it is the plane's distance, far below t)
        assert float((lbb[hit] / tt[hit]).max()) > 0.5


@pytest.mark.parametrize("inside", [False, True], ids=["orbit", "inside"])
@pytest.mark.parametrize("num_layers", [1, 3, 8])
def test_pruned_plain_peel_matches_full_scan_and_jax(num_layers, inside):
    """The plain peel with the kernel's skip rule and insertion gate applied
    gives exactly the layers and counts of the full scan and of the JAX
    peel_layers (interpret mode): orbit views of tet_grid(2), and tet_grid(3)
    seen from inside with faces edge-on to the camera."""
    a, _ = _binned_scene(inside)
    want_l, want_c = _jax_peel(num_layers, inside)
    work = {}
    full = TP.peel_layers_plain(*_port_args(a), num_layers)
    pruned = TP.peel_layers_plain(*_port_args(a), num_layers, work=work, prune=True)
    for got in (full, pruned):
        np.testing.assert_array_equal(to_numpy(got[0]), want_l)
        np.testing.assert_array_equal(to_numpy(got[1]), want_c)
    assert want_c.max() >= min(num_layers, 3)
    if num_layers < 8:
        assert int(work["skipped"]) > 0 and int(work["gated"]) > 0


def _numpy_work_counts(a, num_layers):
    """An independent count of the pairs csrc/peel.cu skips and of the hits
    its insertion gate keeps out: numpy float32 arithmetic in the kernel's
    order, each pixel's slots kept by a Python merge of each 128-entry
    block's hits."""
    return _numpy_peel(a, num_layers)[0]


def _numpy_peel(a, num_layers, frame=(W, H)):
    """The peel in numpy and Python, independent of both packages' code:
    float32 arithmetic in the kernel's order, each pixel's slots kept by a
    Python merge of each 128-entry block's hits (its distinct t, the larger
    id on a tie, each carried into the slots by the JAX kernel's swap rule,
    under which a displaced slot passes the slots equal to it). Returns (work
    counts as in :func:`_numpy_work_counts`, layers (B, H, W, L), counts
    (B, H, W)) of the ``frame`` (width, height)."""
    f32 = np.float32
    W, H = frame
    faces, verts, exist = a["faces"], a["verts"], a["exist"]
    starts, counts, entry = a["starts"], a["counts"], a["entry_bf"]
    gx, gy = -(-W // 16), -(-H // 16)
    out = dict(pairs=0, hits=0, skipped=0, gated=0)
    inf = f32(3.0e38)
    n_views = a["ray_d"].shape[0]
    layers = np.full((n_views, H, W, num_layers), -1, np.int32)
    n_hit = np.zeros((n_views, H, W), np.int32)

    for tile in range(starts.shape[0]):
        b, rem = divmod(tile, gx * gy)
        ty, tx = divmod(rem, gx)
        ys, xs = np.meshgrid(np.arange(16) + 16 * ty, np.arange(16) + 16 * tx,
                             indexing="ij")
        inside = (xs < W) & (ys < H)
        rd = a["ray_d"][b][ys[inside], xs[inside]]                  # (N, 3)
        bounded = (rd[:, 0] * rd[:, 0] + rd[:, 1] * rd[:, 1]
                   + rd[:, 2] * rd[:, 2]) <= f32(1.0 + 2.0 ** -20)
        slots = [[(inf, -1)] * num_layers for _ in range(rd.shape[0])]
        s0, s1 = int(starts[tile]), int(starts[tile]) + int(counts[tile])
        for base in range(s0 // 128 * 128, s1, 128):
            rows = np.arange(max(base, s0), min(base + 128, s1))
            f = entry[rows] % faces.shape[0]
            f = f[exist[f] > 0]
            if f.size == 0:
                continue
            v = verts[faces[f]]
            e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
            t0 = a["ray_o"][b] - v[:, 0]
            qv = np.stack([t0[:, 1] * e1[:, 2] - t0[:, 2] * e1[:, 1],
                           t0[:, 2] * e1[:, 0] - t0[:, 0] * e1[:, 2],
                           t0[:, 0] * e1[:, 1] - t0[:, 1] * e1[:, 0]], 1)
            qe2 = qv[:, 0] * e2[:, 0] + qv[:, 1] * e2[:, 1] + qv[:, 2] * e2[:, 2]
            n1 = np.sqrt(e1[:, 0] * e1[:, 0] + e1[:, 1] * e1[:, 1] + e1[:, 2] * e1[:, 2])
            n2 = np.sqrt(e2[:, 0] * e2[:, 0] + e2[:, 1] * e2[:, 1] + e2[:, 2] * e2[:, 2])
            nv = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                           e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                           e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
            nn = np.fmax(np.sqrt(nv[:, 0] * nv[:, 0] + nv[:, 1] * nv[:, 1]
                                 + nv[:, 2] * nv[:, 2]), f32(2.0 ** -49))
            lb = np.abs(qe2) / (nn + n1 * n2 * f32(2.0 ** -20)) * f32(1.0 - 2.0 ** -18)
            lb = np.fmin(np.where(lb < f32(2.0 ** -100), f32(0), lb), inf)
            sane = (n1 >= 2.0 ** -40) & (n1 <= 2.0 ** 40) & (n2 >= 2.0 ** -40) & (n2 <= 2.0 ** 40)
            lb = np.where(sane, lb, f32(0))
            for i, d in enumerate(rd):
                pv = np.stack([d[1] * e2[:, 2] - d[2] * e2[:, 1],
                               d[2] * e2[:, 0] - d[0] * e2[:, 2],
                               d[0] * e2[:, 1] - d[1] * e2[:, 0]], 1)
                den = pv[:, 0] * e1[:, 0] + pv[:, 1] * e1[:, 1] + pv[:, 2] * e1[:, 2]
                un = pv[:, 0] * t0[:, 0] + pv[:, 1] * t0[:, 1] + pv[:, 2] * t0[:, 2]
                vn = qv[:, 0] * d[0] + qv[:, 1] * d[1] + qv[:, 2] * d[2]
                ok = den != 0
                with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                    inv = f32(1.0) / np.where(ok, den, f32(1.0))
                tt, u, vv = qe2 * inv, un * inv, vn * inv
                hit = ok & (tt >= 0) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt < inf)
                thr = slots[i][-1][0] if bounded[i] else np.inf
                skip = thr <= lb
                out["pairs"] += f.size
                out["hits"] += int(hit.sum())
                out["skipped"] += int(skip.sum())
                out["gated"] += int((hit & ~skip & (tt >= thr)).sum())
                # the block's distinct t (the larger id on a tie), each
                # carried into the L slots: it swaps with the first slot it
                # is strictly below, which is carried on the same way
                best = {}
                for t, fid in zip(tt[hit], f[hit]):
                    best[t] = max(best.get(t, -1), int(fid))
                for t in sorted(best)[:num_layers]:
                    carry = (t, best[t])
                    for k in range(num_layers):
                        if carry[0] < slots[i][k][0]:
                            slots[i][k], carry = carry, slots[i][k]
        for (y, x), s in zip(zip(ys[inside], xs[inside]), slots):
            ids = [fid for t, fid in s if t < inf]
            layers[b, y, x, :len(ids)] = ids
            n_hit[b, y, x] = len(ids)
    return out, layers, n_hit


@pytest.mark.parametrize("inside,num_layers", [(False, 1), (False, 3), (True, 2)],
                         ids=["orbit-L1", "orbit-L3", "inside-L2"])
def test_plain_peel_work_counts_match_numpy(inside, num_layers):
    """The plain peel's ``work`` counts of skipped pairs and gated hits (and
    of pairs and hits) equal an independent numpy count."""
    a, _ = _binned_scene(inside)
    work = {}
    TP.peel_layers_plain(*_port_args(a), num_layers, work=work)
    want = _numpy_work_counts(a, num_layers)
    assert {k: int(work[k]) for k in want} == want
    assert want["skipped"] > 0 and want["gated"] > 0


# ---------------------------------------------------------------------------
# Above MAX_WIDE_LAYERS: the sheet stack, more than 128 hits on every ray.

@functools.lru_cache(maxsize=1)
def _sheet_stack():
    """utils/meshes.sheet_stack (150 sheets; sheets 20, 62 and 125 listed
    twice) on one 16x16 tile, its 306 faces listed nearest first in id
    order, seen from (0, 0, 3) down -z with a 60 degree field of view: 153
    distinct hits on every ray. Returns (numpy arrays, the JAX peel at 16
    layers)."""
    verts, faces = TM.sheet_stack()
    f = faces.shape[0]
    entry_bf = np.full(384, f, np.int32)
    entry_bf[:f] = np.arange(f)
    mv = JM.look_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0))[None]
    proj = JM.perspective(60.0, 1.0)[None]
    ray_o, ray_d = JG.init_rays(jnp.asarray(mv), jnp.asarray(proj), 16, 16)
    a = dict(entry_bf=entry_bf, verts=verts, faces=faces,
             exist=np.ones(f, np.int32), starts=np.array([0], np.int32),
             counts=np.array([f], np.int32), ray_o=np.array(ray_o[:, 0, 0, :]),
             ray_d=np.array(ray_d))
    stream = JP.pack_peel_stream(*(jnp.asarray(a[k]) for k in (
        "entry_bf", "verts", "faces", "exist")))
    want = JP.peel_layers(stream, jnp.asarray(a["starts"]), jnp.asarray(a["counts"]),
                          jnp.asarray(a["ray_o"]), jnp.asarray(a["ray_d"]), 16, 16,
                          16, interpret=True)
    return a, (np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize("num_layers", [17, 32, 96, 100, 128])
def test_plain_peel_beyond_96_layers_on_a_sheet_stack(num_layers):
    """The plain peel at L = 17, 32 and 96 (the wide instance's range on the
    card) and 100 and 128 (the deep instance's) equals the numpy merge of
    the JAX rule on every pixel and, in its first 16 layers, the JAX kernel
    at 16 (the prefix property); counts reach L. Exact ties across blocks
    keep both copies, the earlier block's first (sheet 62: entries 126-127
    and 128-129, layers 62 and 63); a tie inside a block keeps one, the
    larger id (sheet 20: entries 40-43, layer 20)."""
    a, (want_l16, want_c16) = _sheet_stack()
    _, np_l, np_c = _numpy_peel(a, num_layers, frame=(16, 16))
    args = (*(torch.as_tensor(a[k]) for k in (
        "entry_bf", "faces", "verts", "exist", "starts", "counts", "ray_o",
        "ray_d")), 16, 16)
    layers, counts = TP.peel_layers(*args, num_layers)
    np.testing.assert_array_equal(to_numpy(layers), np_l)
    np.testing.assert_array_equal(to_numpy(counts), np_c)
    np.testing.assert_array_equal(to_numpy(layers)[..., :16], want_l16)
    np.testing.assert_array_equal(np.minimum(to_numpy(counts), 16), want_c16)
    assert (np_c == num_layers).all()
    # pixel (3, 11) lies off both quad diagonals: one triangle per sheet
    sheet = a["faces"][np_l[0, 3, 11], 0] // 4
    assert (np.diff(sheet) >= 0).all()
    assert int((sheet == 20).sum()) == (num_layers > 20)
    assert int((sheet == 62).sum()) == (2 if num_layers > 63 else 0)
    if num_layers > 63:
        ids = np_l[0, 3, 11][sheet == 62]
        assert ids[1] == ids[0] + 2 and ids[0] in (126, 127)


# ---------------------------------------------------------------------------
# Above 16 layers on several tiles: the contract the tiered instances' filled
# count per pixel and their store walk rely on.

DEEP_FRAME = 32


def _sheet_tiles(half_size):
    """utils/meshes.sheet_stack of ``half_size`` seen from (0, 0, 3) down -z
    (a 60 degree field of view) through a DEEP_FRAME^2 window: each of its
    four tiles lists every face in id order, nearest first, the tiles one
    after another in the stream, so the 128-entry blocks (at absolute
    offsets) straddle the tiles. Returns the port's peel arguments less
    num_layers (CPU tensors) and the faces."""
    verts, faces = TM.sheet_stack(half_size=half_size)
    f = faces.shape[0]
    n_tiles = (DEEP_FRAME // 16) ** 2
    mv = TM.look_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0))[None]
    proj = TM.perspective(60.0, 1.0)[None]
    ray_o, ray_d = TG.init_rays(torch.as_tensor(mv), torch.as_tensor(proj),
                                DEEP_FRAME, DEEP_FRAME)
    args = (np.tile(np.arange(f, dtype=np.int32), n_tiles), faces, verts,
            np.ones(f, np.int32), np.arange(n_tiles, dtype=np.int32) * f,
            np.full(n_tiles, f, np.int32))
    return (*(torch.as_tensor(x) for x in args), ray_o[:, 0, 0, :].contiguous(),
            ray_d.contiguous(), DEEP_FRAME, DEEP_FRAME), faces


TIERED_LAYERS = (17, 32, 96, 97, 128)


@pytest.fixture(scope="module")
def deep_peels():
    """The plain peel at 17, 32 and 96 layers (the wide instance's range on
    the card) and 97 and 128 (the deep instance's), once per module, on the
    sheet stack (half size 5: every ray crosses all 150 sheets, 153 hits)
    and on smaller sheets (half size 1, whose edges cross the frame: counts
    vary across pixels). {(scene, L): (args, faces, layers, counts)}."""
    out = {}
    for scene, half_size in (("stack", 5.0), ("edges", 1.0)):
        args, faces = _sheet_tiles(half_size)
        for num_layers in TIERED_LAYERS:
            out[scene, num_layers] = (args, faces,
                                      *TP.peel_layers_plain(*args, num_layers))
    return out


@pytest.mark.parametrize("scene", ["stack", "edges"])
@pytest.mark.parametrize("num_layers", TIERED_LAYERS)
def test_plain_peel_counts_its_filled_slots_beyond_96_layers(deep_peels, scene,
                                                             num_layers):
    """The plain peel's contract, which the kernel's count of filled slots
    per pixel keeps: the count is the number of ids >= 0, the ids before it
    are >= 0 and every id past it is -1."""
    _, _, layers, counts = deep_peels[scene, num_layers]
    lay, cnt = to_numpy(layers), to_numpy(counts)
    filled = np.arange(num_layers) < cnt[..., None]
    np.testing.assert_array_equal(cnt, (lay >= 0).sum(-1))
    assert (lay[filled] >= 0).all() and (lay[~filled] == -1).all()
    if scene == "stack":
        assert (cnt == num_layers).all()
    else:
        # counts on both sides of any shared-memory tier a kernel may keep
        assert cnt.min() == 0 and cnt.max() == num_layers
        assert len(np.unique(cnt)) > min(20, num_layers // 4)
        assert ((cnt > 0) & (cnt < num_layers // 2)).any()


@pytest.mark.parametrize("scene", ["stack", "edges"])
def test_plain_peel_at_97_layers_is_a_prefix_of_128(deep_peels, scene):
    """The first 97 layers at L = 128 are the layers at L = 97, and the
    counts the counts capped at 97, also where exact t ties lie across
    128-entry blocks: the copies of sheet 62 (entries 126-129 of the first
    tile, across the block at 128) stay both, adjacent, in the first
    tile."""
    _, faces, l97, c97 = deep_peels[scene, 97]
    _, _, l128, c128 = deep_peels[scene, 128]
    np.testing.assert_array_equal(to_numpy(l128)[..., :97], to_numpy(l97))
    np.testing.assert_array_equal(np.minimum(to_numpy(c128), 97), to_numpy(c97))
    if scene == "stack":
        first = to_numpy(l128)[0, :16, :16].reshape(256, 128)
        sheet = faces[first, 0] // 4
        pair = (sheet == 62).sum(-1) == 2
        assert pair.any()
        at = np.argmax(sheet[pair] == 62, axis=-1)
        ids = first[pair][np.arange(int(pair.sum())), at]
        assert (first[pair][np.arange(int(pair.sum())), at + 1] == ids + 2).all()


def test_deep_peel_on_cpu_tensors_takes_the_plain_version(deep_peels):
    """peel_layers on CPU tensors at L = 32 and 128 (the wide and the deep
    instance's ranges on the card) returns the plain version's output and
    neither builds, loads nor launches a kernel."""
    from dmesh2_renderer_tpu_torch.ops import _kernels

    for num_layers in (32, 128):
        args, _, want_l, want_c = deep_peels["edges", num_layers]
        before = {k.name: k.launches for k in _kernels.COUNTED}
        layers, counts = TP.peel_layers(*args, num_layers)
        assert {k.name: k.launches for k in _kernels.COUNTED} == before
        assert _kernels.PEEL._lib is None
        assert torch.equal(layers, want_l) and torch.equal(counts, want_c)


@pytest.mark.parametrize("scene", ["stack", "edges"])
@pytest.mark.parametrize("short,long", [(17, 32), (32, 96), (96, 97)])
def test_plain_peel_prefix_across_the_wide_range(deep_peels, scene, short, long):
    """The prefix property inside the wide instance's range and across its
    switch to the deep instance (96 to 97 layers): the first ``short``
    layers at ``long`` are the layers at ``short``, the counts the counts
    capped at ``short``."""
    _, _, l_short, c_short = deep_peels[scene, short]
    _, _, l_long, c_long = deep_peels[scene, long]
    np.testing.assert_array_equal(to_numpy(l_long)[..., :short], to_numpy(l_short))
    np.testing.assert_array_equal(np.minimum(to_numpy(c_long), short), to_numpy(c_short))
    assert int((to_numpy(c_long) > short).sum()) > 0
