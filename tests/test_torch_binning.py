"""Port tile binning and record pack vs the JAX package, bit for bit.

Both sides bin IDENTICAL numpy inputs (screen triangles, depths, cull mask,
window origins), so every output must be exactly equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops import binning as JB
from dmesh2_renderer_tpu.ops.reference import face_depth01
from dmesh2_renderer_tpu_torch.convert import scene_from_jax
from dmesh2_renderer_tpu_torch.ops import _kernels
from dmesh2_renderer_tpu_torch.ops import binning as TB
from dmesh2_renderer_tpu_torch.utils.profiling import counters, reset_counters
from tests._torch_port import scene_arrays, to_numpy

W, H, B = 48, 40, 2
PATCH_MIN = np.asarray([[0, 0], [5, 3]], np.int32)


@functools.lru_cache(maxsize=1)
def _inputs():
    s = scene_arrays(b=B)
    verts_ndc, verts_image = JG.compute_verts_ndc_image(
        jnp.asarray(s["verts"]), jnp.asarray(s["mv"]), jnp.asarray(s["proj"]), W, H)
    aa = JG.face_aa_triangles(verts_image, jnp.asarray(s["faces"])).verts
    depth01, _, _, alive = face_depth01(verts_ndc, jnp.asarray(s["faces"]))
    return s, np.array(verts_ndc), np.array(aa), np.array(depth01), np.array(alive)


# case -> (bin_faces keywords, whether entries are truncated)
CASES = {
    # bbox rects only, no giant tier, ample capacity
    "rect": (dict(capacity=2048, max_tiles_per_face=64, num_giant_faces=0), False),
    # exact cull + a giant tier that takes every face over Kt=2 tiles
    "cull_giant": (dict(capacity=2048, max_tiles_per_face=2, num_giant_faces=160,
                        giant_tiles=None, exact_tile_cull=True), False),
    # giant tier too small for the oversized faces, 3-tile giant rows
    "giant_overflow": (dict(capacity=2048, max_tiles_per_face=1,
                            num_giant_faces=8, giant_tiles=3), True),
    # capacity overflow: entries past the capacity are dropped and counted
    "capacity_overflow": (dict(capacity=100, max_tiles_per_face=4,
                               num_giant_faces=4, exact_tile_cull=True), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_faces_matches_jax_exactly(case):
    """CPU tensors take the plain emission grid (bin_emit does not launch),
    and the binning equals the JAX package's."""
    kw, truncates = CASES[case]
    _, _, aa, depth01, alive = _inputs()
    j = JB.bin_faces(jnp.asarray(aa), jnp.asarray(depth01), jnp.asarray(alive),
                     jnp.asarray(PATCH_MIN), W, H, **kw)
    reset_counters()
    t = TB.bin_faces(torch.as_tensor(aa), torch.as_tensor(depth01),
                     torch.as_tensor(alive), torch.as_tensor(PATCH_MIN), W, H, **kw)
    assert counters()["launches"]["bin_emit"] == 0
    for name in JB.Binning._fields:
        a, b = to_numpy(getattr(j, name)), to_numpy(getattr(t, name))
        assert b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (int(t.num_truncated) > 0) == truncates
    if kw["num_giant_faces"]:
        assert (to_numpy(t.giant_ids) < B * aa.shape[1]).any()


def test_bin_emit_is_a_counted_kernel():
    """The emission grid's kernel is built with the others (without FMA
    contraction, as its cull must round as the eager ops do) and its
    launches are counted; a CPU call launches nothing."""
    assert _kernels.BIN_EMIT in _kernels.KERNELS
    assert _kernels.BIN_EMIT in _kernels.COUNTED
    assert _kernels.BIN_EMIT.source.name == "bin_emit.cu"
    assert "-fmad=false" in _kernels.BIN_EMIT.flags
    _, _, aa, depth01, alive = _inputs()
    reset_counters()
    em = TB.emission_keys(torch.as_tensor(aa), torch.as_tensor(depth01),
                          torch.as_tensor(alive), torch.as_tensor(PATCH_MIN), W, H,
                          2048, 2, num_giant_faces=16, exact_tile_cull=True)
    assert em.keys.dtype == em.payload.dtype == torch.int32
    assert counters()["launches"]["bin_emit"] == 0


# The kernel path's argument checks, on the meta device (which runs every
# check but the last, that the tensors are on a CUDA device): case -> the
# argument changed, its wrong value, the error.
BAD_INPUTS = {
    "aa_dtype": ("aa", torch.float64, "aa_face_verts must be torch.float32"),
    "aa_shape": ("aa", (1, 4, 3, 3), r"aa_face_verts must have shape \(1, 4, 3, 2\)"),
    "depth_dtype": ("depth01", torch.float16, "depth01 must be torch.float32"),
    "alive_dtype": ("alive", torch.int32, "alive must be torch.bool"),
    "alive_shape": ("alive", (1, 5), r"alive must have shape \(1, 4\)"),
    "patch_min_dtype": ("patch_min", torch.int64, "patch_min must be torch.int32"),
    "not_cuda": (None, None, "kernels run on CUDA tensors"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_emission_keys_kernel_refuses_what_it_does_not_take(case):
    arg, bad, message = BAD_INPUTS[case]
    spec = dict(aa=((1, 4, 3, 2), torch.float32), depth01=((1, 4), torch.float32),
                alive=((1, 4), torch.bool), patch_min=((1, 2), torch.int32))
    if arg is not None:
        shape, dtype = spec[arg]
        spec[arg] = (bad, dtype) if isinstance(bad, tuple) else (shape, bad)
    t = {k: torch.empty(shape, dtype=dtype, device="meta") for k, (shape, dtype) in spec.items()}
    reset_counters()
    with pytest.raises(ValueError, match=message):
        TB.emission_keys(t["aa"], t["depth01"], t["alive"], t["patch_min"], 32, 32, 128,
                         2, num_giant_faces=2, exact_tile_cull=True)
    assert counters()["launches"]["bin_emit"] == 0


def test_face_tile_rects_matches_jax():
    _, _, aa, _, _ = _inputs()
    gx, gy = JB.tile_grid_size(W, H)
    j = JB.face_tile_rects(jnp.asarray(aa), jnp.asarray(PATCH_MIN), gx, gy)
    t = TB.face_tile_rects(torch.as_tensor(aa), torch.as_tensor(PATCH_MIN), gx, gy)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(to_numpy(b), to_numpy(a))


def test_record_pack_matches_jax_exactly():
    """The plain record pack equals unblock_stream(JAX gather_stream(...)):
    pure copies, sentinel entries included."""
    s, verts_ndc, aa, depth01, alive = _inputs()
    binning = JB.bin_faces(jnp.asarray(aa), jnp.asarray(depth01), jnp.asarray(alive),
                           jnp.asarray(PATCH_MIN), W, H, capacity=1024,
                           max_tiles_per_face=64)
    entry = np.array(binning.entry_bf)
    assert (entry == B * aa.shape[1]).any()      # sentinels present
    v9, c9, z = JB.gather_face_corners(
        jnp.asarray(s["verts"]), jnp.asarray(s["verts_color"]),
        jnp.asarray(verts_ndc), jnp.asarray(s["faces"]))
    table = JB.build_face_table_from_corners(
        v9, c9, z, jnp.asarray(s["faces_opacity"]), jnp.asarray(s["faces_intense"]),
        jnp.asarray(aa), interpret=True)
    want = np.asarray(JB.unblock_stream(JB.gather_stream(table, jnp.asarray(entry))))

    t = scene_from_jax({k: s[k] for k in ("verts", "faces", "verts_color",
                                          "faces_opacity", "faces_intense")}, "cpu")
    got = TB.pack_stream(torch.as_tensor(entry), t["faces"], t["verts"],
                         t["verts_color"], torch.as_tensor(verts_ndc),
                         t["faces_opacity"], t["faces_intense"], torch.as_tensor(aa))
    assert tuple(got.shape) == want.shape == (1024, 32)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_record_pack_sentinel_tail_reads_the_last_row():
    """Sentinel entries (== B*F) past the live ones are packed as row
    B*F - 1, as the JAX gather_stream reads them: every tail row equals the
    JAX gather of entry B*F - 1."""
    s, verts_ndc, aa, _, _ = _inputs()
    bf = B * aa.shape[1]
    entry = np.concatenate([np.arange(0, bf, 7, dtype=np.int32),
                            np.full(256, bf, np.int32)])
    entry = np.concatenate([entry, np.full((-entry.shape[0]) % 128, bf, np.int32)])
    v9, c9, z = JB.gather_face_corners(
        jnp.asarray(s["verts"]), jnp.asarray(s["verts_color"]),
        jnp.asarray(verts_ndc), jnp.asarray(s["faces"]))
    table = JB.build_face_table_from_corners(
        v9, c9, z, jnp.asarray(s["faces_opacity"]), jnp.asarray(s["faces_intense"]),
        jnp.asarray(aa), interpret=True)
    last = np.asarray(JB.unblock_stream(JB.gather_stream(
        table, jnp.full((128,), bf - 1, jnp.int32))))[0]
    t = scene_from_jax({k: s[k] for k in ("verts", "faces", "verts_color",
                                          "faces_opacity", "faces_intense")}, "cpu")
    got = to_numpy(TB.pack_stream_plain(
        torch.as_tensor(entry), t["faces"], t["verts"], t["verts_color"],
        torch.as_tensor(verts_ndc), t["faces_opacity"], t["faces_intense"],
        torch.as_tensor(aa)))
    tail = entry == bf
    assert tail.sum() >= 256 and got.shape == (entry.shape[0], 32)
    np.testing.assert_array_equal(got[tail], np.broadcast_to(last, (int(tail.sum()), 32)))
    assert np.any(last != 0)
