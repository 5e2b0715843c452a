"""The backward's gradient reduction (``reduce_entry_grads``) and the AA
corners' backward (``geometry.face_aa_verts_ccw``) against the plain
reductions and the JAX package.

The reduction's inputs are real tile arrays and entry ids from the port's
``bin_faces`` on icosphere(1) (shared vertices), two views through ragged
48x40 windows, one at patch origin (5, 3): with a giant tier, with a
capacity that truncates, and with a sentinel tail. The records are random,
each tile's contributing cut (``nc_tile``) random in and past its range,
one sentinel entry is planted inside a prefix, and every row outside the
prefixes holds NaN: no such row may reach an output, as on the card, where
the backward's table is left uninitialised there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops.pallas_bwd import scatter_entry_grads as jax_scatter
from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.ops import _kernels
from dmesh2_renderer_tpu_torch.ops import binning as TB
from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
    reduce_entry_grads, reduce_entry_grads_plain, scatter_entry_grads,
)
from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
from dmesh2_renderer_tpu_torch.utils.profiling import counters, reset_counters
from tests._torch_port import scene_arrays, to_numpy

W, H, B = 48, 40, 2
PATCH_MIN = torch.tensor([[0, 0], [5, 3]], dtype=torch.int32)

# case -> bin_faces keywords
CASES = {
    "rect": dict(capacity=2048, max_tiles_per_face=64, num_giant_faces=0),
    "cull_giant": dict(capacity=2048, max_tiles_per_face=2, num_giant_faces=160,
                       exact_tile_cull=True),
    "capacity_overflow": dict(capacity=100, max_tiles_per_face=4, num_giant_faces=4,
                              exact_tile_cull=True),
}


@functools.lru_cache(maxsize=1)
def _scene():
    s = scene_arrays(b=B)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    faces = t["faces"].to(torch.int32)
    ndc, image = G.compute_verts_ndc_image(t["verts"], t["mv"], t["proj"], W, H)
    aa = G.face_aa_verts_ccw(image, faces)
    depth01, _, _, alive = face_depth01(ndc, faces)
    return faces, aa, depth01, alive, t["verts"].shape[0]


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """(records, entry_bf, starts, counts, nc_tile, faces, n_verts) and the
    (R,) mask of the contributing prefixes."""
    faces, aa, depth01, alive, n_verts = _scene()
    bn = TB.bin_faces(aa, depth01, alive, PATCH_MIN, W, H, **CASES[case])
    rng = np.random.default_rng(sorted(CASES).index(case))
    counts = bn.tile_counts.numpy()
    nc = rng.integers(-1, counts + 4).astype(np.int32)
    nc[::5] = counts[::5]                          # whole ranges too
    nc_tile = torch.as_tensor(nc)
    r = bn.entry_bf.shape[0]
    keep, _ = TB.contributing_mask(bn.tile_starts, bn.tile_counts, nc_tile, r)
    entry = bn.entry_bf.clone()
    rows = keep.nonzero().squeeze(1)
    entry[rows[len(rows) // 2]] = B * faces.shape[0]   # a sentinel in a prefix
    rec = torch.as_tensor(rng.normal(size=(r, 32)).astype(np.float32))
    rec[~keep] = float("nan")
    return (rec, entry, bn.tile_starts, bn.tile_counts, nc_tile, faces, n_verts), keep


def _scale(w):
    return max(float(np.abs(w).max()), 1.0)


def test_cases_cover_what_the_reduction_must_skip():
    """Every case has rows past a cut prefix and a sentinel in a prefix; the
    truncating case drops entries; the giant case bins giant rows; the
    others end in a sentinel tail."""
    faces, aa, depth01, alive, _ = _scene()
    for case, kw in CASES.items():
        (_, entry, starts, counts, nc, _, _), keep = _inputs(case)
        bf = B * faces.shape[0]
        assert ((nc >= 0) & (nc < counts)).any(), case
        assert (keep & (entry == bf)).sum() == 1, case
        bn = TB.bin_faces(aa, depth01, alive, PATCH_MIN, W, H, **kw)
        if case == "capacity_overflow":
            assert int(bn.num_truncated) > 0
        else:
            assert (entry[int(counts.sum()):] == bf).all() and int(counts.sum()) < len(entry)
        if kw["num_giant_faces"] > 100:
            assert (bn.giant_ids < bf).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_reduction_matches_scatter_entry_grads(case):
    """On CPU tensors the wrapper takes the plain version, which equals
    contributing_mask + scatter_entry_grads (the same index_add_ sums in the
    same row order; rows outside the prefixes go to a dropped row, not
    through a compaction), with no host sync and no launch."""
    args, keep = _inputs(case)
    rec, entry, _, _, _, faces, n_verts = args
    reset_counters()
    got = reduce_entry_grads(*args[:6], n_verts, B)
    assert counters()["syncs"] == {}
    assert counters()["launches"]["grad_reduce"] == 0
    for g, p in zip(got, reduce_entry_grads_plain(*args[:6], n_verts, B)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    want = list(scatter_entry_grads(rec, entry, faces, n_verts, B, keep))
    d_vndc = torch.zeros((B, n_verts, 3))
    d_vndc[..., 2] = want[3]
    want[3] = d_vndc
    f = faces.shape[0]
    shapes = [(n_verts, 3), (n_verts, 3), (f,), (B, n_verts, 3), (B, f), (B, f, 3, 2)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        assert torch.isfinite(g).all()
        w = to_numpy(w)
        np.testing.assert_allclose(to_numpy(g), w, rtol=1e-6, atol=1e-6 * _scale(w))
        assert np.abs(w).max() > 0.1


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_reduction_matches_jax(case):
    """Against the JAX package's sort + segmented-scan reduction, given the
    contributing mask and the records with zeros outside the prefixes: sums
    reassociate only, 2e-6 relative (the JAX package's own tolerance)."""
    args, keep = _inputs(case)
    rec, entry, _, _, _, faces, n_verts = args
    got = reduce_entry_grads(*args[:6], n_verts, B)
    zeroed = torch.where(keep[:, None], rec, 0.0)
    want = jax_scatter(jnp.asarray(to_numpy(zeroed)), jnp.asarray(to_numpy(entry)),
                       jnp.asarray(to_numpy(faces)), n_verts, B,
                       keep=jnp.asarray(to_numpy(keep)))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = to_numpy(g), np.asarray(w)
        if i == 3:                                  # d_verts_ndc: z alone
            assert not g[..., :2].any()
            g = g[..., 2]
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6 * _scale(w))


def _corner_inputs(dtype=torch.float32, seed=0):
    """Screen vertices of icosphere(1) (each shared by 5-6 faces) for two
    views, scattered so that about half the faces are clockwise."""
    s = scene_arrays(b=B)
    rng = np.random.default_rng(seed)
    p = s["verts"].shape[0]
    image = torch.as_tensor(rng.uniform(0, 48, size=(B, p, 2)), dtype=dtype)
    faces = torch.as_tensor(s["faces"]).to(torch.int32)
    g = torch.as_tensor(rng.normal(size=(B, faces.shape[0], 3, 2)), dtype=dtype)
    return image, faces, g


def test_face_aa_verts_forward_is_the_plain_gather():
    image, faces, _ = _corner_inputs()
    _, neg = G._face_aa_verts_impl(image, faces)
    assert 0.25 < float(neg.float().mean()) < 0.75
    got = G.face_aa_verts_ccw(image.requires_grad_(True), faces)
    torch.testing.assert_close(got.detach(), G._face_aa_verts_impl(image, faces)[0],
                               rtol=0, atol=0)
    np.testing.assert_array_equal(
        to_numpy(got), np.asarray(JG.face_aa_verts_ccw(jnp.asarray(to_numpy(image)),
                                                       jnp.asarray(to_numpy(faces)))))


def test_face_aa_verts_backward_gradcheck():
    image, faces, _ = _corner_inputs(torch.float64)
    image.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: G.face_aa_verts_ccw(x, faces), (image,))


def test_face_aa_verts_backward_matches_autograd_and_jax():
    """The un-swap and the sum onto shared vertices against autograd of the
    plain gather and against the JAX package's hand-written VJP: float32
    sums of 5-6 terms in other orders."""
    image, faces, g = _corner_inputs(seed=1)
    x = image.clone().requires_grad_(True)
    reset_counters()
    (got,) = torch.autograd.grad(G.face_aa_verts_ccw(x, faces), x, g)
    assert counters()["launches"]["corner_reduce"] == 0
    (want,) = torch.autograd.grad(G._face_aa_verts_impl(x, faces)[0], x, g)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    _, vjp = jax.vjp(lambda v: JG.face_aa_verts_ccw(v, jnp.asarray(to_numpy(faces))),
                     jnp.asarray(to_numpy(image)))
    (want_jax,) = vjp(jnp.asarray(to_numpy(g)))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want_jax), rtol=1e-6, atol=1e-6)
    assert np.abs(np.asarray(want_jax)).max() > 1.0


def test_grad_reduce_is_a_counted_kernel_built_with_composite_bwd():
    """grad_reduce.cu's two kernels are counted apart; the backward
    compositor's build also builds it, since every caller launches both."""
    assert _kernels.GRAD_REDUCE in _kernels.KERNELS
    assert _kernels.GRAD_REDUCE in _kernels.COUNTED
    assert _kernels.CORNER_REDUCE in _kernels.COUNTED
    assert _kernels.CORNER_REDUCE.kernel is _kernels.GRAD_REDUCE
    assert _kernels.GRAD_REDUCE.source.name == "grad_reduce.cu"
    assert _kernels.COMPOSITE_BWD.companions == (_kernels.GRAD_REDUCE,)


# The kernel paths' argument checks, on the meta device (which runs every
# check but the last, that the tensors are on a CUDA device): case -> the
# argument changed, its wrong value, the error.
BAD_REDUCE = {
    "records_dtype": ("rec", torch.float64, "grad_records must be torch.float32"),
    "records_shape": ("rec", (8, 29), r"grad_records must have shape \(8, 32\)"),
    "entry_dtype": ("entry", torch.int64, "entry_bf must be torch.int32"),
    "nc_shape": ("nc", (5,), r"nc_tile must have shape \(4,\)"),
    "faces_dtype": ("faces", torch.int64, "faces must be torch.int32"),
    "not_cuda": (None, None, "kernels run on CUDA tensors"),
}


@pytest.mark.parametrize("case", sorted(BAD_REDUCE))
def test_reduce_kernel_refuses_what_it_does_not_take(case):
    arg, bad, message = BAD_REDUCE[case]
    spec = dict(rec=((8, 32), torch.float32), entry=((8,), torch.int32),
                starts=((4,), torch.int32), counts=((4,), torch.int32),
                nc=((4,), torch.int32), faces=((3, 3), torch.int32))
    if arg is not None:
        shape, dtype = spec[arg]
        spec[arg] = (bad, dtype) if isinstance(bad, tuple) else (shape, bad)
    t = {k: torch.empty(shape, dtype=dtype, device="meta") for k, (shape, dtype) in spec.items()}
    reset_counters()
    with pytest.raises(ValueError, match=message):
        reduce_entry_grads(t["rec"], t["entry"], t["starts"], t["counts"], t["nc"],
                           t["faces"], 5, 2)
    assert counters()["launches"]["grad_reduce"] == 0


BAD_CORNERS = {
    "g_dtype": ("g", torch.float64, "g must be torch.float32"),
    "g_shape": ("g", (2, 3, 3, 3), r"g must have shape \(2, 3, 3, 2\)"),
    "neg_dtype": ("neg", torch.uint8, "neg must be torch.bool"),
    "not_cuda": (None, None, "kernels run on CUDA tensors"),
}


@pytest.mark.parametrize("case", sorted(BAD_CORNERS))
def test_corner_kernel_refuses_what_it_does_not_take(case):
    arg, bad, message = BAD_CORNERS[case]
    spec = dict(g=((2, 3, 3, 2), torch.float32), neg=((2, 3), torch.bool),
                faces=((3, 3), torch.int64))
    if arg is not None:
        shape, dtype = spec[arg]
        spec[arg] = (bad, dtype) if isinstance(bad, tuple) else (shape, bad)
    t = {k: torch.empty(shape, dtype=dtype, device="meta") for k, (shape, dtype) in spec.items()}
    reset_counters()
    with pytest.raises(ValueError, match=message):
        G.aa_cotangent_to_verts_image(t["g"], t["neg"], t["faces"], 5)
    assert counters()["launches"]["corner_reduce"] == 0
