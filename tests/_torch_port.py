"""Shared inputs of the PyTorch port's parity tests.

Every input is made with numpy from a seed and handed to both packages: the
JAX side as ``jnp`` arrays, the port as CPU tensors through
``dmesh2_renderer_tpu_torch.convert.scene_from_jax``.
"""

import numpy as np

from dmesh2_renderer_tpu.utils.meshes import icosphere, orbit_cameras


def scene_arrays(b=2, seed=0, subdivisions=1):
    """icosphere(subdivisions) seen by ``b`` orbit cameras, random colours,
    opacities and intensities. Returns a dict of numpy arrays."""
    verts, faces = icosphere(subdivisions)
    mv, proj = orbit_cameras(b)
    rng = np.random.default_rng(seed)
    f = faces.shape[0]
    return dict(
        verts=verts,
        faces=faces,
        verts_color=rng.uniform(size=(verts.shape[0], 3)).astype(np.float32),
        faces_opacity=rng.uniform(0.3, 1.0, size=(f,)).astype(np.float32),
        faces_intense=rng.uniform(0.5, 1.0, size=(b, f)).astype(np.float32),
        mv=mv,
        proj=proj,
        background=np.asarray([0.1, 0.2, 0.3], np.float32),
    )


def to_numpy(x):
    """jnp array or torch tensor -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_blend_counts_match(got, want, tau, atol=1e-5):
    """Hold n_contrib and prev_t of the port against the JAX package's.

    ``got``/``want``: (n_contrib, prev_t, final_t) numpy arrays of one shape.
    With tau == 0 both must agree exactly (n_contrib) and within ``atol``
    (prev_t). With tau > 0 the AA area of a pixel the triangle does not
    touch is a sum of three O(1) edge terms that cancel to within float32
    rounding; where the residue is positive the face "blends" with an alpha
    below float32 resolution, which moves neither colour nor T. XLA:CPU
    contracts the JAX side's multiply-adds into FMAs inside its fused loops
    while PyTorch rounds every operation, so the two sides see different
    residues and may disagree on such sub-resolution blends. A pixel may
    then differ in n_contrib and prev_t only if the side with the larger
    n_contrib ended on such a blend: its prev_t equals its final_t.
    """
    g_nc, g_pt, g_ft = got
    w_nc, w_pt, w_ft = want
    if tau == 0.0:
        np.testing.assert_array_equal(g_nc, w_nc)
        np.testing.assert_allclose(g_pt, w_pt, atol=atol)
        return
    differ = (g_nc != w_nc) | (np.abs(g_pt - w_pt) > atol)
    longer_pt = np.where(g_nc > w_nc, g_pt, w_pt)[differ]
    longer_ft = np.where(g_nc > w_nc, g_ft, w_ft)[differ]
    np.testing.assert_allclose(longer_pt, longer_ft, atol=atol)
    assert differ.mean() < 0.05, differ.mean()
