"""Functional full-frame render entry points.

Port of ``render_partial`` and ``render`` of
``dmesh2_renderer_tpu/functional.py``: rays are computed per call, so the
whole render is a function of its inputs. Inputs may be numpy arrays or
tensors; they are moved to ``device`` (the card unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

import torch

from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.ops.rasterize import make_rasterizer
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.validate import resolve_device, valence_cache


def render_partial(
    verts,          # (P, 3)
    faces,          # (F, 3) int
    verts_color,    # (P, 3)
    faces_opacity,  # (F,)
    faces_intense,  # (B, F)
    mv,             # (B, 4, 4)
    proj,           # (B, 4, 4)
    background,     # (3,)
    width: int,
    height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    patch_origin=None,
    patch_shape: tuple[int, int] | None = None,
    device=None,
):
    """Render B full-frame views, also returning the exit transmittance.

    Returns (color, depth_raw, final_t, aux) with ``depth_raw`` the
    un-remapped composite. ``patch_origin=(x0, y0)`` + ``patch_shape=(ph,
    pw)`` restrict every view to one shared window of the full frame.
    """
    config = config or RasterConfig()
    if (patch_origin is None) != (patch_shape is None):
        raise ValueError(
            "patch_origin and patch_shape must be passed together "
            f"(got patch_origin={patch_origin!r}, patch_shape={patch_shape!r})"
        )
    dev = resolve_device(device)
    valence_cache.check(faces, config.max_vertex_valence, len(verts))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    verts, verts_color, faces_opacity, faces_intense, mv, proj, background = (
        f32(x) for x in (verts, verts_color, faces_opacity, faces_intense, mv,
                         proj, background))
    faces = torch.as_tensor(faces, dtype=torch.int32, device=dev).contiguous()
    b = mv.shape[0]
    ray_o, ray_d = G.init_rays(mv, proj, width, height,
                               origin=patch_origin, shape=patch_shape)
    verts_ndc, verts_image = G.compute_verts_ndc_image(verts, mv, proj, width, height)
    aa_verts = G.face_aa_verts_ccw(verts_image, faces)
    if patch_origin is None:
        patch_min = torch.zeros((b, 2), dtype=torch.int32, device=dev)
        pw, ph = width, height
    else:
        patch_min = torch.tensor([list(patch_origin)] * b, dtype=torch.int32,
                                 device=dev)
        ph, pw = patch_shape
    rasterize = make_rasterizer(pw, ph, float(aa_temperature), config)
    return rasterize(
        verts, verts_color, faces_opacity, verts_ndc, faces_intense, aa_verts,
        faces, background, patch_min, ray_o[:, 0, 0, :], ray_d,
    )


def render(
    verts,          # (P, 3)
    faces,          # (F, 3) int
    verts_color,    # (P, 3)
    faces_opacity,  # (F,)
    faces_intense,  # (B, F)
    mv,             # (B, 4, 4)
    proj,           # (B, 4, 4)
    background,     # (3,)
    width: int,
    height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    device=None,
):
    """Render B full-frame views. Returns (color, depth in [0,1], aux)."""
    color, depth_raw, _final_t, aux = render_partial(
        verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
        background, width, height, aa_temperature, config, device=device,
    )
    return color, 1.0 - (depth_raw + 1.0) / 2.0, aux
