"""Functional full-frame entry points.

Port of ``dmesh2_renderer_tpu/functional.py``: ``render_partial``,
``render`` and ``render_banded`` (the differentiable renderer, whose body
``render_stages`` ``Renderer.forward`` shares) and ``peel_pipeline`` /
``generate_layers`` (the depth peel, whose body ``peel_stages``
``LayeredRenderer.generate`` shares). Rays are computed per call, so the
whole render, and its gradient, is a function of its inputs. Inputs may be
numpy arrays or tensors; they are moved to ``device`` (the card unless the
caller passes ``device="cpu"``).
"""

from __future__ import annotations

import torch

from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.ops.binning import bin_faces
from dmesh2_renderer_tpu_torch.ops.peel import peel_layers
from dmesh2_renderer_tpu_torch.ops.rasterize import RasterAux, make_rasterizer
from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span
from dmesh2_renderer_tpu_torch.utils.validate import (
    check_face_indices, resolve_device, to_device, valence_cache, valence_cap,
)


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
    un-remapped composite. All three images are differentiable with respect
    to ``verts``, ``verts_color``, ``faces_opacity`` and ``faces_intense``
    (analytic backward; a loss on ``final_t`` reaches them too).
    ``patch_origin=(x0, y0)`` + ``patch_shape=(ph, pw)`` restrict every view
    to one shared window of the full frame.
    """
    config = config or RasterConfig()
    with span("render"):
        with span("validate"):
            valence_cache.check(faces, valence_cap(config), len(verts))
        return _render_partial(
            verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
            background, width, height, aa_temperature, config, patch_origin,
            patch_shape, device)


def render_partial_unchecked(
    verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
    background, width: int, height: int, aa_temperature: float = 1.0,
    config: RasterConfig | None = None, patch_origin=None,
    patch_shape: tuple[int, int] | None = None, device=None,
):
    """:func:`render_partial` without its valence and vertex-index guard,
    for callers that checked the whole ``faces`` once: the sharded entry
    points render subsets of it (a depth slab, padded with ``(0, 0, 0)``
    rows, for every view), which the JAX package never checks (there they
    are traced values) and which would cost a host sync and a hash each."""
    with span("render"):
        return _render_partial(
            verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
            background, width, height, aa_temperature, config, patch_origin,
            patch_shape, device)


def _render_partial(verts, faces, verts_color, faces_opacity, faces_intense,
                    mv, proj, background, width, height, aa_temperature,
                    config, patch_origin, patch_shape, device):
    """The functional front end's own work, the window's rays from
    ``init_rays`` and its origins, then :func:`render_stages`."""
    if (patch_origin is None) != (patch_shape is None):
        raise ValueError(
            "patch_origin and patch_shape must be passed together "
            f"(got patch_origin={patch_origin!r}, patch_shape={patch_shape!r})"
        )
    dev = resolve_device(device)
    with span("prep"):
        mv = to_device(mv, torch.float32, dev, "inputs")
        proj = to_device(proj, torch.float32, dev, "inputs")
        b = mv.shape[0]
        ray_o, ray_d = G.init_rays(mv, proj, width, height,
                                   origin=patch_origin, shape=patch_shape)
        if patch_origin is None:
            patch_min = torch.zeros((b, 2), dtype=torch.int32, device=dev)
        else:
            patch_min = to_device([list(patch_origin)] * b, torch.int32, dev,
                                  "patch_origins")
    return render_stages(
        verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
        background, patch_min, ray_o[:, 0, 0, :], ray_d, width, height,
        aa_temperature, config, dev)


def render_stages(verts, faces, verts_color, faces_opacity, faces_intense,
                  mv, proj, background, patch_min, ray_o_cam, ray_d,
                  width: int, height: int, aa_temperature: float,
                  config: RasterConfig | None, device: torch.device):
    """The render body of :func:`render_partial` and ``Renderer.forward``,
    for entry points that open the ``render`` range and choose the views'
    cameras and rays themselves.

    ``mv``, ``proj`` (B, 4, 4), ``patch_min`` (B, 2) int32, ``ray_o_cam``
    (B, 3) and ``ray_d`` (B, ph, pw, 3) are the views' tensors on
    ``device``; the scene arguments are converted here. Runs the
    screen-space stage (``geometry.project_faces``) and the rasterize op
    over the (ph, pw) windows of the (width, height) frame. Returns (color,
    depth_raw, final_t, aux).
    """
    config = config or RasterConfig()

    def f32(x):
        return to_device(x, torch.float32, device, "inputs")

    with span("prep"):
        verts, verts_color, faces_opacity, faces_intense, background = (
            f32(x) for x in (verts, verts_color, faces_opacity, faces_intense,
                             background))
        faces = to_device(faces, torch.int32, device, "inputs").contiguous()
        verts_ndc, aa_verts = G.project_faces(verts, faces, mv, proj, width,
                                              height)
    ph, pw = ray_d.shape[1:3]
    rasterize = make_rasterizer(pw, ph, float(aa_temperature), config)
    return rasterize(verts, verts_color, faces_opacity, verts_ndc, faces_intense,
                     aa_verts, faces, background, patch_min, ray_o_cam, ray_d)


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


def render_banded(
    verts, faces, verts_color, faces_opacity, faces_intense,
    mv, proj, background,
    width: int, height: int,
    bands: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    device=None,
):
    """Render B views in ``bands`` sequential horizontal bands.

    Bounds peak memory instead of wall time: each band is one
    ``render_partial`` window of ``height // bands`` rows, so the live
    buffers (emission grid, sorted stream, framebuffers) are band-sized.
    ``config.binning_capacity`` applies per band. The stitched result is the
    full-frame render (band compositing is per-pixel independent) and is
    differentiable like it.

    Returns (color (B, H, W, 3), depth in [0, 1], aux over the bands:
    num_rendered and num_grad_contributing are per-band maxima, a per-band
    capacity gauge, while num_truncated sums).
    """
    if height % bands:
        raise ValueError(f"height {height} must divide into {bands} bands")
    band = height // bands
    colors, draws, auxs = [], [], []
    for y0 in range(0, height, band):
        color, depth_raw, _final_t, aux = render_partial(
            verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
            background, width, height, aa_temperature, config,
            patch_origin=(0, y0), patch_shape=(band, width), device=device,
        )
        colors.append(color)
        draws.append(depth_raw)
        auxs.append(aux)
    aux = RasterAux(
        num_rendered=torch.stack([a.num_rendered for a in auxs]).amax(),
        num_truncated=torch.stack([a.num_truncated for a in auxs]).sum(),
        num_grad_contributing=torch.stack(
            [a.num_grad_contributing for a in auxs]).amax(),
    )
    depth_raw = torch.cat(draws, dim=1)
    return torch.cat(colors, dim=1), 1.0 - (depth_raw + 1.0) / 2.0, aux


def peel_pipeline(verts, faces, faces_existence, mv, proj, ray_o, ray_d,
                  width: int, height: int, num_layers: int,
                  config: RasterConfig | None = None, device=None):
    """Depth-peel core shared by ``generate_layers`` and
    ``LayeredRenderer.generate``.

    Bins by MIN face depth over the full frame, with no exact tile cull
    (the layered orchestrator's choice, unlike the renderer's mean-depth
    binning), then peels each tile (``ops/peel.py``). A face exists where
    ``faces_existence > 0``. ``ray_o``/``ray_d``: (B, H, W, 3) rays of the B
    views. Returns (layers (B, H, W, L) int32, counts (B, H, W) int32,
    (num_rendered, num_truncated)).
    """
    with span("generate"):
        return peel_stages(verts, faces, faces_existence, mv, proj, ray_o,
                           ray_d, width, height, num_layers, config, device)


def peel_stages(verts, faces, faces_existence, mv, proj, ray_o, ray_d,
                width: int, height: int, num_layers: int,
                config: RasterConfig | None = None, device=None):
    """:func:`peel_pipeline`'s stages, for entry points that open the
    ``generate`` range themselves."""
    cfg = config or RasterConfig()
    dev = resolve_device(device)

    def f32(x):
        return to_device(x, torch.float32, dev, "inputs")

    with span("validate"):
        faces = to_device(faces, torch.int32, dev, "inputs").contiguous()
        check_face_indices(faces, len(verts))
    with span("prep"):
        verts, mv, proj, ray_o, ray_d = (f32(x) for x in (verts, mv, proj, ray_o,
                                                          ray_d))
        exist = (to_device(faces_existence, None, dev, "inputs") > 0).to(torch.int32)
        b = mv.shape[0]
        # The CCW screen triangles: face_aa_triangles(...).verts of the JAX
        # pipeline, without the edge tables it does not read.
        verts_ndc, tris = G.project_faces(verts, faces, mv, proj, width, height)
        _, min_depth, _, alive = face_depth01(verts_ndc, faces)
    with span("binning"):
        binning = bin_faces(
            tris, min_depth, alive,
            torch.zeros((b, 2), dtype=torch.int32, device=dev), width, height,
            cfg.binning_capacity, cfg.max_tiles_per_face,
            num_giant_faces=cfg.num_giant_faces, giant_tiles=cfg.giant_tiles,
        )
    with span("peel"):
        layers, counts = peel_layers(
            binning.entry_bf, faces, verts.contiguous(), exist.contiguous(),
            binning.tile_starts, binning.tile_counts,
            ray_o[:, 0, 0, :].contiguous(), ray_d.contiguous(), width, height,
            num_layers,
        )
    return layers, counts, (binning.num_rendered, binning.num_truncated)


def generate_layers(verts, faces, faces_existence, mv, proj,
                    width: int, height: int, num_layers: int,
                    config: RasterConfig | None = None, device=None):
    """Functional depth peel over B full-frame views (the class form is
    ``models.LayeredRenderer.generate``). Returns (layers (B, H, W, L)
    int32 face ids, -1 padded, counts (B, H, W) int32, (num_rendered,
    num_truncated))."""
    dev = resolve_device(device)
    with span("generate"):
        with span("prep"):
            mv = to_device(mv, torch.float32, dev, "inputs")
            proj = to_device(proj, torch.float32, dev, "inputs")
            ray_o, ray_d = G.init_rays(mv, proj, width, height)
        return peel_stages(verts, faces, faces_existence, mv, proj, ray_o,
                           ray_d, width, height, num_layers, config, device=dev)
