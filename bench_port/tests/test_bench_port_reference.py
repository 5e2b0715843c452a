"""The benchmark's frozen plain reference against the port's plain paths on
tiny scenes on the CPU (here the tests may import the port; the reference
may not), and its scenes against the repository's generators."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.reference import render as ref
from bench_port.reference.binning import bin_faces
from bench_port.reference.geometry import (
    face_aa_verts_ccw, face_depth01, project, round_tf32,
)
from bench_port.scene import build_scene


def _config(name, **sizes):
    cfg = harness.load_data("configs", name)
    cfg.update(width=sizes.pop("width"), height=sizes.pop("height"))
    cfg["scene"].update(sizes.pop("scene", {}))
    cfg["raster"].update(sizes)
    return cfg


def soup_config():
    return _config("soup1m_1080p", width=72, height=50, scene=dict(n_faces=300, size=0.08),
                   binning_capacity=1 << 14, num_giant_faces=16, giant_tiles=4,
                   max_tiles_per_face=3)


def tet_config():
    return _config("tetgrid32_1080p", width=52, height=40, scene=dict(res=3),
                   binning_capacity=1 << 15)


def test_scene_generators_match_the_repository():
    from dmesh2_renderer_tpu_torch.utils import meshes

    tet_grid = harness.load_module("scenes", "tet_grid").tet_grid
    orbit_cameras = harness.load_module("cameras", "orbit").orbit_cameras
    for got, want in zip(tet_grid(3), meshes.tet_grid(3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(orbit_cameras(2), meshes.orbit_cameras(2)):
        np.testing.assert_array_equal(got, want)


def test_scenes_come_from_the_seed():
    cfg = soup_config()
    a, b = build_scene(cfg, 2**31 + 5, "cpu"), build_scene(cfg, 2**31 + 5, "cpu")
    c = build_scene(cfg, 2**31 + 6, "cpu")
    assert torch.equal(a.verts, b.verts) and not torch.equal(a.verts, c.verts)
    assert torch.equal(a.verts_color, torch.remainder(a.verts.abs(), 1.0))
    t = build_scene(tet_config(), 7, "cpu")
    assert 0.3 < float(t.exist.float().mean()) < 0.7


def test_binning_equals_the_port():
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops import binning as port
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01 as port_depth

    cfg = soup_config()
    s = build_scene(cfg, 11, "cpu")
    w, h = cfg["width"], cfg["height"]
    ndc, img = project(s.verts, s.mv, s.proj, w, h)
    tris = face_aa_verts_ccw(img, s.faces)
    p_ndc, p_img = G.compute_verts_ndc_image(s.verts, s.mv, s.proj, w, h)
    assert torch.equal(ndc, p_ndc) and torch.equal(tris, G.face_aa_verts_ccw(p_img, s.faces))
    for got, want in zip(face_depth01(ndc, s.faces), port_depth(ndc, s.faces)):
        assert torch.equal(got, want)
    depth01, _, _, alive = face_depth01(ndc, s.faces)
    r = cfg["raster"]
    kw = dict(num_giant_faces=r["num_giant_faces"], giant_tiles=r["giant_tiles"],
              exact_tile_cull=True)
    got = bin_faces(tris, depth01, alive, w, h, r["binning_capacity"], r["max_tiles_per_face"],
                    **kw)
    want = port.bin_faces(tris, depth01, alive, torch.zeros((1, 2), dtype=torch.int32), w, h,
                          r["binning_capacity"], r["max_tiles_per_face"], **kw)
    assert int(got.num_truncated) == int(want.num_truncated)
    assert int(got.num_rendered) == int(want.num_rendered) > 0
    for a, b in ((got.entry_bf, want.entry_bf), (got.tile_starts, want.tile_starts),
                 (got.tile_counts, want.tile_counts)):
        assert torch.equal(a, b)


def _port_step(s, cfg):
    from dmesh2_renderer_tpu_torch import RasterConfig, Renderer

    renderer = Renderer(s.mv, s.proj, cfg["width"], cfg["height"], device="cpu",
                        config=RasterConfig(**cfg["raster"]))
    leaves = {k: getattr(s, k).clone().requires_grad_(True) for k in ref.TRAINABLE}
    color, depth = renderer.forward([0], [[0, 0]], cfg["width"], cfg["height"],
                                    leaves["verts"], s.faces, leaves["verts_color"],
                                    leaves["faces_opacity"], leaves["faces_intense"],
                                    s.background, cfg["aa_temperature"])
    (color.sum() + depth.sum()).backward()
    return color.detach(), depth.detach(), renderer.last_aux, {k: t.grad for k, t in leaves.items()}


def test_render_forward_and_backward_equal_the_port():
    cfg = soup_config()
    s = build_scene(cfg, 12345, "cpu")
    color, depth, aux, grads = _port_step(s, cfg)
    out = ref.render(s, cfg["width"], cfg["height"], cfg["aa_temperature"], cfg["raster"],
                     backward=True)
    assert float((color.sum(-1) > 0).float().mean()) > 0.2
    assert torch.equal(out["color"], color) and torch.equal(out["depth"], depth)
    assert out["num_rendered"] == int(aux.num_rendered)
    assert out["num_truncated"] == int(aux.num_truncated) == 0
    for k in ref.TRAINABLE:
        g, want = out["grads"][k], grads[k]
        scale = float(want.abs().max())
        assert scale > 0
        torch.testing.assert_close(g, want, rtol=0, atol=1e-5 * scale)
    w = out["work"]
    assert w["forward"]["blend_pairs"] > 0 and w["backward"]["grad_records"] > 0
    assert w["records"] == cfg["raster"]["binning_capacity"]


@pytest.mark.parametrize("layers", [4, 17])
def test_peel_equals_the_port(layers):
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig

    cfg = tet_config()
    s = build_scene(cfg, 99, "cpu")
    w, h = cfg["width"], cfg["height"]
    lr = LayeredRenderer(s.mv, s.proj, w, h, device="cpu", config=RasterConfig(**cfg["raster"]))
    want_l, want_c = lr.generate([0, 1], s.verts, s.faces, s.tets, s.face_tets, s.tet_faces,
                                 s.exist, layers)
    n_tiles = 2 * (-(-w // 16)) * (-(-h // 16))
    out = ref.peel(s, w, h, cfg["raster"], layers, torch.arange(n_tiles))
    b, y, x = out["pixels"].unbind(1)
    assert out["pixels"].shape[0] == 2 * w * h
    assert torch.equal(out["layers"], want_l[b, y, x])
    assert torch.equal(out["counts"], want_c[b, y, x])
    assert int(want_c.max()) >= min(layers, 4)
    assert out["num_rendered"] == int(lr.last_aux[0])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      1.0 + 2.0**-11 + 2.0**-20, -3.5, float("inf")])
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2 * 2.0**-10,
                         1.0 + 2.0**-10, -3.5, float("inf")])
    assert torch.equal(round_tf32(x), want)


def test_the_control_moves_the_frame():
    cfg = soup_config()
    s = build_scene(cfg, 5, "cpu")
    args = (s, cfg["width"], cfg["height"], cfg["aa_temperature"], cfg["raster"])
    a, b = ref.render(*args), ref.render(*args, precision="tf32")
    assert float((a["color"] - b["color"]).abs().max()) > 1e-4
