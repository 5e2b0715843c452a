"""The port's profiler ranges and host-sync counts (utils/profiling.py):
under ``torch.profiler`` each entry point records its ``dmesh2/`` ranges,
nested under its root; with no profiler recording, ``record_function`` is
never called; ``counters()`` counts each host-sync site once per pass.
CPU only, with the port alone."""

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig, Renderer
from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras, tet_grid
from dmesh2_renderer_tpu_torch.utils.profiling import counters, reset_counters

HW = 32
CFG = RasterConfig(binning_capacity=1 << 13)

# Per call: its root and the ranges beneath it, and its host-sync passes,
# with the camera indices and patch origins given as lists, the rest as
# tensors of the device.
CALLS = {
    "forward": ("render",
                {"validate", "prep", "binning", "pack", "fwd_kernel", "stats",
                 "sync/view_indices", "sync/patch_origins", "sync/image_scale",
                 "sync/overflow_check"},
                {"view_indices": 1, "patch_origins": 1, "image_scale": 1,
                 "overflow_check": 1}),
    # The reduction walks the contributing prefixes in place: no sync.
    "backward": ("backward", {"bwd_kernel", "scatter"}, {}),
    "generate": ("generate",
                 {"validate", "prep", "binning", "peel", "sync/face_indices",
                  "sync/view_indices", "sync/image_scale"},
                 {"face_indices": 1, "view_indices": 1, "image_scale": 1}),
}


def _render_scene():
    verts, faces = icosphere(1)
    mv, proj = orbit_cameras(1)
    f = faces.shape[0]
    t = torch.as_tensor
    params = dict(verts=t(verts), verts_color=t(abs(verts) % 1.0),
                  faces_opacity=torch.full((f,), 0.7), faces_intense=torch.ones((1, f)))
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    renderer = Renderer(mv, proj, HW, HW, device="cpu", config=CFG)
    return renderer, t(faces).to(torch.int32), params


def _forward(renderer, faces, p):
    return renderer.forward([0], [[0, 0]], HW, HW, p["verts"], faces, p["verts_color"],
                            p["faces_opacity"], p["faces_intense"], torch.zeros(3))


def _call(kind):
    """A function that makes the call ``kind`` once, after any set-up it
    needs (a backward needs its forward)."""
    if kind == "generate":
        verts, tets, faces, face_tets, tet_faces = (torch.as_tensor(a) for a in tet_grid(2))
        mv, proj = orbit_cameras(2)
        layered = LayeredRenderer(mv, proj, HW, HW, device="cpu", config=CFG)
        exist = torch.ones(faces.shape[0], dtype=torch.int32)
        return lambda: layered.generate([1, 0], verts, faces, tets, face_tets, tet_faces,
                                        exist, 4)
    renderer, faces, params = _render_scene()
    if kind == "forward":
        return lambda: _forward(renderer, faces, params)
    color, depth = _forward(renderer, faces, params)
    loss = color.sum() + depth.sum()
    return loss.backward


@pytest.mark.parametrize("kind", list(CALLS))
def test_profiler_records_each_range_under_its_root(kind):
    root, inner, _ = CALLS[kind]
    call = _call(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    ours = [e for e in prof.events() if e.name.startswith("dmesh2/")]
    names = {e.name[len("dmesh2/"):] for e in ours}
    assert names == {root} | inner
    for e in ours:
        if e.name == "dmesh2/" + root:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != "dmesh2/" + root:
            parent = parent.cpu_parent
        assert parent is not None, f"{e.name} is not under dmesh2/{root}"


@pytest.mark.parametrize("kind", list(CALLS))
def test_no_profiler_no_record_function(kind, monkeypatch):
    call = _call(kind)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    call()


@pytest.mark.parametrize("kind", list(CALLS))
def test_counters_count_each_sync_site_per_call(kind):
    call = _call(kind)
    reset_counters()
    call()
    assert counters()["syncs"] == CALLS[kind][2]
    reset_counters()
    after = counters()
    assert after["syncs"] == {}
    assert after["launches"] and set(after["launches"].values()) == {0}
