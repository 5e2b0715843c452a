#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dmesh2_renderer_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Build every CUDA kernel from ``dmesh2_renderer_tpu_torch/csrc`` (one nvcc
   per source, all at once) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, on the
   inputs the entry points give it (recorded as they call the kernel
   wrappers): icosphere(3), 4 views at 512x512 through one ragged 376x312
   window, tau 1 and 0. ``pack_stream`` must equal its plain version
   exactly; ``composite_fwd`` must agree within 1e-5 on colour, depth,
   final_t and prev_t, with at most 1e-4 of pixels (and of tiles) differing
   in n_contrib (nc_tile); ``composite_bwd`` (from ``loss.backward()``
   through ``render_partial``, with a loss on colour, depth and final_t)
   must agree column by column within 2e-5 x max(|column|, 1) on colour,
   opacity, intensity and z and 5e-4 x max(|column|, 1) on the
   Moeller-Trumbore and AA columns. The whole Renderer on the card is also
   held against the plain reference compositor (``use_pallas=False``) on a
   small scene: images, and the gradients autograd takes through it.
3. The main path at full size: one training step, ``Renderer.forward`` on
   the 1M-triangle soup at 1920x1080 (the JAX package's headline scene) and
   ``loss.backward()`` of ``color.sum() + depth.sum()``, with every kernel
   launch count set to 0 just before and read just after; every kernel must
   have launched. The output must be finite, drop no entries and cover
   pixels, and every gradient must be finite and non-zero. The kernels'
   outputs of that step, and the forward kernels' of a 256x256 window of
   the same scene, are held against their plain versions as in phase 2.
   Then 5 Adam steps toward a target rendered with perturbed colours must
   lower the loss.
4. Timing with CUDA events (median of repeated runs after warm-up): the
   1080p forward and training step, the backward alone, each kernel on the
   main path's own inputs beside its plain version and its bound (the
   compositors' from the work their plain versions count on those inputs),
   the ``index_select`` yardstick of the record pack, every stage of the
   forward (projection, depth/cull, binning and its sort, pack, composite)
   and of the backward (composite_bwd, the gradient reduction, the
   autograd tail through the projection and the AA corners).

The next-to-last lines are the ``{"kernels": [...]}`` JSON line and the
card's ``nvidia-smi`` name and power limit; the last line is the
``{"ok": true, "device": {...}}`` JSON line. A full report is also written
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# throughput outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The TPU kernel each CUDA kernel replaces (file:line of the Pallas kernel).
REPLACES = {
    "pack_stream": "dmesh2_renderer_tpu/ops/binning.py:58",
    "composite_fwd": "dmesh2_renderer_tpu/ops/pallas_fwd.py:254",
    "composite_bwd": "dmesh2_renderer_tpu/ops/pallas_bwd.py:62",
}

KERNEL_TOL = 1e-5          # colour, depth, final_t, prev_t: kernel vs plain
COUNT_MISMATCH_FRAC = 1e-4  # n_contrib / nc_tile mismatches allowed
# composite_bwd vs its plain version, per gradient-record column, times
# max(|column|, 1): the kernel's block sums and the plain version's
# torch.sum associate differently, and the Moeller-Trumbore and AA columns
# come out of epilogues that cancel (the tolerances of
# tests/test_pallas_bwd.py:97-102).
BWD_COLUMNS = [(9, 18, "verts_color", 2e-5), (18, 19, "opacity", 2e-5),
               (19, 20, "intensity", 2e-5), (20, 23, "z", 2e-5),
               (0, 9, "verts", 5e-4), (23, 29, "aa", 5e-4)]
TRAINABLE = ("verts", "verts_color", "faces_opacity", "faces_intense")


@dataclasses.dataclass
class Sizes:
    """Scene sizes; the defaults are what ``python3 chip_smoke.py`` runs."""

    check_subdiv: int = 3
    check_views: int = 4
    check_res: int = 512
    check_window: tuple = (70, 90, 376, 312)        # x0, y0, pw, ph (ragged)
    small_subdiv: int = 2
    small_res: int = 128
    n_faces: int = 1_000_000
    width: int = 1920
    height: int = 1080
    patch: tuple = (832, 412, 256, 256)             # x0, y0, pw, ph
    capacity: int = 32 * (1 << 17)
    reps: int = 10
    plain_reps: int = 3
    adam_steps: int = 5


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warmup: int = 1) -> tuple[float, list[float]]:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events around one call, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def scene_tensors(verts, faces, b, rng, dev):
    """Random colours, opacities and intensities from ``rng``, on ``dev``."""
    f = faces.shape[0]
    return dict(
        verts=torch.as_tensor(verts, device=dev),
        faces=torch.as_tensor(faces, dtype=torch.int32, device=dev),
        verts_color=torch.as_tensor(
            rng.uniform(size=verts.shape).astype(np.float32), device=dev),
        faces_opacity=torch.as_tensor(
            rng.uniform(0.3, 1.0, size=(f,)).astype(np.float32), device=dev),
        faces_intense=torch.as_tensor(
            rng.uniform(0.5, 1.0, size=(b, f)).astype(np.float32), device=dev),
        background=torch.tensor([0.1, 0.2, 0.3], device=dev),
    )


def scene_args(s):
    """``Renderer.forward``'s scene arguments, in its order."""
    return (s["verts"], s["faces"], s["verts_color"], s["faces_opacity"],
            s["faces_intense"], s["background"])


@contextlib.contextmanager
def captured_kernel_calls():
    """Record the arguments and the result of each kernel wrapper as the
    main path calls it (``pack_stream``, ``composite_forward`` and
    ``composite_backward``, looked up in ``ops/rasterize.py``), so that the
    checks and the timings run on exactly what the forward and the backward
    fed the kernels.

    Yields a dict: wrapper name -> (positional args, result) of its last call.
    """
    from dmesh2_renderer_tpu_torch.ops import rasterize

    calls = {}
    originals = {name: getattr(rasterize, name)
                 for name in ("pack_stream", "composite_forward",
                              "composite_backward")}

    def detached(xs):
        return tuple(x.detach() if isinstance(x, torch.Tensor) else x for x in xs)

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls[name] = (detached(args), detached(out) if isinstance(out, tuple)
                           else out.detach())
            return out
        return call

    for name, fn in originals.items():
        setattr(rasterize, name, recording(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(rasterize, name, fn)


def compare_composite(kernel_out, plain_out, label):
    """Max abs error over colour/depth/final_t/prev_t and count mismatches;
    raises when they exceed the limits."""
    errs = {}
    for name, k, p in zip(("color", "depth", "final_t", "prev_t"),
                          kernel_out[:4], plain_out[:4]):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{label}: composite_fwd {name} not finite")
        errs[name] = float((k - p).abs().max()) if k.numel() else 0.0
    nc_bad = int((kernel_out[4] != plain_out[4]).sum())
    tile_bad = int((kernel_out[5] != plain_out[5]).sum())
    n_pix, n_tiles = kernel_out[4].numel(), kernel_out[5].numel()
    print(f"  {label}: composite_fwd max|err| " +
          " ".join(f"{k}={v:.3g}" for k, v in errs.items()) +
          f"; n_contrib mismatches {nc_bad}/{n_pix}, nc_tile {tile_bad}/{n_tiles}")
    worst = max(errs.values())
    if worst > KERNEL_TOL:
        raise AssertionError(f"{label}: composite_fwd error {worst} > {KERNEL_TOL}")
    if nc_bad > COUNT_MISMATCH_FRAC * n_pix or tile_bad > COUNT_MISMATCH_FRAC * n_tiles:
        raise AssertionError(f"{label}: composite_fwd count mismatches "
                             f"{nc_bad} pixels, {tile_bad} tiles")
    return worst


def compare_pack(kernel_rec, plain_rec, label):
    if not torch.equal(kernel_rec, plain_rec):
        err = float((kernel_rec - plain_rec).abs().max())
        raise AssertionError(f"{label}: pack_stream differs from plain, max {err}")
    print(f"  {label}: pack_stream equals its plain version "
          f"({kernel_rec.shape[0]} records)")
    return 0.0


def check_kernels(calls, label, report, work=None):
    """Hold each kernel's output from one main-path call (``calls`` from
    :func:`captured_kernel_calls`) against its plain version on the same
    inputs. Returns the plain compositor's output; ``work`` is passed on to
    it to count the compositing work of these inputs."""
    from dmesh2_renderer_tpu_torch.ops.binning import pack_stream_plain
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward_plain

    pack_args, records = calls["pack_stream"]
    err = compare_pack(records, pack_stream_plain(*pack_args), label)
    report["pack_stream"]["max_abs_err"] = max(report["pack_stream"]["max_abs_err"], err)
    comp_args, out = calls["composite_forward"]
    plain = composite_forward_plain(*comp_args, work=work)
    sync()
    err = compare_composite(out, plain, f"{label} tau={comp_args[-1]}")
    report["composite_fwd"]["max_abs_err"] = max(report["composite_fwd"]["max_abs_err"], err)
    return plain


def compare_backward(kernel_rec, plain_rec, label):
    """Column-group errors of composite_bwd vs its plain version, each
    against its tolerance (``BWD_COLUMNS``); raises when one exceeds it.
    Returns the largest absolute error."""
    if not torch.isfinite(kernel_rec).all():
        raise AssertionError(f"{label}: composite_bwd records not finite")
    worst, msgs = 0.0, []
    for lo, hi, name, tol in BWD_COLUMNS:
        k, p = kernel_rec[:, lo:hi], plain_rec[:, lo:hi]
        err = float((k - p).abs().max()) if k.numel() else 0.0
        scale = max(float(p.abs().max()) if p.numel() else 0.0, 1.0)
        worst = max(worst, err)
        msgs.append(f"{name}={err:.3g}/{scale:.3g}")
        if err > tol * scale:
            raise AssertionError(f"{label}: composite_bwd {name} error {err} > "
                                 f"{tol} x {scale}")
    pad = float(kernel_rec[:, 29:].abs().max()) if kernel_rec.numel() else 0.0
    if pad != 0.0:
        raise AssertionError(f"{label}: composite_bwd padding columns not zero")
    print(f"  {label}: composite_bwd max|err|/scale " + " ".join(msgs) +
          f" ({int((kernel_rec != 0).any(dim=1).sum())} non-zero of "
          f"{kernel_rec.shape[0]} rows)")
    return worst


def check_backward(calls, label, report, work=None):
    """Hold composite_bwd's output from one backward (``calls`` from
    :func:`captured_kernel_calls`) against its plain version on the same
    inputs; ``work`` is passed on to count the work of these inputs."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import composite_backward_plain

    args, out = calls["composite_backward"]
    plain = composite_backward_plain(*args, work=work)
    sync()
    err = compare_backward(out, plain, f"{label} tau={args[-1]}")
    report["composite_bwd"]["max_abs_err"] = max(report["composite_bwd"]["max_abs_err"], err)
    return plain


def leaves_of(s):
    """Trainable leaf copies of a scene's parameters."""
    return {k: s[k].detach().clone().requires_grad_(True) for k in TRAINABLE}


def phase_kernel_checks(dev, sz: Sizes, report):
    from dmesh2_renderer_tpu_torch import RasterConfig, Renderer, render_partial
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

    print(f"phase 2: kernels vs plain versions, icosphere({sz.check_subdiv}), "
          f"{sz.check_views} views, {sz.check_res}^2, window {sz.check_window}")
    rng = np.random.default_rng(0)
    verts, faces = icosphere(sz.check_subdiv)
    mv, proj = orbit_cameras(sz.check_views)
    s = scene_tensors(verts, faces, sz.check_views, rng, dev)
    x0, y0, pw, ph = sz.check_window
    config = RasterConfig(binning_capacity=1 << 16)
    renderer = Renderer(mv, proj, sz.check_res, sz.check_res, config=config)
    for tau in (1.0, 0.0):
        with captured_kernel_calls() as calls:
            renderer.forward(list(range(sz.check_views)), [[x0, y0]] * sz.check_views,
                             pw, ph, *scene_args(s), aa_temperature=tau)
        if int(renderer.last_aux.num_truncated):
            raise AssertionError("phase 2 binning truncated entries")
        check_kernels(calls, "check", report)

    # The backward kernel, from loss.backward() through render_partial with
    # a loss on colour, depth and final_t (so g_final_t is not zero).
    v = sz.check_views
    weights = [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)
               for shape in ((v, ph, pw, 3), (v, ph, pw), (v, ph, pw))]
    for tau in (1.0, 0.0):
        p = leaves_of(s)
        with captured_kernel_calls() as calls:
            outs = render_partial(p["verts"], s["faces"], p["verts_color"],
                                  p["faces_opacity"], p["faces_intense"], mv, proj,
                                  s["background"], sz.check_res, sz.check_res, tau,
                                  config, patch_origin=(x0, y0), patch_shape=(ph, pw))
            sum((o * w).sum() for o, w in zip(outs[:3], weights)).backward()
        if int(outs[3].num_truncated):
            raise AssertionError("phase 2 binning truncated entries")
        check_backward(calls, "check", report)

    # The whole Renderer on the card vs the plain reference compositor:
    # images, and the gradients of a weighted loss on colour and depth.
    verts, faces = icosphere(sz.small_subdiv)
    # Off the icosphere's lattice: exact vertex-on-pixel-boundary ties are
    # subgradient choices where analytic and autodiff gradients may differ.
    verts = verts + np.random.default_rng(12345).normal(
        scale=1e-3, size=verts.shape).astype(np.float32)
    mv2, proj2 = orbit_cameras(2)
    s = scene_tensors(verts, faces, 2, rng, dev)
    res = sz.small_res
    pw2, ph2 = res - 24, res - 40
    w_c = torch.as_tensor(rng.normal(size=(2, ph2, pw2, 3)).astype(np.float32), device=dev)
    w_d = torch.as_tensor(rng.normal(size=(2, ph2, pw2)).astype(np.float32), device=dev)
    out, grads = {}, {}
    for use_pallas in (True, False):
        r = Renderer(mv2, proj2, res, res, config=RasterConfig(use_pallas=use_pallas))
        p = leaves_of(s)
        color, depth = r.forward([0, 1], [[0, 0], [8, 24]], pw2, ph2, p["verts"],
                                 s["faces"], p["verts_color"], p["faces_opacity"],
                                 p["faces_intense"], s["background"],
                                 aa_temperature=1.0)
        ((color * w_c).sum() + (depth * w_d).sum()).backward()
        out[use_pallas] = (color.detach(), depth.detach())
        grads[use_pallas] = {k: p[k].grad for k in TRAINABLE}
    err = max(float((a - b).abs().max()) for a, b in zip(out[True], out[False]))
    print(f"  Renderer (kernels) vs Renderer(use_pallas=False): max|err| {err:.3g}")
    if not err <= 2e-5:
        raise AssertionError(f"Renderer vs reference compositor: {err}")
    # Colour, opacity and intensity gradients are sums that reassociate
    # only: 2e-5 x scale. verts: 5e-4 x scale, the tolerance of the JAX
    # package's analytic-vs-autodiff test on a scene jittered off the
    # lattice, as this one is.
    msgs = []
    for k, tol in (("verts_color", 2e-5), ("faces_opacity", 2e-5),
                   ("faces_intense", 2e-5), ("verts", 5e-4)):
        a, b = grads[True][k], grads[False][k]
        e = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1.0)
        msgs.append(f"{k} {e:.3g}/{scale:.3g}")
        if not (torch.isfinite(a).all() and e <= tol * scale):
            raise AssertionError(f"backward vs reference autograd: {k} {e} > {tol} x {scale}")
    print("  backward (kernels) vs autograd of use_pallas=False: max|err|/scale "
          + ", ".join(msgs))


def headline_scene(dev, sz: Sizes):
    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, triangle_soup

    verts, faces = triangle_soup(sz.n_faces, size=0.02)
    mv, proj = orbit_cameras(1, radius=3.0)
    f = faces.shape[0]
    s = dict(
        verts=torch.as_tensor(verts, device=dev),
        faces=torch.as_tensor(faces, device=dev),
        verts_color=torch.as_tensor(np.abs(verts) % 1.0, device=dev),
        faces_opacity=torch.full((f,), 0.5, device=dev),
        faces_intense=torch.ones((1, f), device=dev),
        background=torch.zeros(3, device=dev),
    )
    config = RasterConfig(binning_capacity=sz.capacity, max_tiles_per_face=12,
                          num_giant_faces=16384, giant_tiles=40,
                          exact_tile_cull=True)
    return s, mv, proj, config


def check_grads(params, label):
    for k, t in params.items():
        g = t.grad
        if g is None or not torch.isfinite(g).all() or not bool((g != 0).any()):
            raise AssertionError(f"{label}: gradient of {k} missing, not finite or zero")
    print(f"  {label}: gradients finite and non-zero; max|grad| " + ", ".join(
        f"{k} {float(t.grad.abs().max()):.4g}" for k, t in params.items()))


def phase_main_path(dev, sz: Sizes, report, kernels):
    from dmesh2_renderer_tpu_torch import Renderer

    print(f"phase 3: main path, one training step (Renderer.forward + "
          f"loss.backward()), {sz.n_faces} faces at {sz.width}x{sz.height}")
    s, mv, proj, config = headline_scene(dev, sz)
    renderer = Renderer(mv, proj, sz.width, sz.height, config=config)
    params = leaves_of(s)

    def forward(p):
        return renderer.forward([0], [[0, 0]], sz.width, sz.height, p["verts"],
                                s["faces"], p["verts_color"], p["faces_opacity"],
                                p["faces_intense"], s["background"], 1.0)

    sync()
    for k in kernels:
        k.launches = 0
    with captured_kernel_calls() as calls:
        color, depth = forward(params)
        (color.sum() + depth.sum()).backward()
    sync()
    color, depth = color.detach(), depth.detach()
    launches = {k.name: k.launches for k in kernels}
    aux = [int(x) for x in renderer.last_aux]
    print(f"  launches on the main path: {launches}")
    print(f"  aux: num_rendered={aux[0]} num_truncated={aux[1]} "
          f"num_grad_contributing={aux[2]}")
    for name, n in launches.items():
        report[name]["launches"] = n
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if not (torch.isfinite(color).all() and torch.isfinite(depth).all()):
        raise AssertionError("main path output is not finite")
    if tuple(color.shape) != (1, sz.height, sz.width, 3):
        raise AssertionError(f"main path colour shape {tuple(color.shape)}")
    if aux[1] != 0:
        raise AssertionError(f"main path truncated {aux[1]} entries")
    covered = int((color.sum(-1) > 0).sum())
    print(f"  non-background pixels: {covered} of {sz.width * sz.height}; "
          f"colour range [{float(color.min()):.4f}, {float(color.max()):.4f}]")
    if covered == 0:
        raise AssertionError("main path rendered only background")
    check_grads(params, "training step")

    # The kernels' outputs of that step vs their plain versions on the card,
    # counting the compositing work these inputs need for the bounds.
    work, bwd_work = {}, {}
    main_label = f"main {sz.width}x{sz.height}"
    check_kernels(calls, main_label, report, work=work)
    check_backward(calls, main_label, report, work=bwd_work)

    # A 256x256 window of the same scene, through the same forward.
    x0, y0, pw, ph = sz.patch
    with captured_kernel_calls() as patch_calls:
        renderer.forward([0], [[x0, y0]], pw, ph, *scene_args(s), 1.0)
    check_kernels(patch_calls, f"patch {pw}x{ph}", report)
    return renderer, s, forward, calls, work, bwd_work


def phase_training(dev, sz: Sizes, renderer, s, forward):
    """A few Adam steps on (verts, verts_color, faces_opacity) toward a
    target rendered from the same scene with perturbed colours."""
    print(f"phase 3b: {sz.adam_steps} Adam steps toward a target with "
          "perturbed colours")
    gen = torch.Generator(device=dev).manual_seed(7)
    target_colors = (s["verts_color"] + 0.2 * torch.randn(
        s["verts_color"].shape, generator=gen, device=dev)).clamp(0.0, 1.0)
    with torch.no_grad():
        target, _ = forward(dict(s, verts_color=target_colors))
    p = leaves_of(s)
    opt = torch.optim.Adam([
        dict(params=[p["verts"]], lr=1e-4),
        dict(params=[p["verts_color"]], lr=1e-2),
        dict(params=[p["faces_opacity"]], lr=1e-3),
    ])
    losses = []
    for _ in range(sz.adam_steps):
        opt.zero_grad(set_to_none=True)
        color, _ = forward(p)
        loss = ((color - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    print("  loss per step: " + ", ".join(f"{x:.6g}" for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Adam steps did not lower the loss: {losses}")
    return losses


def composite_bound(comp_args, work):
    """Least time for the compositing work these inputs need (``work`` from
    the plain version): the records each tile walks until its last pixel
    stops, the rays and the outputs, against the pixel-dependent float
    operations of each class of (face, pixel) pair."""
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        OPS_PER_AA_PAIR, OPS_PER_BBOX_PAIR, OPS_PER_BLEND_PAIR, OPS_PER_PAIR)

    _, _, counts, ray_o, ray_d, bg, patch_min, pw, ph, tau = comp_args
    w = {k: int(v) for k, v in work.items()}
    n_pix = ray_d.shape[0] * ph * pw
    nbytes = (w["records"] * 128 + (ray_d.numel() + ray_o.numel() + bg.numel()
                                    + patch_min.numel()) * 4
              + 3 * counts.numel() * 4 + n_pix * (3 + 4) * 4)
    ops = (w["pairs"] * OPS_PER_PAIR
           + w["bbox_pairs"] * (OPS_PER_BBOX_PAIR + (OPS_PER_AA_PAIR if tau > 0 else 0))
           + w["blend_pairs"] * OPS_PER_BLEND_PAIR)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        dict(w, bytes=nbytes, ops=ops)


def backward_bound(bwd_args, work):
    """Least time for the backward compositing work these inputs need
    (``work`` from the plain version): the contributing records walked, the
    (R, 32) output written once, 14 floats per pixel (ray 3, cotangents 5,
    residuals 6) and the tile arrays, against the forward's per-pair
    operations paid again in the replay plus the gradient fields of each
    blending pair and the block sum and epilogue of each entry."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        OPS_PER_AA_GRAD_PAIR, OPS_PER_GRAD_ENTRY, OPS_PER_GRAD_PAIR)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        OPS_PER_AA_PAIR, OPS_PER_BBOX_PAIR, OPS_PER_BLEND_PAIR, OPS_PER_PAIR)

    records, counts, ray_d, tau = bwd_args[0], bwd_args[2], bwd_args[5], bwd_args[-1]
    pw, ph = bwd_args[-3], bwd_args[-2]
    w = {k: int(v) for k, v in work.items()}
    n_pix = ray_d.shape[0] * ph * pw
    nbytes = (w["records"] * 128 + records.shape[0] * 128 + n_pix * 14 * 4
              + 3 * counts.numel() * 4)
    aa = tau > 0
    ops = (w["pairs"] * OPS_PER_PAIR
           + w["bbox_pairs"] * (OPS_PER_BBOX_PAIR + (OPS_PER_AA_PAIR if aa else 0))
           + w["blend_pairs"] * (OPS_PER_BLEND_PAIR + OPS_PER_GRAD_PAIR
                                 + (OPS_PER_AA_GRAD_PAIR if aa else 0))
           + w["grad_records"] * OPS_PER_GRAD_ENTRY)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        dict(w, bytes=nbytes, ops=ops)


def phase_timing(dev, sz: Sizes, report, renderer, s, forward, calls, work,
                 bwd_work):
    from dmesh2_renderer_tpu_torch.ops.binning import (
        bin_faces, contributing_mask, emission_keys, pack_stream, pack_stream_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain, scatter_entry_grads)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        composite_forward, composite_forward_plain)
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
    from dmesh2_renderer_tpu_torch import geometry as G

    print(f"phase 4: timing (median of {sz.reps} after warm-up; plain versions "
          f"median of {sz.plain_reps})")
    fwd_ms, fwd_all = time_ms(lambda: forward(s), sz.reps, warmup=2)
    mpix = sz.width * sz.height / (fwd_ms * 1e3)
    print(f"  forward {sz.width}x{sz.height}: {fwd_ms:.3f} ms  ({mpix:.2f} Mpix/s); "
          f"runs {[round(t, 3) for t in fwd_all]}")
    timings = dict(forward_ms=fwd_ms, forward_runs_ms=fwd_all, mpix_per_s=mpix)

    # The training step (forward + backward of color.sum() + depth.sum())
    # and the backward alone (retained graph of one forward).
    p = leaves_of(s)

    def train_step():
        for t in p.values():
            t.grad = None
        color, depth = forward(p)
        (color.sum() + depth.sum()).backward()

    step_ms, step_all = time_ms(train_step, sz.reps, warmup=2)
    color, depth = forward(p)
    loss = color.sum() + depth.sum()
    bwd_ms, bwd_all = time_ms(lambda: loss.backward(retain_graph=True), sz.reps)
    del color, depth, loss
    print(f"  training step {sz.width}x{sz.height}: {step_ms:.3f} ms; runs "
          f"{[round(t, 3) for t in step_all]}; backward alone {bwd_ms:.3f} ms; runs "
          f"{[round(t, 3) for t in bwd_all]}")
    timings.update(train_step_ms=step_ms, train_step_runs_ms=step_all,
                   backward_ms=bwd_ms, backward_runs_ms=bwd_all)

    # Record pack, its plain version and the index_select yardstick, on the
    # main path's own inputs.
    pack_args, records = calls["pack_stream"]
    r_entries = records.shape[0]
    entry_bf, faces, verts, vcol, vndc, op, inten, aa = pack_args
    bf = inten.numel()
    table = pack_stream_plain(torch.arange(bf, dtype=torch.int32, device=dev), *pack_args[1:])
    safe = torch.clamp(entry_bf.long(), max=bf - 1)
    pack_ms, _ = time_ms(lambda: pack_stream(*pack_args), sz.reps)
    pack_plain_ms, _ = time_ms(lambda: pack_stream_plain(*pack_args), sz.plain_reps)
    lib_ms, _ = time_ms(lambda: table.index_select(0, safe), sz.reps)
    pack_bytes = (r_entries * 128 + r_entries * 4 + faces.numel() * 4
                  + (verts.numel() + vcol.numel() + vndc.numel() + op.numel()
                     + inten.numel() + aa.numel()) * 4)
    pack_bound = pack_bytes / HBM_BYTES_PER_S * 1e3
    report["pack_stream"].update(ms=pack_ms, plain_ms=pack_plain_ms, bound_ms=pack_bound,
                                 bound_by="bytes", library_ms=lib_ms)
    print(f"  pack_stream: {pack_ms:.3f} ms, plain {pack_plain_ms:.3f} ms, "
          f"index_select {lib_ms:.3f} ms, bound {pack_bound:.3f} ms "
          f"({r_entries} records, {pack_bytes} bytes)")

    # Tile compositor on the main path's own inputs.
    comp_args, _ = calls["composite_forward"]
    comp_ms, _ = time_ms(lambda: composite_forward(*comp_args), sz.reps)
    comp_plain_ms, _ = time_ms(lambda: composite_forward_plain(*comp_args),
                               sz.plain_reps, warmup=0)
    bound, bound_by, comp_work = composite_bound(comp_args, work)
    report["composite_fwd"].update(ms=comp_ms, plain_ms=comp_plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=None)
    print(f"  composite_fwd: {comp_ms:.3f} ms, plain {comp_plain_ms:.3f} ms, "
          f"bound {bound:.3f} ms ({bound_by}; {comp_work})")
    timings.update(composite_work=comp_work)

    # Where the forward's time goes: each stage at the main path's inputs.
    mv, proj = renderer.mv[:1], renderer.proj[:1]
    patch_min = comp_args[6]
    config = renderer.config
    depth01, _, _, alive = face_depth01(vndc, faces)
    bin_kw = dict(num_giant_faces=config.num_giant_faces,
                  giant_tiles=config.giant_tiles,
                  exact_tile_cull=config.exact_tile_cull)
    capacity = -(-config.binning_capacity // 128) * 128
    em = emission_keys(aa, depth01, alive, patch_min, sz.width, sz.height, capacity,
                       config.max_tiles_per_face, **bin_kw)
    stages = {
        "project": time_ms(lambda: G.face_aa_verts_ccw(G.compute_verts_ndc_image(
            verts, mv, proj, sz.width, sz.height)[1], faces), sz.reps)[0],
        "depth_cull": time_ms(lambda: face_depth01(vndc, faces), sz.reps)[0],
        "emission_keys": time_ms(lambda: emission_keys(
            aa, depth01, alive, patch_min, sz.width, sz.height, capacity,
            config.max_tiles_per_face, **bin_kw), sz.reps)[0],
        "bin_faces": time_ms(lambda: bin_faces(
            aa, depth01, alive, patch_min, sz.width, sz.height,
            config.binning_capacity, config.max_tiles_per_face, **bin_kw), sz.reps)[0],
        "sort": time_ms(lambda: torch.sort(em.keys, stable=True), sz.reps)[0],
        "pack_stream": pack_ms,
        "composite_fwd": comp_ms,
    }
    staged = sum(stages[k] for k in ("project", "depth_cull", "bin_faces",
                                     "pack_stream", "composite_fwd"))
    stages["rest_of_forward"] = fwd_ms - staged
    print("  stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"  [bin_faces includes emission_keys and the sort of "
          f"{em.keys.numel()} int32 keys]")
    timings.update(stages_ms=stages, sort_ms=stages["sort"], sort_keys=em.keys.numel(),
                   pack_bytes=pack_bytes, records=r_entries)

    # Backward compositor on the main path's own inputs.
    bwd_args, grad_records = calls["composite_backward"]
    cb_ms, _ = time_ms(lambda: composite_backward(*bwd_args), sz.reps)
    cb_plain_ms, _ = time_ms(lambda: composite_backward_plain(*bwd_args),
                             sz.plain_reps, warmup=0)
    bound, bound_by, cb_work = backward_bound(bwd_args, bwd_work)
    report["composite_bwd"].update(ms=cb_ms, plain_ms=cb_plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=None)
    print(f"  composite_bwd: {cb_ms:.3f} ms, plain {cb_plain_ms:.3f} ms, "
          f"bound {bound:.3f} ms ({bound_by}; {cb_work})")

    # Where the backward's time goes: the reduction (contributing mask +
    # index_add_ scatter) and the autograd tail (projection and AA corners
    # back to verts) on the same inputs.
    starts, counts, nc_tile = bwd_args[1], bwd_args[2], bwd_args[3]
    n_verts, n_batch = verts.shape[0], inten.shape[0]

    def reduce():
        keep, _ = contributing_mask(starts, counts, nc_tile, entry_bf.shape[0])
        return scatter_entry_grads(grad_records, entry_bf, faces, n_verts, n_batch, keep)

    red_ms, _ = time_ms(reduce, sz.reps)
    d = reduce()
    d_vndc = torch.zeros_like(vndc)
    d_vndc[..., 2] = d[3]
    v_leaf = verts.clone().requires_grad_(True)
    vndc_t, vimg_t = G.compute_verts_ndc_image(v_leaf, mv, proj, sz.width, sz.height)
    aa_t = G.face_aa_verts_ccw(vimg_t, faces)
    tail_ms, _ = time_ms(lambda: torch.autograd.grad(
        (vndc_t, aa_t), v_leaf, (d_vndc, d[5]), retain_graph=True), sz.reps)
    bwd_stages = {"composite_bwd": cb_ms, "reduction": red_ms, "autograd_tail": tail_ms}
    bwd_stages["rest_of_backward"] = bwd_ms - sum(bwd_stages.values())
    print("  backward stages (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in bwd_stages.items()))
    timings.update(backward_stages_ms=bwd_stages, backward_work=cb_work)
    return timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    from dmesh2_renderer_tpu_torch.ops import _kernels

    sz = Sizes()
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {[k.name for k in _kernels.KERNELS]} in {build_s:.1f} s")
    for k in _kernels.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {k.name}: {line.strip()}")

    root = os.path.dirname(os.path.abspath(__file__))
    report = {k.name: dict(name=k.name, route="cuda",
                           source=os.path.relpath(k.source, root),
                           replaces=REPLACES[k.name], launches=0, max_abs_err=0.0)
              for k in _kernels.KERNELS}
    phase_kernel_checks(dev, sz, report)
    renderer, s, forward, calls, work, bwd_work = phase_main_path(
        dev, sz, report, _kernels.KERNELS)
    losses = phase_training(dev, sz, renderer, s, forward)
    timings = phase_timing(dev, sz, report, renderer, s, forward, calls, work,
                           bwd_work)
    timings.update(adam_losses=losses)

    kernels_line = {"kernels": [report[k.name] for k in _kernels.KERNELS]}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, torch=torch.__version__, build_s=build_s,
                       timings=timings, **kernels_line), fh, indent=1)
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
