#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dmesh2_renderer_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Build every CUDA kernel from ``dmesh2_renderer_tpu_torch/csrc`` (one nvcc
   per source, all at once) and print the card's name and power limit, the
   ptxas resource lines and each kernel's registers, shared memory, spill
   and resident blocks per SM (the peel's for its 8-slot instance).
2. Hold each kernel against its plain PyTorch version on the card, on the
   inputs the entry points give it (recorded as they call the kernel
   wrappers): icosphere(3), 4 views at 512x512 through one ragged 376x312
   window, tau 1 and 0. ``pack_stream`` must equal its plain version
   exactly; ``composite_fwd`` too, bit for bit (colour, depth, final_t,
   prev_t, n_contrib, nc_tile); ``composite_bwd`` (from ``loss.backward()``
   through ``render_partial``, with a loss on colour, depth and final_t)
   must agree column by column within 2e-5 x max(|column|, 1) on colour,
   opacity, intensity and z and 5e-4 x max(|column|, 1) on the
   Moeller-Trumbore and AA columns. The whole Renderer on the card is also
   held against the plain reference compositor (``use_pallas=False``) on a
   small scene: images, and the gradients autograd takes through it.
2b. The peel kernel against its plain version (layers and counts exactly
   equal) on the inputs ``LayeredRenderer.generate`` gives it: the JAX
   package's layered benchmark config (tet_grid(6), 512x512, 8 layers) and
   tet_grid(2) with a third of the faces deleted, 2 views, a ragged 100x84
   frame, 3 and 8 layers; there the card's LayeredRenderer is also held
   against the numpy brute force of tests/test_peel.py (under 1% of pixels
   may differ).
2d. The peel kernel against its plain version (layers and counts exactly
   equal on every tile) on an adversarial scene: tet_grid(12) seen from two
   eyes inside the grid (one on three grid planes, so faces there are
   edge-on and rays graze the planes beside them) and one outside eye on two
   grid planes looking along them, through a ragged 333x201 frame, at 1, 8
   and 16 layers, and with the rays scaled by 2 (longer than the skip bound
   assumes: those pixels skip nothing) and by 0.5. The plain version's
   counts of the pairs the kernel's skip rule drops and of the hits its
   insertion gate keeps out are printed.
2c. Both compositors against their plain versions on a synthetic stress
   scene (2 views x 3,000 small faces piled over a few tiles of a ragged
   72x40 window; bbox edges on pixel boundaries; entries no pixel blends
   between ones that do; prefixes that are not a multiple of the chunk or
   of the backward's entry group) at tau 0, 0.5 and 1: the forward bit for
   bit, the backward within the phase-2 tolerances and with identical bits
   on two runs.
3. The main path at full size: one training step, ``Renderer.forward`` on
   the 1M-triangle soup at 1920x1080 (the JAX package's headline scene) and
   ``loss.backward()`` of ``color.sum() + depth.sum()``, with every kernel
   launch count set to 0 just before and read just after; every kernel must
   have launched. The output must be finite, drop no entries and cover
   pixels, and every gradient must be finite and non-zero. The kernels'
   outputs of that step, and the forward kernels' of a 256x256 window of
   the same scene, are held against their plain versions as in phase 2,
   which also count the work those inputs need (printed), and
   ``composite_bwd`` run twice more on the step's inputs must give the same
   bits. Then 5 Adam steps toward a target rendered with perturbed colours must
   lower the loss.
4. Timing with CUDA events (median of repeated runs after warm-up): the
   1080p forward and training step, the backward alone, each kernel on the
   main path's own inputs beside its plain version and its bound (the
   compositors' from the work their plain versions count on those inputs),
   the ``index_select`` yardstick of the record pack, every stage of the
   forward (projection, depth/cull, binning and its sort, pack, composite)
   and of the backward (composite_bwd, the gradient reduction, the
   autograd tail through the projection and the AA corners).
5. The layered main path at full size: ``LayeredRenderer.generate`` on
   tet_grid(32) (399,360 faces, a seeded half existing), 2 views at
   1920x1080, 8 layers, with every launch count set to 0 just before and
   read just after; the peel must have launched, nothing may be truncated,
   ``counts.max()`` must be 8 and every layer id -1 or an existing face.
   ``pack_stream``'s whole (R, 32) table, sentinel tail included, must equal
   its plain version (phase 3).
   72 sampled pixels must equal the numpy brute force on the port's own
   rays (except at an exact t tie) with non-decreasing t along the layers,
   and the kernel must equal its plain version on every 63rd tile, also
   when run on those tiles alone.
6. Layered timing: ``generate`` and Mpix/s, its stages (projection, min
   depth, binning, peel), the peel kernel beside its two bounds (the full
   scan the JAX kernel does, and the work left after the kernel's skip
   rule; entries, pairs, hits, skipped pairs and gated hits counted by the
   plain version over every tile, which is also held against the kernel
   there) and beside its plain version, over every tile and on the sampled
   tiles.
7. The card's busy time in the 1080p forward and training step: the union
   of the device intervals torch.profiler records, beside the wall time of
   the profiled calls.

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
    "peel": "dmesh2_renderer_tpu/ops/peel.py:84",
}
# The kernels of each main path: the training step, and the layered peel.
TRAINING_KERNELS = ("pack_stream", "composite_fwd", "composite_bwd")
LAYERED_KERNELS = ("peel",)

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
    # Compositor stress scene: per view, stress_faces small faces piled over
    # three clusters of a few tiles in a ragged window.
    stress_views: int = 2
    stress_faces: int = 3000
    stress_window: tuple = (72, 40)                 # pw, ph (ragged)
    stress_taus: tuple = (0.0, 0.5, 1.0)
    stress_seed: int = 4
    n_faces: int = 1_000_000
    width: int = 1920
    height: int = 1080
    patch: tuple = (832, 412, 256, 256)             # x0, y0, pw, ph
    capacity: int = 32 * (1 << 17)
    reps: int = 10
    plain_reps: int = 3
    adam_steps: int = 5
    # Layered path. Check scenes: the JAX package's layered benchmark
    # config (benchmarks/run.py config 3, whose default max_tiles_per_face
    # truncates a few entries, in the JAX package too) and a small ragged
    # scene with a third of the faces deleted, also held against the numpy
    # brute force.
    peel_res: int = 6
    peel_hw: int = 512
    peel_capacity: int = 1 << 19
    peel_small_frame: tuple = (100, 84)             # width, height (ragged)
    peel_small_layers: tuple = (3, 8)
    # Main layered path: tet_grid(32) (35,937 vertices, 399,360 faces), two
    # views at width x height, 8 layers, binning sized so nothing is cut.
    layered_res: int = 32
    layered_views: int = 2
    layered_layers: int = 8
    layered_capacity: int = 9 << 20
    layered_max_tiles: int = 32
    layered_giant_faces: int = 8192
    layered_giant_tiles: int = 32
    layered_exist_frac: float = 0.5
    layered_tile_stride: int = 63                   # every 63rd tile: >= 256 of 16,320
    layered_pixels: int = 64
    # Adversarial peel scene (phase 2d): tet_grid(adv_res), whose grid
    # planes lie at multiples of 2.4 / adv_res from -1.2, three views.
    adv_res: int = 12
    adv_frame: tuple = (333, 201)                   # width, height (ragged)
    adv_layers: tuple = (1, 8, 16)
    adv_capacity: int = 1 << 21
    adv_ray_scales: tuple = (2.0, 0.5)


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


def merged_span_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def device_busy(fn, reps: int = 3) -> tuple[float, float]:
    """Wall milliseconds per call of ``fn()`` (CUDA events around ``reps``
    calls, after one warm-up) under torch.profiler, and the milliseconds per
    call in which the card ran a kernel or a copy: the union of the device
    activity intervals the profiler records. The profiler slows the host,
    so their ratio is a lower bound of the device's busy share. Busy is 0
    when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return start.elapsed_time(end) / reps, merged_span_us(spans) / 1e3 / reps


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
def captured_kernel_calls(module=None, names=("pack_stream", "composite_forward",
                                              "composite_backward")):
    """Record the arguments and the result of each kernel wrapper as the
    main path calls it (by default ``pack_stream``, ``composite_forward``
    and ``composite_backward``, looked up in ``ops/rasterize.py``; the
    layered path's ``peel_layers`` is looked up in ``functional.py``), so
    that the checks and the timings run on exactly what the main path fed
    the kernels.

    Yields a dict: wrapper name -> (positional args, result) of its last call.
    """
    if module is None:
        from dmesh2_renderer_tpu_torch.ops import rasterize as module

    calls = {}
    originals = {name: getattr(module, name) for name in names}

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
        setattr(module, name, recording(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def compare_composite(kernel_out, plain_out, label):
    """composite_fwd must equal its plain version bit for bit: colour,
    depth, final_t, prev_t, n_contrib and nc_tile (the backward replays its
    blend decisions). Prints the max abs errors and count mismatches; raises
    unless all are zero."""
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
    if not all(torch.equal(k, p) for k, p in zip(kernel_out, plain_out)):
        raise AssertionError(f"{label}: composite_fwd differs from its plain version")
    return max(errs.values())


def compare_pack(kernel_rec, plain_rec, label, tail):
    """The whole (R, 32) table must equal the plain version's, the ``tail``
    sentinel rows included."""
    if not torch.equal(kernel_rec, plain_rec):
        err = float((kernel_rec - plain_rec).abs().max())
        raise AssertionError(f"{label}: pack_stream differs from plain, max {err}")
    print(f"  {label}: pack_stream equals its plain version on all "
          f"{kernel_rec.shape[0]} records ({tail} of them the sentinel tail)")
    return 0.0


def check_kernels(calls, label, report, work=None):
    """Hold each kernel's output from one main-path call (``calls`` from
    :func:`captured_kernel_calls`) against its plain version on the same
    inputs. Returns the plain compositor's output; ``work`` is passed on to
    it to count the compositing work of these inputs."""
    from dmesh2_renderer_tpu_torch.ops.binning import pack_stream_plain
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward_plain

    pack_args, records = calls["pack_stream"]
    tail = int((pack_args[0] == pack_args[6].numel()).sum())
    err = compare_pack(records, pack_stream_plain(*pack_args), label, tail)
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


def stress_scene(dev, sz: Sizes):
    """Compositor inputs of a synthetic pile, made with numpy from
    ``sz.stress_seed``: per view, ``sz.stress_faces`` small faces (a few
    pixels across, opacity 0.02-0.25) around three cluster centres, seen by
    a pinhole camera through a ragged window, and four near-opaque quads
    over two whole tiles mid-pile (those tiles stop before the end of their
    lists, at tau 0). A quarter of the small faces have
    one bbox edge moved onto a pixel boundary (px0 + 1 == txmin, px0 ==
    txmax, and the same in y). Each tile lists, by depth, the faces whose
    bbox meets one of its pixel boxes, with one in eight as many faces far
    from the tile inserted at random places: entries no pixel can blend,
    between entries that do.

    Returns (composite_forward's arguments without tau, number of entries
    with a pixel box of their tile at px0 + 1 == txmin).
    """
    rng = np.random.default_rng(sz.stress_seed)
    b, (pw, ph) = sz.stress_views, sz.stress_window
    gx, gy = -(-pw // 16), -(-ph // 16)
    focal, cx, cy = 40.0, pw / 2 + 1.3, ph / 2 - 0.7
    patch_min = np.array([[3, 5], [0, 0]], np.int32)[:b]
    ray_o = np.array([[0.0, 0.0, 0.0], [0.2, -0.1, 0.05]], np.float32)[:b]
    xs = patch_min[:, 0, None, None] + np.arange(pw)[None, None, :] + 0.5
    ys = patch_min[:, 1, None, None] + np.arange(ph)[None, :, None] + 0.5
    d = np.stack(np.broadcast_arrays((xs - cx) / focal, (ys - cy) / focal,
                                     np.ones((b, ph, pw))), -1)
    ray_d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

    recs, starts, counts, touch = [], [], [], 0
    n = sz.stress_faces
    for view in range(b):
        centres = patch_min[view] + rng.uniform([6, 6], [pw - 6, ph - 6], size=(3, 2))
        c = centres[rng.integers(0, 3, n)] + rng.normal(scale=4.0, size=(n, 2))
        aa = c[:, None, :] + rng.uniform(-3.0, 3.0, size=(n, 3, 2))
        for i in np.nonzero(rng.uniform(size=n) < 0.25)[0]:
            coords = aa[i, :, rng.integers(0, 2)]
            k = np.argmin(coords) if rng.uniform() < 0.5 else np.argmax(coords)
            coords[k] = np.round(coords[k])
        z = rng.uniform(2.0, 5.0, size=(n, 3))
        # Four near-opaque quads (faces 0-7) over two whole tiles, mid-pile:
        # those tiles stop before the end of their lists.
        x0, y0 = patch_min[view]
        a, b_, c_, d_ = np.array([[15, -1], [49, -1], [49, 17], [15, 17]]) + [x0, y0]
        for q in range(4):
            aa[2 * q], aa[2 * q + 1] = (a, b_, c_), (a, c_, d_)
            z[2 * q:2 * q + 2] = 3.0 + 0.2 * q
        # Counter-clockwise: positive shoelace area, as the AA area expects.
        x, y = aa[..., 0], aa[..., 1]
        area2 = (x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0] + x[:, 1] * y[:, 2]
                 - x[:, 2] * y[:, 1] + x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2])
        aa[area2 < 0] = aa[area2 < 0][:, [0, 2, 1]]
        aa = aa.astype(np.float32)
        verts = ray_o[view] + np.stack([(aa[..., 0] - cx) / focal * z,
                                        (aa[..., 1] - cy) / focal * z, z], -1)
        rec = np.zeros((n, 32), np.float32)
        rec[:, 0:9] = verts.reshape(n, 9)
        rec[:, 9:18] = rng.uniform(size=(n, 9))
        rec[:, 18] = rng.uniform(0.02, 0.25, n)
        rec[:8, 18] = 0.95
        rec[:, 19] = rng.uniform(0.5, 1.0, n)
        rec[:, 20:23] = z / 10.0
        rec[:, 23:29] = aa.reshape(n, 6)
        order = np.argsort(z.mean(1), kind="stable")
        txmin, txmax = aa[..., 0].min(1), aa[..., 0].max(1)
        tymin, tymax = aa[..., 1].min(1), aa[..., 1].max(1)
        for ty in range(gy):
            for tx in range(gx):
                x0, y0 = patch_min[view, 0] + 16 * tx, patch_min[view, 1] + 16 * ty
                x1, y1 = min(x0 + 16, patch_min[view, 0] + pw), min(y0 + 16, patch_min[view, 1] + ph)
                # A pixel box [px0, px0 + 1] of the tile meets the bbox.
                meets = (txmin <= x1) & (txmax >= x0) & (tymin <= y1) & (tymax >= y0)
                ids = order[meets[order]]
                far = np.nonzero((txmin > x1 + 2) | (txmax < x0 - 2)
                                 | (tymin > y1 + 2) | (tymax < y0 - 2))[0]
                k = min(len(far), max(1, len(ids) // 8))
                ids = np.insert(ids, np.sort(rng.integers(0, len(ids) + 1, k)),
                                rng.choice(far, k, replace=False))
                touch += int(((txmin[ids] > x0) & (txmin[ids] <= x1)
                              & (txmin[ids] == np.round(txmin[ids]))
                              & (tymin[ids] <= y1) & (tymax[ids] >= y0)).sum())
                starts.append(sum(len(r) for r in recs))
                counts.append(len(ids))
                recs.append(rec[ids])

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    args = (t(np.concatenate(recs)), t(np.asarray(starts), torch.int32),
            t(np.asarray(counts), torch.int32), t(ray_o), t(ray_d),
            torch.tensor([0.1, 0.2, 0.3], device=dev), t(patch_min), pw, ph)
    return args, touch


def phase_stress(dev, sz: Sizes, report):
    """Both compositors against their plain versions on the stress scene
    (:func:`stress_scene`) at each tau: the forward bit for bit, the
    backward within its per-column tolerances and with identical bits on
    two runs. The scene must give a contributing prefix longer than a chunk
    whose length is not a multiple of the chunk or of the backward's entry
    group, and entries no pixel blends between entries that do."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        composite_forward, composite_forward_plain)

    args, touch = stress_scene(dev, sz)
    records, starts, counts = args[:3]
    b, (pw, ph) = sz.stress_views, sz.stress_window
    print(f"phase 2c: compositor stress scene, {b} views x {sz.stress_faces} faces "
          f"piled in a ragged {pw}x{ph} window: {records.shape[0]} entries over "
          f"{counts.numel()} tiles (longest list {int(counts.max())}); {touch} "
          "entries with a pixel box at px0 + 1 == txmin")
    if touch == 0:
        raise AssertionError("stress scene has no bbox touching a pixel box")
    rng = np.random.default_rng(sz.stress_seed + 1)
    cot = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
           for s in ((b, ph, pw, 3), (b, ph, pw), (b, ph, pw))]
    ragged = idle = stopped = 0
    for tau in sz.stress_taus:
        out = composite_forward(*args, tau)
        err = compare_composite(out, composite_forward_plain(*args, tau),
                                f"stress tau={tau}")
        report["composite_fwd"]["max_abs_err"] = max(report["composite_fwd"]["max_abs_err"], err)
        n_loop = torch.minimum(counts, out[5].clamp(min=0))
        ragged += int(((n_loop > 64) & (n_loop % 64 != 0) & (n_loop % 8 != 0)).sum())
        stopped += int((out[2] < 1e-4).sum())
        bwd_args = (*args[:3], out[5], *args[3:7], *out[:4], *cot, pw, ph, tau)
        grads = [composite_backward(*bwd_args) for _ in range(2)]
        work = {}
        plain = composite_backward_plain(*bwd_args, work=work)
        sync()
        err = compare_backward(grads[0], plain, f"stress tau={tau}")
        report["composite_bwd"]["max_abs_err"] = max(report["composite_bwd"]["max_abs_err"], err)
        if not torch.equal(grads[0], grads[1]):
            raise AssertionError(f"stress tau={tau}: composite_bwd differs between two runs")
        idle += int(work["records"]) - int(work["grad_records"])
        print(f"    prefixes min(count, nc_tile): {n_loop.tolist()}; entries of a "
              f"prefix no pixel blends: {int(work['records']) - int(work['grad_records'])} "
              f"of {int(work['records'])}; pixels that stop at T < 1e-4: "
              f"{int((out[2] < 1e-4).sum())}; composite_bwd identical bits on two runs")
    if ragged == 0 or idle == 0 or stopped == 0:
        raise AssertionError(f"stress scene misses a case: {ragged} ragged prefixes "
                             f"longer than a chunk, {idle} idle entries, {stopped} "
                             "stopped pixels")


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


def training_step(forward, params):
    """One training step: ``forward(params)``, then ``loss.backward()`` of
    ``color.sum() + depth.sum()`` into freshly cleared gradients."""
    for t in params.values():
        t.grad = None
    color, depth = forward(params)
    (color.sum() + depth.sum()).backward()


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
    record_launches(report, launches, TRAINING_KERNELS, "training step")
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
    print("  work these inputs need (plain versions' counts): forward "
          f"{ {k: int(v) for k, v in work.items()} }, backward "
          f"{ {k: int(v) for k, v in bwd_work.items()} }")

    # Determinism: the backward kernel again, twice, on the same inputs.
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import composite_backward
    bwd_args, bwd_out = calls["composite_backward"]
    same = all(torch.equal(bwd_out, composite_backward(*bwd_args)) for _ in range(2))
    print(f"  composite_bwd on the {main_label} inputs, three runs: identical bits {same}")
    if not same:
        raise AssertionError("composite_bwd is not deterministic")

    # A 256x256 window of the same scene, through the same forward.
    x0, y0, pw, ph = sz.patch
    with captured_kernel_calls() as patch_calls:
        renderer.forward([0], [[x0, y0]], pw, ph, *scene_args(s), 1.0)
    check_kernels(patch_calls, f"patch {pw}x{ph}", report)
    return renderer, s, forward, calls, work, bwd_work


def record_launches(report, launches, path_kernels, label):
    """Keep each path kernel's launch count; raise if one did not launch."""
    for name in path_kernels:
        report[name]["launches"] = launches[name]
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")


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
    step_ms, step_all = time_ms(lambda: training_step(forward, p), sz.reps, warmup=2)
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
    print(f"  pack_stream: {pack_ms:.3f} ms ({pack_bytes / pack_ms / 1e9:.3f} TB/s), "
          f"plain {pack_plain_ms:.3f} ms, index_select {lib_ms:.3f} ms, bound "
          f"{pack_bound:.3f} ms ({r_entries} records, {pack_bytes} bytes)")

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


def phase_device_busy(sz: Sizes, s, forward):
    """The card's busy time in the 1080p forward and training step under
    torch.profiler. Last of all: after the profiler has run, the host
    launches more slowly, which would move every timing taken after it."""
    print("phase 7: device busy time under torch.profiler (the profiler slows "
          "the host, so the share is a lower bound)")
    p = leaves_of(s)
    out = {}
    for key, fn in (("forward", lambda: forward(s)),
                    ("train_step", lambda: training_step(forward, p))):
        wall, busy = device_busy(fn)
        share = f"{busy / wall:.1%}" if busy > 0 else "not measured"
        print(f"  {key} {sz.width}x{sz.height}: {wall:.3f} ms per call, card busy "
              f"{busy:.3f} ms ({share})")
        out.update({f"{key}_profiled_ms": wall,
                    f"{key}_device_busy_ms": busy if busy > 0 else None})
    return out


def brute_force_layers(verts, faces, exist, ray_o, ray_d, num_layers, pixels):
    """The numpy oracle of tests/test_peel.py for the (y, x) ``pixels`` of
    one view: every existing face against the ray in float32, the first L
    hits by t (a stable sort: equal t in face-id order).

    Returns (layers (n, L) int32, counts (n,) int32, tie (n,) bool), ``tie``
    marking pixels where two of the first L + 1 hits share one t: there the
    peel's tie rule (one layer, the larger id, inside one 128-entry block)
    may order or merge them differently.
    """
    v = verts[faces].astype(np.float32)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    t0 = ray_o - v[:, 0]
    qv = np.cross(t0, e1)
    qe2 = (qv * e2).sum(1)
    n = len(pixels)
    layers = np.full((n, num_layers), -1, np.int32)
    counts = np.zeros(n, np.int32)
    tie = np.zeros(n, bool)
    for i, (y, x) in enumerate(pixels):
        rd = ray_d[y, x]
        pv = np.cross(np.broadcast_to(rd, e2.shape), e2)
        den = (pv * e1).sum(1)
        ok = den != 0
        inv = np.where(ok, 1.0 / np.where(ok, den, 1.0), 0.0).astype(np.float32)
        tt = (qe2 * inv).astype(np.float32)
        u = ((pv * t0).sum(1) * inv).astype(np.float32)
        vv = ((qv * rd).sum(1) * inv).astype(np.float32)
        hit = ok & (tt >= 0) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (exist > 0)
        ids = np.nonzero(hit)[0]
        order = ids[np.argsort(tt[ids], kind="stable")]
        layers[i, :min(len(order), num_layers)] = order[:num_layers]
        counts[i] = min(len(order), num_layers)
        ts = tt[order[:num_layers + 1]]
        tie[i] = len(np.unique(ts)) < len(ts)
    return layers, counts, tie


def ray_t(verts, faces, ray_o, rd, ids):
    """Moeller-Trumbore t of the ray ``rd`` with each face of ``ids``, in
    the float32 arithmetic of :func:`brute_force_layers`."""
    v = verts[faces[ids]].astype(np.float32)
    e1, e2, t0 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], ray_o - v[:, 0]
    pv = np.cross(np.broadcast_to(rd, e2.shape), e2)
    inv = (1.0 / (pv * e1).sum(1)).astype(np.float32)
    return ((np.cross(t0, e1) * e2).sum(1) * inv).astype(np.float32)


def compare_peel(kernel_out, plain_out, label, report, pixels=None):
    """Layers and counts of the peel kernel must equal its plain version's
    (on the ``pixels`` mask when given); raises otherwise."""
    (kl, kc), (pl_, pc) = kernel_out, plain_out
    if pixels is not None:
        kl, kc, pl_, pc = kl[pixels], kc[pixels], pl_[pixels], pc[pixels]
    bad_l = int((kl != pl_).any(dim=-1).sum())
    bad_c = int((kc != pc).sum())
    print(f"  {label}: peel vs plain on {kc.numel()} pixels: {bad_l} differ in "
          f"layers, {bad_c} in counts; max count {int(kc.max()) if kc.numel() else 0}")
    if bad_l or bad_c:
        raise AssertionError(f"{label}: peel kernel differs from its plain version")
    report["peel"]["max_abs_err"] = max(report["peel"]["max_abs_err"], 0.0)


def peel_generate(lr, idx, scene, num_layers, label, report,
                  may_truncate=False, work=None):
    """``LayeredRenderer.generate`` on the card, recording the peel
    wrapper's call, with the kernel's output held against its plain
    version on the same inputs (every tile; ``work`` is passed on to it).
    Raises on truncated binning unless ``may_truncate``. Returns (layers,
    counts, peel call)."""
    from dmesh2_renderer_tpu_torch import functional
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers_plain

    with captured_kernel_calls(functional, ("peel_layers",)) as calls:
        layers, counts = lr.generate(idx, *scene, num_layers)
    truncated = int(lr.last_aux[1])
    if truncated and not may_truncate:
        raise AssertionError(f"{label}: binning truncated {truncated} entries")
    args, out = calls["peel_layers"]
    compare_peel(out, peel_layers_plain(*args, work=work), f"{label} L={num_layers}",
                 report)
    return layers, counts, calls["peel_layers"]


def phase_layered_checks(dev, sz: Sizes, report):
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig
    from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, tet_grid

    print(f"phase 2b: peel kernel vs plain version, tet_grid({sz.peel_res}) at "
          f"{sz.peel_hw}^2 and tet_grid(2) at {sz.peel_small_frame} (ragged); "
          "layered renderer vs the numpy brute force")
    verts, tets, faces, face_tets, tet_faces = tet_grid(sz.peel_res)
    exist = np.ones(faces.shape[0], np.int32)
    mv, proj = orbit_cameras(1)
    lr = LayeredRenderer(mv, proj, sz.peel_hw, sz.peel_hw,
                         config=RasterConfig(binning_capacity=sz.peel_capacity))
    peel_generate(lr, [0], (verts, faces, tets, face_tets, tet_faces, exist), 8,
                  f"tet_grid({sz.peel_res}) {sz.peel_hw}^2", report, may_truncate=True)
    print(f"  (binning of that config: num_rendered={int(lr.last_aux[0])}, "
          f"num_truncated={int(lr.last_aux[1])})")

    verts, tets, faces, face_tets, tet_faces = tet_grid(2)
    exist = np.ones(faces.shape[0], np.int32)
    exist[::3] = 0
    mv, proj = orbit_cameras(2)
    w, h = sz.peel_small_frame
    lr = LayeredRenderer(mv, proj, w, h, config=RasterConfig(binning_capacity=1 << 13))
    scene = (verts, faces, tets, face_tets, tet_faces, exist)
    pixels = [(y, x) for y in range(h) for x in range(w)]
    ray_d = lr.ray_d.cpu().numpy()
    ray_o = lr.ray_o[:, 0, 0].cpu().numpy()
    for num_layers in sz.peel_small_layers:
        layers, counts, _ = peel_generate(lr, [0, 1], scene, num_layers,
                                          f"tet_grid(2) {w}x{h}", report)
        layers, counts = layers.cpu().numpy(), counts.cpu().numpy()
        for view in range(2):
            ref_l, ref_c, _ = brute_force_layers(verts, faces, exist, ray_o[view],
                                                 ray_d[view], num_layers, pixels)
            bad = ((layers[view].reshape(-1, num_layers) != ref_l).any(axis=1)
                   | (counts[view].reshape(-1) != ref_c))
            print(f"  LayeredRenderer vs brute force, L={num_layers}, view {view}: "
                  f"{int(bad.sum())} of {bad.size} pixels differ")
            if not bad.mean() < 0.01 or counts.max() == 0:
                raise AssertionError("LayeredRenderer differs from the brute force")


def phase_peel_adversarial(dev, sz: Sizes, report):
    """The peel kernel against its plain version, every tile, on views that
    stress the skip rule: eyes inside the grid and on
    its planes (faces edge-on, grazing rays, faces across the camera plane),
    a ragged frame, 1, 8 and 16 layers, and rays scaled off unit length."""
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers, peel_layers_plain
    from dmesh2_renderer_tpu_torch.utils.meshes import look_at, perspective, tet_grid

    w, h = sz.adv_frame
    step = 2.4 / sz.adv_res
    # Inside, on the planes x, y and z of grid lines 7, 4 and 6; inside, off
    # every plane; outside, on the planes y and z of lines 8 and 6, looking
    # along both.
    eyes = ((-1.2 + 7 * step, -1.2 + 4 * step, -1.2 + 6 * step),
            (-0.47, 0.31, 0.13), (2.5, -1.2 + 8 * step, -1.2 + 6 * step))
    targets = ((1.0, 0.3, -0.7), (-1.0, -0.2, 0.9), (0.0, -1.2 + 8 * step, 0.0))
    verts, tets, faces, face_tets, tet_faces = tet_grid(sz.adv_res)
    exist = (np.random.default_rng(5).uniform(size=faces.shape[0]) < 0.5).astype(np.int32)
    mv = np.stack([look_at(e, c) for e, c in zip(eyes, targets)])
    proj = np.stack([perspective(70.0, w / h)] * len(eyes))
    print(f"phase 2d: peel kernel vs plain version on every tile, adversarial "
          f"views of tet_grid({sz.adv_res}) ({faces.shape[0]} faces, "
          f"{int(exist.sum())} existing), ragged {w}x{h}, L in {sz.adv_layers}")
    lr = LayeredRenderer(mv, proj, w, h, config=RasterConfig(
        binning_capacity=sz.adv_capacity, max_tiles_per_face=64,
        num_giant_faces=4096))
    scene = (verts, faces, tets, face_tets, tet_faces, exist)
    idx = list(range(len(eyes)))
    for num_layers in sz.adv_layers:
        work = {}
        _, counts, call = peel_generate(lr, idx, scene, num_layers, "adversarial",
                                        report, may_truncate=True, work=work)
        print(f"    binning num_rendered={int(lr.last_aux[0])} num_truncated="
              f"{int(lr.last_aux[1])}; pixels with a layer {int((counts > 0).sum())}; "
              f"plain version's work {({k: int(v) for k, v in work.items()})}")
        if int(counts.max()) < min(num_layers, 2):
            raise AssertionError("adversarial scene gives too few layers")
    args = list(call[0])
    for scale in sz.adv_ray_scales:
        args[7] = call[0][7] * scale
        compare_peel(peel_layers(*args), peel_layers_plain(*args),
                     f"adversarial L={num_layers}, rays x {scale}", report)


def layered_scene(sz: Sizes):
    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, tet_grid

    verts, tets, faces, face_tets, tet_faces = tet_grid(sz.layered_res)
    exist = (np.random.default_rng(3).uniform(size=faces.shape[0])
             < sz.layered_exist_frac).astype(np.int32)
    mv, proj = orbit_cameras(sz.layered_views)
    config = RasterConfig(binning_capacity=sz.layered_capacity,
                          max_tiles_per_face=sz.layered_max_tiles,
                          num_giant_faces=sz.layered_giant_faces,
                          giant_tiles=sz.layered_giant_tiles)
    return (verts, faces, tets, face_tets, tet_faces, exist), mv, proj, config


def phase_layered_main(dev, sz: Sizes, report, kernels):
    """The layered main path: one LayeredRenderer.generate at full size."""
    from dmesh2_renderer_tpu_torch import LayeredRenderer
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers, peel_layers_plain

    scene, mv, proj, config = layered_scene(sz)
    verts, faces, exist = scene[0], scene[1], scene[5]
    n_views, w, h, n_layers = sz.layered_views, sz.width, sz.height, sz.layered_layers
    print(f"phase 5: layered main path, LayeredRenderer.generate on "
          f"tet_grid({sz.layered_res}) ({verts.shape[0]} vertices, "
          f"{faces.shape[0]} faces, {int(exist.sum())} existing), {n_views} views at "
          f"{w}x{h}, {n_layers} layers")
    lr = LayeredRenderer(mv, proj, w, h, config=config)
    idx = list(range(n_views))
    scene_t = tuple(torch.as_tensor(x, device=dev) for x in scene)
    sync()
    for k in kernels:
        k.launches = 0
    layers, counts, peel_call = peel_generate(lr, idx, scene_t, n_layers,
                                              f"main {w}x{h}", report)
    sync()
    launches = {k.name: k.launches for k in kernels}
    nr, nt = (int(x) for x in lr.last_aux)
    print(f"  launches on the layered path: {launches}")
    print(f"  aux: num_rendered={nr} num_truncated={nt}")
    record_launches(report, launches, LAYERED_KERNELS, "layered")
    if tuple(layers.shape) != (n_views, h, w, n_layers) or nt != 0:
        raise AssertionError(f"layered output {tuple(layers.shape)}, truncated {nt}")
    cmax = int(counts.max())
    exist_t = torch.as_tensor(exist, device=dev)
    slot = torch.arange(n_layers, device=dev)
    ids_ok = torch.where(layers >= 0, exist_t[layers.clamp(min=0).long()] > 0,
                         layers == -1).all()
    prefix_ok = ((layers >= 0) == (slot < counts[..., None])).all()
    covered = int((counts > 0).sum())
    print(f"  counts.max() {cmax}; pixels with a layer {covered} of {counts.numel()}; "
          f"ids existing or -1: {bool(ids_ok)}; layers a -1-padded prefix: {bool(prefix_ok)}")
    if cmax != n_layers or not bool(ids_ok) or not bool(prefix_ok):
        raise AssertionError("layered output fails its contract")

    # Sampled pixels vs the numpy brute force on the port's own rays, and
    # the t of their layers recomputed: non-decreasing.
    rng = np.random.default_rng(11)
    cnt_np = counts.cpu().numpy()
    hit_pix = np.argwhere(cnt_np > 0)
    sample = hit_pix[rng.choice(len(hit_pix), sz.layered_pixels, replace=False)]
    sample = np.concatenate([sample, np.stack([
        rng.integers(0, n_views, 8), rng.integers(0, h, 8), rng.integers(0, w, 8)], 1)])
    lay_np = layers.cpu().numpy()
    ray_o = lr.ray_o[:, 0, 0].cpu().numpy()
    ties = bad = 0
    for view in range(n_views):
        pix = sample[sample[:, 0] == view][:, 1:]
        ray_d = lr.ray_d[view][tuple(torch.as_tensor(pix.T, device=dev))].cpu().numpy()
        ref_l, ref_c, tie = brute_force_layers(
            verts, faces, exist, ray_o[view], ray_d[:, None, :], n_layers,
            [(i, 0) for i in range(len(pix))])
        for i, (y, x) in enumerate(pix):
            got = lay_np[view, y, x]
            if not (np.array_equal(got, ref_l[i]) and cnt_np[view, y, x] == ref_c[i]):
                ties += int(tie[i])
                bad += int(not tie[i])
            ids = got[got >= 0]
            if len(ids) and not (np.diff(ray_t(verts, faces, ray_o[view], ray_d[i],
                                               ids)) >= 0).all():
                raise AssertionError(f"layers of pixel {(view, y, x)} are not in t order")
    print(f"  {len(sample)} sampled pixels vs the brute force: {bad} differ, "
          f"{ties} more differ at an exact t tie; layer t non-decreasing")
    if bad:
        raise AssertionError("layered output differs from the brute force")

    # The kernel vs its plain version on every sz.layered_tile_stride-th
    # tile, and the kernel restricted to those tiles vs its full run.
    args = peel_call[0]
    n_tiles = args[4].shape[0]
    tiles = torch.arange(0, n_tiles, sz.layered_tile_stride, dtype=torch.int32,
                         device=dev)
    mask = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    mask[tiles.long()] = True
    gx, gy = -(-w // 16), -(-h // 16)
    mask = (mask.reshape(n_views, gy, gx).repeat_interleave(16, 1)
            .repeat_interleave(16, 2)[:, :h, :w])
    plain = peel_layers_plain(*args, tiles=tiles)
    compare_peel(peel_call[1], plain, f"main {w}x{h}, {tiles.numel()} sampled tiles",
                 report, pixels=mask)
    sub = peel_layers(*args, tiles=tiles)
    compare_peel(sub, plain, f"main {w}x{h}, kernel on the sampled tiles only",
                 report)
    return lr, scene_t, idx, peel_call, tiles


def peel_bound(args, work, n_slots):
    """Least time for the peel of these inputs (``work`` from the plain
    version): entry_bf of every walked entry, the face tables, the tile
    ranges and rays read once, layers and counts written once; against the
    per-entry, per-pair and per-hit float operations of csrc/peel.cu. Two
    bounds: the full scan (every pair, the JAX kernel's work) and the work
    left after the kernel's skip rule (the skip bound per entry, one
    comparison per skipped pair).

    Returns (full-scan ms, its limit, after-skip ms, its limit, counts)."""
    from dmesh2_renderer_tpu_torch.ops.peel import (
        OPS_PER_ENTRY, OPS_PER_ENTRY_BOUND, OPS_PER_HIT_SLOT, OPS_PER_PAIR,
        OPS_PER_SKIPPED_PAIR)

    _, faces, verts, exist, starts, counts, ray_o, ray_d, _, _, n_layers = args
    w = {k: int(v) for k, v in work.items()}
    n_pix = ray_d.numel() // 3
    nbytes = (int(counts.sum()) * 4 + faces.numel() * 4 + verts.numel() * 4
              + exist.numel() * 4 + (starts.numel() + counts.numel()) * 4
              + ray_o.numel() * 4 + ray_d.numel() * 4 + n_pix * (n_layers + 1) * 4)
    hit_ops = w["hits"] * OPS_PER_HIT_SLOT * n_slots
    ops = w["entries"] * OPS_PER_ENTRY + w["pairs"] * OPS_PER_PAIR + hit_ops
    ops_left = (w["entries"] * (OPS_PER_ENTRY + OPS_PER_ENTRY_BOUND)
                + (w["pairs"] - w["skipped"]) * OPS_PER_PAIR
                + w["skipped"] * OPS_PER_SKIPPED_PAIR + hit_ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3

    def bound(n_ops):
        t_ops = n_ops / FP32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    return (*bound(ops), *bound(ops_left),
            dict(w, bytes=nbytes, ops=ops, ops_after_skip=ops_left))


def phase_layered_timing(dev, sz: Sizes, report, lr, scene, idx, peel_call, tiles):
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops.binning import bin_faces
    from dmesh2_renderer_tpu_torch.ops.peel import (
        pack_peel_stream, peel_instance, peel_layers, peel_layers_plain)
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01

    w, h, n_layers = sz.width, sz.height, sz.layered_layers
    n_pix = len(idx) * w * h
    print(f"phase 6: layered timing (median of {sz.reps} after warm-up)")
    gen_ms, gen_all = time_ms(lambda: lr.generate(idx, *scene, n_layers), sz.reps,
                              warmup=2)
    mpix = n_pix / (gen_ms * 1e3)
    print(f"  LayeredRenderer.generate, {len(idx)} views at {w}x{h}, L={n_layers}: "
          f"{gen_ms:.3f} ms ({mpix:.2f} Mpix/s); runs {[round(t, 3) for t in gen_all]}")

    args = peel_call[0]
    entry_bf, faces, verts, exist = args[:4]
    peel_ms, _ = time_ms(lambda: peel_layers(*args), sz.reps)
    sub_ms, _ = time_ms(lambda: peel_layers(*args, tiles=tiles), sz.reps)
    sub_plain_ms, _ = time_ms(lambda: peel_layers_plain(*args, tiles=tiles), 1)
    plain_ms, _ = time_ms(lambda: peel_layers_plain(*args), 1, warmup=0)
    work = {}
    plain_full = peel_layers_plain(*args, work=work)
    compare_peel(peel_call[1], plain_full, f"main {w}x{h}, every tile", report)
    bound, bound_by, left, left_by, peel_work = peel_bound(args, work,
                                                           peel_instance(n_layers))
    report["peel"].update(ms=peel_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by, library_ms=None)
    pairs, hits = peel_work["pairs"], peel_work["hits"]
    print(f"  peel: {peel_ms:.3f} ms, plain {plain_ms:.3f} ms, full-scan bound "
          f"{bound:.3f} ms ({bound_by}), after-skip bound {left:.3f} ms ({left_by}); "
          f"skipped {peel_work['skipped'] / pairs:.1%} of {pairs} pairs, gated "
          f"{peel_work['gated'] / hits:.1%} of {hits} hits ({peel_work}); on the "
          f"{tiles.numel()} sampled tiles: kernel {sub_ms:.3f} ms, plain "
          f"{sub_plain_ms:.3f} ms")

    # Where generate's time goes: each stage at the main path's inputs.
    b_mv, b_proj = lr.mv[idx], lr.proj[idx]
    vndc, vimg = G.compute_verts_ndc_image(verts, b_mv, b_proj, w, h)
    tris = G.face_aa_verts_ccw(vimg, faces)
    _, min_depth, _, alive = face_depth01(vndc, faces)
    config = lr.config
    pm = torch.zeros((len(idx), 2), dtype=torch.int32, device=dev)

    def binning():
        return bin_faces(tris, min_depth, alive, pm, w, h, config.binning_capacity,
                         config.max_tiles_per_face,
                         num_giant_faces=config.num_giant_faces,
                         giant_tiles=config.giant_tiles)

    stages = {
        "project_triangles": time_ms(lambda: G.face_aa_verts_ccw(
            G.compute_verts_ndc_image(verts, b_mv, b_proj, w, h)[1], faces), sz.reps)[0],
        "depth_cull": time_ms(lambda: face_depth01(vndc, faces), sz.reps)[0],
        "bin_faces": time_ms(binning, sz.reps)[0],
        "peel": peel_ms,
    }
    stages["rest_of_generate"] = gen_ms - sum(stages.values())
    pack_ms, _ = time_ms(lambda: pack_peel_stream(entry_bf, verts, faces, exist),
                         sz.reps)
    print("  stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"  [the peel gathers its face records inside the kernel; the plain "
          f"version's (R, 16) table, pack_peel_stream, would take {pack_ms:.3f} ms]")
    return dict(generate_ms=gen_ms, generate_runs_ms=gen_all, generate_mpix_per_s=mpix,
                layered_stages_ms=stages, peel_pack_ms=pack_ms, peel_work=peel_work,
                peel_bound_after_skip_ms=left,
                peel_sampled_tiles=tiles.numel(), peel_sampled_ms=sub_ms,
                peel_sampled_plain_ms=sub_plain_ms)


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
    resources = {k.name: k.occupancy() for k in _kernels.KERNELS}
    for name, occ in resources.items():
        print(f"  {name}: {occ}")

    root = os.path.dirname(os.path.abspath(__file__))
    report = {k.name: dict(name=k.name, route="cuda",
                           source=os.path.relpath(k.source, root),
                           replaces=REPLACES[k.name], launches=0, max_abs_err=0.0)
              for k in _kernels.KERNELS}
    phase_kernel_checks(dev, sz, report)
    phase_layered_checks(dev, sz, report)
    phase_peel_adversarial(dev, sz, report)
    phase_stress(dev, sz, report)
    renderer, s, forward, calls, work, bwd_work = phase_main_path(
        dev, sz, report, _kernels.KERNELS)
    losses = phase_training(dev, sz, renderer, s, forward)
    timings = phase_timing(dev, sz, report, renderer, s, forward, calls, work,
                           bwd_work)
    timings.update(adam_losses=losses)
    # The layered path after the renderer's timings, which then run in the
    # state they ran in before the layered path existed.
    layered = phase_layered_main(dev, sz, report, _kernels.KERNELS)
    timings.update(phase_layered_timing(dev, sz, report, *layered))
    timings.update(phase_device_busy(sz, s, forward))

    kernels_line = {"kernels": [report[k.name] for k in _kernels.KERNELS]}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, torch=torch.__version__, build_s=build_s,
                       resources=resources, timings=timings, **kernels_line),
                  fh, indent=1)
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
