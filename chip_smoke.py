#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dmesh2_renderer_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Build every CUDA kernel from ``dmesh2_renderer_tpu_torch/csrc`` (one nvcc
   per source, all at once) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, on the
   inputs ``Renderer.forward`` gives it (recorded as it calls the kernel
   wrappers): icosphere(3), 4 views at 512x512 through one ragged patch
   window, tau 1 and 0. ``pack_stream`` must equal its plain version
   exactly; ``composite_fwd`` must agree within 1e-5 on colour, depth,
   final_t and prev_t, with at most 1e-4 of pixels (and of tiles) differing
   in n_contrib (nc_tile). The whole Renderer on the card is also held
   against the plain reference compositor (``use_pallas=False``) on a small
   scene.
3. The main path at full size: ``Renderer.forward`` on the 1M-triangle
   soup at 1920x1080 (the JAX package's headline scene), with every kernel
   launch count set to 0 just before and read just after; every kernel must
   have launched. The output must be finite, drop no entries and cover
   pixels. Both kernels' outputs of that run, and of a 256x256 window of the
   same scene, are held against their plain versions as in phase 2.
4. Timing with CUDA events (median of repeated runs after warm-up): the
   1080p forward, each kernel on the main path's own inputs beside its
   plain version and its bound (the compositor's from the work its plain
   version counts on those inputs), the ``index_select`` yardstick of the
   record pack, and every stage of the forward (projection, depth/cull,
   binning and its sort, pack, composite).

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
}

KERNEL_TOL = 1e-5          # colour, depth, final_t, prev_t: kernel vs plain
COUNT_MISMATCH_FRAC = 1e-4  # n_contrib / nc_tile mismatches allowed


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
    main path calls it (``pack_stream`` and ``composite_forward``, looked up
    in ``ops/rasterize.py``), so that the checks and the timings run on
    exactly what ``Renderer.forward`` fed the kernels.

    Yields a dict: wrapper name -> (positional args, result) of its last call.
    """
    from dmesh2_renderer_tpu_torch.ops import rasterize

    calls = {}
    originals = {name: getattr(rasterize, name)
                 for name in ("pack_stream", "composite_forward")}

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls[name] = (args, out)
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


def phase_kernel_checks(dev, sz: Sizes, report):
    from dmesh2_renderer_tpu_torch import RasterConfig, Renderer
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

    print(f"phase 2: kernels vs plain versions, icosphere({sz.check_subdiv}), "
          f"{sz.check_views} views, {sz.check_res}^2, window {sz.check_window}")
    rng = np.random.default_rng(0)
    verts, faces = icosphere(sz.check_subdiv)
    mv, proj = orbit_cameras(sz.check_views)
    s = scene_tensors(verts, faces, sz.check_views, rng, dev)
    x0, y0, pw, ph = sz.check_window
    renderer = Renderer(mv, proj, sz.check_res, sz.check_res,
                        config=RasterConfig(binning_capacity=1 << 16))
    for tau in (1.0, 0.0):
        with captured_kernel_calls() as calls:
            renderer.forward(list(range(sz.check_views)), [[x0, y0]] * sz.check_views,
                             pw, ph, *scene_args(s), aa_temperature=tau)
        if int(renderer.last_aux.num_truncated):
            raise AssertionError("phase 2 binning truncated entries")
        check_kernels(calls, "check", report)

    # The whole Renderer on the card vs the plain reference compositor.
    verts, faces = icosphere(sz.small_subdiv)
    mv2, proj2 = orbit_cameras(2)
    s = scene_tensors(verts, faces, 2, rng, dev)
    res = sz.small_res
    out = {}
    for use_pallas in (True, False):
        r = Renderer(mv2, proj2, res, res, config=RasterConfig(use_pallas=use_pallas))
        out[use_pallas] = r.forward([0, 1], [[0, 0], [8, 24]], res - 24, res - 40,
                                    *scene_args(s), aa_temperature=1.0)
    err = max(float((a - b).abs().max()) for a, b in zip(out[True], out[False]))
    print(f"  Renderer (kernels) vs Renderer(use_pallas=False): max|err| {err:.3g}")
    if not err <= 2e-5:
        raise AssertionError(f"Renderer vs reference compositor: {err}")


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


def phase_main_path(dev, sz: Sizes, report, kernels):
    from dmesh2_renderer_tpu_torch import Renderer

    print(f"phase 3: main path, Renderer.forward, {sz.n_faces} faces at "
          f"{sz.width}x{sz.height}")
    s, mv, proj, config = headline_scene(dev, sz)
    renderer = Renderer(mv, proj, sz.width, sz.height, config=config)
    fwd_args = ([0], [[0, 0]], sz.width, sz.height, *scene_args(s), 1.0)
    sync()
    for k in kernels:
        k.launches = 0
    with captured_kernel_calls() as calls:
        color, depth = renderer.forward(*fwd_args)
    sync()
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

    # The kernels' outputs of that run vs their plain versions on the card,
    # counting the compositing work these inputs need for its bound.
    work = {}
    check_kernels(calls, f"main {sz.width}x{sz.height}", report, work=work)

    # A 256x256 window of the same scene, through the same path.
    x0, y0, pw, ph = sz.patch
    with captured_kernel_calls() as patch_calls:
        renderer.forward([0], [[x0, y0]], pw, ph, *scene_args(s), 1.0)
    check_kernels(patch_calls, f"patch {pw}x{ph}", report)
    return renderer, fwd_args, calls, work


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


def phase_timing(dev, sz: Sizes, report, renderer, fwd_args, calls, work):
    from dmesh2_renderer_tpu_torch.ops.binning import (
        bin_faces, emission_keys, pack_stream, pack_stream_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        composite_forward, composite_forward_plain)
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
    from dmesh2_renderer_tpu_torch import geometry as G

    print(f"phase 4: timing (median of {sz.reps} after warm-up; plain versions "
          f"median of {sz.plain_reps})")
    fwd_ms, fwd_all = time_ms(lambda: renderer.forward(*fwd_args), sz.reps, warmup=2)
    mpix = sz.width * sz.height / (fwd_ms * 1e3)
    print(f"  forward {sz.width}x{sz.height}: {fwd_ms:.3f} ms  ({mpix:.2f} Mpix/s); "
          f"runs {[round(t, 3) for t in fwd_all]}")
    timings = dict(forward_ms=fwd_ms, forward_runs_ms=fwd_all, mpix_per_s=mpix)

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
    main_state = phase_main_path(dev, sz, report, _kernels.KERNELS)
    timings = phase_timing(dev, sz, report, *main_state)

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
