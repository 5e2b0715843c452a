"""Observability of the render pipeline: profiler ranges, host-sync counts
and per-stage timing.

The pipeline's stages have one set of names, used both as the keys of
:func:`profile_render` and as the names of the profiler ranges that
:func:`span` opens inside the entry points: ``prep`` (the screen-space
stage ``geometry.project_faces``, ``face_depth01``, the ray selection and
the camera gathers), ``binning`` (``bin_faces``), ``pack``
(``pack_stream``), ``fwd_kernel`` (``composite_forward``), ``bwd_kernel``
(``composite_backward``), ``scatter`` (``reduce_entry_grads``) and, in the
depth peel, ``peel`` (``peel_layers``). Around them are the roots
``render`` (``Renderer.forward``, ``functional.render_partial`` and
``render_partial_unchecked``, around their shared body
``functional.render_stages``), ``generate`` (``LayeredRenderer.generate``,
``functional.generate_layers``, ``peel_pipeline``) and ``backward`` (the autograd backward, on autograd's
thread), and ``validate`` (argument checks and the valence cache). The
training step (``train.Trainer.step``) is the root ``train_step``: beneath
it the render's and the backward's ranges, ``loss`` (the mean squared
error), ``optimizer`` (the optimizer's step) and ``stats`` (the capacity
check, whose read is the host-sync site ``render_stats``);
``Renderer.forward`` opens ``stats`` around its own capacity check (site
``overflow_check``).

:func:`span` costs one global read while no ``torch.profiler`` records;
under one it opens ``record_function("dmesh2/<name>")``, so the ranges sit
on the profiler's own clock beside the CUDA activity it traces. There is no
switch: a profile of any caller shows them. :func:`host_sync` marks each
point where the host waits for the device; it counts every pass in a plain
dict, profiler or not, and under a profiler opens ``dmesh2/sync/<site>``.
:func:`count_entries` adds a checked render's entry counts (``binned``, the
binning's rect slots; ``blended``, those in some tile's contributing
prefix; ``truncated``), as ``utils/validate.py::check_render_stats`` reads
them. :func:`counters` reads those counts with the kernels' launch counts.

:func:`profile_render`, a port of ``dmesh2_renderer_tpu/utils/profiling.py``,
runs every stage in isolation on the caller's actual scene, each through the
port's own function for that stage, and returns a stage -> milliseconds
mapping, cross-checked against the end-to-end forward and training-step
times so that unattributed overhead (host work, launches, autograd
bookkeeping) is visible. On the card each stage is timed with CUDA events
around ``iters`` calls after one warm-up call; on the CPU with the host
clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler

from dmesh2_renderer_tpu_torch.ops import _kernels

_NULL = contextlib.nullcontext()
# Passes through each host-sync site, by site.
_syncs = defaultdict(int)
# Entries of the renders whose capacity counters were read.
ENTRY_KINDS = ("binned", "blended", "truncated")
_entries = dict.fromkeys(ENTRY_KINDS, 0)


def span(name: str):
    """The profiler range ``dmesh2/<name>`` while a ``torch.profiler``
    records; otherwise a shared context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _autograd_profiler.record_function("dmesh2/" + name)


def host_sync(site: str):
    """Count one pass through the host-sync site ``site`` (the host waits
    for the device there); under a profiler, also the range
    ``dmesh2/sync/<site>``."""
    _syncs[site] += 1
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _autograd_profiler.record_function("dmesh2/sync/" + site)


def count_entries(binned: int, blended: int, truncated: int) -> None:
    """Add one render's entry counts to ``counters()["entries"]``."""
    for kind, n in zip(ENTRY_KINDS, (binned, blended, truncated)):
        _entries[kind] += int(n)


def counters() -> dict:
    """``{"syncs": {site: passes}, "launches": {kernel: launches},
    "entries": {"binned": n, "blended": n, "truncated": n}}``: the host-sync
    counts, every kernel's ``launches`` and the entries of the renders whose
    capacity counters ``check_render_stats`` read (every ``Trainer.step``
    and ``Renderer.forward`` with ``warn_on_overflow``, the default), since
    the process started or the last :func:`reset_counters`."""
    return {"syncs": dict(_syncs),
            "launches": {k.name: k.launches for k in _kernels.COUNTED},
            "entries": dict(_entries)}


def reset_counters() -> None:
    """Zero the host-sync, the launch and the entry counts."""
    _syncs.clear()
    for k in _kernels.COUNTED:
        k.launches = 0
    for kind in ENTRY_KINDS:
        _entries[kind] = 0


def time_fn(fn: Callable, *args, iters: int = 5) -> tuple:
    """Call ``fn(*args)`` once to warm up, then time ``iters`` calls.

    The device is that of the first tensor argument (the CPU when there is
    none). Returns (output of the last call, milliseconds per call).
    """
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return out, (time.perf_counter() - t0) / iters * 1e3


def profile_render(
    verts,           # (P, 3)
    faces,           # (F, 3) int
    verts_color,     # (P, 3)
    faces_opacity,   # (F,)
    faces_intense,   # (B, F)
    mv,              # (B, 4, 4)
    proj,            # (B, 4, 4)
    background,      # (3,)
    width: int,
    height: int,
    aa_temperature: float = 1.0,
    config=None,
    iters: int = 5,
    verbose: bool = False,
    device=None,
):
    """Time every pipeline stage of a full-frame render on this scene.

    Stages, each the port's own function: ``prep`` (the screen-space stage
    ``geometry.project_faces``, which the render body runs, and the
    depth/cull of ``ops/rasterize.build_stream``),
    ``binning`` (``binning.bin_faces``), ``pack`` (``binning.pack_stream``),
    ``fwd_kernel`` (``composite_forward``), ``bwd_kernel``
    (``composite_backward`` with unit colour and depth cotangents) and
    ``scatter`` (``reduce_entry_grads``).

    Returns a dict with those per-stage milliseconds (``stages_ms``), the
    end-to-end forward (``e2e_fwd_ms``, ``functional.render``) and forward
    plus backward (``e2e_ms``, autograd of ``color.sum() + depth.sum()``)
    times, the unattributed remainder ``e2e_ms - sum(stages)``, and the
    binning counters (``num_rendered``, ``num_truncated``, ``num_binned``
    entries in the stream, ``num_contributing`` entries in some tile's
    contributing prefix). Runs on the card unless ``device`` says otherwise.
    """
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.functional import render
    from dmesh2_renderer_tpu_torch.ops import reference as ref_ops
    from dmesh2_renderer_tpu_torch.ops.binning import bin_faces, pack_stream
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, reduce_entry_grads,
    )
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
    from dmesh2_renderer_tpu_torch.ops.rasterize import build_stream
    from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
    from dmesh2_renderer_tpu_torch.utils.validate import resolve_device

    cfg = config or RasterConfig()
    tau = float(aa_temperature)
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    verts, verts_color, faces_opacity, faces_intense, mv, proj, background = (
        f32(x) for x in (verts, verts_color, faces_opacity, faces_intense, mv,
                         proj, background))
    faces = torch.as_tensor(faces, dtype=torch.int32, device=dev).contiguous()
    b = mv.shape[0]
    pm = torch.zeros((b, 2), dtype=torch.int32, device=dev)

    def say(name, ms):
        if verbose:
            print(f"{name:42s} {ms:9.3f} ms", flush=True)

    def prep(verts):
        verts_ndc, aa_verts = G.project_faces(verts, faces, mv, proj, width,
                                              height)
        depth01, _, _, alive = ref_ops.face_depth01(verts_ndc, faces)
        return verts_ndc, aa_verts, depth01, alive

    (verts_ndc, aa_verts, depth01, alive), t_prep = time_fn(prep, verts, iters=iters)
    say("geometry preprocess", t_prep)

    ray_o, ray_d = G.init_rays(mv, proj, width, height)
    ray_o_cam = ray_o[:, 0, 0, :].contiguous()

    binning, t_bin = time_fn(
        lambda aav, d, al: bin_faces(
            aav, d, al, pm, width, height, cfg.binning_capacity,
            cfg.max_tiles_per_face, num_giant_faces=cfg.num_giant_faces,
            giant_tiles=cfg.giant_tiles, exact_tile_cull=cfg.exact_tile_cull),
        aa_verts, depth01, alive, iters=iters)
    say("bin_faces", t_bin)

    records, t_pack = time_fn(
        lambda e: pack_stream(e, faces, verts, verts_color, verts_ndc,
                              faces_opacity, faces_intense, aa_verts),
        binning.entry_bf, iters=iters)
    say("pack_stream", t_pack)
    # The forward's own stream build gives the same stream.
    binning2, records2 = build_stream(
        verts, verts_color, faces_opacity, verts_ndc, faces_intense, aa_verts,
        faces, pm, width, height, cfg)
    if not (torch.equal(binning2.entry_bf, binning.entry_bf)
            and torch.equal(records2, records)):
        raise AssertionError("profiled stages disagree with build_stream")

    fwd_out, t_fwd = time_fn(
        lambda s, st, ct: composite_forward(s, st, ct, ray_o_cam, ray_d,
                                            background, pm, width, height, tau),
        records, binning.tile_starts, binning.tile_counts, iters=iters)
    color, depth, final_t, prev_t, _, nc_tile = fwd_out
    say("composite_forward", t_fwd)

    n_contributing = int(torch.minimum(binning.tile_counts,
                                       nc_tile.clamp(min=0)).sum())
    say("contributing entries", float(n_contributing))

    g_color = torch.ones_like(color)
    g_depth = torch.ones_like(depth)
    grad_records, t_bwd = time_fn(
        lambda s, st, ct, nc: composite_backward(
            s, st, ct, nc, ray_o_cam, ray_d, background, pm, color, depth,
            final_t, prev_t, g_color, g_depth, torch.zeros_like(g_depth),
            width, height, tau),
        records, binning.tile_starts, binning.tile_counts, nc_tile, iters=iters)
    say("composite_backward", t_bwd)

    _, t_scatter = time_fn(
        lambda gr, e, st, ct, nc: reduce_entry_grads(gr, e, st, ct, nc, faces,
                                                     verts.shape[0], b),
        grad_records, binning.entry_bf, binning.tile_starts, binning.tile_counts,
        nc_tile, iters=iters)
    say("reduce_entry_grads", t_scatter)

    def forward(verts, verts_color, faces_opacity, faces_intense):
        c, d, _ = render(verts, faces, verts_color, faces_opacity, faces_intense,
                         mv, proj, background, width, height, tau, cfg, device=dev)
        return c.sum() + d.sum()

    params = [t.detach().clone().requires_grad_(True)
              for t in (verts, verts_color, faces_opacity, faces_intense)]
    with torch.no_grad():
        _, t_e2e_fwd = time_fn(forward, *params, iters=iters)
    say("e2e forward", t_e2e_fwd)
    _, t_e2e = time_fn(lambda *p: torch.autograd.grad(forward(*p), p), *params,
                       iters=iters)
    say("e2e fwd+bwd", t_e2e)

    stages = {
        "prep": t_prep, "binning": t_bin, "pack": t_pack,
        "fwd_kernel": t_fwd, "bwd_kernel": t_bwd, "scatter": t_scatter,
    }
    return {
        "stages_ms": stages,
        "e2e_fwd_ms": t_e2e_fwd,
        "e2e_ms": t_e2e,
        "unattributed_ms": t_e2e - sum(stages.values()),
        "num_rendered": int(binning.num_rendered),
        "num_truncated": int(binning.num_truncated),
        # Entries in the sorted stream (after Kt, the giant tier and the
        # cull, at most the capacity): what binning_capacity must cover.
        "num_binned": int(binning.tile_counts.sum()),
        "num_contributing": n_contributing,
    }
