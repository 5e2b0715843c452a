"""End-to-end DMesh++-style inverse rendering (BASELINE.md config 5).

Port of ``examples/fit_mesh.py``. Optimizes vertex positions, colors, and
opacities of an icosphere to match target renders of a displaced "bumpy"
target shape from 16 orbit cameras, views split over the ranks of the
``torch.distributed`` world (a world of one unless the caller initialised
a process group before calling :func:`main`). Demonstrates the full
training stack: functional render -> averaged grads -> torch.optim.Adam ->
checkpoint/resume. Runs on the card unless ``--device cpu``.

Run: python -m dmesh2_renderer_tpu_torch.examples.fit_mesh [--steps 200]
     [--size 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from dmesh2_renderer_tpu_torch import suggest_config
from dmesh2_renderer_tpu_torch.functional import render
from dmesh2_renderer_tpu_torch.ops.binning import tile_grid_size
from dmesh2_renderer_tpu_torch.parallel import SceneParams, make_mesh, make_view_mesh
from dmesh2_renderer_tpu_torch.train import Trainer, save_checkpoint
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras
from dmesh2_renderer_tpu_torch.utils.validate import resolve_device


class Fit(NamedTuple):
    """What :func:`main` leaves behind: the trainer, its final state, the
    batch each step took, every step's loss (0-d tensors, in step order)
    and the host milliseconds per step up to the last loss's readback."""

    trainer: Trainer
    state: object
    batch: tuple             # faces_intense, mv, proj, target, background
    losses: list
    ms_per_step: float


def fit_config(verts, faces, mv, proj, size: int, margin: float, device=None):
    """``suggest_config`` for the scene at ``size`` x ``size``, with the
    per-face tile budget grown by ``margin`` squared.

    Departure from the JAX example, whose margin covers binning_capacity
    only: at its defaults the per-face tile budget (max_tiles_per_face 4,
    no giant tier) truncates faces within a dozen steps, as they stretch
    toward the target, and its final capacity assert fails. Here the margin
    also bounds how far a face's footprint may grow in each screen
    direction, so its tile count may grow by margin squared (capped at the
    tile grid).
    """
    cfg = suggest_config(verts, faces, mv, proj, size, size, base=RasterConfig(),
                         margin=margin, device=device)
    gx, gy = tile_grid_size(size, size)
    return dataclasses.replace(cfg, max_tiles_per_face=min(
        gx * gy, math.ceil(margin * margin * cfg.max_tiles_per_face)))


def main(argv=None) -> Fit:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--views", type=int, default=16)
    # Not the JAX example's fit_mesh.npz: both resume from whatever
    # checkpoint is at their path, and a JAX checkpoint is not this one's.
    # In the temporary directory TMPDIR names (/tmp by default).
    ap.add_argument("--checkpoint", type=str, default=os.path.join(
        tempfile.gettempdir(), "fit_mesh_torch.npz"))
    ap.add_argument("--grid", action="store_true",
                    help="2-D (view x pixel-band) rank mesh instead of "
                         "pure view data-parallel")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    hw, b = args.size, args.views
    verts_np, faces_np = icosphere(3)
    faces = torch.as_tensor(faces_np, dtype=torch.int32, device=dev)
    f = faces.shape[0]
    mv_np, proj_np = orbit_cameras(b)
    mv, proj = torch.as_tensor(mv_np, device=dev), torch.as_tensor(proj_np, device=dev)
    # Scene-probed static capacities (margin absorbs optimization-time
    # vertex drift; Trainer warns if geometry ever outgrows them).
    cfg = fit_config(verts_np, faces_np, mv_np, proj_np, hw, margin=2.0, device=dev)
    it = torch.ones((b, f), dtype=torch.float32, device=dev)
    bg = torch.zeros((3,), dtype=torch.float32, device=dev)

    # Target: radially displaced sphere with position-derived colors.
    bump = 1.0 + 0.25 * np.sin(4.0 * verts_np[:, 0]) * np.cos(4.0 * verts_np[:, 1])
    target_verts = torch.as_tensor(verts_np * bump[:, None], dtype=torch.float32,
                                   device=dev)
    target_color = torch.abs(target_verts) % 1.0
    with torch.no_grad():
        tgt, _, _ = render(target_verts, faces, target_color,
                           torch.full((f,), 0.95, device=dev), it, mv, proj, bg,
                           hw, hw, 1.0, cfg, device=dev)

    params = SceneParams(
        verts=torch.as_tensor(verts_np, device=dev),
        verts_color=torch.full((verts_np.shape[0], 3), 0.5, device=dev),
        faces_opacity=torch.full((f,), 0.5, device=dev),
    )
    mesh = make_view_mesh(device=dev)
    n = mesh.world_size
    if args.grid and n >= 2:
        # Half the ranks on views, two pixel bands per view: the 2-D
        # deployment shape (parallel/patch_parallel.py). Every rank of the
        # world takes part, so the world must be even.
        if n % 2:
            ap.error(f"--grid needs an even number of ranks, the world has {n}")
        mesh = make_mesh((n // 2, 2), ("dp", "sp"), device=dev)
    elif args.grid:
        print("--grid needs >= 2 devices; falling back to view DP")
    trainer = Trainer(mesh, functools.partial(torch.optim.Adam, lr=5e-3), faces,
                      hw, hw, 1.0, cfg, checkpoint_path=args.checkpoint,
                      checkpoint_every=50)
    state = trainer.init_state(params)
    print(f"devices={mesh.world_size} start_step={int(state.step)}")

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        state, loss = trainer.step(state, it, mv, proj, tgt, bg)
        losses.append(loss)
        # The loop adds no sync but this readback (the Trainer reads its two
        # capacity counters each step, as the JAX Trainer does), so the
        # host clock here covers the card's work.
        if i % 10 == 0 or i == args.steps - 1:
            value = float(loss)
            ms_per_step = (time.time() - t0) / (i + 1) * 1e3
        if i % 10 == 0:
            print(f"step {int(state.step):4d} loss {value:.6f} "
                  f"({ms_per_step:.0f} ms/step)", flush=True)
    # Capacity contract: nothing was silently dropped during the fit (the
    # Trainer also warns per step via check_render_stats).
    stats = trainer.last_stats
    assert int(stats.num_truncated) == 0, "binning truncated geometry"
    if cfg.grad_compact_capacity:
        assert int(stats.num_grad_contributing) <= cfg.grad_compact_capacity, \
            "backward compaction dropped gradient rows"
    if args.checkpoint and mesh.rank == 0:
        save_checkpoint(args.checkpoint, state)
    suffix = f" (saved {args.checkpoint})" if args.checkpoint else ""
    print(f"final loss {float(loss):.6f}{suffix}")
    return Fit(trainer, state, (it, mv, proj, tgt, bg), losses, ms_per_step)


if __name__ == "__main__":
    main()
