"""One rank of the port's two-rank gloo tests (tests/test_torch_parallel.py).

Run as ``python -m tests._torch_dist_worker RANK WORLD INIT_FILE OUT_DIR
[SCENARIO]`` from the repository root. It imports torch and the port only
(never jax), joins a ``gloo`` group through the ``file://`` rendezvous
``INIT_FILE``, runs the multi-rank cases of SCENARIO on the CPU and writes
what it saw to ``OUT_DIR/rank{RANK}.npz``. SCENARIO is ``view`` (view
parallelism, tests/test_torch_parallel.py; the default), ``face`` (face
slabs, tests/test_torch_face_parallel.py) or ``patch`` (pixel bands and the
view x band grid, tests/test_torch_patch_parallel.py). The scene is made
with numpy from a seed by :func:`scene`, which the tests call too.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

B, HW, LAYERS, SGD_LR = 4, 16, 4, 1.0
CONFIG = dict(binning_capacity=1 << 12, interpret=True)


def scene(seed=0):
    """icosphere(1) seen by B orbit cameras at HW x HW, random colours,
    opacities, intensities and target images. Returns a dict of numpy
    arrays."""
    verts, faces = icosphere(1)
    mv, proj = orbit_cameras(B)
    rng = np.random.default_rng(seed)
    f = faces.shape[0]
    return dict(
        verts=verts, faces=faces,
        verts_color=rng.uniform(size=(verts.shape[0], 3)).astype(np.float32),
        faces_opacity=rng.uniform(0.3, 0.9, size=(f,)).astype(np.float32),
        faces_intense=rng.uniform(0.5, 1.0, size=(B, f)).astype(np.float32),
        mv=mv, proj=proj,
        background=np.asarray([0.1, 0.2, 0.3], np.float32),
        target=rng.uniform(size=(B, HW, HW, 3)).astype(np.float32),
        faces_existence=(rng.uniform(size=f) < 0.7).astype(np.int32),
    )


# A depth tie where the binning's tiers decide the order: TIE_FRAME is
# (width, height), two 16x16 tiles one above the other; with
# max_tiles_per_face=1 face 0 keeps its first tile in the regular tier and
# spills its second into the giant one.
TIE_FRAME = (16, 32)
TIE_CONFIG = dict(binning_capacity=1 << 10, max_tiles_per_face=1,
                  num_giant_faces=1, interpret=True)


def tie_scene():
    """Face 0 (red) covers the whole TIE_FRAME; face 1 (blue), at exactly
    face 0's depth (every vertex at z = 0, the camera on the z axis at z =
    3), lies in the tile where face 0 is in the giant tier. Opacity 0.6,
    black background. Returns a dict of numpy arrays, keyed as
    :func:`scene`."""
    from dmesh2_renderer_tpu_torch.utils.meshes import perspective

    width, height = TIE_FRAME
    mv = np.eye(4, dtype=np.float32)
    mv[2, 3] = -3.0
    return dict(
        verts=np.array([[-10, -10, 0], [10, -10, 0], [0, 10, 0],
                        [-0.6, 1.5, 0], [0.6, 1.5, 0], [0.0, 0.3, 0]], np.float32),
        faces=np.arange(6, dtype=np.int32).reshape(2, 3),
        verts_color=np.array([[1, 0, 0]] * 3 + [[0, 0, 1]] * 3, np.float32),
        faces_opacity=np.array([0.6, 0.6], np.float32),
        faces_intense=np.ones((1, 2), np.float32),
        mv=mv[None], proj=perspective(60.0, width / height)[None],
        background=np.zeros(3, np.float32),
    )


def run_ranks(out_dir, scenario: str, world: int = 2, timeout: float = 240.0):
    """Run ``world`` ranks of ``scenario`` as processes from the repository
    root, each joined with ``timeout`` seconds, their rendezvous a file in
    ``out_dir``; raises with a rank's log if it failed. Returns each rank's
    outputs as a dict of numpy arrays."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    init = os.path.join(out_dir, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._torch_dist_worker", str(r), str(world), init,
         str(out_dir), scenario], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {scenario!r} failed:\n{log}")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def sgd_step(mesh, s, config, make_step=None):
    """One SGD step (view-parallel unless ``make_step`` builds another
    step); returns (loss, grads, params after, stats or None)."""
    from dmesh2_renderer_tpu_torch.parallel import SceneParams, make_sharded_train_step

    opt = functools.partial(torch.optim.SGD, lr=SGD_LR)
    step = (make_step or make_sharded_train_step)(mesh, opt, s["faces"], HW, HW, 1.0,
                                                  config)
    params = SceneParams(*(torch.tensor(s[k], requires_grad=True)
                           for k in ("verts", "verts_color", "faces_opacity")))
    params, _, loss, *stats = step(params, step.init(params), s["faces_intense"],
                                   s["mv"], s["proj"], s["target"], s["background"])
    return (float(loss), [p.grad.numpy().copy() for p in params],
            [p.detach().numpy().copy() for p in params],
            [int(x) for x in stats[0]] if stats else None)


def train_and_resume(mesh, s, config, out_dir):
    """Adam through the Trainer: two steps, rank 0 checkpoints after step 2,
    and a trainer resumed from it continues exactly as the first. Returns
    (losses of three steps, resumed exactly, final parameters)."""
    from dmesh2_renderer_tpu_torch.parallel import SceneParams
    from dmesh2_renderer_tpu_torch.train import Trainer, load_checkpoint

    ckpt = os.path.join(out_dir, "trainer.npz")
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    tr = Trainer(mesh, opt, s["faces"], HW, HW, 1.0, config,
                 checkpoint_path=ckpt, checkpoint_every=2)
    state = tr.init_state(SceneParams(s["verts"], s["verts_color"],
                                      s["faces_opacity"]))
    losses = []
    args = (s["faces_intense"], s["mv"], s["proj"], s["target"], s["background"])
    for _ in range(2):
        state, loss = tr.step(state, *args)
        losses.append(float(loss))
    dist.barrier()
    tr2 = Trainer(mesh, opt, s["faces"], HW, HW, 1.0, config)
    resumed = load_checkpoint(ckpt, tr2.init_state(SceneParams(
        s["verts"], s["verts_color"], s["faces_opacity"])))
    same = int(resumed.step) == int(state.step) == 2 and all(
        torch.equal(a, b) for a, b in zip(resumed.params, state.params))
    state, loss = tr.step(state, *args)
    losses.append(float(loss))
    resumed, _ = tr2.step(resumed, *args)
    same = same and all(torch.equal(a, b) for a, b in zip(resumed.params,
                                                          state.params))
    return losses, same, [p.detach().numpy() for p in state.params]


def _sgd_out(out, prefix, result):
    loss, grads, after, stats = result
    out[f"{prefix}_loss"] = np.asarray(loss)
    if stats is not None:
        out[f"{prefix}_stats"] = np.asarray(stats)
    for i, (g, p) in enumerate(zip(grads, after)):
        out[f"{prefix}_grad_{i}"], out[f"{prefix}_param_{i}"] = g, p


def _scene_args(s):
    return [s[k] for k in ("verts", "faces", "verts_color", "faces_opacity",
                           "faces_intense", "mv", "proj", "background")]


def face_cases(world, s, config):
    """render_faces_sharded and one face-sharded SGD step on ``world``
    slabs."""
    from dmesh2_renderer_tpu_torch.parallel import (
        make_face_mesh, make_face_sharded_train_step, render_faces_sharded)

    mesh = make_face_mesh(world, device="cpu")
    color, depth, (nr, nt) = render_faces_sharded(mesh, *_scene_args(s), HW, HW,
                                                  1.0, config)
    out = dict(color=color.numpy(), depth=depth.numpy(),
               aux=np.asarray([int(nr), int(nt)]))
    _sgd_out(out, "sgd", sgd_step(mesh, s, config, make_face_sharded_train_step))
    return out


def patch_cases(world, s, config, out_dir):
    """render_pixels_sharded on ``world`` bands; one grid SGD step on a
    (1, world) ("dp", "sp") mesh and one on the 1-D pixel mesh; Adam through
    the Trainer on the (1, world) grid, with a resume."""
    from dmesh2_renderer_tpu_torch.parallel import (
        make_grid_train_step, make_mesh, make_pixel_mesh, render_pixels_sharded)

    pixel_mesh = make_pixel_mesh(world, device="cpu")
    color, depth, stats = render_pixels_sharded(pixel_mesh, *_scene_args(s), HW, HW,
                                                1.0, config)
    out = dict(color=color.numpy(), depth=depth.numpy(),
               stats=np.asarray([int(x) for x in stats]))
    grid = make_mesh((1, world), ("dp", "sp"), device="cpu")
    assert grid.coord("sp") == grid.rank and grid.coord("dp") == 0
    _sgd_out(out, "grid", sgd_step(grid, s, config, make_grid_train_step))
    _sgd_out(out, "sp", sgd_step(pixel_mesh, s, config, make_grid_train_step))
    losses, same, params = train_and_resume(grid, s, config, out_dir)
    out.update(adam_losses=np.asarray(losses), resume_exact=np.asarray(same))
    for i, p in enumerate(params):
        out[f"adam_param_{i}"] = p
    return out


def main(rank: int, world: int, init_file: str, out_dir: str,
         scenario: str = "view") -> None:
    from dmesh2_renderer_tpu_torch import RasterConfig

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        s = scene()
        config = RasterConfig(**CONFIG)
        if scenario == "face":
            out = face_cases(world, s, config)
        elif scenario == "patch":
            out = patch_cases(world, s, config, out_dir)
        else:
            out = view_cases(rank, world, s, config, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def view_cases(rank, world, s, config, out_dir):
    """render_views_sharded, generate_layers_sharded, one view-parallel SGD
    step and Adam through the Trainer, with a resume."""
    from dmesh2_renderer_tpu_torch.parallel import (
        generate_layers_sharded, make_view_mesh, render_views_sharded)

    mesh = make_view_mesh(world, device="cpu")
    assert (mesh.rank, mesh.world_size) == (rank, world)
    color, depth = render_views_sharded(mesh, *_scene_args(s), HW, HW, 1.0, config)
    out = dict(color=color.numpy(), depth=depth.numpy())

    layers, counts, (nr, nt) = generate_layers_sharded(
        mesh, s["verts"], s["faces"], s["faces_existence"], s["mv"], s["proj"],
        HW, HW, LAYERS, config)
    out.update(layers=layers.numpy(), counts=counts.numpy(),
               peel_aux=np.asarray([int(nr), int(nt)]))
    _sgd_out(out, "sgd", sgd_step(mesh, s, config))
    losses, same, params = train_and_resume(mesh, s, config, out_dir)
    out.update(adam_losses=np.asarray(losses), resume_exact=np.asarray(same))
    for i, p in enumerate(params):
        out[f"adam_param_{i}"] = p
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:6])
    sys.exit(0)
