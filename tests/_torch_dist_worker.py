"""One rank of the port's two-rank gloo tests (tests/test_torch_parallel.py).

Run as ``python -m tests._torch_dist_worker RANK WORLD INIT_FILE OUT_DIR``
from the repository root. It imports torch and the port only (never jax),
joins a ``gloo`` group through the ``file://`` rendezvous ``INIT_FILE``,
runs every multi-rank scenario on the CPU and writes what it saw to
``OUT_DIR/rank{RANK}.npz``. The scene is made with numpy from a seed by
:func:`scene`, which the tests call too.
"""

from __future__ import annotations

import functools
import os
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


def sgd_step(mesh, s, config):
    """One view-parallel SGD step; returns (loss, grads, params after, stats)."""
    from dmesh2_renderer_tpu_torch.parallel import SceneParams, make_sharded_train_step
    from dmesh2_renderer_tpu_torch.train import Trainer

    opt = functools.partial(torch.optim.SGD, lr=SGD_LR)
    step = make_sharded_train_step(mesh, opt, s["faces"], HW, HW, 1.0, config)
    state = Trainer(mesh, opt, s["faces"], HW, HW, 1.0, config).init_state(
        SceneParams(s["verts"], s["verts_color"], s["faces_opacity"]))
    params, _, loss, stats = step(state.params, state.opt_state, s["faces_intense"],
                                  s["mv"], s["proj"], s["target"], s["background"])
    return (float(loss), [p.grad.numpy().copy() for p in params],
            [p.detach().numpy().copy() for p in params],
            [int(stats.num_truncated), int(stats.num_grad_contributing)])


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.parallel import (
        SceneParams, generate_layers_sharded, make_view_mesh, render_views_sharded)
    from dmesh2_renderer_tpu_torch.train import Trainer, load_checkpoint

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_view_mesh(world, device="cpu")
        assert (mesh.rank, mesh.world_size) == (rank, world)
        s = scene()
        config = RasterConfig(**CONFIG)
        out = {}

        color, depth = render_views_sharded(
            mesh, s["verts"], s["faces"], s["verts_color"], s["faces_opacity"],
            s["faces_intense"], s["mv"], s["proj"], s["background"], HW, HW, 1.0,
            config)
        out.update(color=color.numpy(), depth=depth.numpy())

        layers, counts, (nr, nt) = generate_layers_sharded(
            mesh, s["verts"], s["faces"], s["faces_existence"], s["mv"], s["proj"],
            HW, HW, LAYERS, config)
        out.update(layers=layers.numpy(), counts=counts.numpy(),
                   peel_aux=np.asarray([int(nr), int(nt)]))

        loss, grads, after, stats = sgd_step(mesh, s, config)
        out.update(sgd_loss=np.asarray(loss), sgd_stats=np.asarray(stats))
        for i, (g, p) in enumerate(zip(grads, after)):
            out[f"sgd_grad_{i}"], out[f"sgd_param_{i}"] = g, p

        # Adam through the Trainer: the loss falls, rank 0 checkpoints after
        # step 2, and a resumed trainer continues exactly as the first.
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
        out.update(adam_losses=np.asarray(losses), resume_exact=np.asarray(same))
        for i, p in enumerate(state.params):
            out[f"adam_param_{i}"] = p.detach().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)
