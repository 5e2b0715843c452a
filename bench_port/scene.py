"""Scenes of the benchmark's configurations, made from the seed.

A configuration file names three generators, each with its parameters,
and each a file of its own found by that name:

* ``scene``: ``scenes/<generator>.py``, the mesh and any seeded state;
* ``cameras``: ``cameras/<generator>.py``, the views;
* ``appearance`` (optional, for the differentiable renderer):
  ``appearances/<generator>.py``, colours, opacities, intensities and the
  background.

Each such file has ``make(params, gen, device, parts)``, which returns a
dict of tensors on ``device`` to add to the scene (``parts`` holds what
the earlier generators made); seeded parts are drawn with ``gen``, one
``torch.Generator`` on the device, in a few large calls. Parts that
``Scene`` has no field for go into ``Scene.extra``. The program and the
reference are handed the same tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

@dataclass
class Scene:
    verts: torch.Tensor            # (P, 3) float32
    faces: torch.Tensor            # (F, 3) int32
    mv: torch.Tensor               # (B, 4, 4) float32
    proj: torch.Tensor             # (B, 4, 4) float32
    verts_color: torch.Tensor | None = None    # (P, 3)
    faces_opacity: torch.Tensor | None = None  # (F,)
    faces_intense: torch.Tensor | None = None  # (B, F)
    background: torch.Tensor | None = None     # (3,)
    exist: torch.Tensor | None = None          # (F,) int32
    tets: torch.Tensor | None = None           # (T, 4) int32
    face_tets: torch.Tensor | None = None      # (F, 2) int32
    tet_faces: torch.Tensor | None = None      # (T, 4) int32
    extra: dict = field(default_factory=dict)  # a generator's other parts

    @property
    def views(self) -> int:
        return self.mv.shape[0]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def look_at(eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Right-handed look-at model-view matrix (the camera looks down -z)."""
    eye, center, up = (np.asarray(a, dtype=np.float64) for a in (eye, center, up))
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    mv = np.eye(4)
    mv[0, :3], mv[1, :3], mv[2, :3] = right, true_up, -fwd
    mv[:3, 3] = -mv[:3, :3] @ eye
    return mv.astype(np.float32)


def perspective(fovy_deg=45.0, aspect=1.0, near=0.1, far=10.0):
    """OpenGL-style perspective projection (NDC z in [-1, 1])."""
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def build_scene(config: dict, seed: int, device) -> Scene:
    """The scene of ``config`` (a configuration file's contents) at
    ``seed``, on ``device``."""
    from bench_port.harness import load_module

    device = torch.device(device)
    gen = generator(seed, device)
    parts = {}
    for kind, key in (("scenes", "scene"), ("cameras", "cameras"),
                      ("appearances", "appearance")):
        if key in config:
            params = config[key]
            parts.update(load_module(kind, params["generator"]).make(params, gen, device, parts))
    names = {f.name for f in fields(Scene)} - {"extra"}
    extra = {k: v for k, v in parts.items() if k not in names}
    return Scene(**{k: v for k, v in parts.items() if k in names}, extra=extra)
