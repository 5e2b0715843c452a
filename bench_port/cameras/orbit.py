"""``orbit``: ``views`` cameras on a circle around the origin (a frozen
copy of the repository's ``orbit_cameras``), square-aspect perspective.

Parameters: ``views``, ``radius``, ``elevation``, ``fovy_deg``, ``near``,
``far``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.scene import look_at, perspective


def orbit_cameras(views: int, radius: float = 3.0, elevation: float = 0.3,
                  fovy_deg: float = 45.0, near: float = 0.1, far: float = 10.0):
    """``views`` cameras on a circle around the origin: (mv, proj), each
    (views, 4, 4) float32."""
    mvs = []
    for i in range(views):
        ang = 2 * np.pi * i / max(views, 1)
        mvs.append(look_at((radius * np.cos(ang), radius * elevation, radius * np.sin(ang))))
    proj = perspective(fovy_deg, 1.0, near, far)
    return np.stack(mvs), np.stack([proj] * views)


def make(p, gen, device, parts):
    mv, proj = orbit_cameras(int(p["views"]), p["radius"], p["elevation"], p["fovy_deg"],
                             p["near"], p["far"])
    return dict(mv=torch.as_tensor(mv).to(device), proj=torch.as_tensor(proj).to(device))
