"""LayeredRenderer: exact depth peeling (non-differentiable).

Port of ``dmesh2_renderer_tpu/models/layered.py``: the same constructor and
``generate`` signature, including the tetrahedral adjacency tensors, which
the peel does not need (``ops/peel.py``) but which are accepted and checked
for parity. It uses the rays the ``Renderer`` precomputed for its cameras.
"""

from __future__ import annotations

import torch

from dmesh2_renderer_tpu_torch.functional import peel_stages
from dmesh2_renderer_tpu_torch.models.renderer import Renderer
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span
from dmesh2_renderer_tpu_torch.utils.validate import (
    check_camera_indices, check_layered_args, to_device,
)


class LayeredRenderer(Renderer):
    # The JAX class's signature: ``config`` is the sixth positional
    # argument here, where the Renderer has ``aa_grad_buffer_size``.
    def __init__(self, mv, proj, width, height, device=None,
                 config: RasterConfig | None = None):
        super().__init__(mv, proj, width, height, device=device, config=config)

    def generate(
        self,
        batch_mvp_idx,       # (B,) int camera indices
        verts,               # (P, 3)
        faces,               # (F, 3) int
        tets,                # (T, 4) int   -- accepted for API parity
        face_tets,           # (F, 2) int   -- accepted for API parity
        tet_faces,           # (T, 4) int   -- accepted for API parity
        faces_existence,     # (F,) int
        num_layers: int,
    ):
        """Returns (render_layers (B, H, W, L) int32 face IDs, -1 padded,
        render_layers_cnt (B, H, W) int32). ``faces_existence`` is cast to
        int32 first, as in the JAX class: a fractional flag below 1 drops
        the face. ``self.last_aux`` holds (num_rendered, num_truncated)."""
        dev = self.device
        with span("generate"):
            with span("validate"):
                check_layered_args(verts, faces, tets, face_tets, tet_faces,
                                   faces_existence)
                check_camera_indices(batch_mvp_idx, self.num_batch)
            del tets, face_tets, tet_faces  # peel needs no adjacency
            with span("prep"):
                idx = to_device(batch_mvp_idx, torch.int64, dev, "view_indices")
                exist = to_device(faces_existence, None, dev, "inputs").to(torch.int32)
                views = (self.mv[idx], self.proj[idx], self.ray_o[idx], self.ray_d[idx])
            layers, counts, aux = peel_stages(
                verts, faces, exist, *views, self.width, self.height,
                int(num_layers), self.config, device=dev,
            )
        self.last_aux = aux
        return layers, counts
