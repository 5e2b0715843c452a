"""User-facing Renderer: the differentiable multi-view triangle renderer.

Port of ``dmesh2_renderer_tpu/models/renderer.py``: hold a batch of cameras,
precompute per-pixel rays once, and per call gather the views' cameras,
slice their patch rays, run the render body that ``functional.render_partial``
runs (``functional.render_stages``: the screen-space stage and the
rasterize op) and remap depth.
``loss.backward()`` through ``forward`` gives the JAX package's analytic
gradients for ``verts``, ``verts_color``, ``faces_opacity`` and
``faces_intense`` (the backward compositor kernel on the card).

Differences from the JAX class:
  * ``device`` selects where it runs: ``None`` means the card (``"cuda"``),
    and without a card that raises; ``device="cpu"`` runs the plain PyTorch
    versions of the kernels.
  * ``aa_grad_buffer_size`` is accepted but unused, as in the JAX class.
  * ``forward`` exposes the binning statistics of the last call via
    ``self.last_aux``.
"""

from __future__ import annotations

import torch

from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.functional import render_stages
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span
from dmesh2_renderer_tpu_torch.utils.validate import (
    check_cameras,
    check_patch_windows,
    check_render_args,
    check_render_stats,
    resolve_device,
    to_device,
    valence_cache,
    valence_cap,
)


class Renderer:
    def __init__(self, mv, proj, width, height, device=None,
                 aa_grad_buffer_size: int = 20, config: RasterConfig | None = None):
        check_cameras(mv, proj)
        self.device = resolve_device(device)
        self.mv = torch.as_tensor(mv, dtype=torch.float32, device=self.device)
        self.proj = torch.as_tensor(proj, dtype=torch.float32, device=self.device)
        self.width = int(width)
        self.height = int(height)
        self.num_batch = self.mv.shape[0]
        self.aa_grad_buffer_size = aa_grad_buffer_size  # parity arg; unused
        self.config = config or RasterConfig()
        self.last_aux = None
        # Per-pixel camera rays, precomputed once.
        self.ray_o, self.ray_d = G.init_rays(self.mv, self.proj, self.width,
                                             self.height)

    def compute_verts_ndc_image(self, verts, mv, proj):
        return G.compute_verts_ndc_image(verts, mv, proj, self.width, self.height)

    def forward(
        self,
        batch_mvp_idx,        # (B,) int camera indices
        batch_patch_min,      # (B, 2) int patch origins
        patch_width: int,
        patch_height: int,
        verts,                # (P, 3)
        faces,                # (F, 3) int
        verts_color,          # (P, 3)
        faces_opacity,        # (F,)
        faces_intense,        # (B, F)
        background,           # (3,)
        aa_temperature: float = 1.0,
    ):
        """Render. Returns (color (B, ph, pw, 3), depth (B, ph, pw) in [0, 1],
        larger = nearer)."""
        dev = self.device
        pw, ph = int(patch_width), int(patch_height)
        with span("render"):
            with span("validate"):
                check_patch_windows(batch_mvp_idx, batch_patch_min, pw, ph,
                                    self.num_batch, self.width, self.height)
                check_render_args(
                    verts, faces, verts_color, faces_opacity, faces_intense,
                    background, len(batch_mvp_idx), aa_temperature,
                )
                # Valence and vertex-index check on the caller's own object,
                # before conversion, so the identity fast path holds across
                # calls. Static mode checks the indices only, as the JAX
                # class skips the guard.
                valence_cache.check(faces, valence_cap(self.config), len(verts))
            with span("prep"):
                idx = to_device(batch_mvp_idx, torch.int64, dev, "view_indices")
                patch_min = to_device(batch_patch_min, torch.int32, dev,
                                      "patch_origins")
                b_mv, b_proj = self.mv[idx], self.proj[idx]
                ray_o, ray_d = G.select_rays(self.ray_o, self.ray_d, idx,
                                             patch_min, pw, ph)
            color, depth_raw, _final_t, aux = render_stages(
                verts, faces, verts_color, faces_opacity, faces_intense, b_mv,
                b_proj, background, patch_min, ray_o[:, 0, 0, :], ray_d,
                self.width, self.height, aa_temperature, self.config, dev)
            self.last_aux = aux
            if self.config.warn_on_overflow:
                check_render_stats(aux, self.config, "overflow_check")
            return color, 1.0 - (depth_raw + 1.0) / 2.0

    __call__ = forward
