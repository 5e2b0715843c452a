"""PyTorch/CUDA port of dmesh2_renderer_tpu for NVIDIA Hopper.

The differentiable renderer: ``Renderer`` and ``functional.render``, forward
and analytic backward. Tile binning, geometry and the gradient reduction are
plain PyTorch; the record pack and the forward and backward tile
compositors are hand-written CUDA kernels (``csrc/``), built with nvcc at
first use. Entry
points run on the card unless the caller passes ``device="cpu"``, which runs
each kernel's plain PyTorch version instead.
"""

from dmesh2_renderer_tpu_torch.functional import render, render_partial
from dmesh2_renderer_tpu_torch.models.renderer import Renderer
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig

__all__ = ["Renderer", "RasterConfig", "render", "render_partial"]
