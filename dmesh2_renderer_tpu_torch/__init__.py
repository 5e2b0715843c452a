"""PyTorch/CUDA port of dmesh2_renderer_tpu for NVIDIA Hopper.

Two renderers, as in the JAX package: the differentiable ``Renderer`` and
``functional.render`` (forward and analytic backward), and the depth-peel
``LayeredRenderer`` and ``functional.generate_layers``. Tile binning,
geometry and the gradient reduction are plain PyTorch; the record pack, the
forward and backward tile compositors and the depth peel are hand-written
CUDA kernels (``csrc/``), built with nvcc at first use. Entry points run on
the card unless the caller passes ``device="cpu"``, which runs each
kernel's plain PyTorch version instead.
"""

from dmesh2_renderer_tpu_torch.functional import (
    generate_layers, render, render_banded, render_partial,
)
from dmesh2_renderer_tpu_torch.models.layered import LayeredRenderer
from dmesh2_renderer_tpu_torch.models.renderer import Renderer
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig

__all__ = ["Renderer", "LayeredRenderer", "RasterConfig", "render",
           "render_partial", "render_banded", "generate_layers"]
