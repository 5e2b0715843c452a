"""PyTorch/CUDA port of dmesh2_renderer_tpu for NVIDIA Hopper.

Two renderers, as in the JAX package: the differentiable ``Renderer`` and
``functional.render`` (forward and analytic backward), and the depth-peel
``LayeredRenderer`` and ``functional.generate_layers``. Each pair shares
one body (``functional.render_stages``, ``functional.peel_stages``). The
binning's emission grid, the record pack, the forward and backward tile
compositors, the gradient reduction (with the AA corners' backward) and the
depth peel are hand-written CUDA kernels (``csrc/``), built with nvcc at
first use; geometry and the binning's sort and tile ranges are plain
PyTorch. Entry points run on the card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead.
``suggest_config`` sizes the static
binning capacities from a scene; ``parallel`` and ``train`` hold the
data-parallel training step and the ``Trainer`` over ``torch.distributed``.
"""

from dmesh2_renderer_tpu_torch.functional import (
    generate_layers, render, render_banded, render_partial,
)
from dmesh2_renderer_tpu_torch.models.layered import LayeredRenderer
from dmesh2_renderer_tpu_torch.models.renderer import Renderer
from dmesh2_renderer_tpu_torch.utils.autotune import suggest_config
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig

__all__ = ["Renderer", "LayeredRenderer", "RasterConfig", "render",
           "render_partial", "render_banded", "generate_layers",
           "suggest_config"]
