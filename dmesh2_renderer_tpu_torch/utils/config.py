"""Global constants and the per-call configuration of the renderer.

The port's copy of ``dmesh2_renderer_tpu/utils/config.py``: the behavioral
constants (tile size, early-termination threshold, epsilons, record widths)
are identical, and ``RasterConfig`` keeps every field and every validation
rule so that code written against the JAX package carries across.
"""

from __future__ import annotations

import dataclasses

# 16x16-pixel tiles: the binning granularity and, on the card, one thread
# block of 256 threads (one per pixel).
TILE_X = 16
TILE_Y = 16
TILE_PIXELS = TILE_X * TILE_Y  # 256

# Early-termination threshold on transmittance: a face blends only while the
# transmittance in front of it is >= T_EPS.
T_EPS = 1e-4

# Degenerate-edge epsilon of the AA triangle precompute.
AA_EPS = 1e-3

# w-clamping epsilon in projection.
W_EPS = 1e-4

# Ray-direction normalization epsilon.
RAY_NORM_EPS = 1e-6

DEFAULT_BINNING_CAPACITY = 1 << 18
DEFAULT_MAX_TILES_PER_FACE = 64

# The binning capacity is rounded up to a multiple of this (the JAX
# package's stream block; kept so that both packages bin into the same
# number of slots and report the same truncation).
STREAM_BLOCK = 128
DEFAULT_FACE_CHUNK = STREAM_BLOCK

# Width of one face record in the packed per-entry stream (f32 words).
FACE_RECORD_WIDTH = 32


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Configuration of one rasterization call.

    Fields that act in the port:

    * ``binning_capacity``, ``max_tiles_per_face``, ``num_giant_faces``,
      ``giant_tiles``, ``exact_tile_cull``: static-capacity tile binning,
      identical to the JAX package (same entries, same truncation count).
    * ``use_pallas``: True runs the hand-written CUDA kernels (on CUDA
      tensors; their plain PyTorch versions on CPU tensors). False is the
      caller's explicit request for the plain reference compositor
      (``ops/reference.py``), with no binning at all.
    * ``max_vertex_valence``: the valence guard of the eager entry points
      (``utils/validate.py``), which always runs in the port.
    * ``grad_compact_capacity``: ``Renderer.forward`` warns when the
      forward's contributing-entry count exceeds it.
    * ``warn_on_overflow``: ``Renderer.forward`` warns on truncation.

    Fields that only tune the TPU kernels of the JAX package and do nothing
    here (accepted and validated so that callers' code carries across):
    ``face_chunk``, ``fwd_subchunks``, ``bwd_subchunks``, ``prep_mode``,
    ``grad_sort_mode``, ``grad_sort_split``, ``vertex_sort_mode`` and
    ``interpret``.
    """

    binning_capacity: int = DEFAULT_BINNING_CAPACITY
    max_tiles_per_face: int = DEFAULT_MAX_TILES_PER_FACE
    face_chunk: int = DEFAULT_FACE_CHUNK
    # Giant-face tier: up to this many faces whose tile rect exceeds
    # max_tiles_per_face additionally emit their remaining tiles, up to
    # giant_tiles each (None = the full tile grid). 0 disables the tier.
    num_giant_faces: int = 64
    giant_tiles: int | None = None
    # Exact triangle-vs-tile cull on top of the bbox-rect duplication.
    exact_tile_cull: bool = False
    fwd_subchunks: int = 1
    bwd_subchunks: int = 1
    prep_mode: str = "split"
    use_pallas: bool = True
    interpret: bool = False
    max_vertex_valence: int = 256
    grad_compact_capacity: int | None = None
    grad_sort_mode: str = "payload"
    grad_sort_split: int = 15
    vertex_sort_mode: str = "sort"
    warn_on_overflow: bool = True

    def __post_init__(self):
        if self.grad_sort_mode not in ("payload", "iota"):
            raise ValueError(
                f"grad_sort_mode must be 'payload' or 'iota', got "
                f"{self.grad_sort_mode!r}"
            )
        if not (1 <= self.grad_sort_split <= 29):
            raise ValueError(
                f"grad_sort_split must be in [1, 29], got "
                f"{self.grad_sort_split!r}"
            )
        if self.vertex_sort_mode not in ("sort", "static"):
            raise ValueError(
                f"vertex_sort_mode must be 'sort' or 'static', got "
                f"{self.vertex_sort_mode!r}"
            )
        if self.fwd_subchunks not in (1, 2, 4):
            raise ValueError(
                f"fwd_subchunks must be 1, 2, or 4, got {self.fwd_subchunks!r}"
            )
        if self.bwd_subchunks not in (1, 2, 4):
            raise ValueError(
                f"bwd_subchunks must be 1, 2, or 4, got {self.bwd_subchunks!r}"
            )
        if self.prep_mode not in ("split", "fused"):
            raise ValueError(
                f"prep_mode must be 'split' or 'fused', got {self.prep_mode!r}"
            )
