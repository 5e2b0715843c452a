"""Carry a scene and a configuration across from the JAX package.

The JAX package's inputs arrive as numpy arrays (``np.asarray`` of its
arrays, or the numpy scene utilities), so both packages can compute from
identical inputs without this package importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dmesh2_renderer_tpu_torch.utils.config import RasterConfig

# Scene inputs of the JAX package: the SceneParams fields (verts,
# verts_color, faces_opacity) plus the rest of a render call's arguments.
_FLOAT_FIELDS = ("verts", "verts_color", "faces_opacity", "faces_intense",
                 "mv", "proj", "background")
_INT_FIELDS = ("faces",)


def scene_from_jax(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """numpy scene arrays -> the port's tensors on ``device``.

    Floats become float32 and ``faces`` int32, each copied to ``device``.
    Raises ValueError on a name that is not a scene input.
    """
    out = {}
    for name, value in arrays.items():
        if name in _FLOAT_FIELDS:
            dtype = torch.float32
        elif name in _INT_FIELDS:
            dtype = torch.int32
        else:
            raise ValueError(
                f"{name!r} is not a scene input (expected one of "
                f"{_FLOAT_FIELDS + _INT_FIELDS})")
        out[name] = torch.as_tensor(np.asarray(value), dtype=dtype,
                                    device=device).contiguous()
    return out


def config_from_jax(fields: dict) -> RasterConfig:
    """``dataclasses.asdict`` of the JAX ``RasterConfig`` -> the port's.

    Every field carries across by name with the same validation.
    """
    return RasterConfig(**fields)
