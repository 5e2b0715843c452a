"""Carry a scene and a configuration across from the JAX package.

The JAX package's inputs arrive as numpy arrays (``np.asarray`` of its
arrays, or the numpy scene utilities), so both packages can compute from
identical inputs, and differentiate the same parameters, without this
package importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dmesh2_renderer_tpu_torch.utils.config import RasterConfig

# Scene inputs of the JAX package: the SceneParams fields (verts,
# verts_color, faces_opacity) plus the rest of a render call's arguments,
# and the layered renderer's existence flags and tet adjacency.
_FLOAT_FIELDS = ("verts", "verts_color", "faces_opacity", "faces_intense",
                 "mv", "proj", "background")
_INT_FIELDS = ("faces", "faces_existence", "tets", "face_tets", "tet_faces")


def scene_from_jax(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """numpy scene arrays -> the port's tensors on ``device``.

    Floats become float32 and the integer fields (``faces``,
    ``faces_existence`` and the tet adjacency) int32, each copied to
    ``device``.
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


SCENE_PARAMS = ("verts", "verts_color", "faces_opacity")


def params_from_jax(params: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The JAX package's training state -> the port's trainable leaves.

    ``params`` holds the ``SceneParams`` fields (``verts``, ``verts_color``,
    ``faces_opacity``) as numpy arrays. Returns float32 leaf tensors on
    ``device`` with ``requires_grad=True``, so that both packages
    differentiate the same parameters. Raises ValueError on a missing or
    extra field.
    """
    if set(params) != set(SCENE_PARAMS):
        raise ValueError(f"expected the fields {SCENE_PARAMS}, got {tuple(params)}")
    return {name: t.requires_grad_(True)
            for name, t in scene_from_jax(params, device).items()}


def config_from_jax(fields: dict) -> RasterConfig:
    """``dataclasses.asdict`` of the JAX ``RasterConfig`` -> the port's.

    Every field carries across by name with the same validation.
    """
    return RasterConfig(**fields)
