"""API-boundary shape/value validation.

The port's copy of ``dmesh2_renderer_tpu/utils/validate.py``: malformed
arguments raise ValueError before any tensor work, with the same messages.
Arguments may be numpy arrays or torch tensors on any device. Also the
capacity check after a render (``check_render_stats``), which warns rather
than raises.
"""

from __future__ import annotations

import hashlib
import warnings
import weakref

import numpy as np
import torch

from dmesh2_renderer_tpu_torch.utils.profiling import count_entries, host_sync


def _shape(x):
    return tuple(getattr(x, "shape", ()))


def _host_array(x, site: str) -> np.ndarray:
    """``x`` as a numpy array; copying a device tensor to the host waits
    for the device, counted as host sync ``site``."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.device.type == "cpu":
        return x.detach().numpy()
    with host_sync(site):
        return x.detach().cpu().numpy()


def to_device(x, dtype, device: torch.device, site: str) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``. Data that is not
    already a tensor of ``device``'s type is copied, and a copy to or from
    the card waits for everything queued on the device: counted as host
    sync ``site`` (on the CPU too, where the same call on the card would
    wait)."""
    if isinstance(x, torch.Tensor) and x.device.type == device.type:
        return torch.as_tensor(x, dtype=dtype, device=device)
    with host_sync(site):
        return torch.as_tensor(x, dtype=dtype, device=device)


def check_vertex_valence(faces, max_vertex_valence: int | None,
                         num_verts: int | None = None) -> bool:
    """Fail loudly when a vertex's valence exceeds the gradient-scan cap.

    The JAX package reduces face gradients onto shared vertices with a
    segmented scan of depth ``RasterConfig.max_vertex_valence``; a vertex
    with more incident faces would get a truncated gradient sum. The port
    keeps the same contract at its entry points. With ``num_verts`` it also
    checks that every index lies in [0, num_verts): the CUDA kernels read
    vertex rows through these indices unchecked. ``max_vertex_valence=None``
    checks the indices only (``vertex_sort_mode="static"``: the JAX
    package's valence table is exact for any valence). Raises ValueError on
    violation; returns True.
    """
    f = _host_array(faces, "valence")
    if f.size == 0:
        return True
    if num_verts is not None:
        _check_index_range(int(f.min()), int(f.max()), num_verts)
    if max_vertex_valence is None:
        return True
    val = int(np.bincount(f.ravel()).max())
    if val > max_vertex_valence:
        raise ValueError(
            f"mesh has a vertex shared by {val} faces, above "
            f"RasterConfig.max_vertex_valence={max_vertex_valence}: its "
            "gradient would be silently truncated. Set "
            f"RasterConfig(max_vertex_valence={1 << (val - 1).bit_length()}) "
            "(the scan cost is logarithmic in the cap)."
        )
    return True


class _ValenceCache:
    """Memoizes successful valence checks.

    Two levels: an object-identity fast path (zero cost when callers pass
    the same ``faces`` object every step), backed by a content-digest cache
    so a different same-shape topology is re-validated. Weakrefs guard the
    id fast path against id reuse after garbage collection.
    """

    def __init__(self):
        self._by_id = {}       # (id, cap, P) -> weakref to the checked object
        self._digests = set()  # (shape, cap, P, sha1) that passed

    def check(self, faces, max_vertex_valence: int | None,
              num_verts: int | None = None) -> bool:
        idkey = (id(faces), max_vertex_valence, num_verts)
        ref = self._by_id.get(idkey)
        if ref is not None and ref() is faces:
            return True
        f = _host_array(faces, "valence")
        digest = (f.shape, max_vertex_valence, num_verts,
                  hashlib.sha1(np.ascontiguousarray(f).tobytes()).hexdigest())
        if digest not in self._digests:
            check_vertex_valence(f, max_vertex_valence, num_verts)  # raises
            self._digests.add(digest)
        try:
            self._by_id[idkey] = weakref.ref(faces)
        except TypeError:  # numpy arrays and tensors take weakrefs; lists do not
            pass
        return True


# Shared across the eager entry points (models.Renderer, functional.render):
# all of them validate the same contract against the same topology objects.
valence_cache = _ValenceCache()


def valence_cap(config) -> int | None:
    """The valence the entry points hold ``faces`` to: the config's cap,
    or None (indices only) with ``vertex_sort_mode="static"``, whose JAX
    valence-table reduction is exact for any valence. The port's own
    ``index_add_`` reduction has no cap."""
    if config.vertex_sort_mode == "static":
        return None
    return config.max_vertex_valence


def check_render_args(verts, faces, verts_color, faces_opacity, faces_intense,
                      background, n_batch, aa_temperature):
    p3 = _shape(verts)
    if len(p3) != 2 or p3[1] != 3:
        raise ValueError(f"verts must be (P, 3), got {p3}")
    p = p3[0]
    fs = _shape(faces)
    if len(fs) != 2 or fs[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {fs}")
    f = fs[0]
    if _shape(verts_color) != (p, 3):
        raise ValueError(
            f"verts_color must be (P, 3) = ({p}, 3), got {_shape(verts_color)}"
        )
    if _shape(faces_opacity) != (f,):
        raise ValueError(
            f"faces_opacity must be (F,) = ({f},), got {_shape(faces_opacity)}"
        )
    if _shape(faces_intense) != (n_batch, f):
        raise ValueError(
            f"faces_intense must be (B, F) = ({n_batch}, {f}), "
            f"got {_shape(faces_intense)}"
        )
    if _shape(background) != (3,):
        raise ValueError(f"background must be (3,), got {_shape(background)}")
    tau = float(aa_temperature)
    if not 0.0 <= tau <= 1.0:
        raise ValueError(f"aa_temperature must be in [0, 1], got {tau}")


def check_layered_args(verts, faces, tets, face_tets, tet_faces,
                       faces_existence):
    p3, fs = _shape(verts), _shape(faces)
    if len(p3) != 2 or p3[1] != 3:
        raise ValueError(f"verts must be (P, 3), got {p3}")
    if len(fs) != 2 or fs[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {fs}")
    f = fs[0]
    ts = _shape(tets)
    if len(ts) != 2 or ts[1] != 4:
        raise ValueError(f"tets must be (T, 4), got {ts}")
    if _shape(face_tets) != (f, 2):
        raise ValueError(f"face_tets must be (F, 2) = ({f}, 2), got {_shape(face_tets)}")
    if _shape(tet_faces) != (ts[0], 4):
        raise ValueError(
            f"tet_faces must be (T, 4) = ({ts[0]}, 4), got {_shape(tet_faces)}"
        )
    if _shape(faces_existence) != (f,):
        raise ValueError(
            f"faces_existence must be (F,) = ({f},), got {_shape(faces_existence)}"
        )


def check_face_indices(faces: torch.Tensor, num_verts: int) -> None:
    """Every vertex index of ``faces`` must lie in [0, num_verts): the CUDA
    kernels read vertex rows through them unchecked. Reduces on the
    tensor's own device (one host sync)."""
    if faces.numel() == 0:
        return
    with host_sync("face_indices"):
        lo, hi = torch.stack(torch.aminmax(faces)).tolist()
    _check_index_range(lo, hi, num_verts)


def _check_index_range(lo: int, hi: int, num_verts: int) -> None:
    if lo < 0 or hi >= num_verts:
        raise ValueError(
            f"faces index vertices in [{lo}, {hi}], outside [0, {num_verts})")


def check_cameras(mv, proj):
    ms, ps = _shape(mv), _shape(proj)
    if len(ms) != 3 or ms[1:] != (4, 4):
        raise ValueError(f"mv must be (B, 4, 4), got {ms}")
    if ps != ms:
        raise ValueError(f"proj must match mv {ms}, got {ps}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``"cuda"``. A CUDA device without a usable card raises:
    the entry points never carry on silently on the CPU; pass
    ``device="cpu"`` to run the plain versions there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def check_camera_indices(batch_mvp_idx, num_cameras: int) -> np.ndarray:
    """Every view's camera index must select one of the cameras: the rays
    and matrices are gathered through it. Returns the indices as a flat
    host array."""
    idx = _host_array(batch_mvp_idx, "view_indices").reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= num_cameras):
        raise ValueError(
            f"batch_mvp_idx must index the {num_cameras} cameras, got {idx.tolist()}")
    return idx


def check_patch_windows(batch_mvp_idx, batch_patch_min, patch_width: int,
                        patch_height: int, num_cameras: int, width: int,
                        height: int):
    """Every view's camera index and patch window must lie in the frame:
    the rays of each window are gathered from the full-frame ray maps."""
    idx = check_camera_indices(batch_mvp_idx, num_cameras)
    pm = _host_array(batch_patch_min, "patch_origins")
    if pm.shape != (idx.shape[0], 2):
        raise ValueError(
            f"batch_patch_min must be (B, 2) = ({idx.shape[0]}, 2), got {pm.shape}")
    if pm.size and (pm.min() < 0 or (pm[:, 0] + patch_width).max() > width
                    or (pm[:, 1] + patch_height).max() > height):
        raise ValueError(
            f"patch windows {pm.tolist()} of {patch_width}x{patch_height} "
            f"leave the {width}x{height} frame")


def check_render_stats(stats, config, site: str = "render_stats") -> None:
    """Warn when a render's capacity counters signal truncation.

    ``stats`` has ``num_rendered``, ``num_truncated`` and
    ``num_grad_contributing`` (a ``RasterAux`` or a training step's
    ``RenderStats``). Binning truncation drops geometry; a contributing
    count above ``grad_compact_capacity`` is harmless here (the port's
    backward reduces every contributing entry) but would make the JAX
    package's backward drop gradient rows with this config. The three
    counts are stacked on their device and read in one device-to-host copy,
    a pass through the host-sync site ``site`` (``overflow_check`` in
    ``Renderer.forward``, ``render_stats`` in ``Trainer.step``), and added
    to ``counters()["entries"]`` (binned, blended, truncated). Warns on
    behalf of its caller's caller.
    """
    stacked = torch.stack([stats.num_rendered, stats.num_truncated,
                           stats.num_grad_contributing])
    with host_sync(site):
        rendered, truncated, contributing = stacked.tolist()
    count_entries(rendered, contributing, truncated)
    if truncated > 0:
        warnings.warn(
            f"binning truncated {truncated} face instances; the rendered "
            "image is missing geometry. Raise RasterConfig.binning_capacity "
            "(or max_tiles_per_face for faces spanning many tiles).",
            RuntimeWarning,
            stacklevel=3,
        )
    cap = config.grad_compact_capacity
    if cap and contributing > cap:
        warnings.warn(
            f"{contributing} entries contribute gradients but "
            f"grad_compact_capacity={cap}. This backward reduces every "
            "contributing entry, so its gradients stay right; the JAX "
            "package's backward would drop the excess with this config and "
            "give wrong gradients. Raise RasterConfig.grad_compact_capacity "
            "to keep the config portable.",
            RuntimeWarning,
            stacklevel=3,
        )
