"""``tet_grid``: a regular tetrahedral grid of a cube (a frozen copy of the
repository's numpy ``tet_grid``), each face existing with probability
``exist_fraction``, drawn from the seed on the device.

Parameters: ``res`` (cells per edge), ``extent`` (half the cube's side),
``exist_fraction``.
"""

from __future__ import annotations

import numpy as np
import torch


def tet_grid(res: int, extent: float = 1.2):
    """Regular tetrahedral grid of a cube, 6 tets per cell: (verts (P, 3)
    f32, tets (T, 4), faces (F, 3), face_tets (F, 2), tet_faces (T, 4), all
    int32). Faces are sorted vertex triples numbered by first appearance in
    (tet, face-of-tet) order; ``face_tets`` holds the first and the last tet
    of each face (-1 where only one holds it)."""
    xs = np.linspace(-extent, extent, res + 1)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    verts = grid.reshape(-1, 3).astype(np.float32)
    n = res + 1
    i, j, k = (a.reshape(-1) for a in np.meshgrid(
        np.arange(res), np.arange(res), np.arange(res), indexing="ij"))
    c = np.arange(8)
    corners = (((i[:, None] + c // 4) * n + j[:, None] + (c // 2) % 2) * n + k[:, None] + c % 2)
    cube_tets = np.array([(0, 1, 3, 7), (0, 1, 7, 5), (0, 5, 7, 4),
                          (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7)])
    tets = corners[:, cube_tets].reshape(-1, 4).astype(np.int32)
    tri_of_tet = np.array([(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)])
    tris = np.sort(tets[:, tri_of_tet].reshape(-1, 3).astype(np.int64), axis=1)
    p = np.int64(verts.shape[0])
    key = (tris[:, 0] * p + tris[:, 1]) * p + tris[:, 2]
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    face_of = rank[inverse.reshape(-1)]
    faces = tris[first[order]].astype(np.int32)
    tet_faces = face_of.reshape(-1, 4).astype(np.int32)
    by_face = np.argsort(face_of, kind="stable")
    count = np.bincount(face_of, minlength=faces.shape[0])
    last = by_face[np.cumsum(count) - 1]
    face_tets = np.full((faces.shape[0], 2), -1, np.int32)
    face_tets[:, 0] = first[order] // 4
    face_tets[:, 1] = np.where(count > 1, last // 4, -1)
    return verts, tets, faces, face_tets, tet_faces


def make(p, gen, device, parts):
    verts, tets, faces, face_tets, tet_faces = tet_grid(int(p["res"]), float(p["extent"]))
    exist = (torch.rand(faces.shape[0], generator=gen, device=device)
             < float(p["exist_fraction"])).to(torch.int32)

    def dev(a):
        return torch.as_tensor(a).to(device)

    return dict(verts=dev(verts), faces=dev(faces), tets=dev(tets), face_tets=dev(face_tets),
                tet_faces=dev(tet_faces), exist=exist)
