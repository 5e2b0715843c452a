"""Test/benchmark geometry: icosphere, triangle soup, tet grid, cameras
(numpy).

The port's own copy of ``dmesh2_renderer_tpu/utils/meshes.py`` (the JAX
package's ``__init__`` imports JAX, so the port cannot import it).
"""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 1):
    """Unit icosphere. Returns (verts (P,3) f32, faces (F,3) i32)."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)

    return verts.astype(np.float32), faces.astype(np.int32)


def triangle_soup(n_faces: int, seed: int = 0, extent: float = 1.0, size: float = 0.05):
    """Random triangle soup in [-extent, extent]^3 (benchmark config 4)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(n_faces, 1, 3))
    offsets = rng.normal(scale=size, size=(n_faces, 3, 3))
    tri = (centers + offsets).astype(np.float32)
    verts = tri.reshape(-1, 3)
    faces = np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3)
    return verts, faces


def sheet_stack(n_sheets: int = 150, duplicates=(20, 62, 125),
                half_size: float = 3.0, z_near: float = 1.0, z_far: float = -1.0):
    """A depth-peel stress scene: ``n_sheets`` parallel quads facing +z
    (each two triangles), sheet i at z = z_near + i (z_far - z_near) /
    (n_sheets - 1), listed nearest first for a camera on the +z axis. Each
    sheet in ``duplicates`` is listed twice: its two triangles again right
    after it, on the same vertex ids, so a ray hits both copies at
    bit-identical t. A ray from (0, 0, 3) within 30 degrees of -z crosses
    every sheet. With the default duplicates, listed in id order the copies
    of sheet 62 sit at entries 126-129 and those of sheet 125 at 254-257:
    across the 128-entry blocks of the peel. Returns (verts (4 n, 3) f32,
    faces (F, 3) int32)."""
    z = z_near + np.arange(n_sheets) * (z_far - z_near) / (n_sheets - 1)
    # A lopsided square: its diagonal passes through no pixel centre of a
    # camera on the z axis, whose rays would hit both triangles at t equal
    # only up to the operation order.
    corners = np.array([[-1.0, -0.9], [1.03, -0.9], [1.03, 0.97], [-1.0, 0.97]]) * half_size
    verts = np.concatenate([np.column_stack([corners, np.full(4, zi)]) for zi in z])
    faces = []
    for i in range(n_sheets):
        quad = [[4 * i, 4 * i + 1, 4 * i + 2], [4 * i, 4 * i + 2, 4 * i + 3]]
        faces += quad * (2 if i in duplicates else 1)
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def look_at(eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Right-handed look-at model-view matrix (camera looks down -z)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    mv = np.eye(4)
    mv[0, :3] = right
    mv[1, :3] = true_up
    mv[2, :3] = -fwd
    mv[:3, 3] = -mv[:3, :3] @ eye
    return mv.astype(np.float32)


def perspective(fovy_deg=45.0, aspect=1.0, near=0.1, far=10.0):
    """OpenGL-style perspective projection (NDC z in [-1, 1])."""
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def orbit_cameras(n: int, radius: float = 3.0, elevation: float = 0.3):
    """n cameras orbiting the origin. Returns (mv (n,4,4), proj (n,4,4))."""
    mvs, projs = [], []
    for i in range(n):
        ang = 2 * np.pi * i / max(n, 1)
        eye = (radius * np.cos(ang), radius * elevation, radius * np.sin(ang))
        mvs.append(look_at(eye))
        projs.append(perspective())
    return np.stack(mvs), np.stack(projs)


def tet_grid(res: int = 2, extent: float = 1.2):
    """Regular tetrahedral grid filling a cube (the layered renderer's scene).

    Each cube cell is split into 6 tets. Returns (verts (P,3) f32,
    tets (T,4) i32, faces (F,3) i32, face_tets (F,2) i32, tet_faces (T,4) i32)
    with the adjacency layout ``LayeredRenderer.generate`` takes.

    The JAX package's pure-Python path, vectorised with the same output:
    tets in (i, j, k, cell-tet) order, faces as sorted vertex triples
    numbered by first appearance in (tet, face-of-tet) order, ``face_tets``
    the first and the last tet that holds each face (-1 where only one
    does).
    """
    xs = np.linspace(-extent, extent, res + 1)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    verts = grid.reshape(-1, 3).astype(np.float32)

    n = res + 1
    i, j, k = (a.reshape(-1) for a in np.meshgrid(
        np.arange(res), np.arange(res), np.arange(res), indexing="ij"))
    # Cube corner c is (i + c//4, j + (c//2)%2, k + c%2).
    c = np.arange(8)
    corners = (((i[:, None] + c // 4) * n + j[:, None] + (c // 2) % 2) * n
               + k[:, None] + c % 2)                                  # (N, 8)
    cube_tets = np.array([(0, 1, 3, 7), (0, 1, 7, 5), (0, 5, 7, 4),
                          (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7)])
    tets = corners[:, cube_tets].reshape(-1, 4).astype(np.int32)

    tri_of_tet = np.array([(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)])
    tris = np.sort(tets[:, tri_of_tet].reshape(-1, 3).astype(np.int64), axis=1)
    p = np.int64(verts.shape[0])
    key = (tris[:, 0] * p + tris[:, 1]) * p + tris[:, 2]
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")       # faces by first appearance
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    face_of = rank[inverse.reshape(-1)]            # face id per (tet, face)
    faces = tris[first[order]].astype(np.int32)
    tet_faces = face_of.reshape(-1, 4).astype(np.int32)

    # Last appearance of each face: the end of its run in a stable sort.
    by_face = np.argsort(face_of, kind="stable")
    count = np.bincount(face_of, minlength=faces.shape[0])
    last = by_face[np.cumsum(count) - 1]
    face_tets = np.full((faces.shape[0], 2), -1, np.int32)
    face_tets[:, 0] = first[order] // 4
    face_tets[:, 1] = np.where(count > 1, last // 4, -1)
    return verts, tets, faces, face_tets, tet_faces
