"""Host-side triangle-mesh container and procedural primitives.

TPU-native replacement for Unity ``Mesh`` + ``MeshFactory``
(``MeshFactory.cs:6-110``) and the procedural generators embedded in the
simulators.  Everything here is NumPy and runs once at scene-build time.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray   # (N, 3) float
    triangles: np.ndarray  # (T, 3) int — CCW winding, outward normals

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float32)
        self.triangles = np.asarray(self.triangles, dtype=np.int32).reshape(-1, 3)

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    def transformed(self, translate=(0, 0, 0), scale=1.0) -> "TriMesh":
        v = self.vertices * np.float32(scale) + np.asarray(translate, np.float32)
        return TriMesh(v, self.triangles)


def plane(size: float = 1.0) -> TriMesh:
    """4-vertex XZ plane (capability of ``MeshFactory.CreatePlane``,
    ``MeshFactory.cs:8-51``)."""
    h = size / 2.0
    vertices = np.array(
        [[-h, 0, -h], [h, 0, -h], [-h, 0, h], [h, 0, h]], dtype=np.float32
    )
    triangles = np.array([[0, 2, 1], [2, 3, 1]], dtype=np.int32)
    return TriMesh(vertices, triangles)


def grid_plane(size: float = 1.0, res: int = 8) -> TriMesh:
    """res x res cloth-style XZ plane (generalisation of the 4-vertex plane,
    needed for cloth workloads with pinned anchor rows)."""
    if res < 2:
        raise ValueError("res must be >= 2")
    h = size / 2.0
    xs = np.linspace(-h, h, res, dtype=np.float32)
    zs = np.linspace(-h, h, res, dtype=np.float32)
    vv = np.stack(
        [
            np.repeat(xs, res),
            np.zeros(res * res, np.float32),
            np.tile(zs, res),
        ],
        axis=1,
    )
    tris = []
    for i in range(res - 1):
        for j in range(res - 1):
            a = i * res + j
            b = (i + 1) * res + j
            c = (i + 1) * res + j + 1
            d = i * res + j + 1
            tris.append([a, d, b])
            tris.append([d, c, b])
    return TriMesh(vv, np.asarray(tris, np.int32))


def cube(size: float = 1.0) -> TriMesh:
    """8-vertex cube, CCW winding (capability of ``MeshFactory.CreateCube``,
    ``MeshFactory.cs:53-109``; same corner ordering as
    ``SoftBodyGPU``'s primitive path)."""
    h = size / 2.0
    vertices = np.array(
        [
            [-h, -h, -h],  # 0
            [h, -h, -h],   # 1
            [h, -h, h],    # 2
            [-h, -h, h],   # 3
            [-h, h, -h],   # 4
            [h, h, -h],    # 5
            [h, h, h],     # 6
            [-h, h, h],    # 7
        ],
        dtype=np.float32,
    )
    triangles = np.array(
        [
            [0, 1, 2], [0, 2, 3],        # bottom (-Y)
            [4, 6, 5], [4, 7, 6],        # top (+Y)
            [3, 2, 6], [3, 6, 7],        # front (+Z)
            [0, 5, 1], [0, 4, 5],        # back (-Z)
            [0, 7, 4], [0, 3, 7],        # left (-X)
            [1, 6, 2], [1, 5, 6],        # right (+X)
        ],
        dtype=np.int32,
    )
    return TriMesh(vertices, triangles)


def cube_corners(size: float = 1.0) -> np.ndarray:
    """The 8 cube-corner particle positions in the ordering used by the
    minimal CPU cube engine (``SoftBodyCubeCPU.cs:209-219``)."""
    h = size / 2.0
    return np.array(
        [
            [-h, -h, -h],
            [h, -h, -h],
            [h, h, -h],
            [-h, h, -h],
            [-h, -h, h],
            [h, -h, h],
            [h, h, h],
            [-h, h, h],
        ],
        dtype=np.float32,
    )


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> TriMesh:
    """Icosphere primitive (new capability required by BASELINE config 2;
    the reference has no sphere generator)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts[0])
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        mid_cache: dict = {}
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key in mid_cache:
                return mid_cache[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            idx = len(verts_list) - 1
            mid_cache[key] = idx
            return idx

        new_faces = []
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    return TriMesh((verts * radius).astype(np.float32), faces.astype(np.int32))


def signed_volume(mesh_vertices: np.ndarray, triangles: np.ndarray) -> float:
    """Signed volume of a closed surface; per-tet formula as in the unused
    reference helper ``CalculateVolume`` (``XPBDSimulatorCS.compute:220-223``)."""
    v = np.asarray(mesh_vertices, dtype=np.float64)
    t = np.asarray(triangles, dtype=np.int64)
    p1, p2, p3 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    return float(np.einsum("ij,ij->i", p1, np.cross(p2, p3)).sum() / 6.0)
