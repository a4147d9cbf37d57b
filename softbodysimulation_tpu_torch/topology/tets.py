"""Tetrahedral topology builders (host-side NumPy, runs once).

Solid soft bodies: decompose a volume into tetrahedra, one XPBD volume
constraint per tet (``ops/tet_volume.py``) plus distance constraints on the
tet edges.  The reference seeded exactly this capability and never wired it:
``CalculateVolume`` (``XPBDSimulatorCS.compute:220-223``) is a tet-volume
helper, and the commented-out ``AddVolumeConstraints``
(``SoftBodySimulator.cs:187-212``) walks cube cells intending per-cell
volume preservation.  Builders here:

* ``cube_lattice_tets``      — Kuhn (6-tet path) subdivision of every cell of
  the res^3 lattice, index-compatible with ``lattice.lattice_points``'s
  x-major numbering (index = x*res^2 + y*res + z).  All six tets of a cell
  share the cell's main diagonal, so the subdivision is conforming across
  neighboring cells (faces match) with no parity alternation needed.
* ``tets_from_surface_centroid`` — closed surface mesh -> one interior
  centroid vertex + one tet per face: the cheap volumetric fill for blobby
  closed meshes (icospheres, welded shells).
* ``tet_edges`` / ``boundary_faces`` / ``fix_orientation`` / ``tet_rest_volumes6``
  — derived structure: unique edges for the distance family, outward-oriented
  boundary triangles (faces used by exactly one tet) for rendering/export/
  global-volume, positive-orientation repair, and 6x rest volumes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Kuhn/path subdivision: cube corner id = 4x + 2y + z (matching the lattice's
# x-major vertex numbering); each axis permutation walks 000 -> 111 one axis
# at a time, giving 6 congruent tets that all share the 000-111 diagonal.
# Odd permutations produce NEGATIVE orientation in walk order, so their
# last two corners are swapped here — every path tet is positively oriented
# as written (the stencil engine consumes these offsets directly and has no
# fix_orientation pass).
_KUHN_PATHS = (
    (0b000, 0b100, 0b110, 0b111),   # x, y, z
    (0b000, 0b100, 0b111, 0b101),   # x, z, y (swapped)
    (0b000, 0b010, 0b111, 0b110),   # y, x, z (swapped)
    (0b000, 0b010, 0b011, 0b111),   # y, z, x
    (0b000, 0b001, 0b101, 0b111),   # z, x, y
    (0b000, 0b001, 0b111, 0b011),   # z, y, x (swapped)
)


def kuhn_offset_paths() -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """The 6 Kuhn path tets as per-corner (dx, dy, dz) cell offsets —
    corner order matches ``cube_lattice_tets`` (p0 = cell origin,
    p3 = opposite corner).  The stencil lattice engine treats each path
    as one offset FAMILY (``solvers/lattice._tet_sweep``)."""
    return tuple(
        tuple(((b >> 2) & 1, (b >> 1) & 1, b & 1) for b in path)
        for path in _KUHN_PATHS)


def cube_lattice_tets(res: int) -> np.ndarray:
    """(6*(res-1)^3, 4) int32 tets over the res^3 lattice grid."""
    if res < 2:
        return np.zeros((0, 4), np.int32)
    c = np.arange(res - 1)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    base = (gx * res * res + gy * res + gz).reshape(-1)       # cell origin
    # corner offsets in lattice indexing for cube corner id 4x+2y+z
    off = np.array([(b >> 2 & 1) * res * res + (b >> 1 & 1) * res + (b & 1)
                    for b in range(8)], np.int64)
    tets = []
    for path in _KUHN_PATHS:
        tets.append(np.stack([base + off[v] for v in path], axis=1))
    return np.concatenate(tets, axis=0).astype(np.int32)


def tets_from_surface_centroid(
        vertices: np.ndarray, triangles: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Fill a closed surface with a centroid fan: returns
    (vertices+centroid, (T,4) tets = [centroid, v0, v1, v2])."""
    vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
    triangles = np.asarray(triangles, np.int64).reshape(-1, 3)
    centroid = vertices.mean(axis=0, keepdims=True)
    verts = np.concatenate([vertices, centroid], axis=0)
    cid = len(vertices)
    tets = np.concatenate(
        [np.full((len(triangles), 1), cid, np.int64), triangles], axis=1)
    return verts, fix_orientation(verts, tets.astype(np.int32))


def tet_volumes6(positions: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """(T,) 6x signed volumes (host NumPy; see ops/tet_volume.tet_volume6)."""
    p = np.asarray(positions, np.float64)[np.asarray(tets, np.int64)]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    return np.einsum("ij,ij->i", e1, np.cross(e2, e3))


# alias: rest volumes are stored pre-multiplied by 6 (ops/tet_volume.py)
tet_rest_volumes6 = tet_volumes6


def fix_orientation(positions: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Swap the last two indices of negatively oriented tets so every signed
    volume is positive (degenerate zero-volume tets are rejected)."""
    tets = np.asarray(tets, np.int32).reshape(-1, 4).copy()
    v = tet_volumes6(positions, tets)
    if (v == 0).any():
        raise ValueError("degenerate (zero-volume) tetrahedron")
    neg = v < 0
    tets[neg] = tets[neg][:, [0, 1, 3, 2]]
    return tets


def tet_edges(tets: np.ndarray) -> np.ndarray:
    """(E,2) unique undirected edges of a tet set (the distance family)."""
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    e = np.concatenate([tets[:, [a, b]] for a, b in pairs], axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return e.astype(np.int32)


def boundary_faces(tets: np.ndarray) -> np.ndarray:
    """(F,3) outward-oriented boundary triangles: the tet faces used exactly
    once.  Faces are emitted with the outward winding of a POSITIVELY
    oriented tet (run ``fix_orientation`` first)."""
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    # outward faces of a positively oriented tet (0,1,2,3)
    faces = np.concatenate([
        tets[:, [1, 2, 3]],
        tets[:, [0, 3, 2]],
        tets[:, [0, 1, 3]],
        tets[:, [0, 2, 1]],
    ], axis=0)
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return faces[counts[inv] == 1].astype(np.int32)
