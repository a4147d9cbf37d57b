"""Edge / hinge extraction and vertex welding (host-side, NumPy).

Capability parity with the reference's topology passes:
  * unique edge extraction from triangles  — ``SoftBodyCPU.cs:160-201``
  * dihedral hinge discovery               — ``SoftBodyCPU.cs:203-266``
  * opposite-vertex bending distance pairs — ``SoftBodyGPU.cs:334-356``
  * position-epsilon vertex welding        — ``SoftBodyGPU.cs:369-413``
All vectorized NumPy (the reference's O(n^2) weld becomes an O(n log n)
lexsort); a C++ fast path may override these for very large meshes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unique_edges(triangles: np.ndarray) -> np.ndarray:
    """Unique undirected edges (a < b), sorted lexicographically.

    Deterministic replacement for the reference's HashSet iteration order
    (``SoftBodyCPU.cs:164-176``), which was unspecified.
    """
    t = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return e.astype(np.int32)


def hinges(triangles: np.ndarray) -> np.ndarray:
    """Dihedral hinges: rows [a, b, c, d] where edge (a,b) is shared by
    exactly two triangles with opposite tips c and d
    (``SoftBodyCPU.cs:203-266``).  Edges shared by !=2 triangles are skipped,
    as are degenerate tip configurations (``SoftBodyCPU.cs:254``)."""
    t = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    # every (edge, opposite-vertex) incidence
    ab = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0)
    opp = np.concatenate([t[:, 2], t[:, 0], t[:, 1]], axis=0)
    ab = np.sort(ab, axis=1)
    order = np.lexsort((opp, ab[:, 1], ab[:, 0]))
    ab, opp = ab[order], opp[order]
    same = (ab[1:] == ab[:-1]).all(axis=1)
    # boundaries of runs of identical edges
    run_start = np.concatenate([[True], ~same])
    starts = np.flatnonzero(run_start)
    run_len = np.diff(np.concatenate([starts, [len(ab)]]))
    two = run_len == 2
    s = starts[two]
    a, b = ab[s, 0], ab[s, 1]
    c, d = opp[s], opp[s + 1]
    ok = (c != d) & (c != a) & (c != b) & (d != a) & (d != b)
    out = np.stack([a[ok], b[ok], c[ok], d[ok]], axis=1)
    return out.astype(np.int32)


def opposite_vertex_pairs(triangles: np.ndarray) -> np.ndarray:
    """Cross-edge bending pairs: for each interior edge, the two opposite
    vertices (the SoftBodyGPU scheme, where bending constraints are plain
    distance constraints between tips, ``SoftBodyGPU.cs:347-356``)."""
    h = hinges(triangles)
    if h.shape[0] == 0:
        return np.zeros((0, 2), np.int32)
    p = np.sort(h[:, 2:4].astype(np.int64), axis=1)
    p = np.unique(p, axis=0)
    return p.astype(np.int32)


def weld(
    vertices: np.ndarray, triangles: np.ndarray, eps: float = 1e-4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge vertices closer than ``eps``.

    Returns (welded_vertices, retriangulated_triangles, map_to_welded) where
    ``map_to_welded[i]`` is the welded index of original vertex i — the
    analog of ``_originalIndexMap`` used to un-weld for display
    (``SoftBodyGPU.cs:369-413``, ``:254-258``).  Quantises to an eps-grid
    (O(n log n)) instead of the reference's O(n^2) pairwise scan.
    """
    v = np.asarray(vertices, dtype=np.float64)
    keys = np.round(v / eps).astype(np.int64)
    _, first_idx, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    # keep stable order: remap unique ids by order of first appearance
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    map_to_welded = rank[inverse].astype(np.int32)
    keep = np.sort(first_idx)
    welded_vertices = v[keep].astype(np.float32)
    tri = map_to_welded[np.asarray(triangles, dtype=np.int64)]
    # drop degenerate triangles created by welding
    good = (
        (tri[:, 0] != tri[:, 1])
        & (tri[:, 1] != tri[:, 2])
        & (tri[:, 2] != tri[:, 0])
    )
    return welded_vertices, tri[good].astype(np.int32), map_to_welded


def edge_rest_lengths(vertices: np.ndarray, edges: np.ndarray) -> np.ndarray:
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(edges, dtype=np.int64)
    d = v[e[:, 1]] - v[e[:, 0]]
    return np.linalg.norm(d, axis=1).astype(np.float32)


def hinge_rest_angles(vertices: np.ndarray, hinge_arr: np.ndarray) -> np.ndarray:
    """Rest dihedral angles acos(n1·n2) per hinge
    (``CPUBendingConstraint.CalculateRestAngle``,
    ``CPUBendingConstraint.cs:169-188``)."""
    v = np.asarray(vertices, dtype=np.float64)
    h = np.asarray(hinge_arr, dtype=np.int64)
    if h.shape[0] == 0:
        return np.zeros((0,), np.float32)
    pa, pb, pc, pd = v[h[:, 0]], v[h[:, 1]], v[h[:, 2]], v[h[:, 3]]
    e0, e1, e2 = pb - pa, pc - pa, pd - pa
    n1 = np.cross(e0, e1)
    n2 = np.cross(e2, e0)
    l1 = np.linalg.norm(n1, axis=1)
    l2 = np.linalg.norm(n2, axis=1)
    ok = (l1 * l1 > 1e-9) & (l2 * l2 > 1e-9)
    cos = np.einsum("ij,ij->i", n1, n2) / np.where(ok, l1 * l2, 1.0)
    cos = np.clip(cos, -1.0, 1.0)
    ang = np.where(ok, np.arccos(cos), 0.0)
    return ang.astype(np.float32)
