"""Particle and constraint orderings for windowed mesh topologies.

Counterpart of the ordering helpers of ``softbodysimulation_tpu/topology/
windows.py`` (``rcm_order``, ``sort_edges_by_window``,
``sort_hinges_by_window``), copied verbatim.  Reverse Cuthill-McKee keeps
every edge between nearby particle indices, and the min-endpoint sorts keep
consecutive constraints on nearby particles; ``topology/build.py`` applies
them so a windowed topology numbers particles and constraints exactly as the
JAX package does.  The one-hot window matrices that module also builds
(``build_windows``, ``build_hinge_windows``) are a layout for the TPU's
matrix unit and have no counterpart here.
"""

from __future__ import annotations

import numpy as np


def rcm_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering. Returns ``order`` (new -> old index),
    i.e. particle ``order[i]`` of the input becomes particle ``i``."""
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    deg = np.array([len(a) for a in adj])
    visited = np.zeros(n, bool)
    order = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in sorted((v for v in adj[u] if not visited[v]),
                            key=lambda v: deg[v]):
                if visited[v]:      # duplicate adjacency entry
                    continue
                visited[v] = True
                queue.append(v)
    return np.array(order[::-1], dtype=np.int64)


def sort_edges_by_window(edges: np.ndarray):
    """Stable-sort edges by min endpoint (block locality). Returns the
    sort permutation (apply it to every per-edge array)."""
    return np.argsort(edges.min(axis=1), kind="stable")


def sort_hinges_by_window(hinges: np.ndarray):
    """Stable-sort hinges by min endpoint (block locality)."""
    return np.argsort(hinges.min(axis=1), kind="stable")
