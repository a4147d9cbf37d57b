"""Graph coloring of constraints (host-side preprocessing).

Port-in-spirit of the reference's two coloring strategies — naive greedy
(``SoftBodySimulator.cs:316-364``) and cluster-merge coloring
(``GraphClustering.cs:16-136``) — made deterministic and O(E·deg) instead of
O(E^2).  Colors partition constraints so that no two constraints in a color
share a particle; the COLORED solve mode then does exact parallel
Gauss-Seidel, one fixed-shape batched pass per color (replacing the per-color
``Dispatch`` loop at ``SoftBodySimulator.cs:600-609``).

Races are impossible in functional JAX, so unlike the reference's stubbed
``ValidateColorGroups`` kernel (``XPBDSoftBody.compute:209-232``) our
validator actually reports conflicts — as a topology unit test.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def greedy_color(constraints: np.ndarray, n_particles: int) -> np.ndarray:
    """Greedy first-fit coloring.

    ``constraints``: (K, A) int array; each row's entries are the particle
    indices it touches (A=2 edges, A=4 hinges).  Returns (K,) color ids.
    Deterministic: constraints processed in row order, smallest free color.
    """
    cons = np.asarray(constraints, dtype=np.int64).reshape(len(constraints), -1)
    k = cons.shape[0]
    colors = np.full(k, -1, dtype=np.int64)
    if k == 0:
        return colors.astype(np.int32)
    # particle -> bitmask-ish set of used colors, kept as python sets per
    # particle (fast enough: total work = sum of degrees)
    used_by_particle: List[set] = [set() for _ in range(n_particles)]
    for i in range(k):
        used: set = set()
        for p in cons[i]:
            used |= used_by_particle[p]
        c = 0
        while c in used:
            c += 1
        colors[i] = c
        for p in cons[i]:
            used_by_particle[p].add(c)
    return colors.astype(np.int32)


def validate_coloring(constraints: np.ndarray, colors: np.ndarray) -> bool:
    """True iff no two same-color constraints share a particle (the check the
    reference's ``ValidateColorGroups`` kernel left as an empty stub)."""
    cons = np.asarray(constraints, dtype=np.int64).reshape(len(constraints), -1)
    colors = np.asarray(colors)
    for c in np.unique(colors):
        rows = cons[colors == c]
        flat = rows.reshape(-1)
        if len(np.unique(flat)) != len(flat):
            return False
    return True


def color_buckets(
    colors: np.ndarray, pad_multiple: int = 8
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack constraint indices into padded per-color buckets.

    Returns (ids (C, M) int32, valid (C, M) float32, num_colors).  M is the
    max bucket size rounded up to ``pad_multiple`` (for TPU-friendly shapes).
    Padding entries carry id 0 and valid 0.0, so downstream scatters are
    no-ops for them.
    """
    colors = np.asarray(colors, dtype=np.int64)
    if colors.size == 0:
        return (
            np.zeros((1, pad_multiple), np.int32),
            np.zeros((1, pad_multiple), np.float32),
            1,
        )
    num_colors = int(colors.max()) + 1
    counts = np.bincount(colors, minlength=num_colors)
    m = int(counts.max())
    m = ((m + pad_multiple - 1) // pad_multiple) * pad_multiple
    ids = np.zeros((num_colors, m), dtype=np.int32)
    valid = np.zeros((num_colors, m), dtype=np.float32)
    for c in range(num_colors):
        idx = np.flatnonzero(colors == c)
        ids[c, : len(idx)] = idx
        valid[c, : len(idx)] = 1.0
    return ids, valid, num_colors


def cluster_color(
    constraints: np.ndarray, n_particles: int, target_per_cluster: int = 8
) -> np.ndarray:
    """Cluster-then-color (capability of ``GraphClustering.cs:16-136``).

    The reference greedily merges the cluster pair sharing the most particles
    (O(K^3)); we get the same effect — spatially coherent clusters about
    ``target_per_cluster`` constraints each — via union-find over shared
    particles with a size cap, then color the cluster graph.  Constraints in
    one cluster share a color, so this yields FEWER, larger color groups at
    the cost of more colors than per-constraint greedy — the same trade the
    reference made to cut dispatch count.
    """
    # NB the reference's version is UNSOUND: it merges clusters that share
    # particles and then gives every constraint in a cluster one color
    # (``GraphClustering.cs:70-72`` + ``:126-132``), so same-color constraints
    # inside a cluster race — the very hazard its stubbed ValidateColorGroups
    # kernel was meant to catch.  Our COLORED solve mode requires validity, so
    # here clusters only define a locality-coherent *ordering* for the greedy
    # colorer; the result is always conflict-free.
    cons = np.asarray(constraints, dtype=np.int64).reshape(len(constraints), -1)
    k = cons.shape[0]
    if k == 0:
        return np.zeros((0,), np.int32)

    parent = np.arange(k)
    size = np.ones(k, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    last_cons_of_particle = np.full(n_particles, -1, dtype=np.int64)
    for i in range(k):
        for p in cons[i]:
            j = last_cons_of_particle[p]
            if j >= 0:
                ri, rj = find(i), find(int(j))
                if ri != rj and size[ri] + size[rj] <= target_per_cluster:
                    parent[rj] = ri
                    size[ri] += size[rj]
            last_cons_of_particle[p] = i

    roots = np.array([find(i) for i in range(k)])
    _, cluster_id = np.unique(roots, return_inverse=True)

    # greedy-color constraints in cluster-major order: spatially coherent
    # colors (the reference's goal) without the reference's races
    order = np.argsort(cluster_id, kind="stable")
    colors = np.full(k, -1, dtype=np.int64)
    used_by_particle: List[set] = [set() for _ in range(n_particles)]
    for i in order:
        used: set = set()
        for p in cons[i]:
            used |= used_by_particle[p]
        c = 0
        while c in used:
            c += 1
        colors[i] = c
        for p in cons[i]:
            used_by_particle[p].add(c)
    return colors.astype(np.int32)
