"""res^3 cube-lattice topology (the flagship workload).

Rebuilds the flagship engine's procedural generators —
particle grid (``SoftBodySimulator.cs:107-144``), structural edges
(``:214-233``), shear face-diagonals (``:235-269``), bend cube-diagonals
(``:270-290``) and the surface-quad render topology (``:391-444``) — as
vectorized NumPy.

Crucially for TPU, a lattice's constraint graph is exactly SEVEN fixed offset
families (3 structural axes + 3 shear diagonals + 1 bend diagonal).  The
stencil solver (``solvers/lattice.py``) exploits this: constraint projection
becomes shifted-array arithmetic with boundary masks — no edge list, no
gather, no scatter, no graph coloring.  Each family further splits into two
parity classes that are conflict-free, giving exact Gauss-Seidel as 14 dense
passes.  This module also emits the explicit edge list so the same lattice
can run on the general engine for cross-validation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# (dx, dy, dz, kind): kind 0=structural, 1=shear, 2=bend — mirrors the three
# constraint classes and their per-class compliances
# (SoftBodySettings.cs:30-38).
OFFSET_FAMILIES: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 0, 0, 0),
    (0, 1, 0, 0),
    (0, 0, 1, 0),
    (1, 1, 0, 1),
    (1, 0, 1, 1),
    (0, 1, 1, 1),
    (1, 1, 1, 2),
)

# Fully-braced variant: BOTH diagonals of every face + all 4 cube diagonals.
# The reference's single-diagonal bracing leaves free fold hinges (a square
# with one diagonal folds about it isometrically), so its lattice crumples
# under sustained load — unnoticed upstream because the flagship scene runs
# gravity=0.  13 families removes every hinge DOF.
BRACED_FAMILIES: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 0, 0, 0),
    (0, 1, 0, 0),
    (0, 0, 1, 0),
    (1, 1, 0, 1),
    (1, -1, 0, 1),
    (1, 0, 1, 1),
    (1, 0, -1, 1),
    (0, 1, 1, 1),
    (0, 1, -1, 1),
    (1, 1, 1, 2),
    (1, 1, -1, 2),
    (1, -1, 1, 2),
    (1, -1, -1, 2),
)


def family_anchor_ranges(res: int, family, reference_bounds: bool):
    """Valid anchor index ranges (xs, ys, zs) for a family's edges.

    reference_bounds=True replicates the reference quirk of anchoring all
    shear/bend diagonals at x,y,z < res-1 (SoftBodySimulator.cs:240-288).
    """
    dx, dy, dz, kind = family
    r = np.arange(res)

    def axis_range(d):
        if d > 0:
            return r[: res - d]
        if d < 0:
            return r[-d:]
        return r

    if reference_bounds and kind != 0:
        if min(dx, dy, dz) < 0:
            raise ValueError("reference bounds only defined for the 7 "
                             "non-negative reference families")
        return (r[: res - 1],) * 3
    return axis_range(dx), axis_range(dy), axis_range(dz)


def lattice_points(res: int, size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Particle grid, x-major ordering index = x*res^2 + y*res + z
    (``SoftBodySimulator.cs:121-144``)."""
    if res < 2:
        raise ValueError("resolution must be >= 2 (SoftBodySettings.cs:9-10)")
    size = np.asarray(size, dtype=np.float64)
    spacing = size / (res - 1)
    idx = np.arange(res, dtype=np.float64)
    x = idx * spacing[0] - size[0] * 0.5
    y = idx * spacing[1] - size[1] * 0.5
    z = idx * spacing[2] - size[2] * 0.5
    pts = np.stack(
        np.meshgrid(x, y, z, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    return (pts + np.asarray(center, np.float64)).astype(np.float32)


def _lin(res: int, x, y, z):
    return (x * res + y) * res + z


def lattice_edges(
    res: int,
    structural_compliance: float = 1e-4,
    shear_compliance: float = 1e-3,
    bend_compliance: float = 1e-2,
    braced: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Explicit (E,2) edge list + per-edge compliance.

    braced=False (default): the reference's 7 families with its quirky
    shear/bend anchor bounds — counts match the reference generators exactly:
    3*res^2*(res-1) structural, 3*(res-1)^3 shear, (res-1)^3 bend
    (SoftBodySimulator.cs:214-290).  braced=True: 13 families, exact bounds,
    hinge-free (see BRACED_FAMILIES).
    """
    comp_by_kind = (structural_compliance, shear_compliance, bend_compliance)
    families = BRACED_FAMILIES if braced else OFFSET_FAMILIES
    edges: List[np.ndarray] = []
    comps: List[np.ndarray] = []
    for fam in families:
        dx, dy, dz, kind = fam
        xs, ys, zs = family_anchor_ranges(res, fam, reference_bounds=not braced)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        a = _lin(res, gx, gy, gz).reshape(-1)
        b = _lin(res, gx + dx, gy + dy, gz + dz).reshape(-1)
        edges.append(np.stack([a, b], axis=1))
        comps.append(np.full(len(a), comp_by_kind[kind], dtype=np.float32))
    e = np.concatenate(edges, axis=0).astype(np.int32)
    c = np.concatenate(comps, axis=0)
    return e, c


def lattice_family_colors(res: int, braced: bool = False) -> np.ndarray:
    """Per-edge colors for ``lattice_edges`` output matching the stencil
    engine's pass order: color = 2*family + parity of the anchor coordinate
    along the family's leading offset axis.  Lets the general COLORED engine
    replay the stencil engine's exact Gauss-Seidel ordering for
    cross-validation."""
    families = BRACED_FAMILIES if braced else OFFSET_FAMILIES
    colors: List[np.ndarray] = []
    for fi, fam in enumerate(families):
        dx, dy, dz, _ = fam
        xs, ys, zs = family_anchor_ranges(res, fam, reference_bounds=not braced)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        lead = gx if dx else (gy if dy else gz)
        colors.append((2 * fi + (lead.reshape(-1) % 2)).astype(np.int32))
    return np.concatenate(colors)


def lattice_surface_triangles(res: int) -> np.ndarray:
    """Surface quads -> triangles, same winding as ``AddQuad``/``AddCubeFace``
    (``SoftBodySimulator.cs:413-444``): quad (a,b,c,d) -> (a,c,b), (a,d,c)."""
    tris: List[List[int]] = []

    def quad(a, b, c, d):
        tris.append([a, c, b])
        tris.append([a, d, c])

    for x in range(res - 1):
        for y in range(res - 1):
            for z in range(res - 1):
                if not (
                    x == 0 or x == res - 2 or y == 0 or y == res - 2
                    or z == 0 or z == res - 2
                ):
                    continue
                i000 = _lin(res, x, y, z)
                i001 = _lin(res, x, y, z + 1)
                i010 = _lin(res, x, y + 1, z)
                i011 = _lin(res, x, y + 1, z + 1)
                i100 = _lin(res, x + 1, y, z)
                i101 = _lin(res, x + 1, y, z + 1)
                i110 = _lin(res, x + 1, y + 1, z)
                i111 = _lin(res, x + 1, y + 1, z + 1)
                if x == 0:
                    quad(i000, i010, i011, i001)
                if x == res - 2:
                    quad(i100, i101, i111, i110)
                if y == 0:
                    quad(i000, i001, i101, i100)
                if y == res - 2:
                    quad(i010, i110, i111, i011)
                if z == 0:
                    quad(i000, i100, i110, i010)
                if z == res - 2:
                    quad(i001, i011, i111, i101)
    return np.asarray(tris, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static description consumed by the stencil solver: resolution, the
    offset-family set, and rest length / compliance per family (uniform
    within a family for a uniform grid).  Hashable => jit-static."""

    res: int
    size: Tuple[float, float, float]
    families: Tuple[Tuple[int, int, int, int], ...]
    rest_lengths: Tuple[float, ...]      # per family
    compliances: Tuple[float, ...]       # per family
    reference_bounds: bool               # reference's shear-anchor quirk

    @property
    def n_particles(self) -> int:
        return self.res ** 3

    @property
    def n_families(self) -> int:
        return len(self.families)


def lattice_spec(
    res: int,
    size=(1.0, 1.0, 1.0),
    structural_compliance: float = 1e-4,
    shear_compliance: float = 1e-3,
    bend_compliance: float = 1e-2,
    braced: bool = False,
) -> LatticeSpec:
    size = tuple(float(s) for s in size)
    spacing = np.asarray(size) / (res - 1)
    comp_by_kind = (structural_compliance, shear_compliance, bend_compliance)
    families = BRACED_FAMILIES if braced else OFFSET_FAMILIES
    rests, comps = [], []
    for dx, dy, dz, kind in families:
        rests.append(float(np.linalg.norm(
            spacing * np.abs(np.array([dx, dy, dz])))))
        comps.append(float(comp_by_kind[kind]))
    return LatticeSpec(res=res, size=size, families=families,
                       rest_lengths=tuple(rests), compliances=tuple(comps),
                       reference_bounds=not braced)


def cube8_triangles() -> np.ndarray:
    """Surface triangles over the 8 ``cube_corners``-ordered particles (the
    analog of SoftBodyCubeCPU's display mesh, which drives 24 render verts
    from the 8 particles, ``SoftBodyCubeCPU.cs:351-411``)."""
    quads = [
        (0, 1, 2, 3),   # -z face
        (5, 4, 7, 6),   # +z face
        (4, 0, 3, 7),   # -x face
        (1, 5, 6, 2),   # +x face
        (4, 5, 1, 0),   # -y face
        (3, 2, 6, 7),   # +y face
    ]
    tris = []
    for a, b, c, d in quads:
        tris += [[a, c, b], [a, d, c]]
    return np.asarray(tris, dtype=np.int32)


def cube8_edges(
    with_face_diagonals: bool = True, with_internal_diagonals: bool = True
) -> np.ndarray:
    """The hand-built 8-corner cube constraint set
    (``SoftBodyCubeCPU.cs:226-271``): 12 edges, optional 12 face diagonals,
    optional 4 internal diagonals."""
    e = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    if with_face_diagonals:
        e += [
            (0, 2), (1, 3), (4, 6), (5, 7),
            (0, 5), (1, 4), (1, 6), (2, 5),
            (2, 7), (3, 6), (3, 4), (0, 7),
        ]
    if with_internal_diagonals:
        e += [(0, 6), (1, 7), (2, 4), (3, 5)]
    return np.asarray(e, dtype=np.int32)
