"""Assemble a ``Topology`` of tensors from host-side mesh data (NumPy).

Counterpart of ``softbodysimulation_tpu/topology/build.py``
(``build_topology`` with its tetrahedra, ``build_incidence``,
``build_windowed_topology``, ``validate_topology``, ``topology_from_mesh``,
``BodySpec``, ``BodySlices``, ``merge_topologies``): the same NumPy
arithmetic, so every field equals the JAX builder's, integers exactly and
floats to the bit.  ``build_windowed_topology`` keeps the reverse
Cuthill-McKee renumbering (of tets too), the window sorts of edges and
hinges and the colour-major edge order of ``colored=True``, so a state
means the same particles in both packages; it builds no one-hot window
matrices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.state import Topology
from . import coloring as _coloring
from . import edges as _edges
from . import mesh as _mesh


def _t(a, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype))


def build_topology(
    positions: np.ndarray,
    edges: np.ndarray,
    compliance,
    hinges: Optional[np.ndarray] = None,
    bend_compliance=0.1,
    triangles: Optional[np.ndarray] = None,
    color: bool = True,
    color_strategy: str = "greedy",
    colors: Optional[np.ndarray] = None,
    rest_lengths: Optional[np.ndarray] = None,
    rest_angles: Optional[np.ndarray] = None,
    tets: Optional[np.ndarray] = None,
    tet_compliance=0.0,
    rest_tet_volumes: Optional[np.ndarray] = None,
) -> Topology:
    """Build the static constraint topology on the CPU (``Topology.to``
    moves it).

    positions  — (N,3) rest positions (rest lengths/angles measured here,
                 as in ``SoftBodyCPU.cs:182`` / ``:256``).
    edges      — (E,2) int distance constraints.
    compliance — scalar or (E,) XPBD compliance per edge.
    hinges     — (H,4) dihedral bending constraints or None.
    triangles  — (T,3) surface triangles (normals/volume/export) or None.
    tets       — (T,4) tetrahedra for the per-tet volume family
                 (``topology/tets.py``) or None; ``rest_tet_volumes`` are
                 6x signed volumes, measured here when not given.
    """
    positions = np.asarray(positions, dtype=np.float64)
    n = positions.shape[0]
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    e = edges.shape[0]
    comp = np.broadcast_to(np.asarray(compliance, np.float32), (e,)).copy()
    if rest_lengths is None:
        rest_lengths = _edges.edge_rest_lengths(positions, edges)
    else:
        rest_lengths = np.asarray(rest_lengths, np.float32)

    if hinges is None:
        hinges = np.zeros((0, 4), np.int32)
    hinges = np.asarray(hinges, dtype=np.int32).reshape(-1, 4)
    h = hinges.shape[0]
    bcomp = np.broadcast_to(np.asarray(bend_compliance, np.float32),
                            (h,)).copy()
    if rest_angles is None:
        rest_angles = _edges.hinge_rest_angles(positions, hinges)
    else:
        rest_angles = np.asarray(rest_angles, np.float32)

    if triangles is None:
        triangles = np.zeros((0, 3), np.int32)
    triangles = np.asarray(triangles, dtype=np.int32).reshape(-1, 3)
    rest_volume = (
        _mesh.signed_volume(positions, triangles) if triangles.shape[0]
        else 0.0)

    from . import native as _native

    color_fn = {
        # native C++ colorer when available (identical deterministic
        # algorithm, tested bit-equal); NumPy/Python fallback otherwise
        "greedy": _native.greedy_color,
        "cluster": _coloring.cluster_color,
    }[color_strategy]
    if colors is not None:
        colors = np.asarray(colors, np.int32)
        if not _coloring.validate_coloring(edges, colors):
            raise ValueError("provided edge coloring has conflicts")
    elif color and e:
        colors = color_fn(edges, n)
    else:
        colors = np.zeros((e,), np.int32)
    col_ids, col_valid, num_colors = _coloring.color_buckets(colors)

    if color and h:
        bcolors = color_fn(hinges, n)
    else:
        bcolors = np.zeros((h,), np.int32)
    bcol_ids, bcol_valid, num_bcolors = _coloring.color_buckets(bcolors)

    tet_fields = {}
    if tets is not None and len(tets):
        from . import tets as _tets

        tets = np.asarray(tets, np.int32).reshape(-1, 4)
        t = tets.shape[0]
        tcomp = np.broadcast_to(
            np.asarray(tet_compliance, np.float32), (t,)).copy()
        if rest_tet_volumes is None:
            rest_tv = _tets.tet_rest_volumes6(positions, tets)
            if (rest_tv <= 0).any():
                raise ValueError("non-positive rest tet volume — run "
                                 "tets.fix_orientation")
        else:
            rest_tv = np.asarray(rest_tet_volumes, np.float64)
        tcolors = color_fn(tets, n) if color else np.zeros((t,), np.int32)
        tcol_ids, tcol_valid, num_tcolors = _coloring.color_buckets(tcolors)
        tdeg = np.bincount(tets.reshape(-1), minlength=n).astype(np.float32)
        tet_fields = dict(
            tets=_t(tets, np.int32),
            rest_tet_volumes=_t(rest_tv, np.float32),
            tet_compliance=_t(tcomp, np.float32),
            tcol_tet_ids=_t(tcol_ids, np.int32),
            tcol_valid=_t(tcol_valid, np.float32),
            tet_degree=_t(tdeg, np.float32),
            tet_incidence=_t(build_incidence(tets, n), np.int32),
            num_tet_colors=num_tcolors,
        )

    deg = np.bincount(edges.reshape(-1), minlength=n).astype(np.float32)
    bdeg = np.bincount(hinges.reshape(-1), minlength=n).astype(np.float32)

    return Topology(
        edges=_t(edges, np.int32),
        rest_lengths=_t(rest_lengths, np.float32),
        compliance=_t(comp, np.float32),
        colors=_t(colors, np.int32),
        col_edge_ids=_t(col_ids, np.int32),
        col_valid=_t(col_valid, np.float32),
        hinges=_t(hinges, np.int32),
        rest_angles=_t(rest_angles, np.float32),
        bend_compliance=_t(bcomp, np.float32),
        bend_colors=_t(bcolors, np.int32),
        bcol_hinge_ids=_t(bcol_ids, np.int32),
        bcol_valid=_t(bcol_valid, np.float32),
        triangles=_t(triangles, np.int32),
        rest_volume=_t(rest_volume, np.float32),
        degree=_t(deg, np.float32),
        bend_degree=_t(bdeg, np.float32),
        incidence=_t(build_incidence(edges, n), np.int32),
        bend_incidence=_t(build_incidence(hinges, n), np.int32),
        num_colors=num_colors,
        num_bend_colors=num_bcolors,
        n_particles=n,
        **tet_fields,
    )


def build_incidence(constraints: np.ndarray, n: int,
                    pad_multiple: int = 4) -> np.ndarray:
    """(N, D) indices into the flattened (K*arity) contribution array; for
    constraint k touching particle p as its a-th endpoint, the contribution
    index is a*K + k.  Rows padded with K*arity (an appended zero row)."""
    cons = np.asarray(constraints, dtype=np.int64)
    k = cons.shape[0]
    if k == 0:
        return np.zeros((n, 0), np.int32)
    arity = cons.shape[1]
    counts = np.bincount(cons.reshape(-1), minlength=n)
    d = int(counts.max()) if len(counts) else 0
    d = max(pad_multiple, ((d + pad_multiple - 1) // pad_multiple)
            * pad_multiple)
    out = np.full((n, d), k * arity, dtype=np.int32)
    flat_p = cons.T.reshape(-1)              # particle of contribution a*k+j
    contrib_idx = np.arange(arity * k, dtype=np.int64)
    order = np.argsort(flat_p, kind="stable")
    sorted_p = flat_p[order]
    group_start = np.searchsorted(sorted_p, np.arange(n))
    ranks = np.arange(len(sorted_p)) - group_start[sorted_p]
    out[sorted_p, ranks] = contrib_idx[order]
    return out


def build_windowed_topology(
    positions: np.ndarray,
    edges: np.ndarray,
    compliance,
    hinges: Optional[np.ndarray] = None,
    triangles: Optional[np.ndarray] = None,
    rest_lengths: Optional[np.ndarray] = None,
    block_edges: int = 128,
    max_window: int = 1024,
    seg_align: int = 128,
    colored: bool = False,
    order: Optional[np.ndarray] = None,
    **kw,
):
    """The JAX package's windowed topology without its window matrices:
    particles renumbered by reverse Cuthill-McKee (or ``order``, new ->
    old), edges and hinges stable-sorted by min endpoint, tets renumbered
    in their own order, and with ``colored=True`` the edges re-sorted
    colour-major (stable).  ``tet_window_perm`` (the tets sorted by min
    endpoint) is set where JAX's tet windows would fit ``max_window``
    (``tet_window_perm``), as JAX sets it only where its window builder
    succeeds.  Returns
    ``(positions_permuted (N,3) f32, Topology)`` — build the state from the
    returned positions."""
    from . import windows as _windows

    positions = np.asarray(positions, np.float64)
    n = positions.shape[0]
    edges = np.asarray(edges, np.int32).reshape(-1, 2)
    e = edges.shape[0]
    comp = np.broadcast_to(np.asarray(compliance, np.float32), (e,)).copy()

    if order is None:
        order = _windows.rcm_order(edges, n)
    else:
        order = np.asarray(order, np.int64)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pos2 = positions[order]
    e2 = rank[edges.astype(np.int64)].astype(np.int32)
    sortperm = _windows.sort_edges_by_window(e2)
    e2 = e2[sortperm]
    comp = comp[sortperm]
    if rest_lengths is not None:
        rest_lengths = np.asarray(rest_lengths, np.float32)[sortperm]
    if colored and e:
        from . import native as _native

        colors = _native.greedy_color(e2, n)
        cperm = np.argsort(colors, kind="stable")
        e2 = e2[cperm]
        comp = comp[cperm]
        colors = colors[cperm]
        if rest_lengths is not None:
            rest_lengths = rest_lengths[cperm]
        kw["colors"] = colors
    if hinges is not None and len(hinges):
        hinges = rank[np.asarray(hinges, np.int64)].astype(np.int32)
        hinges = hinges[_windows.sort_hinges_by_window(hinges)]
    if triangles is not None and len(triangles):
        triangles = rank[np.asarray(triangles, np.int64)].astype(np.int32)
    tets = kw.pop("tets", None)
    if tets is not None and len(tets):
        # orientation is invariant under relabelling: no re-fixing needed
        kw["tets"] = rank[np.asarray(tets, np.int64)].astype(np.int32)

    topo = build_topology(pos2, e2, comp, hinges=hinges,
                          triangles=triangles, rest_lengths=rest_lengths,
                          **kw)
    if topo.n_tets:
        perm = tet_window_perm(topo.tets.numpy(), min(block_edges, 128),
                               max_window, seg_align)
        if perm is not None:
            topo = topo.replace(tet_window_perm=_t(perm, np.int32))
    return pos2.astype(np.float32), topo


def tet_window_perm(tets: np.ndarray, block: int, max_window: int,
                    seg_align: int) -> Optional[np.ndarray]:
    """The tets' min-endpoint sort (slot -> tet), or None where JAX's tet
    windows (``topology/windows.build_hinge_windows`` of the JAX package:
    blocks of ``block`` sorted tets, the last one repeated to pad, each
    block's particle span from its base rounded down to ``seg_align``,
    rounded up to it) would exceed ``max_window``, as for a centroid fan's
    hub on a large mesh."""
    from . import windows as _windows

    order = _windows.sort_hinges_by_window(tets)
    t = np.asarray(tets, np.int64)[order]
    k = max(1, -(-len(t) // block))
    if k * block > len(t):
        t = np.vstack([t, np.tile(t[-1:], (k * block - len(t), 1))])
    blocks = t.reshape(k, block, 4)
    bases = (blocks.min(axis=(1, 2)) // seg_align) * seg_align
    span = int((blocks.max(axis=(1, 2)) - bases + 1).max())
    if seg_align * -(-span // seg_align) > max_window:
        return None
    return order.astype(np.int32)


def validate_topology(topo: Topology) -> dict:
    """Constraint-data validation (the ``ValidateConstraintData`` analog,
    ``SoftBodySimulator.cs:1018-1044``): index bounds, positive rest
    lengths, non-negative compliances, coloring validity.  Returns a report
    dict; raises on hard violations."""
    edges = topo.edges.cpu().numpy()
    n = topo.n_particles
    report = {"n_particles": n, "n_edges": topo.n_edges,
              "n_hinges": topo.n_hinges, "num_colors": topo.num_colors}
    if topo.n_edges:
        if edges.min() < 0 or edges.max() >= n:
            raise ValueError("edge indices out of bounds")
        if (edges[:, 0] == edges[:, 1]).any():
            raise ValueError("degenerate edge (a == b)")
        if not (topo.rest_lengths > 0).all():
            raise ValueError("non-positive rest length")
        if (topo.compliance < 0).any():
            raise ValueError("negative compliance")
        if not _coloring.validate_coloring(edges, topo.colors.cpu().numpy()):
            raise ValueError("edge coloring has conflicts")
    h = topo.hinges.cpu().numpy()
    if topo.n_hinges:
        if h.min() < 0 or h.max() >= n:
            raise ValueError("hinge indices out of bounds")
        if not _coloring.validate_coloring(h,
                                           topo.bend_colors.cpu().numpy()):
            raise ValueError("hinge coloring has conflicts")
    t = topo.triangles
    if t.shape[0] and (t.min() < 0 or t.max() >= n):
        raise ValueError("triangle indices out of bounds")
    if topo.n_tets:
        tt = topo.tets.cpu().numpy()
        report["n_tets"] = topo.n_tets
        if tt.min() < 0 or tt.max() >= n:
            raise ValueError("tet indices out of bounds")
        if not (topo.rest_tet_volumes > 0).all():
            raise ValueError("non-positive rest tet volume")
        ids = topo.tcol_tet_ids.cpu().numpy()
        val = topo.tcol_valid.cpu().numpy()
        for c in range(topo.num_tet_colors):
            flat = tt[ids[c][val[c] > 0]].reshape(-1)
            if len(np.unique(flat)) != len(flat):
                raise ValueError("tet coloring has conflicts")
    report["ok"] = True
    return report


def topology_from_mesh(
    mesh: "_mesh.TriMesh",
    compliance: float = 0.01,
    bending: bool = False,
    bend_compliance: float = 0.1,
    weld_eps: float = 0.0,
    windowed: bool = False,
    **kw,
):
    """Mesh -> particles + edge/hinge constraints, the
    ``InitializeSoftBodyFromMesh`` path (``SoftBodyCPU.cs:121-157``).
    Returns (positions, Topology).  ``weld_eps > 0`` welds first
    (``SoftBodyGPU.cs:121``).  ``windowed=True`` renumbers the vertices by
    reverse Cuthill-McKee (the returned positions and the topology's
    triangles are in the permuted space); ``windowed="colored"``
    additionally orders edges colour-major."""
    verts, tris = mesh.vertices, mesh.triangles
    if weld_eps > 0:
        verts, tris, _ = _edges.weld(verts, tris, weld_eps)
    e = _edges.unique_edges(tris)
    hn = _edges.hinges(tris) if bending else None
    if windowed:
        return build_windowed_topology(
            verts, e, compliance, hinges=hn,
            bend_compliance=bend_compliance, triangles=tris,
            colored=(windowed == "colored"), **kw)
    topo = build_topology(verts, e, compliance, hinges=hn,
                          bend_compliance=bend_compliance, triangles=tris,
                          **kw)
    return verts.astype(np.float32), topo


class BodySpec:
    """Host-side description of ONE soft body, for ``merge_topologies``: its
    positions and optional constraint families with per-body (scalar or
    per-element) compliances.  Indices are local to the body; merging
    offsets them."""

    def __init__(self, positions, edges=None, compliance=1e-4,
                 hinges=None, bend_compliance=0.1,
                 triangles=None, tets=None, tet_compliance=0.0):
        self.positions = np.asarray(positions, np.float64).reshape(-1, 3)
        n = self.positions.shape[0]

        def rows(a, k):
            return (np.zeros((0, k), np.int32) if a is None
                    else np.asarray(a, np.int32).reshape(-1, k))

        self.edges = rows(edges, 2)
        self.hinges = rows(hinges, 4)
        self.triangles = rows(triangles, 3)
        self.tets = rows(tets, 4)
        for name, arr in (("edges", self.edges), ("hinges", self.hinges),
                          ("triangles", self.triangles), ("tets", self.tets)):
            if arr.size and (arr.min() < 0 or arr.max() >= n):
                raise ValueError(f"{name} index out of range for body "
                                 f"with {n} particles")

        def per(c, rows_):
            return np.broadcast_to(np.asarray(c, np.float32),
                                   (rows_.shape[0],)).copy()

        self.compliance = per(compliance, self.edges)
        self.bend_compliance = per(bend_compliance, self.hinges)
        self.tet_compliance = per(tet_compliance, self.tets)


class BodySlices:
    """Per-body index ranges into a merged topology: ``particles``,
    ``edges``, ``hinges``, ``triangles``, ``tets`` are ``slice`` objects
    into the corresponding merged arrays."""

    def __init__(self, particles, edges, hinges, triangles, tets):
        self.particles = particles
        self.edges = edges
        self.hinges = hinges
        self.triangles = triangles
        self.tets = tets

    def __repr__(self):
        return (f"BodySlices(particles={self.particles}, "
                f"edges={self.edges}, hinges={self.hinges}, "
                f"triangles={self.triangles}, tets={self.tets})")


def merge_topologies(bodies, windowed=False, **build_kwargs):
    """Merge several bodies into ONE topology sharing a particle index
    space (the multi-body scenes, ``core/scenes.ball_on_cloth``): constraint
    families stay disjoint per body, and the self-collision backends
    resolve inter-body contact exactly as intra-body contact.

    bodies — sequence of ``BodySpec`` (or kwargs-dicts for BodySpec).
    build_kwargs — forwarded to ``build_topology`` (colouring runs on the
    merged graph).  windowed — route the merged arrays through
    ``build_windowed_topology`` with the IDENTITY particle order, so every
    body keeps its particle index range (``colored=True`` would interleave
    the bodies' edge slices and is refused).

    Returns ``(positions (N,3) f32, Topology, [BodySlices])``.
    """
    if windowed and build_kwargs.get("colored"):
        raise NotImplementedError(
            "merge_topologies(windowed=True) cannot also sort color-major "
            "(per-body edge slices would interleave)")
    specs = [b if isinstance(b, BodySpec) else BodySpec(**b) for b in bodies]
    if not specs:
        raise ValueError("merge_topologies needs at least one body")

    slices = []
    off = dict(particles=0, edges=0, hinges=0, triangles=0, tets=0)
    for s in specs:
        counts = dict(particles=s.positions.shape[0], edges=s.edges.shape[0],
                      hinges=s.hinges.shape[0],
                      triangles=s.triangles.shape[0], tets=s.tets.shape[0])
        slices.append(BodySlices(**{k: slice(off[k], off[k] + counts[k])
                                    for k in counts}))
        for k in counts:
            off[k] += counts[k]
    starts = [sl.particles.start for sl in slices]

    def cat(name, shift=False):
        return np.concatenate(
            [getattr(s, name) + (o if shift else 0)
             for s, o in zip(specs, starts)], axis=0)

    pos = cat("positions")
    tets = cat("tets", shift=True)
    kwargs = dict(
        hinges=cat("hinges", shift=True),
        bend_compliance=cat("bend_compliance"),
        triangles=cat("triangles", shift=True),
        tets=tets if tets.shape[0] else None,
        tet_compliance=cat("tet_compliance"),
        **build_kwargs,
    )
    edges_cat, comp_cat = cat("edges", shift=True), cat("compliance")
    if windowed:
        pos2, topo = build_windowed_topology(
            pos, edges_cat, comp_cat, order=np.arange(pos.shape[0]),
            **kwargs)
        return pos2.astype(np.float32), topo, slices
    topo = build_topology(pos, edges_cat, comp_cat, **kwargs)
    return pos.astype(np.float32), topo, slices
