"""General-topology XPBD engine (arbitrary meshes, solids, contact): the
plain PyTorch version of the CUDA mesh kernel.

Counterpart of ``softbodysimulation_tpu/solvers/general.py``, on ``(N, 3)``
tensors, for the distance, dihedral-bending and per-tet volume families
with floor, sphere and self-collision contacts:

* COLORED — exact parallel Gauss-Seidel: one gather -> project -> scatter
  per colour of the host-side colouring (no particle repeats within a
  colour, so the batched update equals the sequential sweep).
* JACOBI — every constraint projected at once; distance and bending with
  the per-constraint ``omega / max(degree)`` relaxation, tets at full
  strength with each particle taking the mean of its corrections (mass
  splitting); corrections summed per particle through the incidence lists
  (a padded gather and a row sum in column order, no scatter), optionally
  Chebyshev-accelerated.

Self-collision (``ops/spatial_hash.py``) runs first among the contacts, in
every projection and again after the Chebyshev momentum step; the
backends that sort along the Hilbert curve compute the order once per
contact substep, after the WARM_START pre-apply.  ``self_collision_every``
gates it on the substep index (``i % every == 0``).

The JAX engine's ``distance_backend`` / ``bending_backend`` "windowed" and
"auto" spell the Jacobi sweep as one-hot matrix products; their result
equals the gather spelling to float32 rounding (``general.py:116-129`` of
the JAX package), so every backend runs the gather semantics here.

The CPU tests hold this engine against the JAX engine, and on the card the
kernel (``kernels/mesh_cuda.py``) is held against it.  ``make_step``
takes the route ``kernels/mesh_cuda.route`` reads from the config and
dispatches on the state's device through the kernel wrapper (a CUDA state
launches the kernel, a CPU state runs this engine); the ``hash`` and
``sorted`` backends run in this engine on the state's device, alone or,
at a cadence that divides the frame, between kernel chunks.  The plain
loop on any device is ``run_substeps_plain`` (and ``step_fn`` /
``multi_step_fn``); its ``approx_math`` is the twin of the kernel's
variant.
The rigid world is the config's (floor, spheres, boxes), or, when the
state carries a ``core/colliders.ColliderSet``, that set's traced poses,
which replace the config's spheres, boxes and ground height (JAX
``general.py:552-580``).  The global volume constraint and the windowed
tet backend (``tet_backend="windowed"``) raise ``NotImplementedError``
(``check_supported``).  An ensemble of one topology (batched leaves)
runs ``run_substeps_plain_batched`` / ``make_batched_step``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import (SimState, Topology, body_count, body_of,
                          check_colliders, stack_bodies)
from ..ops import bending as _bending
from ..ops import collision as _collision
from ..ops import distance as _distance
from ..ops import integrate as _integrate
from ..ops import spatial_hash as _spatial_hash
from ..ops import tet_volume as _tet_volume


def check_supported(cfg: SolverConfig):
    """Refuse, at build time, what this slice of the port does not carry."""
    windowed_tets = cfg.enable_tet_volume and cfg.tet_backend == "windowed"
    for flag, what in ((cfg.enable_volume, "the global volume constraint"),
                       (windowed_tets,
                        "the windowed tet backend (one-hot tet windows)")):
        if flag:
            raise NotImplementedError(f"mesh port: {what} is not ported "
                                      f"(ROADMAP A-3)")


def check_state(state: SimState):
    """Refuse, at call time, a state whose colliders lie on another device
    than its positions."""
    check_colliders(state)


def chebyshev_omegas(cfg: SolverConfig) -> List[float]:
    """The Chebyshev weight of each Jacobi iteration (the recurrence of
    ``general.py:644-647`` of the JAX package), in float32 arithmetic as
    the JAX engine evaluates it on the device."""
    rho2 = np.float32(cfg.jacobi_rho ** 2)
    om = np.float32(1.0)
    out = []
    for k in range(cfg.iterations):
        if k < cfg.jacobi_cheby_delay:
            om = np.float32(1.0)
        elif k == cfg.jacobi_cheby_delay:
            om = np.float32(2.0 / (2.0 - cfg.jacobi_rho ** 2))
        else:
            om = np.float32(4.0) / (np.float32(4.0) - rho2 * om)
        out.append(float(om))
    return out


def accelerated(cfg: SolverConfig) -> bool:
    return (cfg.solve_mode == SolveMode.JACOBI and cfg.jacobi_rho > 0
            and cfg.iterations > cfg.jacobi_cheby_delay)


@dataclasses.dataclass(frozen=True)
class _Tables:
    """A topology's index tables on one device, int64, and the per-edge /
    per-hinge relaxation scales rounded as the JAX engine computes them."""

    ea: torch.Tensor
    eb: torch.Tensor
    hinge: Tuple[torch.Tensor, ...]       # ia, ib, ic, id
    incidence: "Incidence"
    bend_incidence: "Incidence"
    colors: Tuple[torch.Tensor, ...]      # valid edge ids per colour
    bend_colors: Tuple[torch.Tensor, ...]
    tet: Tuple[torch.Tensor, ...]         # i0, i1, i2, i3 (empty: no tets)
    tet_incidence: Optional["Incidence"]
    tet_colors: Tuple[torch.Tensor, ...]
    omega: torch.Tensor                   # omega (0 => 1) as float32
    edge_scale: torch.Tensor              # omega / max(deg_a, deg_b, 1)
    hinge_scale: torch.Tensor             # omega / max(bend degree, 1)
    warm_scale: torch.Tensor              # fraction / max(deg_a, deg_b, 1)
    topo: Topology                        # on the device


def relax_scales(topo: Topology, cfg: SolverConfig):
    """(edge_scale, hinge_scale, warm_scale) as float32 numpy arrays."""
    edges = topo.edges.cpu().numpy().astype(np.int64)
    hinges = topo.hinges.cpu().numpy().astype(np.int64)
    deg = topo.degree.cpu().numpy()
    bdeg = topo.bend_degree.cpu().numpy()
    one = np.float32(1.0)
    omega = np.float32(cfg.omega if cfg.omega > 0 else 1.0)
    maxdeg = np.maximum(np.maximum(deg[edges[:, 0]], deg[edges[:, 1]]), one)
    bmax = np.maximum(
        np.maximum(np.maximum(bdeg[hinges[:, 0]], bdeg[hinges[:, 1]]),
                   np.maximum(bdeg[hinges[:, 2]], bdeg[hinges[:, 3]])), one)
    warm = one / maxdeg
    if cfg.warm_start_fraction != 1.0:
        warm = warm * np.float32(cfg.warm_start_fraction)
    return omega / maxdeg, omega / bmax, warm


@functools.lru_cache(maxsize=16)
def _tables(topo: Topology, cfg: SolverConfig, device: str) -> _Tables:
    t = topo.to(device)
    edges = t.edges.long()
    hinges = t.hinges.long()

    def buckets(ids, valid):
        return tuple(ids[c][valid[c] > 0].long() for c in range(ids.shape[0]))

    es, hs, ws = (torch.as_tensor(a, device=device)
                  for a in relax_scales(topo, cfg))
    has_tets = t.n_tets > 0
    return _Tables(
        ea=edges[:, 0], eb=edges[:, 1],
        hinge=tuple(hinges[:, k] for k in range(4)),
        incidence=Incidence.of(t.incidence, 2 * t.n_edges),
        bend_incidence=Incidence.of(t.bend_incidence, 4 * t.n_hinges),
        colors=buckets(t.col_edge_ids, t.col_valid),
        bend_colors=buckets(t.bcol_hinge_ids, t.bcol_valid),
        tet=(tuple(t.tets.long()[:, k] for k in range(4)) if has_tets
             else ()),
        tet_incidence=(Incidence.of(t.tet_incidence, 4 * t.n_tets)
                       if has_tets else None),
        tet_colors=(buckets(t.tcol_tet_ids, t.tcol_valid) if has_tets
                    else ()),
        omega=torch.tensor(cfg.omega if cfg.omega > 0 else 1.0,
                           dtype=torch.float32, device=device),
        edge_scale=es, hinge_scale=hs, warm_scale=ws, topo=t)


# a row with more entries than this is a hub (the centre of a tet fan)
HUB_WIDTH = 32


@dataclasses.dataclass(frozen=True)
class Incidence:
    """A padded incidence table split for the column-order row sum: the
    first ``narrow.shape[1]`` columns of every row (enough for every row
    but the hubs), and the hubs' whole rows (``hub_rows``, ``hub``)."""

    narrow: torch.Tensor          # (N, Dn) int64
    hub_rows: torch.Tensor        # (R,) int64
    hub: torch.Tensor             # (R, D) int64

    @staticmethod
    def of(incidence: torch.Tensor, pad: int) -> "Incidence":
        """Split a table whose pad index (one past the contributions) is
        ``pad``."""
        inc = incidence.long()
        counts = (inc < pad).sum(dim=1)
        wide = counts > HUB_WIDTH
        dn = int(counts[~wide].max()) if bool((~wide).any()) else 0
        rows = torch.nonzero(wide).flatten()
        return Incidence(narrow=inc[:, :max(dn, 1)], hub_rows=rows,
                         hub=inc[rows])


class _HubRowSum(torch.autograd.Function):
    """``head`` (R, 3) continued by the columns of ``cols`` (R, W, 3), one
    column at a time in column order: the running float32 sum of the CUDA
    kernel's particle passes, on the tensors' own device.  Backward: the
    exact VJP of a sum, the row cotangent broadcast to every column."""

    @staticmethod
    def forward(ctx, head, cols):
        ctx.width = cols.shape[1]
        stack = torch.cat([head[:, None], cols], dim=1)
        if stack.device.type == "cpu":
            # numpy's running sum is sequential in float32 (torch's CPU
            # cumsum accumulates in float64)
            run = np.add.accumulate(stack.numpy(), axis=1)[:, -1]
            return torch.from_numpy(np.ascontiguousarray(run))
        # a CUDA scan along a dimension that is neither the innermost nor
        # the only one gives each (row, coordinate) one thread that adds
        # the columns in order in float32 (ATen's scan_outer_dim): the
        # kernel's sum, in one launch
        return torch.cumsum(stack, dim=1)[:, -1]

    @staticmethod
    def backward(ctx, g):
        return g, g[:, None, :].expand(-1, ctx.width, -1)


def gather_sum(contrib: torch.Tensor, incidence: Incidence):
    """Row i: the sum of ``contrib[incidence[i, k]]`` over k, in column
    order (the pad index points one past the end, at an appended zero row)
    -- the order of the CUDA kernel's particle passes.  A hub's row goes on
    past the narrow columns through ``_HubRowSum``, so its hundreds of
    columns do not widen every row."""
    full = torch.cat([contrib, contrib.new_zeros((1, 3))])
    cols = incidence.narrow
    delta = full[cols[:, 0]]
    for k in range(1, cols.shape[1]):
        delta = delta + full[cols[:, k]]
    if incidence.hub_rows.numel():
        run = _HubRowSum.apply(delta[incidence.hub_rows],
                               full[incidence.hub[:, cols.shape[1]:]])
        delta = delta.index_put((incidence.hub_rows,), run)
    return delta


# --------------------------------------------------------------- distance
def _solve_distance_colored(pred, lam, inv_mass, T: _Tables,
                            cfg: SolverConfig, dt, approx_math=False):
    topo = T.topo
    for ids in T.colors:
        ea, eb = T.ea[ids], T.eb[ids]
        wa, wb = inv_mass[ea], inv_mass[eb]
        dl, n = _distance.distance_delta_lambda(
            pred[ea], pred[eb], wa, wb, topo.rest_lengths[ids],
            topo.compliance[ids], lam[ids], dt, cfg, approx_math)
        lam = lam.index_add(0, ids, dl)
        if cfg.lambda_clamp > 0:
            lam = torch.clamp(lam, -cfg.lambda_clamp, cfg.lambda_clamp)
        dp = dl[:, None] * n
        pred = pred.index_add(0, ea, -wa[:, None] * dp)
        pred = pred.index_add(0, eb, wb[:, None] * dp)
    return pred, lam


def _solve_distance_jacobi(pred, lam, inv_mass, T: _Tables,
                           cfg: SolverConfig, dt, approx_math=False):
    topo = T.topo
    wa, wb = inv_mass[T.ea], inv_mass[T.eb]
    dl, n = _distance.distance_delta_lambda(
        pred[T.ea], pred[T.eb], wa, wb, topo.rest_lengths, topo.compliance,
        lam, dt, cfg, approx_math)
    # the relaxation scales delta-lambda before both the multiplier update
    # and the position correction (general.py:97-103 of the JAX package)
    dl = dl * T.edge_scale
    lam = _distance.accumulate_lambda(lam, dl, cfg)
    dp = dl[:, None] * n
    contrib = torch.cat([-wa[:, None] * dp, wb[:, None] * dp])
    return pred + gather_sum(contrib, T.incidence), lam


# ---------------------------------------------------------------- bending
def _hinge_gather(pred, inv_mass, idx):
    return [pred[i] for i in idx], [inv_mass[i] for i in idx]


def _solve_bending_colored(pred, lam, inv_mass, T: _Tables,
                           cfg: SolverConfig, dt, approx_math=False):
    topo = T.topo
    for ids in T.bend_colors:
        idx = [h[ids] for h in T.hinge]
        p, w = _hinge_gather(pred, inv_mass, idx)
        dl, *grads = _bending.bending_delta_lambda(
            *p, *w, topo.rest_angles[ids], topo.bend_compliance[ids],
            lam[ids], dt, cfg, approx_math)
        lam = lam.index_add(0, ids, dl)
        dlb = dl[:, None]
        for i, wi, g in zip(idx, w, grads):
            pred = pred.index_add(0, i, wi[:, None] * dlb * g)
    return pred, lam


def _solve_bending_jacobi(pred, lam, inv_mass, T: _Tables,
                          cfg: SolverConfig, dt, approx_math=False):
    topo = T.topo
    p, w = _hinge_gather(pred, inv_mass, T.hinge)
    dl, *grads = _bending.bending_delta_lambda(
        *p, *w, topo.rest_angles, topo.bend_compliance, lam, dt, cfg,
        approx_math)
    dl = dl * T.hinge_scale
    lam = lam + dl
    dlb = dl[:, None]
    contrib = torch.cat([wi[:, None] * dlb * g for wi, g in zip(w, grads)])
    return pred + gather_sum(contrib, T.bend_incidence), lam


# ------------------------------------------------------------- tet volume
def _tet_projection(pred, lam, inv_mass, ids, idx, T: _Tables,
                    cfg: SolverConfig, dt):
    topo = T.topo
    p, w = _hinge_gather(pred, inv_mass, idx)
    rest, comp = topo.rest_tet_volumes, topo.tet_compliance
    if ids is not None:
        rest, comp, lam = rest[ids], comp[ids], lam[ids]
    dl, *grads = _tet_volume.tet_delta_lambda(*p, *w, rest, comp, lam, dt,
                                              cfg)
    return dl, w, grads


def _solve_tets_colored(pred, lam, inv_mass, T: _Tables, cfg: SolverConfig,
                        dt):
    """Exact parallel Gauss-Seidel over the tets, one batched projection per
    conflict-free colour."""
    for ids in T.tet_colors:
        idx = [i[ids] for i in T.tet]
        dl, w, grads = _tet_projection(pred, lam, inv_mass, ids, idx, T, cfg,
                                       dt)
        lam = lam.index_add(0, ids, dl)
        dlb = dl[:, None]
        for i, wi, g in zip(idx, w, grads):
            pred = pred.index_add(0, i, wi[:, None] * dlb * g)
    return pred, lam


def _solve_tets_jacobi(pred, lam, inv_mass, T: _Tables, cfg: SolverConfig,
                       dt):
    """Mass-splitting Jacobi over the tets: every tet projected at full
    strength (times omega, and no 1/max-degree prescale: the hub of a
    centroid fan touches every tet), each particle applying the mean of the
    corrections that reach it (``general.py:403-441`` of the JAX
    package)."""
    dl, w, grads = _tet_projection(pred, lam, inv_mass, None, T.tet, T, cfg,
                                   dt)
    dl = dl * T.omega
    lam = lam + dl
    dlb = dl[:, None]
    contrib = torch.cat([wi[:, None] * dlb * g for wi, g in zip(w, grads)])
    delta = gather_sum(contrib, T.tet_incidence)
    return pred + delta / torch.clamp(T.topo.tet_degree, min=1.0)[:, None], \
        lam


# ---------------------------------------------------------------- substep
def _warm_apply_distance(pred, lam, inv_mass, T: _Tables, cfg: SolverConfig,
                         approx_math=False):
    """Pre-apply carried distance impulses along current edge directions,
    with the Jacobi pass's per-edge 1/max-degree relaxation (times
    ``warm_start_fraction``), the carried multiplier scaled identically and
    clamped so the correction never exceeds ``warm_start_clamp * rest``
    per particle (the direction as ``ops/distance.length_and_unit``
    takes it).  Returns (pred, lam)."""
    wa, wb = inv_mass[T.ea], inv_mass[T.eb]
    lam = lam * T.warm_scale
    if cfg.warm_start_clamp > 0:
        wmax = torch.clamp(torch.maximum(wa, wb), min=1e-12)
        lim = cfg.warm_start_clamp * T.topo.rest_lengths / wmax
        lam = torch.clamp(lam, -lim, lim)
    d = pred[T.eb] - pred[T.ea]
    dp = lam[:, None] * _distance.length_and_unit(d, approx_math)[1]
    contrib = torch.cat([-wa[:, None] * dp, wb[:, None] * dp])
    return pred + gather_sum(contrib, T.incidence), lam


def _substep(x, v, w, f, lam, T: _Tables, cfg: SolverConfig, dt,
             apply_ext: bool, contact_on: bool,
             world: _collision.RigidWorld, approx_math: bool = False):
    """One substep on (N, 3) tensors; ``lam`` = (lambda_dist, lambda_bend,
    lambda_tet or None).  ``contact_on=False`` leaves self-collision out of
    this substep (the contact cadence).  ``world``: the rigid world
    (``ops/collision.RigidWorld``).  ``approx_math``: the mesh kernel's
    variant's twin in the distance and bending projections.  Returns (x,
    v, lam)."""
    lam_d, lam_b, lam_t = lam
    # lambda lifecycle: WARM_START carries only distance impulses (they are
    # pre-applied); bending and tets restart fresh except in DECAY
    if cfg.lambda_mode == LambdaMode.RESET:
        lam_d = torch.zeros_like(lam_d)
    else:
        lam_d = lam_d * cfg.lambda_decay
    if cfg.lambda_mode == LambdaMode.DECAY:
        lam_b = lam_b * cfg.lambda_decay
        lam_t = None if lam_t is None else lam_t * cfg.lambda_decay
    else:
        lam_b = torch.zeros_like(lam_b)
        lam_t = None if lam_t is None else torch.zeros_like(lam_t)

    pred, v = _integrate.predict(x, v, w, f, dt, cfg, apply_ext=apply_ext)
    if cfg.lambda_mode == LambdaMode.WARM_START:
        pred, lam_d = _warm_apply_distance(pred, lam_d, w, T, cfg,
                                           approx_math)

    colored = cfg.solve_mode == SolveMode.COLORED
    has_bending = cfg.enable_bending and T.topo.n_hinges > 0
    has_tets = (cfg.enable_tet_volume and T.topo.n_tets > 0
                and lam_t is not None)
    sc_on = cfg.enable_self_collision and contact_on
    # the curve order is built once per substep, from the predicted (and
    # warm-started) positions, and reused by every projection
    sc_order = (_spatial_hash.morton_order(pred, cfg)
                if sc_on and _spatial_hash.needs_morton_order(cfg) else None)
    has_contacts = (sc_on or cfg.floor_mode == FloorMode.XPBD_INEQUALITY
                    or world.n_spheres > 0 or world.n_boxes > 0)

    def project_contacts(pred):
        if sc_on:
            pred = _spatial_hash.project_self_collision(pred, w, sc_order,
                                                        cfg)
        if cfg.floor_mode == FloorMode.XPBD_INEQUALITY:
            pred = world.project_floor(pred, x, w, dt, cfg)
        if world.n_spheres:
            pred = world.project_spheres(pred, x, w, dt, cfg)
        if world.n_boxes:
            pred = world.project_boxes(pred, x, w, dt, cfg)
        return pred

    def project_all(pred, lam_d, lam_b, lam_t):
        solve = _solve_distance_colored if colored else _solve_distance_jacobi
        pred, lam_d = solve(pred, lam_d, w, T, cfg, dt, approx_math)
        if has_bending:
            solve = (_solve_bending_colored if colored
                     else _solve_bending_jacobi)
            pred, lam_b = solve(pred, lam_b, w, T, cfg, dt, approx_math)
        if has_tets:
            solve = _solve_tets_colored if colored else _solve_tets_jacobi
            pred, lam_t = solve(pred, lam_t, w, T, cfg, dt)
        return project_contacts(pred), lam_d, lam_b, lam_t

    if accelerated(cfg):
        # Chebyshev semi-iterative acceleration; the momentum step can
        # re-penetrate contacts the sweep resolved, so they are projected
        # once more after it
        prev = pred
        for om in chebyshev_omegas(cfg):
            new, lam_d, lam_b, lam_t = project_all(pred, lam_d, lam_b, lam_t)
            acc = om * (cfg.jacobi_gamma * (new - pred) + pred - prev) + prev
            if has_contacts:
                acc = project_contacts(acc)
            prev, pred = pred, acc
    else:
        for _ in range(cfg.iterations):
            pred, lam_d, lam_b, lam_t = project_all(pred, lam_d, lam_b, lam_t)

    x, v = _integrate.finalize(x, pred, w, dt)
    if cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
        x, v = world.reflect_floor(x, v, w, dt, cfg)
    return x, v, (lam_d, lam_b, lam_t)


def contact_every(cfg: SolverConfig) -> int:
    """Substep i of a run projects self-collision iff ``i % every == 0``."""
    return cfg.self_collision_every if cfg.enable_self_collision else 1


def with_materials(T: _Tables, materials) -> _Tables:
    """The tables with the distance constraints' rest lengths and
    compliances taken from ``materials = {"rest_lengths": (E,),
    "compliance": (E,)}`` (float32 tensors on the tables' device), as the
    JAX engines take ``topo.replace(...)``: the ``min_alpha_tilde`` floor,
    the ``max_dlambda_rel`` bound and the warm-start clamp follow them."""
    e = T.topo.n_edges
    rest, comp = materials["rest_lengths"], materials["compliance"]
    for name, t in (("rest_lengths", rest), ("compliance", comp)):
        if (tuple(t.shape) != (e,) or t.dtype != torch.float32
                or t.device != T.ea.device):
            raise ValueError(f"materials[{name!r}] must be float32 ({e},) on "
                             f"{T.ea.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return dataclasses.replace(
        T, topo=T.topo.replace(rest_lengths=rest, compliance=comp))


def run_substeps_plain(state: SimState, topo: Topology, cfg: SolverConfig,
                       dt_sub: float, n_substeps: int,
                       with_ext: bool = False, materials=None,
                       approx_math: bool = False) -> SimState:
    """The plain engine's substep loop on any device: ``n_substeps`` raw
    substeps, self-collision on substep i iff ``i % self_collision_every ==
    0``.  ``with_ext=True`` consumes ``state.ext_force`` on the first
    substep and zeroes it; ``with_ext=False`` neither applies nor clears it
    (the semantics of the JAX package's fused runners).  ``materials``
    (``with_materials``) overrides the topology's rest lengths and
    compliances for this call; the topology's cached tables are kept.
    ``approx_math``: the mesh kernel's variant's twin (``ops/distance
    .length_and_unit``, ``ops/bending``)."""
    check_supported(cfg)
    check_state(state)
    T = _tables(topo, cfg, str(state.device))
    if materials is not None:
        T = with_materials(T, materials)
    every = contact_every(cfg)
    world = _collision.RigidWorld.of(cfg, state.colliders, state.device)
    x, v = state.positions, state.velocities
    lam = (state.lambda_dist, state.lambda_bend, state.lambda_tet)
    for i in range(n_substeps):
        x, v, lam = _substep(x, v, state.inv_mass, state.ext_force, lam, T,
                             cfg, dt_sub, with_ext and i == 0,
                             contact_on=i % every == 0, world=world,
                             approx_math=approx_math)
    out = state.replace(positions=x, velocities=v, lambda_dist=lam[0],
                        lambda_bend=lam[1], lambda_tet=lam[2])
    if with_ext:
        out = out.replace(ext_force=torch.zeros_like(state.ext_force))
    return out


def run_substeps_plain_batched(state: SimState, topo: Topology,
                               cfg: SolverConfig, dt_sub: float,
                               n_substeps: int, with_ext: bool = False,
                               materials=None,
                               approx_math: bool = False) -> SimState:
    """The plain twin of the B-3 ensemble: ``run_substeps_plain`` body by
    body on a batched state (``core/state.body_of``; inv_mass a shared
    ``(N,)`` or a per-body ``(B, N)`` leaf), the results stacked, so each
    body is the single-body engine to the bit.  ``materials`` hold shared
    ``(E,)`` or per-body ``(B, E)`` tensors.  A loop, not ``torch.func
    .vmap``: the engine's index updates and the kernels' ctypes calls do
    not trace.  Autograd flows through it, a shared leaf's gradient summed
    over the bodies."""
    per_body = (materials is not None
                and materials["rest_lengths"].ndim == 2)
    bodies = []
    for i in range(body_count(state)):
        mat = ({k: t[i] for k, t in materials.items()} if per_body
               else materials)
        bodies.append(run_substeps_plain(body_of(state, i), topo, cfg,
                                         dt_sub, n_substeps, with_ext, mat,
                                         approx_math))
    return stack_bodies(state, bodies)


def step_fn(state: SimState, topo: Topology, cfg: SolverConfig,
            dt: float) -> SimState:
    """One physics step = ``cfg.substeps`` substeps; external forces are
    consumed on the first substep and zeroed after
    (``SoftBodyParticleCPU.cs:25-33``); substep i of the frame projects
    self-collision iff ``i % self_collision_every == 0``, the cadence of
    the JAX ``step_fn``.  Plain engine, on any device."""
    return run_substeps_plain(state, topo, cfg, dt / cfg.substeps,
                              cfg.substeps, with_ext=True)


def multi_step_fn(state: SimState, topo: Topology, cfg: SolverConfig,
                  dt: float, n_steps: int) -> SimState:
    for _ in range(n_steps):
        state = step_fn(state, topo, cfg, dt)
    return state


def make_step(topo: Topology, cfg: SolverConfig, dt: float,
              n_steps: int = 1):
    """``SimState -> SimState`` advancing ``n_steps`` frames of
    ``cfg.substeps`` substeps, ``state.ext_force`` consumed on the first
    substep and zeroed after.  The route (``fn.route``,
    ``kernels/mesh_cuda.route``) is read from the config here:
    ``"kernel"`` and ``"hybrid"`` go through
    ``mesh_cuda.make_mesh_cuda_step`` (the kernel, whose frames run as one
    substep loop since the accumulator is zero after the first substep; or
    the hybrid contact step of the ``hash`` and ``sorted`` backends), which
    dispatches on the state's device (CUDA: the kernel; CPU: this engine),
    a state carrying a ColliderSet running a runner built for its collider
    counts (``kin_colliders``), one per count, so animating the poses
    rebuilds nothing; ``"plain"`` (``hash`` or ``sorted`` every substep, or
    at a cadence that does not divide the frame) runs ``multi_step_fn`` on
    the state's device, as JAX's ``general.make_step`` runs every
    backend."""
    from ..core.colliders import per_collider_count
    from ..kernels import mesh_cuda

    route = mesh_cuda.route(cfg)
    if route == "plain":
        check_supported(cfg)

        def fn(state: SimState) -> SimState:
            return multi_step_fn(state, topo, cfg, dt, n_steps)
    else:
        fn = per_collider_count(lambda kin: mesh_cuda.make_mesh_cuda_step(
            topo, cfg, dt, n_steps, kin_colliders=kin))
    fn.route = route
    return fn


def make_batched_step(topo: Topology, cfg: SolverConfig, dt: float,
                      n_steps: int = 1):
    """Ensemble stepping (JAX ``parallel/batch.make_batched_general_step``):
    ``n_steps`` frames of ``cfg.substeps`` substeps of a batched state,
    ``ext_force`` consumed on the first substep and zeroed after.  A CUDA
    state runs the B-3 ensemble (``mesh_cuda.make_mesh_cuda_step(...,
    n_bodies=B, batched=True)``: every body in one launch a pass, with
    ``per_body_mass`` when ``inv_mass`` is ``(B, N)`` and the ColliderSet's
    counts as ``kin_colliders``), a CPU state
    ``run_substeps_plain_batched``.  What an ensemble is refused raises
    here; the runner itself is built at each call from the state's body
    count and leaves (a few checks; the device tables are cached)."""
    from ..core.colliders import kin_counts
    from ..kernels import mesh_cuda

    mesh_cuda.make_mesh_cuda_step(topo, cfg, dt, n_steps, batched=True)

    def fn(state: SimState) -> SimState:
        return mesh_cuda.make_mesh_cuda_step(
            topo, cfg, dt, n_steps, kin_colliders=kin_counts(state.colliders),
            n_bodies=body_count(state), batched=True,
            per_body_mass=state.inv_mass.ndim == 2)(state)

    return fn
