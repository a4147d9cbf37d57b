"""Stencil XPBD engine for res^3 lattices: the plain PyTorch version.

Counterpart of ``softbodysimulation_tpu/solvers/lattice.py``.  A regular
lattice's constraint graph is a fixed set of offset families
(``topology/lattice.py``), so each constraint pass is shifted-array
arithmetic on the component-major ``(3, res, res*res)`` layout:

  * gather  -> ``torch.roll`` by the family offset (wrap-around killed by a
    boundary mask),
  * scatter -> the inverse roll of the correction field,
  * graph colouring -> a parity split along the family's leading axis.

This module is the plain version of the hand-written CUDA lattice kernel
(``kernels/lattice_cuda.py``): the CPU tests hold it against the JAX
engine, and on the card the kernel is held against it.  ``make_step`` and
``make_substep_runner`` dispatch on the state's device: a CPU state runs
this engine, a CUDA state launches the kernel (or raises).  The plain loop
on any device is ``run_substeps_plain`` (and ``step_fn`` /
``multi_step_fn``).

The slice covers the lattice main path, the per-cell tet family (6 Kuhn
tets per cell, ``_tet_sweep``; ``solid_lattice``) and the rigid world:
the floor, sphere and box colliders of the config or, when the state
carries a ``core/colliders.ColliderSet``, that set's traced poses (JAX
``solvers/lattice.py:296-312``); contacts run floor, boxes, spheres, as
there.  Lane-folded ensembles run ``run_substeps_plain_batched``
(``make_batched_step``).

Self-collision (JAX ``solvers/lattice.py:353-358, 419-426``) runs through
``ops/spatial_hash.project_self_collision`` after the tet sweep and before
the floor, its curve order built once per substep from ``pred``; the
contact cadence gates it on the substep within a frame in ``step_fn``
(``:538-577``) and on the raw substep index in a substep run
(``:681-726``).  ``make_step`` and ``make_substep_runner`` take the route
``kernels/lattice_cuda.route`` reads from the config: the kernel, the
hybrid contact step or runner (kernel chunks between contact substeps of
this engine), or this engine alone; on a CPU state every kernel of a
route runs its plain version.  Lane-folded ensembles refuse
self-collision (the B-1 ensemble kernel does not run it).

``approx_math`` on the internals (``_family_pass``, ``_tet_sweep``,
``run_substeps_plain``, ``run_substeps_plain_batched``) is the plain twin
of the kernel's variant (``lattice_pallas.py:152-185, 1053-1061, 1099,
1281-1285``): the length as ``|d|^2 * rsqrt(|d|^2)``, the multiplier step
times ``torch.reciprocal`` of its denominator, the correction scaled by
the rsqrt.  The public ``make_step`` and ``step_fn`` take no such knob,
as JAX's stencil engine has none.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..core.colliders import per_collider_count
from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState, check_colliders, on_device
from ..ops import collision as _collision
from ..ops import integrate as _integrate
from ..ops import spatial_hash as _spatial_hash
from ..topology import tets as _tets
from .general import contact_every
from ..topology.lattice import LatticeSpec, lattice_points


def n_lambda(spec: LatticeSpec) -> int:
    return spec.n_families * spec.res ** 3


def make_lattice_state(spec: LatticeSpec, center=(0.0, 0.0, 0.0),
                       mass: float = 1.0, dtype=torch.float32,
                       device="cuda", tet_volume: bool = False) -> SimState:
    """The rest lattice on ``device`` (the card unless the caller asks for
    the CPU).  ``tet_volume=True`` sizes ``lambda_tet`` for the per-cell
    tet family (6 Kuhn tets per cell; enable with
    ``cfg.enable_tet_volume``)."""
    device = on_device(device, "make_lattice_state")
    pos = lattice_points(spec.res, spec.size, center)
    n = pos.shape[0]
    inv = 0.0 if mass <= 1e-4 else 1.0 / mass
    return SimState(
        positions=torch.as_tensor(pos, dtype=dtype, device=device),
        velocities=torch.zeros((n, 3), dtype=dtype, device=device),
        inv_mass=torch.full((n,), inv, dtype=dtype, device=device),
        ext_force=torch.zeros((n, 3), dtype=dtype, device=device),
        lambda_dist=torch.zeros((n_lambda(spec),), dtype=dtype,
                                device=device),
        lambda_bend=torch.zeros((0,), dtype=dtype, device=device),
        lambda_volume=torch.zeros((), dtype=dtype, device=device),
        lambda_tet=(torch.zeros((6 * spec.res ** 3,), dtype=dtype,
                                device=device) if tet_volume else None),
    )


def check_state(state: SimState, cfg: SolverConfig):
    """Refuse, at call time, a state whose colliders lie on another device
    than its positions, and a tet config whose state has no tet
    multipliers."""
    check_colliders(state)
    if cfg.enable_tet_volume and state.lambda_tet is None:
        raise ValueError("enable_tet_volume needs a state built with "
                         "tet_volume=True (make_lattice_state)")


@functools.lru_cache(maxsize=64)
def _family_masks(spec: LatticeSpec) -> Tuple[np.ndarray, ...]:
    """Per-family (valid, parity0) boolean masks in (res, res*res) layout.

    valid: anchor a has a partner a+d in bounds (with the reference's
    shear/bend anchor quirk when spec.reference_bounds).  parity0: anchor's
    leading-offset-axis coordinate is even."""
    res = spec.res
    xx, yy, zz = np.meshgrid(np.arange(res), np.arange(res), np.arange(res),
                             indexing="ij")
    out = []
    for fam in spec.families:
        dx, dy, dz, kind = fam
        if spec.reference_bounds and kind != 0:
            valid = (xx < res - 1) & (yy < res - 1) & (zz < res - 1)
        else:
            valid = np.ones((res, res, res), bool)
            for coord, d in ((xx, dx), (yy, dy), (zz, dz)):
                if d > 0:
                    valid &= coord < res - d
                elif d < 0:
                    valid &= coord >= -d
        lead = xx if dx else (yy if dy else zz)
        parity0 = (lead % 2) == 0
        out.append((valid.reshape(res, res * res),
                    parity0.reshape(res, res * res)))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _masks_dev(spec: LatticeSpec, device):
    """``_family_masks`` on ``device``, copied there once."""
    return tuple((torch.as_tensor(vv, device=device),
                  torch.as_tensor(pp, device=device))
                 for (vv, pp) in _family_masks(spec))


def _roll_fwd(a, fam, res):
    """partner view a[x+dx, y+dy, z+dz] in (..., res, res*res) layout."""
    dx, dy, dz, _ = fam
    if dx:
        a = torch.roll(a, -dx, dims=a.ndim - 2)
    k = dy * res + dz
    if k:
        a = torch.roll(a, -k, dims=a.ndim - 1)
    return a


def _roll_bwd(a, fam, res):
    dx, dy, dz, _ = fam
    k = dy * res + dz
    if k:
        a = torch.roll(a, k, dims=a.ndim - 1)
    if dx:
        a = torch.roll(a, dx, dims=a.ndim - 2)
    return a


def _family_pass(pred, w, wb, lam_f, fam, mask, rest, comp, dt,
                 cfg: SolverConfig, res, relax=None, approx_math=False):
    """One constraint pass on (3,res,res^2) pred.  ``mask`` folds validity
    and (for GS) parity; relax=None => exact GS, float => Jacobi scaling.
    ``approx_math``: rsqrt and the reciprocal, as the kernel's variant."""
    pb = _roll_fwd(pred, fam, res)
    d = pb - pred
    len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    if approx_math:
        inv_len = torch.rsqrt(torch.clamp(len_sq, min=1e-24))
        length = len_sq * inv_len
    else:
        length = torch.sqrt(torch.clamp(len_sq, min=1e-24))
    c = length - rest
    alpha = comp / (dt * dt)
    if cfg.min_alpha_tilde > 0:
        alpha = max(alpha, cfg.min_alpha_tilde)
    denom = w + wb + alpha
    if approx_math:
        dl = (-c - alpha * lam_f) * torch.reciprocal(
            torch.clamp(denom, min=1e-30))
    else:
        dl = (-c - alpha * lam_f) / torch.clamp(denom, min=1e-30)
    if cfg.max_dlambda > 0:
        dl = torch.clamp(dl, -cfg.max_dlambda, cfg.max_dlambda)
    if cfg.max_dlambda_rel > 0:
        m = cfg.max_dlambda_rel * rest
        dl = torch.clamp(dl, -m, m)
    if cfg.fast_math:
        # static masks only (see SolverConfig.fast_math); mask is a float
        # multiplier here
        scale = mask if relax is None else mask * relax
        dl = dl * scale
    else:
        active = (
            mask
            & (length >= cfg.eps_length)
            & (torch.abs(denom) >= cfg.eps_denominator)
            & ((w >= cfg.static_inv_mass_eps)
               | (wb >= cfg.static_inv_mass_eps))
        )
        dl = torch.where(active, dl if relax is None else dl * relax, 0.0)
    lam_f = lam_f + dl
    if cfg.lambda_clamp > 0:
        lam_f = torch.clamp(lam_f, -cfg.lambda_clamp, cfg.lambda_clamp)
    dp = d * (dl * inv_len if approx_math else dl / length)[None]
    pred = pred - w[None] * dp
    pred = pred + _roll_bwd(wb[None] * dp, fam, res)
    return pred, lam_f


def _warm_apply_family(pred, w, wb, lam_f, fam, valid, res, rest,
                       cfg: SolverConfig):
    """Pre-apply a family's carried impulses along current edge directions,
    the carried multiplier clamped so the correction never exceeds
    ``warm_start_clamp * rest`` per particle.  Returns (pred, clamped lam)."""
    if cfg.warm_start_fraction != 1.0:
        lam_f = lam_f * cfg.warm_start_fraction  # SOR pre-application
    if cfg.warm_start_clamp > 0:
        wmax = torch.clamp(torch.maximum(w, wb), min=1e-12)
        # a 0-dim tensor over wmax divides truly; float / tensor would be
        # reciprocal(wmax) * float in PyTorch
        lim = wmax.new_tensor(cfg.warm_start_clamp * rest) / wmax
        lam_f = torch.clamp(lam_f, -lim, lim)
    pb = _roll_fwd(pred, fam, res)
    d = pb - pred
    len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    length = torch.sqrt(torch.clamp(len_sq, min=1e-24))
    dl = torch.where(valid, lam_f, 0.0)
    dp = d * (dl / length)[None]
    pred = pred - w[None] * dp
    pred = pred + _roll_bwd(wb[None] * dp, fam, res)
    return pred, lam_f


@functools.lru_cache(maxsize=16)
def _tet_fields(spec: LatticeSpec):
    """Static structure of the per-cell tet family: the 6 Kuhn paths as
    offset families (``topology/tets.kuhn_offset_paths``), the valid-cell
    anchor mask, the per-particle tet degree (for the mass-splitting
    apply), and the shared 6x rest volume (the cell volume: every Kuhn
    tet of a box cell has V = cellV / 6)."""
    res = spec.res
    paths = _tets.kuhn_offset_paths()
    cells = np.zeros((res, res, res), bool)
    cells[:res - 1, :res - 1, :res - 1] = True
    tdeg = np.zeros((res, res, res), np.float32)
    c = res - 1
    for path in paths:
        for (ox, oy, oz) in path:
            tdeg[ox:ox + c, oy:oy + c, oz:oz + c] += 1.0
    spacing = tuple(s / (res - 1) for s in spec.size)
    rest6 = float(spacing[0] * spacing[1] * spacing[2])
    return (paths, cells.reshape(res, res * res),
            tdeg.reshape(res, res * res), rest6)


@functools.lru_cache(maxsize=16)
def _tet_dev(spec: LatticeSpec, device):
    paths, valid, tdeg, rest6 = _tet_fields(spec)
    return (paths, torch.as_tensor(valid, device=device),
            torch.as_tensor(tdeg, device=device), rest6)


def _cross3(a, b):
    """Cross product over the leading component axis of (3, ...)."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _dot3(a, b):
    """Dot product over the leading component axis, summed x + y + z."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def tet_constants(spec: LatticeSpec, cfg: SolverConfig, dt: float):
    """(alpha, pressure x 6 rest volume, omega) of the tet sweep, as Python
    floats: ``tet_compliance / dt^2``, the target 6V, and
    ``cfg.omega if cfg.omega > 0 else 1.0``."""
    rest6 = _tet_fields(spec)[3]
    return (cfg.tet_compliance / (dt * dt), cfg.tet_pressure * rest6,
            cfg.omega if cfg.omega > 0 else 1.0)


def _tet_sweep(pred, w, lam_t, spec: LatticeSpec, cfg: SolverConfig, dt,
               tet_dev, approx_math=False):
    """Per-cell tet-volume Jacobi sweep, gather-free: each Kuhn path is an
    offset family, so the 4 endpoint gathers are rolls and the gradient
    scatter is the inverse rolls.  All 6 paths project against the SAME
    pred (Jacobi), full strength, then one mass-splitting apply
    ``pred += w / max(tdeg, 1) * delta``.  Each particle's delta sums its
    terms path by path: g0 at its own cell, then g1, g2, g3 from the cells
    at -o1, -o2, -o3.  lam_t: (6, res, r2).  ``approx_math``: the multiplier
    step times ``torch.reciprocal`` of its denominator."""
    paths, valid, tdeg, _ = tet_dev
    alpha, target, omega = tet_constants(spec, cfg, dt)
    res = spec.res
    delta = torch.zeros_like(pred)
    lam_parts = []
    for pi, path in enumerate(paths):
        f1 = path[1] + (0,)
        f2 = path[2] + (0,)
        f3 = path[3] + (0,)
        e1 = _roll_fwd(pred, f1, res) - pred
        e2 = _roll_fwd(pred, f2, res) - pred
        e3 = _roll_fwd(pred, f3, res) - pred
        g1 = _cross3(e2, e3)
        g2 = _cross3(e3, e1)
        g3 = _cross3(e1, e2)
        g0 = -(g1 + g2 + g3)
        cerr = _dot3(e1, g1) - target
        w1 = _roll_fwd(w, f1, res)
        w2 = _roll_fwd(w, f2, res)
        w3 = _roll_fwd(w, f3, res)
        denom = (w * _dot3(g0, g0) + w1 * _dot3(g1, g1)
                 + w2 * _dot3(g2, g2) + w3 * _dot3(g3, g3) + alpha)
        lam_f = lam_t[pi]
        if approx_math:
            dl = (-cerr - alpha * lam_f) * torch.reciprocal(
                torch.clamp(denom, min=1e-30))
        else:
            dl = (-cerr - alpha * lam_f) / torch.clamp(denom, min=1e-30)
        active = valid & (denom > cfg.eps_denominator)
        dl = torch.where(active, dl, 0.0) * omega
        lam_parts.append(lam_f + dl)
        dlb = dl[None]
        delta = delta + dlb * g0
        delta = delta + _roll_bwd(dlb * g1, f1, res)
        delta = delta + _roll_bwd(dlb * g2, f2, res)
        delta = delta + _roll_bwd(dlb * g3, f3, res)
    pred = pred + (w / torch.clamp(tdeg, min=1.0))[None] * delta
    return pred, torch.stack(lam_parts)


def _floor_xpbd(pred, x, w, dt, cfg: SolverConfig, ground):
    """XPBD inequality floor at height ``ground`` (a 0-dim tensor) +
    positional friction, componentwise on (3,res,res^2) (semantics of
    ops/collision.floor_project_xpbd)."""
    pen = ground - pred[1]
    alpha_c = cfg.collision_compliance / (dt * dt)
    denom = w + alpha_c
    dl = pen / torch.clamp(denom, min=1e-30)
    hit = ((pen > 0) & (w >= cfg.static_inv_mass_eps)
           & (torch.abs(denom) >= cfg.eps_denominator))
    p1 = pred[1] + torch.where(hit, w * dl, 0.0)
    fr = min(max(cfg.friction, 0.0), 1.0)
    p0 = pred[0] - torch.where(hit, (pred[0] - x[0]) * fr, 0.0)
    p2 = pred[2] - torch.where(hit, (pred[2] - x[2]) * fr, 0.0)
    return torch.stack([p0, p1, p2])


def _spheres(pred, x, w, dt, cfg: SolverConfig, world):
    """Sphere SDF projection with positional friction, relative to each
    collider's velocity."""
    fr = min(max(cfg.friction, 0.0), 1.0)
    for k in range(world.n_spheres):
        center, radius = world.spheres[k, :3], world.spheres[k, 3]
        dvec = pred - center.reshape(3, 1, 1)
        dist = torch.sqrt(torch.clamp(
            dvec[0] * dvec[0] + dvec[1] * dvec[1] + dvec[2] * dvec[2],
            min=1e-24))
        nrm = dvec / dist[None]
        penet = radius - dist
        act = (penet > 0) & (w >= cfg.static_inv_mass_eps)
        pred = pred + torch.where(act[None], nrm * penet[None], 0.0)
        # friction in the collider's frame
        vel = (_integrate.over_dt(pred - x, dt)
               - world.sphere_velocities[k].reshape(3, 1, 1))
        vn = (vel[0] * nrm[0] + vel[1] * nrm[1]
              + vel[2] * nrm[2])[None] * nrm
        vt = vel - vn
        pred = pred - torch.where(act[None], vt * (dt * fr), 0.0)
    return pred


def _boxes(pred, x, w, dt, cfg: SolverConfig, world):
    """Box SDF projection: ``ops/collision.box_sdf_project`` on the
    flattened (N, 3) view, as the JAX engine applies it."""
    flat = _collision.box_sdf_project(
        pred.reshape(3, -1).T, x.reshape(3, -1).T, w.reshape(-1), dt, cfg,
        boxes=world.boxes, box_velocities=world.box_velocities)
    return flat.T.reshape(pred.shape)


def _substep(x, v, w, f, lam, spec: LatticeSpec, cfg: SolverConfig, dt,
             apply_ext: bool, masks_dev, lam_t, tet_dev, world,
             contact_on: bool = True, approx_math: bool = False):
    """One substep in (3,res,res^2) layout.  x,v,f: (3,res,r2); w: (res,r2);
    lam: (nfam,res,r2); lam_t: (6,res,r2) or None (the tet sweep runs when
    ``tet_dev`` is given); ``world``: the rigid world
    (``ops/collision.RigidWorld``); ``contact_on=False`` leaves
    self-collision out of this substep (the cadence).  Returns (x, v, lam,
    lam_t)."""
    res = spec.res

    if cfg.lambda_mode == LambdaMode.RESET:
        lam = torch.zeros_like(lam)
    else:
        lam = lam * cfg.lambda_decay
    if lam_t is not None:
        # tets follow the general engine's lifecycle: fresh except in DECAY
        if cfg.lambda_mode == LambdaMode.DECAY:
            lam_t = lam_t * cfg.lambda_decay
        else:
            lam_t = torch.zeros_like(lam_t)

    # predict (reference gravity is a force: v += dt*w*(g + f_ext);
    # gravity_is_acceleration applies g mass-independently)
    g = _integrate.gravity(tuple(cfg.gravity), x.dtype,
                           x.device).reshape(3, 1, 1)
    ext = f if apply_ext else torch.zeros_like(f)
    if cfg.gravity_is_acceleration:
        if cfg.max_force > 0:
            ext = torch.clamp(ext, -cfg.max_force, cfg.max_force)
        active = (w > 0)[None]
        v = v + dt * (torch.where(active, g, 0.0) + w[None] * ext)
    else:
        force = g + ext
        if cfg.max_force > 0:
            force = torch.clamp(force, -cfg.max_force, cfg.max_force)
        v = v + dt * w[None] * force
    if cfg.damping_mode.value == "per_step":
        v = v * (1.0 - min(max(cfg.damping, 0.0), 1.0))
    else:
        v = v * (1.0 - cfg.damping * dt)
    if cfg.max_velocity > 0:
        v = torch.clamp(v, -cfg.max_velocity, cfg.max_velocity)
    pred = x + dt * v
    if cfg.world_bounds > 0:
        pred = torch.clamp(pred, -cfg.world_bounds, cfg.world_bounds)

    sc_on = cfg.enable_self_collision and contact_on
    # the curve order, once per substep from the predicted positions
    sc_order = (_spatial_hash.morton_order(pred.reshape(3, -1).T, cfg)
                if sc_on and _spatial_hash.needs_morton_order(cfg) else None)

    wb_per_fam = [_roll_fwd(w, fam, res) for fam in spec.families]

    if cfg.lambda_mode == LambdaMode.WARM_START:
        lam_parts = []
        for fi, fam in enumerate(spec.families):
            pred, lam_f = _warm_apply_family(
                pred, w, wb_per_fam[fi], lam[fi], fam, masks_dev[fi][0],
                res, spec.rest_lengths[fi], cfg)
            lam_parts.append(lam_f)
        lam = torch.stack(lam_parts)

    for _ in range(cfg.iterations):
        lam_parts = []
        for fi, fam in enumerate(spec.families):
            valid, parity0 = masks_dev[fi]
            m_even = valid & parity0
            m_odd = valid & ~parity0
            m_all = valid
            if cfg.fast_math:
                # float multipliers; see SolverConfig.fast_math
                m_even = m_even.to(pred.dtype)
                m_odd = m_odd.to(pred.dtype)
                m_all = m_all.to(pred.dtype)
            lam_f = lam[fi]
            rest = spec.rest_lengths[fi]
            comp = spec.compliances[fi]
            wb = wb_per_fam[fi]
            if cfg.solve_mode == SolveMode.COLORED:
                pred, lam_f = _family_pass(
                    pred, w, wb, lam_f, fam, m_even, rest, comp, dt, cfg,
                    res, approx_math=approx_math)
                pred, lam_f = _family_pass(
                    pred, w, wb, lam_f, fam, m_odd, rest, comp, dt, cfg,
                    res, approx_math=approx_math)
            else:
                pred, lam_f = _family_pass(
                    pred, w, wb, lam_f, fam, m_all, rest, comp, dt, cfg,
                    # intra-family conflict degree is 2, hence omega/2
                    res, relax=0.5 * (cfg.omega if cfg.omega > 0 else 1.0),
                    approx_math=approx_math)
            lam_parts.append(lam_f)
        lam = torch.stack(lam_parts)

        if tet_dev is not None:
            pred, lam_t = _tet_sweep(pred, w, lam_t, spec, cfg, dt, tet_dev,
                                     approx_math)

        if sc_on:
            # before the floor and the colliders, as the general engine
            flat = _spatial_hash.project_self_collision(
                pred.reshape(3, -1).T, w.reshape(-1), sc_order, cfg)
            pred = flat.T.reshape(pred.shape)
        if cfg.floor_mode == FloorMode.XPBD_INEQUALITY:
            pred = _floor_xpbd(pred, x, w, dt, cfg, world.ground)
        if world.n_boxes:
            pred = _boxes(pred, x, w, dt, cfg, world)
        if world.n_spheres:
            pred = _spheres(pred, x, w, dt, cfg, world)

    # finalize
    pinned = (w == 0.0)[None]
    v = torch.where(pinned, 0.0, _integrate.over_dt(pred - x, dt))
    x = torch.where(pinned, x, pred)

    if cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
        # flagship-style velocity-level floor (ops/collision semantics)
        pen = world.ground - x[1]
        hit = (pen > 0) & (w > 0)
        x1 = torch.where(hit, world.ground + cfg.floor_offset, x[1])
        falling = hit & (v[1] < 0)
        vy = torch.abs(v[1]) * cfg.restitution + pen * cfg.penetration_kick
        v1 = torch.where(falling, vy, v[1])
        normal_force = torch.abs(v1) + pen * cfg.normal_force_scale
        h_speed = torch.sqrt(torch.clamp(v[0] * v[0] + v[2] * v[2],
                                         min=1e-24))
        moving = h_speed > 1e-3
        fmag = torch.minimum(h_speed,
                             normal_force * cfg.floor_friction_coeff * dt)
        scalef = torch.where(falling & moving, fmag / h_speed, 0.0)
        v0 = v[0] - v[0] * scalef
        v2 = v[2] - v[2] * scalef
        x = torch.stack([x[0], x1, x[2]])
        v = torch.stack([v0, v1, v2])

    return x, v, lam, lam_t


def _to_grid(state: SimState, spec: LatticeSpec):
    """(x, v, w, f, lam, lam_t) in (.., res, res^2) layout; lam_t is None
    for a state without tet multipliers."""
    res = spec.res
    r2 = res * res
    lam_t = (None if state.lambda_tet is None
             else state.lambda_tet.reshape(6, res, r2))
    return (state.positions.T.reshape(3, res, r2),
            state.velocities.T.reshape(3, res, r2),
            state.inv_mass.reshape(res, r2),
            state.ext_force.T.reshape(3, res, r2),
            state.lambda_dist.reshape(spec.n_families, res, r2), lam_t)


def _from_grid(state: SimState, x, v, lam, lam_t,
               zero_ext: bool) -> SimState:
    out = state.replace(
        positions=x.reshape(3, -1).T.contiguous(),
        velocities=v.reshape(3, -1).T.contiguous(),
        lambda_dist=lam.reshape(-1),
        lambda_tet=None if lam_t is None else lam_t.reshape(-1),
    )
    if zero_ext:
        out = out.replace(ext_force=torch.zeros_like(state.ext_force))
    return out


def run_substeps_plain(state: SimState, spec: LatticeSpec,
                       cfg: SolverConfig, dt_sub: float, n_substeps: int,
                       with_ext: bool = False,
                       approx_math: bool = False) -> SimState:
    """The plain engine's substep loop on any device: ``n_substeps`` raw
    substeps, self-collision on substep i iff ``i % self_collision_every ==
    0``.  ``with_ext=True`` consumes ``state.ext_force`` on the first
    substep and zeroes it; ``with_ext=False`` neither applies nor clears it
    (the semantics of the JAX package's fused runners).  ``approx_math``:
    the kernel variant's twin (module docstring)."""
    check_state(state, cfg)
    every = contact_every(cfg)
    masks = _masks_dev(spec, state.device)
    tet_dev = (_tet_dev(spec, state.device) if cfg.enable_tet_volume
               else None)
    world = _collision.RigidWorld.of(cfg, state.colliders, state.device)
    x, v, w, f, lam, lam_t = _to_grid(state, spec)
    for i in range(n_substeps):
        x, v, lam, lam_t = _substep(x, v, w, f, lam, spec, cfg, dt_sub,
                                    with_ext and i == 0, masks, lam_t,
                                    tet_dev, world,
                                    contact_on=i % every == 0,
                                    approx_math=approx_math)
    return _from_grid(state, x, v, lam, lam_t, zero_ext=with_ext)


def step_fn(state: SimState, spec: LatticeSpec, cfg: SolverConfig,
            dt: float) -> SimState:
    """One physics step = cfg.substeps substeps; external forces consumed on
    the first substep (SoftBodyParticleCPU force lifecycle); substep j of
    the frame projects self-collision iff ``j % self_collision_every ==
    0``, the cadence of the JAX ``step_fn``.  Plain engine, on any
    device."""
    return run_substeps_plain(state, spec, cfg, dt / cfg.substeps,
                              cfg.substeps, with_ext=True)


def multi_step_fn(state, spec, cfg, dt, n_steps: int) -> SimState:
    for _ in range(n_steps):
        state = step_fn(state, spec, cfg, dt)
    return state


def make_step(spec: LatticeSpec, cfg: SolverConfig, dt: float,
              n_steps: int = 1):
    """``SimState -> SimState`` advancing ``n_steps`` frames of
    ``cfg.substeps`` substeps, ``state.ext_force`` consumed on the first
    substep and zeroed after.  The route (``fn.route``,
    ``kernels/lattice_cuda.route``) is read from the config here:
    ``"kernel"`` and ``"hybrid"`` go through ``lattice_cuda.make_cuda_step``
    (the kernel, whose frames run as one substep loop since the accumulator
    is zero after the first substep; or the hybrid contact step), which
    dispatches on the state's device (CUDA: the kernel; CPU: this engine),
    a state carrying a ColliderSet running a runner built for its collider
    counts (``kin_colliders``), one per count, so animating the poses
    rebuilds nothing; ``"plain"`` (self-collision every substep, or at a
    cadence that does not divide the frame) runs ``multi_step_fn`` on the
    state's device."""
    from ..kernels import lattice_cuda

    route = lattice_cuda.route(cfg)
    if route == "plain":
        def fn(state: SimState) -> SimState:
            return multi_step_fn(state, spec, cfg, dt, n_steps)
    else:
        fn = per_collider_count(lambda kin: lattice_cuda.make_cuda_step(
            spec, cfg, dt, n_steps, kin_colliders=kin))
    fn.route = route
    return fn


def _tile(a: torch.Tensor, n_bodies: int) -> torch.Tensor:
    """(..., res, r2) -> (..., res, B*r2): the single body's plane repeated
    along the lane axis, as ``np.tile(v, (1, B))``."""
    return a.repeat(*([1] * (a.ndim - 1)), n_bodies)


def _to_wide(t: torch.Tensor, spec: LatticeSpec, k: int = 0):
    """Batched leaves -> the lane-folded layout, lane = b*r2 + (y*res + z):
    ``(B, N, 3)`` -> ``(3, res, B*r2)`` (``k == 0``), or ``(B, k*N)`` -> ``(k,
    res, B*r2)`` (multiplier families); JAX ``solvers/lattice.py:625-629,
    652-657``."""
    res, r2 = spec.res, spec.res * spec.res
    b = t.shape[0]
    if k == 0:
        return t.reshape(b, res, r2, 3).permute(3, 1, 0, 2).reshape(
            3, res, b * r2)
    return t.reshape(b, k, res, r2).permute(1, 2, 0, 3).reshape(
        k, res, b * r2)


def _from_wide(a: torch.Tensor, spec: LatticeSpec, b: int, k: int = 0):
    res, r2 = spec.res, spec.res * spec.res
    if k == 0:
        return a.reshape(3, res, b, r2).permute(2, 1, 3, 0).reshape(
            b, res * r2, 3)
    return a.reshape(k, res, b, r2).permute(2, 0, 1, 3).reshape(b, -1)


def run_substeps_plain_batched(state: SimState, spec: LatticeSpec,
                               cfg: SolverConfig, dt_sub: float,
                               n_substeps: int, with_ext: bool = False,
                               approx_math: bool = False) -> SimState:
    """The lane-folded ensemble engine (JAX ``solvers/lattice.py:597-680``),
    ``n_substeps`` raw substeps of a batched state on any device: the B
    bodies lie side by side along the lane axis, ``(3, res, B*r2)``, and
    the family masks (and the tet tables), tiled per body, kill the rolls'
    wrap across a body boundary as they kill it across a y row, so each
    body's arithmetic is ``run_substeps_plain``'s on that body, to the bit.
    Leaves: positions, velocities, ext_force ``(B, N, 3)``, lambda_dist
    ``(B, nfam*N)``, lambda_tet ``(B, 6N)``, inv_mass ``(B, N)`` or a
    shared ``(N,)``.  ``with_ext`` as ``run_substeps_plain``; a ColliderSet
    on the state is one rigid world acting on every body (the B-1
    ensemble's ``kin_colliders``); ``approx_math`` as
    ``run_substeps_plain``."""
    if cfg.enable_self_collision:
        raise NotImplementedError(
            "lattice port: self-collision in a lane-folded ensemble is not "
            "ported (the B-1 ensemble kernel does not run it)")
    check_state(state, cfg)
    b = state.positions.shape[0]
    res, r2 = spec.res, spec.res * spec.res
    dev = state.device
    masks = tuple((_tile(vv, b), _tile(pp, b))
                  for vv, pp in _masks_dev(spec, dev))
    tet_dev = None
    if cfg.enable_tet_volume:
        paths, valid, tdeg, rest6 = _tet_dev(spec, dev)
        tet_dev = (paths, _tile(valid, b), _tile(tdeg, b), rest6)
    world = _collision.RigidWorld.of(cfg, state.colliders, dev)
    x = _to_wide(state.positions, spec)
    v = _to_wide(state.velocities, spec)
    f = _to_wide(state.ext_force, spec)
    w = state.inv_mass.expand(b, spec.n_particles).reshape(
        b, res, r2).permute(1, 0, 2).reshape(res, b * r2)
    lam = _to_wide(state.lambda_dist, spec, spec.n_families)
    lam_t = (None if state.lambda_tet is None
             else _to_wide(state.lambda_tet, spec, 6))
    for i in range(n_substeps):
        x, v, lam, lam_t = _substep(x, v, w, f, lam, spec, cfg, dt_sub,
                                    with_ext and i == 0, masks, lam_t,
                                    tet_dev, world, approx_math=approx_math)
    out = state.replace(
        positions=_from_wide(x, spec, b), velocities=_from_wide(v, spec, b),
        lambda_dist=_from_wide(lam, spec, b, spec.n_families),
        lambda_tet=None if lam_t is None else _from_wide(lam_t, spec, b, 6))
    if with_ext:
        out = out.replace(ext_force=torch.zeros_like(state.ext_force))
    return out


def make_batched_step(spec: LatticeSpec, cfg: SolverConfig, dt: float,
                      n_bodies: int, n_steps: int = 1):
    """Ensemble stepping with the body axis folded into the lane dimension
    (JAX ``solvers/lattice.py:597``): ``n_steps`` frames of
    ``cfg.substeps`` substeps of a batched state (``parallel.batch
    .stack_states``), ``ext_force`` consumed on the first substep of the
    first frame and zeroed after.  A CUDA state runs the B-1 ensemble
    (``kernels/lattice_cuda.make_cuda_step(..., n_bodies=B)``, every body
    in one launch a call), a CPU state ``run_substeps_plain_batched``.
    Colliders on a batched step stay refused, as in JAX
    (``:634-638``): animate them through the kernel runner's
    ``kin_colliders`` or ``parallel.batch.make_sharded_pallas_rollout``."""
    from ..kernels import lattice_cuda

    run = lattice_cuda.make_cuda_step(spec, cfg, dt, n_steps,
                                      n_bodies=n_bodies, batched=True)

    def fn(batched: SimState) -> SimState:
        if batched.colliders is not None:
            raise NotImplementedError(
                "lane-folded ensemble stepping does not take ColliderSets; "
                "animate colliders through make_cuda_substep_runner(..., "
                "n_bodies=B, kin_colliders=(S, B)) or "
                "parallel.batch.make_sharded_pallas_rollout")
        return run(batched)

    return fn


def make_substep_runner(spec: LatticeSpec, cfg: SolverConfig, dt_sub: float,
                        n_substeps: int):
    """Flat loop over raw substeps (no ext forces; ``ext_force`` reads back
    zero; self-collision on substep i iff ``i % self_collision_every ==
    0``) — used by benchmarks.  Takes the route ``make_step`` takes
    (``fn.route``): the kernel runner, the hybrid contact runner
    (``lattice_cuda.make_hybrid_contact_runner``), or this engine's
    ``run_substeps_plain`` on the state's device."""
    from ..kernels import lattice_cuda

    route = lattice_cuda.route(cfg)
    if route == "plain":
        def run(state: SimState) -> SimState:
            return run_substeps_plain(state, spec, cfg, dt_sub, n_substeps)
    else:
        make = (lattice_cuda.make_hybrid_contact_runner if route == "hybrid"
                else lattice_cuda.make_cuda_substep_runner)
        run = per_collider_count(lambda kin: make(
            spec, cfg, dt_sub, n_substeps, kin_colliders=kin))

    def fn(state: SimState) -> SimState:
        return run(state).replace(ext_force=torch.zeros_like(state.ext_force))

    fn.route = route
    return fn
