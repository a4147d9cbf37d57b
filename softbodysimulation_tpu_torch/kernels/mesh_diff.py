"""The fused mesh backward (``csrc/mesh_diff_xpbd.cu``, TPU kernel B-5), its
plain version and the runners built on them.

Counterpart of ``softbodysimulation_tpu/kernels/mesh_diff_pallas.py``
(``check_fused_backward_envelope``, ``_make_backward_chunk``, the chunk
choice, ``make_fused_differentiable_mesh_runner`` and
``make_fused_differentiable_material_runner``).  A runner is a
``torch.autograd.Function``:

  forward  -- the mesh kernel (``mesh_cuda.advance``), unchanged;
  backward -- the chunk-boundary states recomputed with the same kernel
              (so the linearization point is the forward trajectory), then
              one backward chunk per C substeps, in reverse.

A backward chunk maps ``(inv_mass, x, v, lambda, gx, gv, glambda[, rest,
compliance])`` to ``(gx0, gv0, glambda0[, g_rest, g_compliance])``: phase A
replays the chunk's C substeps and stashes, per substep, the entry
positions and velocities (and, with WARM_START, the post-predict positions
and the decayed multipliers the pre-apply starts from) and, per iteration,
the entry positions, multipliers and Chebyshev ``prev`` and the post-sweep
positions; phase B walks the substeps and iterations backward: the
finalize VJP, per iteration the contact and Chebyshev VJPs and the
distance sweep's VJP, then the warm pre-apply's, the predict's and the
multiplier lifecycle's.  ``backward_chunk_plain`` is the phases in
PyTorch, a hand-written VJP (not autograd), in the same order as the CUDA
kernel; a CUDA state runs the kernel, a CPU state the plain version, any
other device raises.  The kernel is built into the mesh library
(``mesh_cuda.SOURCES``), so its replay runs the forward's very code.

Cotangents reach positions, velocities and ``lambda_dist`` (and, for the
material runner, both material vectors; with ``kin_colliders=(S, 0)``,
the state's ColliderSet: each sphere's center, radius and velocity and
the ground height, ``mesh_diff_pallas.py:503-617``); ``inv_mass``,
``ext_force`` and the other multipliers get none (the runners are built
without ext force).  The pose is constant over a rollout, so its
cotangents SUM over the substeps, iterations and chunks.  The envelope
(``check_fused_backward_envelope``) is the JAX kernel's: JACOBI (plain or
Chebyshev), RESET / DECAY / WARM_START, distance constraints only, the
XPBD floor or none, spheres (the config's or kinematic), no boxes (the
config's or kinematic), no self-collision, single body.

There is no VMEM here: the stash lives in the card's memory, and the chunk
is the whole rollout whenever its stash fits ``STASH_BUDGET`` bytes, else
the largest divisor of the substep count whose stash fits.

``launches`` counts the CUDA kernels the backward chunks have launched
(their forward replays included; the forward runs and the boundary
recomputation count in ``mesh_cuda.launches``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.colliders import check_kin, kin_counts
from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState, Topology
from ..ops import collision as _collision
from ..ops import integrate as _integrate
from ..ops.distance import dot3
from ..solvers import general as _general
from . import mesh_cuda as _mesh
from .diff import _LEAVES, _flatten, _unflatten

# bytes the stash of one backward chunk may take on the card
STASH_BUDGET = 1 << 30

launches = 0   # CUDA kernels launched by the backward chunks (plain int)


def check_fused_backward_envelope(cfg: SolverConfig, topo: Topology,
                                  kin_colliders=None,
                                  materials: bool = False):
    """Raise ``NotImplementedError`` outside the fused backward's envelope
    (module docstring); ``materials=True`` adds the material runner's two
    refusals (bounds that are functions of the rest lengths).
    ``kin_colliders=(S, B)``: traced ColliderSet poses, which replace the
    config's rigid world, so the config's boxes are not checked; kinematic
    spheres are covered with pose cotangents, kinematic boxes are not."""
    why = None
    if cfg.solve_mode != SolveMode.JACOBI:
        why = f"solve mode {cfg.solve_mode} (JACOBI only)"
    elif cfg.lambda_mode not in (LambdaMode.RESET, LambdaMode.DECAY,
                                 LambdaMode.WARM_START):
        why = f"lambda mode {cfg.lambda_mode}"
    elif cfg.enable_bending and topo.n_hinges > 0:
        why = "bending constraints"
    elif cfg.enable_volume and topo.triangles.shape[0] > 0:
        why = "the global volume constraint"
    elif cfg.enable_tet_volume and topo.n_tets > 0:
        why = "per-tet volume constraints"
    elif cfg.enable_self_collision:
        why = "self-collision"
    elif cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
        why = "the velocity-reflect floor"
    elif kin_colliders is not None and int(kin_colliders[1]) > 0:
        why = "kinematic box colliders"
    elif kin_colliders is None and cfg.box_colliders:
        why = "box colliders"
    elif materials and cfg.max_dlambda_rel > 0:
        why = "max_dlambda_rel with materials (the bound is a function of rest)"
    elif (materials and cfg.lambda_mode == LambdaMode.WARM_START
          and cfg.warm_start_clamp > 0):
        why = ("warm_start_clamp with materials (the warm limit is a function "
               "of rest)")
    if why is not None:
        raise NotImplementedError(
            f"fused mesh backward does not cover {why} -- use the paired "
            "backward (kernels.diff.make_differentiable_mesh_runner with "
            "backward='xla')")


def stash_bytes(topo: Topology, cfg: SolverConfig, chunk: int) -> int:
    """Bytes of one chunk's stash: per substep the entry x and v planes (and
    with WARM_START a plane and a multiplier vector), per iteration the
    entry, post-sweep (and Chebyshev prev) planes and the multipliers."""
    n, e, k = topo.n_particles, topo.n_edges, cfg.iterations
    planes = 3 if _general.accelerated(cfg) else 2
    per_sub = 2 * 3 * n + k * (planes * 3 * n + e)
    if cfg.lambda_mode == LambdaMode.WARM_START:
        per_sub += 3 * n + e
    return 4 * chunk * per_sub


def pick_chunk(topo: Topology, cfg: SolverConfig, n_substeps: int,
               budget: int = STASH_BUDGET) -> int:
    """``n_substeps`` when its stash fits ``budget`` bytes, else the
    largest divisor of ``n_substeps`` whose stash fits."""
    for c in range(n_substeps, 0, -1):
        if n_substeps % c == 0 and stash_bytes(topo, cfg, c) <= budget:
            return c
    raise NotImplementedError(
        f"fused mesh backward: even a 1-substep chunk's stash "
        f"({stash_bytes(topo, cfg, 1)} bytes) exceeds the budget of "
        f"{budget} bytes -- use the paired backward")


def _chunk_of(topo, cfg, n_substeps, chunk_substeps):
    if chunk_substeps is None:
        return pick_chunk(topo, cfg, n_substeps)
    chunk = int(chunk_substeps)
    if chunk < 1 or n_substeps % chunk:
        raise ValueError(f"chunk_substeps {chunk} must divide n_substeps "
                         f"{n_substeps}")
    return chunk


def fused_envelope_ok(topo: Topology, cfg: SolverConfig, n_substeps: int,
                      materials: bool = False, kin_colliders=None) -> bool:
    """Whether the fused backward covers the configuration (the envelope
    and a chunk whose stash fits); ``backward="auto"`` chooses by this
    alone."""
    try:
        check_fused_backward_envelope(cfg, topo, kin_colliders, materials)
        pick_chunk(topo, cfg, n_substeps)
    except NotImplementedError:
        return False
    return True


# ------------------------------------------------------ the plain version
class PoseGrads:
    """Per-particle accumulators of the pose cotangents of a kinematic
    rigid world (ground height, each sphere's center, radius and
    velocity), summed over particles by ``totals``: the kernel's
    ``gpose`` planes, in the plain version."""

    def __init__(self, n_spheres: int, like: torch.Tensor):
        n = like.shape[0]
        self.ground = like.new_zeros(n)
        self.center = like.new_zeros((n_spheres, n, 3))
        self.radius = like.new_zeros((n_spheres, n))
        self.velocity = like.new_zeros((n_spheres, n, 3))

    def totals(self):
        """{"spheres": (S, 4), "sphere_velocities": (S, 3),
        "ground_height": ()}."""
        return {"spheres": torch.cat([self.center.sum(1),
                                      self.radius.sum(1)[:, None]], 1),
                "sphere_velocities": self.velocity.sum(1),
                "ground_height": self.ground.sum()}


def _contact_stages(cfg: SolverConfig, world):
    """The contact chain in forward order: the floor (None), then each
    sphere's index."""
    floor = [None] if cfg.floor_mode == FloorMode.XPBD_INEQUALITY else []
    return floor + list(range(world.n_spheres))


def _stage_fwd(stage, p, anchor, w, dt, cfg, world):
    if stage is None:
        return world.project_floor(p, anchor, w, dt, cfg)
    return _collision.sphere_sdf_project(
        p, anchor, w, dt, cfg, spheres=world.spheres[stage:stage + 1],
        sphere_velocities=world.sphere_velocities[stage:stage + 1])


def _contacts_fwd(p, anchor, w, dt, cfg, world):
    for stage in _contact_stages(cfg, world):
        p = _stage_fwd(stage, p, anchor, w, dt, cfg, world)
    return p


def _floor_bwd(g, p, anchor, w, dt, cfg, world, pose):
    """VJP of the XPBD floor at input ``p``: (g_p, g_anchor); the ground
    height's per-particle cotangent is added into ``pose`` when given."""
    pen = world.ground - p[:, 1]
    denom = w + cfg.collision_compliance / (dt * dt)
    a = ((pen > 0) & (w >= cfg.static_inv_mass_eps)
         & (torch.abs(denom) >= cfg.eps_denominator))
    fdt = _collision.friction_step(cfg, dt)
    gu = -g * fdt
    g_gh = g[:, 1] * w / denom
    gy = g[:, 1] - g_gh
    g_p = torch.stack([torch.where(a, g[:, 0] + _integrate.over_dt(gu[:, 0], dt),
                                   g[:, 0]),
                       torch.where(a, gy, g[:, 1]),
                       torch.where(a, g[:, 2] + _integrate.over_dt(gu[:, 2], dt),
                                   g[:, 2])], dim=1)
    ga = -_integrate.over_dt(gu, dt)
    zero = torch.zeros_like(pen)
    g_a = torch.stack([torch.where(a, ga[:, 0], zero), zero,
                       torch.where(a, ga[:, 2], zero)], dim=1)
    if pose is not None:
        pose.ground = pose.ground + torch.where(a, g_gh, zero)
    return g_p, g_a


def _sphere_bwd(g2, p, anchor, w, dt, cfg, world, k, pose):
    """VJP of sphere ``k``'s projection and friction at input ``p``:
    (g_p, g_anchor); its center, radius and velocity cotangents per
    particle are added into ``pose`` when given."""
    center, radius = world.spheres[k, :3], world.spheres[k, 3]
    d = p - center
    dist = torch.sqrt(dot3(d, d))
    dmax = torch.clamp(dist, min=1e-12)
    n = d / dmax[:, None]
    pen = radius - dist
    a = ((pen > 0) & (w >= cfg.static_inv_mass_eps))[:, None]
    p1 = p + torch.where(a, n * pen[:, None], 0.0)
    vel = _integrate.over_dt(p1 - anchor, dt) - world.sphere_velocities[k]
    vn = dot3(vel, n)
    gvt = -g2 * _collision.friction_step(cfg, dt)
    gvtn = dot3(gvt, n)
    g_vel = gvt - n * gvtn[:, None]
    gvel = _integrate.over_dt(g_vel, dt)
    gn = -(vn[:, None] * gvt + vel * gvtn[:, None])
    gp1 = g2 + gvel
    gn = gn + pen[:, None] * gp1
    g_pen = dot3(gp1, n)
    gdist = -g_pen + torch.where(dist >= 1e-12,
                                 -dot3(gn, d) / (dmax * dmax), 0.0)
    gd = gn / dmax[:, None] + d * (gdist / dist)[:, None]
    if pose is not None:
        pose.center[k] = pose.center[k] + torch.where(a, -gd, 0.0)
        pose.radius[k] = pose.radius[k] + torch.where(a[:, 0], g_pen, 0.0)
        pose.velocity[k] = pose.velocity[k] + torch.where(a, -g_vel, 0.0)
    return (torch.where(a, gp1 + gd, g2),
            torch.where(a, -gvel, 0.0))


def _contacts_bwd(g, p, anchor, w, dt, cfg, world, pose):
    """VJP of the contact chain at input ``p``: the chain's intermediate
    inputs recomputed, then walked backward.  (g_p, g_anchor); the pose
    cotangents go into ``pose`` when given."""
    stages = _contact_stages(cfg, world)
    vals = [p]
    for stage in stages[:-1]:
        vals.append(_stage_fwd(stage, vals[-1], anchor, w, dt, cfg, world))
    ga = torch.zeros_like(g)
    for stage, val in reversed(list(zip(stages, vals))):
        if stage is None:
            g, gs = _floor_bwd(g, val, anchor, w, dt, cfg, world, pose)
        else:
            g, gs = _sphere_bwd(g, val, anchor, w, dt, cfg, world, stage,
                                pose)
        ga = ga + gs
    return g, ga


def _edge_geometry(pred, T):
    d = pred[T.eb] - pred[T.ea]
    len_sq = dot3(d, d)
    length = torch.sqrt(torch.clamp(len_sq, min=1e-24))
    return d, len_sq, length


def _position_vjp(g_n, g_len, d, len_sq, length):
    """Cotangent of d from those of n = d / length and of length."""
    g_len = g_len - dot3(g_n, d) / (length * length)
    g_lsq = torch.where(len_sq >= 1e-24, g_len * 0.5 / length, 0.0)
    return g_n / length[:, None] + d * (2.0 * g_lsq)[:, None]


def _scatter(g_d, T):
    """Each particle's sum of -g_d (a side) and +g_d (b side) over its
    incidence row, in column order (the sum order of the kernel)."""
    return _general.gather_sum(torch.cat([-g_d, g_d]), T.incidence)


def _sweep_bwd(g_after, glam, pred, lam_e, w, T, cfg, dt, acc_mat):
    """VJP of one JACOBI distance sweep linearized at its entry (``pred``,
    ``lam_e``): returns (entry-position cotangent, entry-multiplier
    cotangent) and adds the material cotangents into ``acc_mat`` (a
    [g_rest, g_alpha] list) when it is given."""
    topo = T.topo
    wa, wb = w[T.ea], w[T.eb]
    d, len_sq, length = _edge_geometry(pred, T)
    alpha = topo.compliance * (1.0 / (dt * dt))
    if cfg.min_alpha_tilde > 0:
        alpha = torch.clamp(alpha, min=cfg.min_alpha_tilde)
    denom = wa + wb + alpha
    valid = ((length >= cfg.eps_length)
             & (torch.abs(denom) >= cfg.eps_denominator)
             & ((wa >= cfg.static_inv_mass_eps)
                | (wb >= cfg.static_inv_mass_eps)))
    denom_v = torch.where(valid, denom, 1.0)
    raw = (-(length - topo.rest_lengths) - alpha * lam_e) / denom_v
    ok, dl = valid, raw
    for bound in ((cfg.max_dlambda if cfg.max_dlambda > 0 else None),
                  (cfg.max_dlambda_rel * topo.rest_lengths
                   if cfg.max_dlambda_rel > 0 else None)):
        if bound is not None:
            ok = ok & (dl > -bound) & (dl < bound)
            dl = torch.clamp(dl, -bound, bound)
    s = torch.where(valid, dl, 0.0) * T.edge_scale
    g_dp = wb[:, None] * g_after[T.eb] - wa[:, None] * g_after[T.ea]
    n = d / length[:, None]
    glo = glam
    if cfg.lambda_clamp > 0:
        lam_pre = lam_e + s
        glo = torch.where((lam_pre > -cfg.lambda_clamp)
                          & (lam_pre < cfg.lambda_clamp), glam, 0.0)
    graw = torch.where(ok, (dot3(g_dp, n) + glo) * T.edge_scale, 0.0)
    q = graw / denom_v
    if acc_mat is not None:
        acc_mat[0] = acc_mat[0] + q
        acc_mat[1] = acc_mat[1] - q * (lam_e + raw)
    g_d = _position_vjp(s[:, None] * g_dp, -q, d, len_sq, length)
    return g_after + _scatter(g_d, T), glo - alpha * q


def _warm_bwd(g_after, glam, pred, lam_in, w, T, cfg):
    """VJP of the WARM_START pre-apply linearized at its entry (post-predict
    ``pred``, decayed ``lam_in``): (position cotangent, multiplier
    cotangent)."""
    wa, wb = w[T.ea], w[T.eb]
    s = lam_in * T.warm_scale
    ok = torch.ones_like(s, dtype=torch.bool)
    if cfg.warm_start_clamp > 0:
        wmax = torch.clamp(torch.maximum(wa, wb), min=1e-12)
        lim = cfg.warm_start_clamp * T.topo.rest_lengths / wmax
        ok = (s > -lim) & (s < lim)
        s = torch.clamp(s, -lim, lim)
    d, len_sq, length = _edge_geometry(pred, T)
    g_dp = wb[:, None] * g_after[T.eb] - wa[:, None] * g_after[T.ea]
    glc = glam + dot3(g_dp, d / length[:, None])
    g_d = _position_vjp(s[:, None] * g_dp, torch.zeros_like(s), d, len_sq,
                        length)
    return (g_after + _scatter(g_d, T),
            torch.where(ok, glc, 0.0) * T.warm_scale)


def _predict_bwd(gp, x, v, w, dt, cfg):
    """VJP of predict (no ext force): (g_x, g_v)."""
    free = cfg.replace(max_velocity=0.0, world_bounds=0.0)
    _, v_raw = _integrate.predict(x, v, w, torch.zeros_like(x), dt, free,
                                  apply_ext=False)
    g0 = gp
    if cfg.world_bounds > 0:
        vc = v_raw
        if cfg.max_velocity > 0:
            vc = torch.clamp(v_raw, -cfg.max_velocity, cfg.max_velocity)
        p_raw = x + dt * vc
        g0 = torch.where((p_raw > -cfg.world_bounds)
                         & (p_raw < cfg.world_bounds), gp, 0.0)
    gv = dt * g0
    if cfg.max_velocity > 0:
        gv = torch.where((v_raw > -cfg.max_velocity)
                         & (v_raw < cfg.max_velocity), gv, 0.0)
    return g0, gv * _integrate.damping_factor(cfg, dt)


def _cheby_weights(om: float, gamma: float):
    """d acc / d (new, cur, prev) of the Chebyshev step acc = om * (gamma *
    (new - cur) + cur - prev) + prev, multiplied out in float32 as the
    kernel does."""
    om, gamma = np.float32(om), np.float32(gamma)
    one = np.float32(1.0)
    return (float(om * gamma), float(om * (one - gamma)), float(one - om))


def backward_chunk_plain(topo: Topology, cfg: SolverConfig, dt: float,
                         chunk: int, inv_mass, x, v, lam, gx, gv, glam,
                         materials=None, colliders=None):
    """The VJP of ``chunk`` substeps linearized at the chunk-entry state
    ``(x, v, lam)`` ((N, 3), (N, 3), (E,)), given the output cotangents
    ``(gx, gv, glam)``: returns ``(gx0, gv0, glam0)``, with ``materials``
    also ``(g_rest, g_compliance)``, and with ``colliders`` (a ColliderSet
    of spheres, which replaces the config's rigid world) last the pose
    cotangents ``{"spheres", "sphere_velocities", "ground_height"}``.  The
    plain version of the B-5 kernel: its phases in its order (module
    docstring)."""
    check_fused_backward_envelope(cfg, topo, kin_counts(colliders),
                                  materials=materials is not None)
    world = _collision.RigidWorld.of(cfg, colliders, x.device)
    pose = None if colliders is None else PoseGrads(colliders.n_spheres, x)
    T = _general._tables(topo, cfg, str(x.device))
    if materials is not None:
        T = _general.with_materials(T, materials)
    w = inv_mass
    oms = _general.chebyshev_omegas(cfg)
    accel = _general.accelerated(cfg)
    warm = cfg.lambda_mode == LambdaMode.WARM_START
    gamma = cfg.jacobi_gamma
    zero = torch.zeros_like(x)

    # phase A: replay, stashing the linearization points
    st_x, st_v, st_wx, st_wlam = [], [], [], []
    st_pred, st_lam, st_new, st_prev = [], [], [], []
    for _ in range(chunk):
        st_x.append(x)
        st_v.append(v)
        lam = (torch.zeros_like(lam) if cfg.lambda_mode == LambdaMode.RESET
               else lam * cfg.lambda_decay)
        pred, _ = _integrate.predict(x, v, w, zero, dt, cfg, apply_ext=False)
        if warm:
            st_wx.append(pred)
            st_wlam.append(lam)
            pred, lam = _general._warm_apply_distance(pred, lam, w, T, cfg)
        prev = pred
        for om in oms:
            st_pred.append(pred)
            st_lam.append(lam)
            st_prev.append(prev)
            new, lam = _general._solve_distance_jacobi(pred, lam, w, T, cfg,
                                                       dt)
            st_new.append(new)
            new = _contacts_fwd(new, x, w, dt, cfg, world)
            if accel:
                acc = om * (gamma * (new - pred) + pred - prev) + prev
                prev, pred = pred, _contacts_fwd(acc, x, w, dt, cfg, world)
            else:
                pred = new
        x, v = _integrate.finalize(x, pred, w, dt)

    # phase B: cotangents, substeps and iterations in reverse
    acc_mat = None
    if materials is not None:
        acc_mat = [torch.zeros_like(lam), torch.zeros_like(lam)]
    pinned = (w == 0.0)[:, None]
    for sub in reversed(range(chunk)):
        anchor = st_x[sub]
        gp = torch.where(pinned, 0.0, gx + _integrate.over_dt(gv, dt))
        gx = torch.where(pinned, gx, -_integrate.over_dt(gv, dt))
        gprev = torch.zeros_like(gp)
        for it in reversed(range(cfg.iterations)):
            si = sub * cfg.iterations + it
            new0 = st_new[si]
            if accel:
                om, cur, prv = oms[it], st_pred[si], st_prev[si]
                new1 = _contacts_fwd(new0, anchor, w, dt, cfg, world)
                acc = om * (gamma * (new1 - cur) + cur - prv) + prv
                gacc, ga = _contacts_bwd(gp, acc, anchor, w, dt, cfg, world,
                                         pose)
                gx = gx + ga
                a_new, a_cur, a_prev = _cheby_weights(om, gamma)
                gcur = a_cur * gacc + gprev
                gprev = a_prev * gacc
                gq, ga = _contacts_bwd(a_new * gacc, new0, anchor, w, dt,
                                       cfg, world, pose)
            else:
                gcur = None
                gq, ga = _contacts_bwd(gp, new0, anchor, w, dt, cfg, world,
                                       pose)
            gx = gx + ga
            gp, glam = _sweep_bwd(gq, glam, st_pred[si], st_lam[si], w, T,
                                  cfg, dt, acc_mat)
            if accel:
                gp = gp + gcur
        if accel:
            gp = gp + gprev
        if warm:
            gp, glam = _warm_bwd(gp, glam, st_wx[sub], st_wlam[sub], w, T,
                                 cfg)
        g0, gv = _predict_bwd(gp, anchor, st_v[sub], w, dt, cfg)
        gx = gx + g0
        glam = (torch.zeros_like(glam) if cfg.lambda_mode == LambdaMode.RESET
                else glam * cfg.lambda_decay)
    out = (gx, gv, glam)
    if materials is not None:
        out += (acc_mat[0], compliance_cotangent(
            acc_mat[1], materials["compliance"], cfg, dt))
    if pose is not None:
        out += (pose.totals(),)
    return out


def compliance_cotangent(g_alpha, compliance, cfg: SolverConfig, dt: float):
    """d/d compliance from d/d alpha: alpha = compliance / dt^2, floored at
    ``min_alpha_tilde`` (the floor's VJP passes the cotangent only where
    the raw alpha is above it)."""
    inv_dt2 = 1.0 / (dt * dt)
    if cfg.min_alpha_tilde > 0:
        g_alpha = torch.where(compliance * inv_dt2 > cfg.min_alpha_tilde,
                              g_alpha, 0.0)
    return g_alpha * inv_dt2


# ----------------------------------------------------------- the kernel
def backward_chunk_cuda(topo: Topology, cfg: SolverConfig, dt: float,
                        chunk: int, inv_mass, x, v, lam, gx, gv, glam,
                        materials=None, colliders=None):
    """``backward_chunk_plain``'s contract, launched on the card (tensors
    on one CUDA device); no host sync.  The pose cotangents are summed
    over the particles without atomics: each particle accumulates its own
    column of the ``gpose`` planes (ground, then per sphere center x3,
    radius, velocity x3), and one block per plane sums it in a fixed
    order."""
    global launches
    check_fused_backward_envelope(cfg, topo, kin_counts(colliders),
                                  materials=materials is not None)
    dev = x.device
    world = _collision.RigidWorld.of(cfg, colliders, dev)
    _mesh._check_supported(cfg, topo,
                           kin_colliders=(world.n_spheres, world.n_boxes))
    if dev.type != "cuda":
        raise ValueError(f"fused mesh backward: state on {dev}, not CUDA")
    if colliders is not None and colliders.device != dev:
        raise ValueError(f"fused mesh backward: colliders on "
                         f"{colliders.device}, state on {dev}")
    n, e, k = topo.n_particles, topo.n_edges, cfg.iterations
    tables = _mesh._device_tables(topo, cfg, dt, str(dev))
    params = _mesh.launch_params(tables, world)
    # the replay runs the distance family alone (the envelope has no other)
    params.n_hinges = params.bending = params.n_tets = params.tets_on = 0

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def plane(name, t):
        return _mesh._checked(name, t, (n, 3), dev).t().contiguous()

    xw, vw = plane("positions", x), plane("velocities", v)
    planes = f32(3, 3, n)
    work = dict(x=xw, v=vw,
                w=_mesh._checked("inv_mass", inv_mass, (n,), dev).contiguous(),
                f=torch.zeros((3, n), dtype=torch.float32, device=dev),
                pred=planes[0], cur=planes[1], prev=planes[2],
                lam=_mesh._checked("lambda_dist", lam, (e,), dev).clone(),
                contrib=f32(2 * e, 3),
                colliders=world.table,
                **tables.tensors)
    if materials is not None:
        work["rest"], work["alpha"] = _mesh.material_constants(
            materials, cfg, dt, e, dev)
    bufs = _mesh.MeshBuffers(**{f: ctypes.c_void_p(work[f].data_ptr())
                                for f in _mesh._BUFFERS if f in work})
    warm = cfg.lambda_mode == LambdaMode.WARM_START
    scratch = f32(4, 3, n)
    grads = dict(gx=plane("gx", gx), gv=plane("gv", gv),
                 glam=_mesh._checked("glam", glam, (e,), dev).clone(),
                 gp=scratch[0], gprev=scratch[1], gq=scratch[2],
                 gcur=scratch[3], gcontrib=f32(2 * e, 3),
                 st_x=f32(chunk, 3, n), st_v=f32(chunk, 3, n),
                 st_pred=f32(chunk * k, 3, n), st_new=f32(chunk * k, 3, n),
                 st_lam=f32(chunk * k, e))
    if _general.accelerated(cfg):
        grads["st_prev"] = f32(chunk * k, 3, n)
    if warm:
        grads.update(st_wx=f32(chunk, 3, n), st_wlam=f32(chunk, e))
    if materials is not None:
        grads.update(grest=torch.zeros(e, dtype=torch.float32, device=dev),
                     galpha=torch.zeros(e, dtype=torch.float32, device=dev))
    if colliders is not None:
        rows = pose_rows(colliders.n_spheres)
        grads.update(gpose=torch.zeros((rows, n), dtype=torch.float32,
                                       device=dev), gpose_out=f32(rows))
    dbufs = _mesh.DiffBuffers(**{f: ctypes.c_void_p(grads[f].data_ptr())
                                 for f in _mesh.DIFF_BUFFERS if f in grads})
    lib = _mesh._library()
    count = ctypes.c_longlong(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mesh_diff_xpbd_run(ctypes.byref(params), ctypes.byref(bufs),
                                ctypes.byref(dbufs), dev.index, chunk,
                                tables.om, ctypes.byref(count),
                                ctypes.c_void_p(stream))
    launches += count.value
    if rc != 0:
        msg = lib.mesh_xpbd_error_string(rc).decode()
        raise RuntimeError(f"fused mesh backward launch failed: {msg} ({rc})")
    out = (grads["gx"].t().contiguous(), grads["gv"].t().contiguous(),
           grads["glam"])
    if materials is not None:
        out += (grads["grest"], compliance_cotangent(
            grads["galpha"], materials["compliance"], cfg, dt))
    if colliders is not None:
        out += (pose_totals(grads["gpose_out"], colliders.n_spheres),)
    return out


def pose_rows(n_spheres: int) -> int:
    """Planes of the kernel's pose cotangents: the ground, then per sphere
    its center (3), radius and velocity (3)."""
    return 1 + 7 * n_spheres


def pose_totals(g: torch.Tensor, n_spheres: int):
    """The kernel's ``gpose_out`` as ``PoseGrads.totals`` lays it out."""
    sph = g[1:].reshape(n_spheres, 7)
    return {"spheres": sph[:, :4].contiguous(),
            "sphere_velocities": sph[:, 4:].contiguous(),
            "ground_height": g[0]}


def backward_chunk(topo, cfg, dt, chunk, inv_mass, x, v, lam, gx, gv, glam,
                   materials=None, colliders=None):
    """A CUDA state launches the B-5 kernel; a CPU state runs the plain
    version; any other device raises."""
    if x.device.type == "cuda":
        return backward_chunk_cuda(topo, cfg, dt, chunk, inv_mass, x, v, lam,
                                   gx, gv, glam, materials, colliders)
    if x.device.type == "cpu":
        return backward_chunk_plain(topo, cfg, dt, chunk, inv_mass, x, v,
                                    lam, gx, gv, glam, materials, colliders)
    raise NotImplementedError(
        f"fused mesh backward: no path for a state on {x.device}")


# ------------------------------------------------------------ the runners
class _FusedRollout(torch.autograd.Function):
    """Forward: the mesh kernel over ``n_substeps``; backward: boundaries
    recomputed with it, then the backward chunks in reverse."""

    @staticmethod
    def forward(ctx, spec, keys, *tensors):
        topo, cfg, dt, n_substeps, chunk = spec
        state, mats = _unflatten(keys, tensors)
        out = _mesh.advance(state, topo, cfg, dt, n_substeps, False, mats)
        ctx.spec, ctx.keys = spec, keys
        ctx.save_for_backward(*tensors)
        return tuple(getattr(out, k) for k in keys if k in _LEAVES)

    @staticmethod
    def backward(ctx, *g_out):
        topo, cfg, dt, n_substeps, chunk = ctx.spec
        state, mats = _unflatten(ctx.keys, ctx.saved_tensors)
        coll = state.colliders
        g = dict(zip([k for k in ctx.keys if k in _LEAVES], g_out))
        bounds = [state]
        for _ in range(n_substeps // chunk - 1):
            bounds.append(_mesh.advance(bounds[-1], topo, cfg, dt, chunk,
                                        False, mats))
        gx, gv, glam = g["positions"], g["velocities"], g["lambda_dist"]
        g_mat, g_pose = None, None
        for b in reversed(bounds):
            outs = backward_chunk(topo, cfg, dt, chunk, b.inv_mass,
                                  b.positions, b.velocities, b.lambda_dist,
                                  gx, gv, glam, mats, coll)
            gx, gv, glam = outs[:3]
            if mats is not None:
                g_mat = (outs[3:5] if g_mat is None
                         else tuple(a + c for a, c in zip(g_mat, outs[3:5])))
            if coll is not None:
                # the pose is constant over the rollout: chunks sum
                g_pose = (outs[-1] if g_pose is None else
                          {key: g_pose[key] + outs[-1][key]
                           for key in g_pose})
        grads = {"positions": gx, "velocities": gv, "lambda_dist": glam}
        if g_mat is not None:
            grads.update(rest_lengths=g_mat[0], compliance=g_mat[1])
        if g_pose is not None:
            grads.update({"colliders." + key: val
                          for key, val in g_pose.items()})
        return (None, None) + tuple(grads.get(k) for k in ctx.keys)


def _fused_apply(spec, state: SimState, materials=None,
                 kin_colliders=None) -> SimState:
    _general.check_state(state)
    check_kin(kin_colliders, state.colliders, "fused mesh runner")
    keys, tensors = _flatten(state, materials)
    outs = _FusedRollout.apply(spec, keys, *tensors)
    return state.replace(**dict(zip([k for k in keys if k in _LEAVES],
                                    outs)))


def make_fused_differentiable_mesh_runner(topo: Topology, cfg: SolverConfig,
                                          dt_sub: float, n_substeps: int,
                                          chunk_substeps=None,
                                          kin_colliders=None):
    """``fn(state) -> SimState`` over ``n_substeps`` raw substeps: forward
    the mesh kernel, reverse mode through the fused backward (module
    docstring).  ``chunk_substeps`` (must divide ``n_substeps``; default
    ``pick_chunk``) sets the substeps per backward chunk: only the chunk
    boundaries are kept, each chunk's stash lives for its own backward.
    ``kin_colliders=(S, 0)``: the state's ColliderSet of S spheres
    replaces the config's rigid world, and its pose cotangents (each
    sphere's center, radius and velocity, the ground height) come from the
    kernel, summed over the chunks; kinematic boxes raise."""
    kin = None if kin_colliders is None else tuple(
        int(c) for c in kin_colliders)
    check_fused_backward_envelope(cfg, topo, kin)
    _mesh._check_supported(cfg, topo, kin_colliders=kin)
    chunk = _chunk_of(topo, cfg, n_substeps, chunk_substeps)
    spec = (topo, cfg, dt_sub, n_substeps, chunk)

    def fn(state: SimState) -> SimState:
        return _fused_apply(spec, state, kin_colliders=kin)

    return fn


def make_fused_differentiable_material_runner(topo: Topology,
                                              cfg: SolverConfig,
                                              dt_sub: float, n_substeps: int,
                                              chunk_substeps=None):
    """``fn(state, materials) -> SimState`` with ``materials =
    {"rest_lengths": (E,), "compliance": (E,)}`` (topology edge order,
    float32 on the state's device): the fused backward with the per-edge
    rest and compliance cotangents accumulated in its cotangent sweep.
    Envelope: ``check_fused_backward_envelope(..., materials=True)``."""
    check_fused_backward_envelope(cfg, topo, materials=True)
    _mesh._check_supported(cfg, topo)
    chunk = _chunk_of(topo, cfg, n_substeps, chunk_substeps)
    spec = (topo, cfg, dt_sub, n_substeps, chunk)

    def fn(state: SimState, materials) -> SimState:
        return _fused_apply(spec, state, materials)

    return fn
