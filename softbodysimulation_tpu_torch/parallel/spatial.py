"""Spatial sharding of ONE large lattice across devices (halo exchange): the
plain PyTorch version.

Counterpart of ``softbodysimulation_tpu/parallel/spatial.py`` (its XLA
backend).  The lattice is split along x into D slabs of P = res / D
planes, one per entry of ``devices`` (a sequence of ``torch.device``;
repeats are allowed, so four slabs can share one card, or the CPU).  Each
slab owns its planes as tensors on its device, in the port's component-
major layout: positions, velocities and ext force (3, P*res^2), inverse
masses (P*res^2,), multipliers (13, P*res^2) and, for solid lattices, tet
multipliers (6, P*res^2).  The state's x-major order makes each slab a
contiguous range of every plane, so sharding is slicing.

No slab reads another slab's tensors.  The stencil families with dx = 1
need one plane of halo, and the only path between slabs is ``exchange``,
the counterpart of the JAX engine's ``lax.ppermute`` with
``_right_perm`` / ``_left_perm``: a copy of one plane from each slab's
neighbour onto the slab's own device, zeros where there is no neighbour.

  * before such a pass, each slab receives its right neighbour's FIRST
    plane of predicted positions (the gather halo);
  * after it, each slab's correction for its last anchor plane's partner
    is sent RIGHT and added to the neighbour's first plane (the spill).

Masks are built from GLOBAL coordinates, so the arithmetic is the single-
device engine's (``solvers/lattice.py``) up to the order of a few sums:
this engine takes ``dp = dl * (d / length)`` where the single-device
engine takes ``d * (dl / length)``, as the two JAX engines do, and the
sharded tet sweep adds the spill last.

The rigid world (floor, spheres and boxes of the config, or a
``core/colliders.ColliderSet``'s traced poses with ``kin_colliders=(S,
B)``) is replicated: every slab holds its own copy of the collider
tensors on its device, and projects its particles against the whole
world in the order floor, spheres, boxes (JAX ``spatial.py:367-372``).

``make_spatial_lattice_step`` routes by the slabs' device: slabs on the
CPU run this engine; slabs on CUDA devices launch the hand-written slab
kernel (``kernels/spatial_cuda.py``, TPU kernel B-6) unless the caller asks
for this engine with ``backend="xla"``.  The slab kernel refuses SDF
colliders, as JAX's does (``kernels/spatial_pallas.py:62-64``), so
colliders on the card take ``backend="xla"``.  Self-collision raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.colliders import ColliderSet, check_kin
from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState, check_colliders
from ..ops import collision as _collision
from ..ops import integrate as _integrate
from ..solvers import lattice as _lat
from ..topology.lattice import LatticeSpec

BACKENDS = ("auto", "xla", "pallas")


@dataclasses.dataclass(frozen=True)
class Slab:
    """One slab's share of a lattice state, on its own device."""

    positions: torch.Tensor            # (3, P*r2)
    velocities: torch.Tensor           # (3, P*r2)
    inv_mass: torch.Tensor             # (P*r2,)
    ext_force: torch.Tensor            # (3, P*r2)
    lambda_dist: torch.Tensor          # (nfam, P*r2)
    lambda_tet: Optional[torch.Tensor] = None   # (6, P*r2)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kw) -> "Slab":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShardedLatticeState:
    """A lattice state split into x-slabs (``shard_lattice_state``); the
    slabs stay on their devices across calls of a spatial step."""

    slabs: Tuple[Slab, ...]
    lambda_bend: torch.Tensor
    lambda_volume: torch.Tensor
    # the rigid world replicated: one copy on each slab's device, or None
    colliders: Optional[Tuple[ColliderSet, ...]] = None

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.slabs)

    def replace(self, **kw) -> "ShardedLatticeState":
        return dataclasses.replace(self, **kw)


def slab_devices(devices: Sequence, res: int) -> Tuple[torch.device, ...]:
    """``devices`` as a tuple of ``torch.device`` (a CUDA device without an
    index is the current one); raises unless ``res`` splits evenly into
    them and they are all of one type."""
    devs = tuple(torch.device(d) for d in devices)
    devs = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)
    if not devs:
        raise ValueError("spatial: no devices")
    if res % len(devs) != 0:
        raise ValueError(f"res {res} not divisible by {len(devs)} shards")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"spatial: slabs on devices of one type only, got "
                         f"{[str(d) for d in devs]}")
    return devs


def shard_lattice_state(state: SimState, spec: LatticeSpec,
                        devices: Sequence) -> ShardedLatticeState:
    """Split a lattice ``SimState`` into x-slabs, slab s on ``devices[s]``
    (each slab's tensors are copies; a ColliderSet is copied to every
    slab's device)."""
    check_colliders(state)
    devs = slab_devices(devices, spec.res)
    n = spec.n_particles
    m = n // len(devs)

    def part(t, rows):
        return [t.reshape(rows, n)[:, s * m:(s + 1) * m].to(
            d, copy=True).contiguous() for s, d in enumerate(devs)]

    x = part(state.positions.T, 3)
    v = part(state.velocities.T, 3)
    w = [t.reshape(-1) for t in part(state.inv_mass, 1)]
    f = part(state.ext_force.T, 3)
    lam = part(state.lambda_dist, spec.n_families)
    lam_t = (part(state.lambda_tet, 6) if state.lambda_tet is not None
             else [None] * len(devs))
    coll = (None if state.colliders is None else
            tuple(state.colliders.map(lambda t: t.to(d, copy=True))
                  for d in devs))
    return ShardedLatticeState(
        slabs=tuple(Slab(*fields) for fields in zip(x, v, w, f, lam, lam_t)),
        lambda_bend=state.lambda_bend, lambda_volume=state.lambda_volume,
        colliders=coll)


def gather_lattice_state(sharded: ShardedLatticeState,
                         device=None) -> SimState:
    """The whole ``SimState`` of a sharded one, on ``device`` (default: the
    first slab's)."""
    dev = sharded.devices[0] if device is None else torch.device(device)

    def cat(name):
        parts = [getattr(s, name) for s in sharded.slabs]
        if parts[0] is None:
            return None
        return torch.cat([p.to(dev) for p in parts], dim=-1)

    lam_t = cat("lambda_tet")
    return SimState(
        positions=cat("positions").T.contiguous(),
        velocities=cat("velocities").T.contiguous(),
        inv_mass=cat("inv_mass"),
        ext_force=cat("ext_force").T.contiguous(),
        lambda_dist=cat("lambda_dist").reshape(-1),
        lambda_bend=sharded.lambda_bend.to(dev),
        lambda_volume=sharded.lambda_volume.to(dev),
        lambda_tet=None if lam_t is None else lam_t.reshape(-1),
        colliders=(None if sharded.colliders is None
                   else sharded.colliders[0].to(dev)),
    )


def exchange(planes: Sequence[torch.Tensor], devices: Sequence,
             source: int) -> List[torch.Tensor]:
    """The halo move between slabs: slab i receives a copy of slab
    (i + source)'s plane on its own device, and zeros where that slab does
    not exist (``lax.ppermute``).  ``source=+1`` fetches from the right
    neighbour (``_right_perm``), ``source=-1`` from the left
    (``_left_perm``)."""
    out = []
    for i, dev in enumerate(devices):
        j = i + source
        if 0 <= j < len(planes):
            out.append(planes[j].to(dev, copy=True))
        else:
            out.append(torch.zeros_like(planes[i]))
    return out


def _roll_lanes(a, k):
    return torch.roll(a, k, dims=a.ndim - 1) if k else a


def _family_pass(pred, w, w_halo, lam, fam, masks, rest, comp, dt,
                 cfg: SolverConfig, res, devices, relax=None, warm=False):
    """One constraint pass of family ``fam`` on every slab (the JAX engine's
    ``_sharded_family_pass``; with ``warm`` its ``_apply_warm``).  pred:
    per-slab (3, P, r2); w, w_halo, each mask and lam: (P, r2).  Returns
    (pred, lam) lists."""
    dx, dy, dz, _ = fam
    k = dy * res + dz
    if dx:
        halos = exchange([p[:, 0] for p in pred], devices, +1)
    out_p, out_l, corr = [], [], []
    for s, (p, ws, lam_f, mask) in enumerate(zip(pred, w, lam, masks)):
        if dx:
            pb = torch.cat([p[:, 1:], halos[s][:, None]], dim=1)
            wb = w_halo[s]
        else:
            pb, wb = p, ws
        pb = _roll_lanes(pb, -k)
        wb = _roll_lanes(wb, -k)
        if warm:
            if cfg.warm_start_fraction != 1.0:
                lam_f = lam_f * cfg.warm_start_fraction
            if cfg.warm_start_clamp > 0:
                wmax = torch.clamp(torch.maximum(ws, wb), min=1e-12)
                # true division (float / tensor is a reciprocal multiply)
                lim = wmax.new_tensor(cfg.warm_start_clamp * rest) / wmax
                lam_f = torch.clamp(lam_f, -lim, lim)
        d = pb - p
        length = torch.sqrt(torch.clamp(_lat._dot3(d, d), min=1e-24))
        nrm = d / length[None]
        if warm:
            dl = torch.where(mask, lam_f, 0.0)
        else:
            c = length - rest
            alpha = comp / (dt * dt)
            if cfg.min_alpha_tilde > 0:
                alpha = max(alpha, cfg.min_alpha_tilde)
            denom = ws + wb + alpha
            dl = (-c - alpha * lam_f) / torch.clamp(denom, min=1e-30)
            if cfg.max_dlambda > 0:
                dl = torch.clamp(dl, -cfg.max_dlambda, cfg.max_dlambda)
            if cfg.max_dlambda_rel > 0:
                m = cfg.max_dlambda_rel * rest
                dl = torch.clamp(dl, -m, m)
            active = (mask & (length >= cfg.eps_length)
                      & (torch.abs(denom) >= cfg.eps_denominator)
                      & ((ws >= cfg.static_inv_mass_eps)
                         | (wb >= cfg.static_inv_mass_eps)))
            dl = torch.where(active, dl if relax is None else dl * relax,
                             0.0)
            lam_f = lam_f + dl
            if cfg.lambda_clamp > 0:
                lam_f = torch.clamp(lam_f, -cfg.lambda_clamp,
                                    cfg.lambda_clamp)
        dp = dl[None] * nrm
        out_p.append(p - ws[None] * dp)
        out_l.append(lam_f)
        corr.append(_roll_lanes(wb[None] * dp, k))
    if not dx:
        return [p + c for p, c in zip(out_p, corr)], out_l
    # the partner of anchor plane i is plane i + 1; the last plane's partner
    # lives on the right neighbour
    spills = exchange([c[:, -1] for c in corr], devices, -1)
    return [torch.cat([p[:, :1] + sp[:, None], p[:, 1:] + c[:, :-1]], dim=1)
            for p, c, sp in zip(out_p, corr, spills)], out_l


def _tet_sweep(pred, w, lam_t, tvalid, tdeg, spec: LatticeSpec,
               cfg: SolverConfig, dt, devices):
    """The per-cell tet sweep on every slab (the JAX engine's
    ``_sharded_tet_sweep``): every Kuhn path offset has dx in {0, 1}, so
    one right-halo fetch of pred and w serves the 6 paths, and the
    gradient terms that land on the right neighbour's first plane collect
    in one spill plane pushed right once, after the paths (so a slab's
    first plane adds its left neighbour's terms last)."""
    res = spec.res
    paths = _lat._tet_fields(spec)[0]
    alpha, target, omega = _lat.tet_constants(spec, cfg, dt)
    halo_p = exchange([p[:, 0] for p in pred], devices, +1)
    halo_w = exchange([ws[0] for ws in w], devices, +1)
    accs, out_l = [], []
    for s, (p, ws) in enumerate(zip(pred, w)):
        planes = p.shape[1]
        p_x = torch.cat([p, halo_p[s][:, None]], dim=1)
        w_x = torch.cat([ws, halo_w[s][None]], dim=0)

        def fetch(a_x, off):
            return _roll_lanes(a_x[..., off[0]:off[0] + planes, :],
                               -(off[1] * res + off[2]))

        acc = torch.zeros((3, planes + 1, p.shape[2]), dtype=p.dtype,
                          device=p.device)
        lam_parts = []
        for pi, path in enumerate(paths):
            o1, o2, o3 = path[1], path[2], path[3]
            e1 = fetch(p_x, o1) - p
            e2 = fetch(p_x, o2) - p
            e3 = fetch(p_x, o3) - p
            g1 = _lat._cross3(e2, e3)
            g2 = _lat._cross3(e3, e1)
            g3 = _lat._cross3(e1, e2)
            g0 = -(g1 + g2 + g3)
            cerr = _lat._dot3(e1, g1) - target
            denom = (ws * _lat._dot3(g0, g0)
                     + fetch(w_x, o1) * _lat._dot3(g1, g1)
                     + fetch(w_x, o2) * _lat._dot3(g2, g2)
                     + fetch(w_x, o3) * _lat._dot3(g3, g3) + alpha)
            lam_f = lam_t[s][pi]
            dl = (-cerr - alpha * lam_f) / torch.clamp(denom, min=1e-30)
            active = tvalid[s] & (denom > cfg.eps_denominator)
            dl = torch.where(active, dl, 0.0) * omega
            lam_parts.append(lam_f + dl)
            dlb = dl[None]
            for g, off in ((g0, (0, 0, 0)), (g1, o1), (g2, o2), (g3, o3)):
                acc[:, off[0]:off[0] + planes] += _roll_lanes(
                    dlb * g, off[1] * res + off[2])
        accs.append(acc)
        out_l.append(torch.stack(lam_parts))
    spills = exchange([a[:, -1] for a in accs], devices, -1)
    out_p = []
    for p, ws, td, acc, sp in zip(pred, w, tdeg, accs, spills):
        delta = acc[:, :-1]
        delta[:, 0] += sp
        out_p.append(p + (ws / torch.clamp(td, min=1.0))[None] * delta)
    return out_p, out_l


def _flat(fn, pred, *args):
    """Apply an (M, 3) op of ``ops/`` to (3, P, r2) slab tensors."""
    shape = pred.shape
    flat = [a.reshape(3, -1).T if a.ndim == 3 else a.reshape(-1)
            for a in (pred, *args)]
    return tuple(o.T.reshape(shape) for o in fn(*flat))


class _Static:
    """Per-slab static fields: family masks and tet fields sliced from the
    global ones onto each slab's device."""

    def __init__(self, spec: LatticeSpec, cfg: SolverConfig, devices):
        res, nd = spec.res, len(devices)
        planes = res // nd
        glob = _lat._family_masks(spec)

        def sl(a, s, dev):
            return torch.as_tensor(
                a[s * planes:(s + 1) * planes], device=dev)

        self.valid = [[sl(v, s, d) for s, d in enumerate(devices)]
                      for v, _ in glob]
        self.par0 = [[sl(p, s, d) for s, d in enumerate(devices)]
                     for _, p in glob]
        if cfg.enable_tet_volume:
            _, tv, td, _ = _lat._tet_fields(spec)
            self.tvalid = [sl(tv, s, d) for s, d in enumerate(devices)]
            self.tdeg = [sl(td, s, d) for s, d in enumerate(devices)]


def _substep(x, v, w, w_halo, f, lam, lam_t, st: _Static, spec, cfg, dt,
             apply_ext, devices, worlds):
    """One substep of every slab.  x, v, f: per-slab (3, P, r2); w, w_halo:
    (P, r2); lam: (nfam, P, r2); lam_t: (6, P, r2) or None; worlds: each
    slab's ``ops/collision.RigidWorld``."""
    res = spec.res
    pred, vel = [], []
    for xs, vs, ws, fs in zip(x, v, w, f):
        p, vv = _flat(lambda *a: _integrate.predict(
            *a, dt, cfg, apply_ext=apply_ext), xs, vs, ws, fs)
        pred.append(p)
        vel.append(vv)
    if cfg.lambda_mode == LambdaMode.RESET:
        lam = [torch.zeros_like(lf) for lf in lam]
    else:
        lam = [lf * cfg.lambda_decay for lf in lam]
    if lam_t[0] is not None:
        # tets follow the general engine's lifecycle: fresh except in DECAY
        if cfg.lambda_mode == LambdaMode.DECAY:
            lam_t = [lt * cfg.lambda_decay for lt in lam_t]
        else:
            lam_t = [torch.zeros_like(lt) for lt in lam_t]

    def families(pred, lam, warm):
        lam = [list(lf) for lf in lam]
        for fi, fam in enumerate(spec.families):
            rest, comp = spec.rest_lengths[fi], spec.compliances[fi]
            cur = [lf[fi] for lf in lam]
            valid = st.valid[fi]
            if warm:
                passes = [(valid, None)]
            elif cfg.solve_mode == SolveMode.COLORED:
                passes = [([v & p for v, p in zip(valid, st.par0[fi])],
                           None),
                          ([v & ~p for v, p in zip(valid, st.par0[fi])],
                           None)]
            else:
                # intra-family conflict degree is 2, hence omega/2
                passes = [(valid, 0.5 * (cfg.omega if cfg.omega > 0
                                         else 1.0))]
            for masks, relax in passes:
                pred, cur = _family_pass(pred, w, w_halo, cur, fam, masks,
                                         rest, comp, dt, cfg, res, devices,
                                         relax=relax, warm=warm)
            for lf, c in zip(lam, cur):
                lf[fi] = c
        return pred, [torch.stack(lf) for lf in lam]

    if cfg.lambda_mode == LambdaMode.WARM_START:
        pred, lam = families(pred, lam, warm=True)
    for _ in range(cfg.iterations):
        pred, lam = families(pred, lam, warm=False)
        if cfg.enable_tet_volume:
            pred, lam_t = _tet_sweep(pred, w, lam_t, st.tvalid, st.tdeg,
                                     spec, cfg, dt, devices)
        for s, wd in enumerate(worlds):
            if cfg.floor_mode == FloorMode.XPBD_INEQUALITY:
                pred[s], = _flat(lambda *a: (wd.project_floor(*a, dt, cfg),),
                                 pred[s], x[s], w[s])
            if wd.n_spheres:
                pred[s], = _flat(lambda *a: (wd.project_spheres(
                    *a, dt, cfg),), pred[s], x[s], w[s])
            if wd.n_boxes:
                pred[s], = _flat(lambda *a: (wd.project_boxes(*a, dt, cfg),),
                                 pred[s], x[s], w[s])
    out_x, out_v = [], []
    for xs, p, ws, wd in zip(x, pred, w, worlds):
        xf, vf = _flat(lambda xa, pa, wa: _integrate.finalize(xa, pa, wa, dt),
                       xs, p, ws)
        if cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
            xf, vf = _flat(lambda *a: wd.reflect_floor(*a, dt, cfg), xf, vf,
                           ws)
        out_x.append(xf)
        out_v.append(vf)
    return out_x, out_v, lam, lam_t


def check_supported(cfg: SolverConfig, spec: LatticeSpec):
    """What the sharded engine refuses, at build time."""
    if cfg.enable_self_collision:
        raise NotImplementedError(
            "spatial port: self-collision is not carried by the sharded "
            "engine")


def check_tets(sharded: ShardedLatticeState, cfg: SolverConfig):
    """Refuse a tet config whose state has no tet multipliers."""
    if cfg.enable_tet_volume and sharded.slabs[0].lambda_tet is None:
        raise ValueError("enable_tet_volume needs a state built with "
                         "tet_volume=True (make_lattice_state)")


def run_sharded_plain(sharded: ShardedLatticeState, spec: LatticeSpec,
                      cfg: SolverConfig, dt_sub: float, n_substeps: int,
                      with_ext: bool = True) -> ShardedLatticeState:
    """``n_substeps`` substeps of the sharded engine on any devices;
    ``with_ext`` consumes ``ext_force`` on the first substep and zeroes
    it."""
    check_supported(cfg, spec)
    check_tets(sharded, cfg)
    devices = sharded.devices
    res, nfam = spec.res, spec.n_families
    r2 = res * res
    planes = res // len(devices)
    slabs = sharded.slabs
    x = [s.positions.reshape(3, planes, r2) for s in slabs]
    v = [s.velocities.reshape(3, planes, r2) for s in slabs]
    w = [s.inv_mass.reshape(planes, r2) for s in slabs]
    f = [s.ext_force.reshape(3, planes, r2) for s in slabs]
    lam = [s.lambda_dist.reshape(nfam, planes, r2) for s in slabs]
    lam_t = [None if s.lambda_tet is None
             else s.lambda_tet.reshape(6, planes, r2) for s in slabs]
    st = _Static(spec, cfg, devices)
    worlds = [_collision.RigidWorld.of(cfg, c, dev) for c, dev in zip(
        sharded.colliders or (None,) * len(devices), devices)]
    # the inverse-mass halo is static: fetched once
    w_first = exchange([ws[0] for ws in w], devices, +1)
    w_halo = [torch.cat([ws[1:], h[None]], dim=0)
              for ws, h in zip(w, w_first)]
    for i in range(n_substeps):
        x, v, lam, lam_t = _substep(x, v, w, w_halo, f, lam, lam_t, st,
                                    spec, cfg, dt_sub, with_ext and i == 0,
                                    devices, worlds)
    out = []
    for s, xs, vs, lf, lt in zip(slabs, x, v, lam, lam_t):
        out.append(s.replace(
            positions=xs.reshape(3, -1), velocities=vs.reshape(3, -1),
            lambda_dist=lf.reshape(nfam, -1),
            lambda_tet=None if lt is None else lt.reshape(6, -1),
            ext_force=(torch.zeros_like(s.ext_force) if with_ext
                       else s.ext_force)))
    return sharded.replace(slabs=tuple(out))


def stepper(spec: LatticeSpec, devices, run):
    """``SimState | ShardedLatticeState -> the same kind``: a ``SimState`` is
    split onto ``devices``, advanced by ``run`` and gathered back onto its
    own device; a sharded state stays on its slabs."""

    def step(state):
        if isinstance(state, ShardedLatticeState):
            if state.devices != tuple(devices):
                raise ValueError(
                    f"spatial: state slabs on "
                    f"{[str(d) for d in state.devices]}, step built for "
                    f"{[str(d) for d in devices]}")
            return run(state)
        out = run(shard_lattice_state(state, spec, devices))
        return gather_lattice_state(out, state.device)

    return step


def make_spatial_lattice_step(spec: LatticeSpec, cfg: SolverConfig,
                              dt: float, devices: Sequence,
                              n_steps: int = 1, backend: str = "auto",
                              kin_colliders=None):
    """A step advancing ``n_steps`` frames of ``cfg.substeps`` substeps of
    one lattice split into x-slabs over ``devices`` (one slab each),
    ``ext_force`` consumed on the first substep and zeroed after.  It takes
    a ``SimState`` (split, run, gathered back) or a
    ``ShardedLatticeState`` (the slabs stay resident) and returns the same
    kind.

    ``backend``: ``"auto"`` (default) launches the slab kernel B-6
    (``kernels/spatial_cuda.py``) for slabs on CUDA devices, and raises
    ``NotImplementedError`` outside its envelope; slabs on the CPU run this
    engine.  ``"xla"`` runs this engine on any device (tets, spheres, boxes
    and kinematic colliders on the card).  ``"pallas"`` names the kernel
    route, as the JAX package does.

    ``kin_colliders=(S, B)``: the state's ColliderSet (S spheres, B boxes)
    replaces the config's rigid world, replicated on every slab, so a
    collider sweeps across the slabs with nothing rebuilt; the state must
    carry one with those counts (checked at call time).  A step built
    without it refuses a state that carries colliders.  The slab kernel
    does not carry them (as in JAX): use ``backend="xla"``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    devs = slab_devices(devices, spec.res)
    check_supported(cfg, spec)
    kin = None if kin_colliders is None else tuple(
        int(k) for k in kin_colliders)
    if backend == "pallas" or (backend == "auto"
                               and devs[0].type == "cuda"):
        if kin is not None:
            raise NotImplementedError(
                "kinematic colliders on the slab kernel are not fused (as "
                "in the JAX package) -- use backend='xla' (same slabs, "
                "traced poses)")
        from ..kernels import spatial_cuda

        return spatial_cuda.make_spatial_cuda_substep(spec, cfg, dt, devs,
                                                      n_steps=n_steps)
    dt_sub = dt / cfg.substeps
    n_sub = n_steps * cfg.substeps

    def run(sh: ShardedLatticeState) -> ShardedLatticeState:
        check_kin(kin, sh.colliders and sh.colliders[0], "spatial step")
        return run_sharded_plain(sh, spec, cfg, dt_sub, n_sub,
                                 with_ext=True)

    return stepper(spec, devs, run)

