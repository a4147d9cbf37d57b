"""The hand-written CUDA lattice kernel (``csrc/lattice_xpbd.cu``) and its
runners.

Counterpart of ``softbodysimulation_tpu/kernels/lattice_pallas.py``:
``make_cuda_substep_runner`` stands for both ``make_pallas_substep_runner``
and ``make_pallas_substep_runner_streamed`` (one kernel covers both, the
resident kernel's joint g + ext ``max_force`` clamp included, and their
``approx_math`` variant), ``make_cuda_step`` for ``make_pallas_step``, and
``make_hybrid_contact_step`` / ``make_hybrid_contact_runner`` for their
namesakes (``:1720-1859``): a self-colliding config's contact-free
substeps as kernel launches between contact substeps of the plain
stencil engine (on the card, its blocked pass is TPU kernel B-4).
``route(cfg)`` says which of them a step built from ``cfg`` runs.

Every route runs a call (any number of substeps) as one launch of the
persistent kernel, its passes separated by barriers.  ``plan_schedule``
plans it from the shape alone: each block's tile of particles, the grid,
and the barrier -- ``__syncthreads()`` where a block holds whole bodies
(bodies of at most ``BLOCK_BODY_MAX`` particles), its tile held in
shared memory for the whole call (``tile_bytes``), else a grid-wide
``GRID_BARRIER`` in a cooperative launch sized to what the card holds at
once (``device_occupancy``), every plane in global memory.  The per-pass
loop the persistent kernel replaced (one launch a pass) stays in the
library as its yardstick:
``run_substeps_cuda(..., design="per_pass")``, which no route takes.

The rigid world reaches the kernel as a collider table
(``ops/collision.RigidWorld.table``, ``csrc/colliders.cuh``): the config's
ground, spheres and boxes, or, for a runner built with
``kin_colliders=(S, B)``, the state's ColliderSet, read by every launch,
so a new pose rebuilds nothing and syncs nothing; each launch takes its
collider counts from that world.

Device dispatch, with no fallback: a state on a CUDA device launches the
kernel (or raises: a refused cooperative launch, a grid that cannot be
co-resident, a failed build); a state on the CPU runs the kernel's plain
version, ``solvers.lattice.run_substeps_plain`` -- the only path a host
without a card can take.  The library is built with ``nvcc`` on the first
CUDA call (``kernels/_build.py``), never at import.

``launches`` counts the CUDA kernels this module has launched, and
``resident_launches`` those of them that held their tiles in shared
memory (the block kind; ``scripts/trace_lattice.py`` reports both);
callers may reset either to 0 to count one run.  ``diag.profiling`` names
the runner's spans and, inside ``profiling.counting()``, has it launch the
kernel's counted twin, which tallies its barriers' wait on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core.colliders import check_kin
from ..core.config import (DampingMode, FloorMode, LambdaMode, SolveMode,
                           SolverConfig)
from ..core.state import SimState, body_contract, check_bodies
from ..diag import profiling
from ..ops import collision as _collision
from ..solvers import lattice as _lat
from ..topology.lattice import LatticeSpec
from . import _build

LIB_NAME = "lattice_xpbd"
SOURCES = ("lattice_xpbd.cu",)
# no contracted multiply-adds: the tet sweep's sums and products round as
# the plain engine's separate torch ops do
NVCC_EXTRA = ("-fmad=false",)
MAX_FAM = 16
# rows of the collider table (csrc/lattice_xpbd.cuh LX_MAX_SPHERES, _BOXES)
MAX_SPHERES = 16
MAX_BOXES = 16

launches = 0   # CUDA kernels launched by this module (plain int)
resident_launches = 0   # of them, block-kind launches (tiles in shared memory)
TET_PLANES = 74   # csrc/lattice_xpbd.cuh's tet scratch planes
THREADS = 256     # csrc/lattice_xpbd.cu LX_THREADS: threads a block
SMEM_DEFAULT = 48 * 1024   # shared memory a block gets without opting in
# the persistent kernel's barriers (csrc/lattice_xpbd.cu LX_BLOCK,
# LX_GRID_CTR): __syncthreads() for a block of whole bodies; across
# blocks, a counting barrier on a global counter
BARRIERS = {"block": 0, "counter": 1}
# the grid barrier: the counter, which timed ahead of cooperative_groups'
# grid.sync() at every size measured (H100 80GB HBM3, 700 W: 0.0403 vs
# 0.0431 ms a substep at res 40, 0.0299 vs 0.0367 at res 16, 0.608 vs
# 0.853 at res 128; PERF.md), so grid.sync() was dropped
GRID_BARRIER = "counter"
# the largest body (particles) that a block holds whole and steps with
# __syncthreads() alone; larger bodies spread over the grid.  Phase 41's
# crossover (same card, ms a substep, block vs counter): 64-particle
# bodies 0.0254 vs 0.0436 (1,024 of them), 216 0.0328 vs 0.0457 (304) and
# 0.0236 vs 0.0299 (one); 512 0.0451 vs 0.0453 (128) but 0.0443 vs 0.0335
# (one); 1,000 and 1,728 the grid's by 1.8-4.1x.  So a block holds a
# body of up to one particle a thread.
BLOCK_BODY_MAX = THREADS


class LatticeParams(ctypes.Structure):
    """Mirror of ``struct LatticeParams`` in ``csrc/lattice_xpbd.cu`` (every
    field 4 bytes wide, same order)."""

    _fields_ = [
        ("res", ctypes.c_int), ("n", ctypes.c_int), ("nfam", ctypes.c_int),
        ("iterations", ctypes.c_int), ("colored", ctypes.c_int),
        ("lambda_mode", ctypes.c_int), ("fast_math", ctypes.c_int),
        ("gravity_acc", ctypes.c_int), ("floor_mode", ctypes.c_int),
        ("reference_bounds", ctypes.c_int), ("n_spheres", ctypes.c_int),
        ("n_boxes", ctypes.c_int),
        ("fam", (ctypes.c_int * 4) * MAX_FAM),
        ("dt", ctypes.c_float), ("gravity", ctypes.c_float * 3),
        ("max_force", ctypes.c_float), ("damp_factor", ctypes.c_float),
        ("max_velocity", ctypes.c_float), ("world_bounds", ctypes.c_float),
        ("lambda_decay", ctypes.c_float), ("warm_fraction", ctypes.c_float),
        ("relax", ctypes.c_float), ("max_dlambda", ctypes.c_float),
        ("lambda_clamp", ctypes.c_float), ("eps_length", ctypes.c_float),
        ("eps_denominator", ctypes.c_float), ("static_eps", ctypes.c_float),
        ("ground_height", ctypes.c_float), ("floor_alpha", ctypes.c_float),
        ("friction", ctypes.c_float), ("sphere_dt_fr", ctypes.c_float),
        ("box_dt_fr", ctypes.c_float), ("floor_offset", ctypes.c_float),
        ("restitution", ctypes.c_float),
        ("penetration_kick", ctypes.c_float),
        ("normal_force_scale", ctypes.c_float),
        ("floor_friction_coeff", ctypes.c_float),
        ("rest", ctypes.c_float * MAX_FAM),
        ("alpha", ctypes.c_float * MAX_FAM),
        ("dl_rel", ctypes.c_float * MAX_FAM),
        ("warm_lim", ctypes.c_float * MAX_FAM),
        ("tets", ctypes.c_int),
        ("tet_off", ((ctypes.c_int * 3) * 3) * 6),
        ("tet_alpha", ctypes.c_float), ("tet_target", ctypes.c_float),
        ("tet_omega", ctypes.c_float), ("body_n", ctypes.c_int),
        ("approx_math", ctypes.c_int),
    ]


_LAMBDA_MODE = {LambdaMode.RESET: 0, LambdaMode.DECAY: 1,
                LambdaMode.WARM_START: 2}
_FLOOR_MODE = {FloorMode.NONE: 0, FloorMode.XPBD_INEQUALITY: 1,
               FloorMode.VELOCITY_REFLECT: 2}


def _check_supported(cfg: SolverConfig, spec: LatticeSpec,
                     kin_colliders=None):
    """Build-time refusals: self-collision (as JAX's streamed runner
    refuses it: ``make_hybrid_contact_runner`` or the stencil engine run
    it) and the kernel's fixed table sizes."""
    if cfg.enable_self_collision:
        raise NotImplementedError(
            "lattice kernel: self-collision runs in the hybrid contact "
            "step / runner or the stencil engine, not in the kernel")
    if spec.n_families > MAX_FAM:
        raise NotImplementedError(
            f"lattice kernel: at most {MAX_FAM} offset families")
    n_sph, n_box = ((len(cfg.sphere_colliders), len(cfg.box_colliders))
                    if kin_colliders is None else kin_colliders)
    if n_sph > MAX_SPHERES or n_box > MAX_BOXES:
        raise NotImplementedError(
            f"lattice kernel: at most {MAX_SPHERES} sphere and {MAX_BOXES} "
            f"box colliders")


def make_params(spec: LatticeSpec, cfg: SolverConfig, dt: float,
                approx_math: bool = False) -> LatticeParams:
    """The kernel's constants, each rounded to float32 from the same double
    expression the plain engine (and the JAX engine) evaluates; the
    collider counts are a launch's (``run_substeps_cuda``)."""
    p = LatticeParams()
    p.approx_math = int(approx_math)
    p.res = spec.res
    p.n = p.body_n = spec.n_particles
    p.nfam = spec.n_families
    p.iterations = cfg.iterations
    p.colored = int(cfg.solve_mode == SolveMode.COLORED)
    p.lambda_mode = _LAMBDA_MODE[cfg.lambda_mode]
    p.fast_math = int(cfg.fast_math)
    p.gravity_acc = int(cfg.gravity_is_acceleration)
    p.floor_mode = _FLOOR_MODE[cfg.floor_mode]
    p.reference_bounds = int(spec.reference_bounds)
    p.dt = dt
    p.gravity[:] = cfg.gravity
    p.max_force = cfg.max_force
    if cfg.damping_mode == DampingMode.PER_STEP:
        p.damp_factor = 1.0 - min(max(cfg.damping, 0.0), 1.0)
    else:
        p.damp_factor = 1.0 - cfg.damping * dt
    p.max_velocity = cfg.max_velocity
    p.world_bounds = cfg.world_bounds
    p.lambda_decay = cfg.lambda_decay
    p.warm_fraction = cfg.warm_start_fraction
    p.relax = 0.5 * (cfg.omega if cfg.omega > 0 else 1.0)
    p.max_dlambda = cfg.max_dlambda
    p.lambda_clamp = cfg.lambda_clamp
    p.eps_length = cfg.eps_length
    p.eps_denominator = cfg.eps_denominator
    p.static_eps = cfg.static_inv_mass_eps
    p.ground_height = cfg.ground_height
    p.floor_alpha = cfg.collision_compliance / (dt * dt)
    fr = min(max(cfg.friction, 0.0), 1.0)
    p.friction = fr
    p.sphere_dt_fr = dt * fr
    p.box_dt_fr = _collision.friction_step(cfg, dt)
    p.floor_offset = cfg.floor_offset
    p.restitution = cfg.restitution
    p.penetration_kick = cfg.penetration_kick
    p.normal_force_scale = cfg.normal_force_scale
    p.floor_friction_coeff = cfg.floor_friction_coeff
    for fi, fam in enumerate(spec.families):
        p.fam[fi][:] = fam
        rest = spec.rest_lengths[fi]
        alpha = spec.compliances[fi] / (dt * dt)
        if cfg.min_alpha_tilde > 0:
            alpha = max(alpha, cfg.min_alpha_tilde)
        p.rest[fi] = rest
        p.alpha[fi] = alpha
        p.dl_rel[fi] = (cfg.max_dlambda_rel * rest
                        if cfg.max_dlambda_rel > 0 else 0.0)
        p.warm_lim[fi] = (cfg.warm_start_clamp * rest
                          if cfg.warm_start_clamp > 0 else 0.0)
    p.tets = int(cfg.enable_tet_volume)
    for pi, path in enumerate(_lat._tet_fields(spec)[0]):
        for k, off in enumerate(path[1:]):
            p.tet_off[pi][k][:] = off
    p.tet_alpha, p.tet_target, p.tet_omega = _lat.tet_constants(spec, cfg,
                                                                dt)
    return p


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One call of the persistent kernel: block ``j`` owns the particles
    ``[j * chunk, min((j + 1) * chunk, n))`` (its tile) for the whole call,
    each of its ``THREADS`` threads those at a stride of ``THREADS``;
    ``barrier`` separates the passes (a key of ``BARRIERS``).  The block
    kind holds its tile in shared memory (``tile_bytes``); the grid kind
    reads a tile and its halo from global memory."""

    barrier: str
    grid: int
    chunk: int
    n: int
    body_n: int

    @property
    def kind(self) -> str:
        """``"block"`` (whole bodies a block) or ``"grid"`` (one body
        across blocks, a cooperative launch)."""
        return "block" if self.barrier == "block" else "grid"

    def tiles(self):
        """Each block's particles, ``(lo, hi)`` (empty where ``lo >= n``)."""
        return [(min(j * self.chunk, self.n),
                 min((j + 1) * self.chunk, self.n))
                for j in range(self.grid)]


def tile_bytes(sched: Schedule, nfam: int) -> int:
    """Shared memory a block of ``sched`` holds its tile in for the whole
    call (``csrc/lattice_xpbd.cu`` ``tile_floats``): for the block kind the
    iterate's two buffers (3 planes each), the inverse masses and the
    distance multipliers' two buffers (``nfam`` planes each), ``chunk``
    floats a plane; none for the grid kind."""
    if sched.kind != "block":
        return 0
    return 4 * sched.chunk * (6 + 1 + 2 * nfam)


def choose_barrier(spec: LatticeSpec) -> str:
    """The barrier a body of ``spec`` gets, from its size alone:
    ``"block"`` up to ``BLOCK_BODY_MAX`` particles, else ``GRID_BARRIER``."""
    return "block" if spec.n_particles <= BLOCK_BODY_MAX else GRID_BARRIER


def plan_schedule(spec: LatticeSpec, n_bodies: int, n_sms: int,
                  blocks_per_sm: int, barrier=None, grid=None) -> Schedule:
    """The persistent kernel's tiles, barrier and grid for ``n_bodies``
    bodies of ``spec`` on a card of ``n_sms`` SMs that holds
    ``blocks_per_sm`` of the kernel's blocks on each at once
    (``device_occupancy``).  ``barrier`` (default ``choose_barrier``) and
    ``grid`` (default the planner's) are for tests and timing.

    ``"block"``: a block holds whole bodies, as many as fill its threads
    but no more than spread the bodies over every SM; no co-residency is
    needed.  A grid barrier: one block for every ``THREADS`` particles, at
    most ``n_sms * blocks_per_sm``, a tile of whole warps each (so the
    grid may come out a little smaller than asked); a grid
    larger than the card holds at once raises ``ValueError`` (its barrier
    would never open)."""
    body_n = spec.n_particles
    n = body_n * n_bodies
    if n_bodies < 1:
        raise ValueError(f"lattice kernel: {n_bodies} bodies")
    barrier = choose_barrier(spec) if barrier is None else barrier
    if barrier not in BARRIERS:
        raise ValueError(f"lattice kernel: no barrier {barrier!r}")
    if barrier == "block":
        per = (max(1, min(THREADS // body_n, -(-n_bodies // n_sms)))
               if grid is None else -(-n_bodies // grid))
        return Schedule(barrier, -(-n_bodies // per), per * body_n, n,
                        body_n)
    cap = n_sms * blocks_per_sm
    g = min(-(-n // THREADS), cap) if grid is None else grid
    if g < 1 or g > cap:
        raise ValueError(
            f"lattice kernel: a grid of {g} blocks cannot be co-resident on "
            f"{n_sms} SMs x {blocks_per_sm} blocks (the {barrier} barrier "
            f"needs every block resident)")
    chunk = -(-(-(-n // g)) // 32) * 32   # whole warps
    return Schedule(barrier, -(-n // chunk), chunk, n, body_n)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's types."""
    lib = _build.load_library(LIB_NAME, SOURCES, NVCC_EXTRA)
    lib.lattice_xpbd_params_size.argtypes = []
    lib.lattice_xpbd_params_size.restype = ctypes.c_int
    lib.lattice_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.lattice_xpbd_error_string.restype = ctypes.c_char_p
    vp = ctypes.c_void_p
    ci, cip = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    state_args = [ctypes.POINTER(LatticeParams), ci, vp, vp, vp, vp, ci,
                  vp, vp, vp, vp, vp, vp, vp, ci]
    lib.lattice_xpbd_run.argtypes = state_args + [
        ci, ci, ci, vp, vp, ctypes.POINTER(ctypes.c_longlong), vp]
    lib.lattice_xpbd_run.restype = ci
    lib.lattice_xpbd_run_per_pass.argtypes = state_args + [
        ctypes.POINTER(ctypes.c_longlong), vp]
    lib.lattice_xpbd_run_per_pass.restype = ci
    lib.lattice_xpbd_occupancy.argtypes = [ci, ci, cip, cip, cip, cip]
    lib.lattice_xpbd_occupancy.restype = ci
    lib.lattice_xpbd_tile_floats.argtypes = [ci, ci]
    lib.lattice_xpbd_tile_floats.restype = ci
    lib.lattice_xpbd_last_error.argtypes = []
    lib.lattice_xpbd_last_error.restype = ci
    lib.lattice_xpbd_approx_probe.argtypes = [vp, vp, ctypes.c_int, vp]
    lib.lattice_xpbd_approx_probe.restype = ctypes.c_int
    if lib.lattice_xpbd_params_size() != ctypes.sizeof(LatticeParams):
        raise RuntimeError("LatticeParams layout differs between "
                           "lattice_cuda.py and lattice_xpbd.cu")
    if 4 * lib.lattice_xpbd_tile_floats(THREADS, 13) != tile_bytes(
            Schedule("block", 1, THREADS, THREADS, 64), 13):
        raise RuntimeError("a block tile's size differs between "
                           "lattice_cuda.py and lattice_xpbd.cu")
    return lib


@functools.lru_cache(maxsize=None)
def device_occupancy(index: int, barrier: str):
    """(SMs, blocks of the persistent kernel one SM holds at once) for the
    kernel of ``barrier`` on CUDA device ``index``; raises where a grid
    barrier has no cooperative launch."""
    lib = _library()
    threads, per_sm, sms, coop = (ctypes.c_int() for _ in range(4))
    rc = lib.lattice_xpbd_occupancy(index, BARRIERS[barrier],
                                    ctypes.byref(threads),
                                    ctypes.byref(per_sm), ctypes.byref(sms),
                                    ctypes.byref(coop))
    if rc != 0:
        msg = lib.lattice_xpbd_error_string(rc).decode()
        raise RuntimeError(f"lattice kernel occupancy failed: {msg} ({rc})")
    if threads.value != THREADS:
        raise RuntimeError(f"lattice kernel: {threads.value} threads a "
                           f"block in the library, {THREADS} here")
    if barrier != "block" and not coop.value:
        raise RuntimeError(f"lattice kernel: device {index} has no "
                           f"cooperative launch for the {barrier} barrier")
    return sms.value, per_sm.value


def schedule_for(spec: LatticeSpec, n_bodies: int, device: torch.device,
                 barrier=None) -> Schedule:
    """``plan_schedule`` with the occupancy of ``device``."""
    barrier = choose_barrier(spec) if barrier is None else barrier
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms, per_sm = device_occupancy(index, barrier)
    return plan_schedule(spec, n_bodies, sms, per_sm, barrier=barrier)


def approx_probe(x: torch.Tensor):
    """(rsqrtf(x), the approximate reciprocal of x) as the ``approx_math``
    kernel computes them, for float32 ``x`` on the card: a diagnostic off
    every path (its launch is not counted), to hold the intrinsics against
    ``torch.rsqrt`` and ``torch.reciprocal``."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("approx_probe takes a float32 CUDA tensor")
    x = x.contiguous().reshape(-1)
    out = torch.empty(2 * x.numel(), dtype=torch.float32, device=x.device)
    rc = _library().lattice_xpbd_approx_probe(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        x.numel(), ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"approx probe launch failed ({rc})")
    return out[:x.numel()], out[x.numel():]


def _ptr(name: str, t: torch.Tensor, shape, device) -> ctypes.c_void_p:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"lattice kernel: {name} must be float32 on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lattice kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lattice kernel: {name} must be contiguous")
    return ctypes.c_void_p(t.data_ptr())


def _planes(t: torch.Tensor, b: int) -> torch.Tensor:
    """(B, N, 3) body leaves -> a fresh (3, B*N) structure of arrays, body
    after body in each plane."""
    return t.reshape(b, -1, 3).permute(2, 0, 1).reshape(3, -1).contiguous()


def _unplanes(a: torch.Tensor, b: int) -> torch.Tensor:
    return a.view(3, b, -1).permute(1, 2, 0).contiguous()


def _rows(t: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """(B, k*N) multipliers -> a fresh (k, B*N) buffer: family f's plane
    holds every body's multipliers of f, body after body."""
    out = torch.empty((k, t.numel() // k), dtype=t.dtype, device=t.device)
    out.view(k, b, -1).copy_(t.reshape(b, k, -1).permute(1, 0, 2))
    return out


def _unrows(a: torch.Tensor, k: int, b: int) -> torch.Tensor:
    return a.view(k, b, -1).permute(1, 0, 2).reshape(b, -1)


def _check_leaves(state: SimState, spec: LatticeSpec, b, batched: bool):
    """Refuse state leaves whose shapes are not the runner's contract:
    one body's ``(N, 3)`` leaves, or, ``batched``, ``(B, N, 3)`` with a
    shared ``(N,)`` or a per-body ``(B, N)`` ``inv_mass``."""
    n, lead = spec.n_particles, ((b,) if batched else ())
    want = {"positions": lead + (n, 3), "velocities": lead + (n, 3),
            "ext_force": lead + (n, 3),
            "lambda_dist": lead + (spec.n_families * n,)}
    if state.lambda_tet is not None:
        want["lambda_tet"] = lead + (6 * n,)
    for k, shape in want.items():
        if tuple(getattr(state, k).shape) != shape:
            raise ValueError(f"lattice kernel: {k} has shape "
                             f"{tuple(getattr(state, k).shape)}, expected "
                             f"{shape}")
    if tuple(state.inv_mass.shape) not in {(n,), lead + (n,)}:
        raise ValueError(f"lattice kernel: inv_mass has shape "
                         f"{tuple(state.inv_mass.shape)}, expected ({n},) "
                         f"or {lead + (n,)}")


def run_substeps_cuda(state: SimState, spec: LatticeSpec, cfg: SolverConfig,
                      dt_sub: float, n_substeps: int,
                      with_ext: bool = False,
                      batched: bool = False,
                      approx_math: bool = False, *,
                      design: str = "persistent",
                      schedule=None) -> SimState:
    """Launch the kernel for ``n_substeps`` substeps of a CUDA state; the
    semantics of ``solvers.lattice.run_substeps_plain`` (``batched``: of
    ``run_substeps_plain_batched``, all bodies in one launch; ``approx_math``
    as there), the state's ColliderSet (if any) replacing the config's
    rigid world.  One launch of the persistent kernel (``schedule_for``);
    inside ``diag.profiling.counting()``, of its counted twin.  A
    block-kind tile beyond the shared memory a block of the card holds
    (``tile_bytes``) raises ``ValueError`` before any launch.
    ``design="per_pass"`` runs the yardstick, one launch a pass, and
    ``schedule`` (a ``Schedule`` for this shape) another plan than the
    shape's: for the card tests and ``chip_smoke.py``'s timing, never a
    route.  No host sync.  Under a profiler the call is the span
    ``sbs.lattice.call``, its phases ``sbs.lattice.layout`` (leaves to
    planes, scratch, the rigid world), ``sbs.lattice.launch`` (the
    constants, the schedule, the launch) and ``sbs.lattice.unlayout``
    (planes to leaves)."""
    with profiling.span("lattice.call"):
        return _run_substeps_cuda(state, spec, cfg, dt_sub, n_substeps,
                                  with_ext, batched, approx_math, design,
                                  schedule)


def _run_substeps_cuda(state, spec, cfg, dt_sub, n_substeps, with_ext,
                       batched, approx_math, design, schedule):
    global launches, resident_launches
    _lat.check_state(state, cfg)
    dev = state.device
    with profiling.span("lattice.layout"):
        world = _collision.RigidWorld.of(cfg, state.colliders, dev)
        rows = (world.n_spheres, world.n_boxes)
        _check_supported(cfg, spec, kin_colliders=rows)
        if dev.type != "cuda":
            raise ValueError(f"lattice kernel: state on {dev}, not CUDA")
        b = state.positions.shape[0] if batched else 1
        _check_leaves(state, spec, b, batched)
        n1, nfam = spec.n_particles, spec.n_families
        n = b * n1
        # body leaves -> (3, B*N) planes and (k, B*N) multiplier planes,
        # once per call (as _to_grid); the kernel updates them in place
        x = _planes(state.positions, b)
        v = _planes(state.velocities, b)
        w = state.inv_mass.expand(b, n1).reshape(n).contiguous()
        f = _planes(state.ext_force, b)
        lam = _rows(state.lambda_dist, nfam, b)
        lam_scratch = torch.empty_like(lam)
        pred_a = torch.empty((3, n), dtype=torch.float32, device=dev)
        pred_b = torch.empty_like(pred_a)
        lam_t = None
        lam_t_ptr = terms_ptr = ctypes.c_void_p(None)
        if state.lambda_tet is not None:
            lam_t = _rows(state.lambda_tet, 6, b)
            lam_t_ptr = _ptr("lambda_tet", lam_t, (6, n), dev)
        if cfg.enable_tet_volume:
            # the tet sweep's per-path endpoint terms (72 planes) and its
            # tet degree and valid-cell planes (csrc/lattice_xpbd.cu
            # TET_PLANES)
            tet_terms = torch.empty((TET_PLANES, n), dtype=torch.float32,
                                    device=dev)
            terms_ptr = ctypes.c_void_p(tet_terms.data_ptr())
        args = [_ptr("positions", x, (3, n), dev),
                _ptr("velocities", v, (3, n), dev),
                _ptr("inv_mass", w, (n,), dev),
                _ptr("ext_force", f, (3, n), dev),
                ctypes.c_int(int(with_ext)),
                _ptr("lambda_dist", lam, (nfam, n), dev),
                _ptr("lambda scratch", lam_scratch, (nfam, n), dev),
                _ptr("pred", pred_a, (3, n), dev),
                _ptr("pred", pred_b, (3, n), dev), lam_t_ptr, terms_ptr,
                _ptr("colliders", world.table, (1 + sum(rows),
                                                 _collision.KIN_W), dev)]
    with profiling.span("lattice.launch"):
        params = make_params(spec, cfg, dt_sub, approx_math)
        params.n = n
        params.n_spheres, params.n_boxes = rows
        lib = _library()
        count = ctypes.c_longlong(0)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if design == "per_pass":
            rc = lib.lattice_xpbd_run_per_pass(ctypes.byref(params),
                                               dev.index, *args, n_substeps,
                                               ctypes.byref(count), stream)
        elif design == "persistent":
            sched = schedule or schedule_for(spec, b, dev)
            if (sched.n, sched.body_n) != (n, n1):
                raise ValueError("lattice kernel: the schedule is for "
                                 "another shape")
            # the counting barrier's word, zeroed by the library before
            # launch
            counter = torch.empty(1, dtype=torch.int64, device=dev)
            totals = (profiling.totals(dev, sched.grid * THREADS // 32)
                      if profiling.counting_open() and n_substeps > 0
                      else None)
            rc = lib.lattice_xpbd_run(
                ctypes.byref(params), dev.index, *args, n_substeps,
                BARRIERS[sched.barrier], sched.grid, sched.chunk,
                ctypes.c_void_p(counter.data_ptr()),
                ctypes.c_void_p(None if totals is None
                                else totals.data_ptr()),
                ctypes.byref(count), stream)
        else:
            raise ValueError(f"lattice kernel: no design {design!r}")
    launches += count.value
    if design == "persistent" and sched.kind == "block":
        resident_launches += count.value
    if rc != 0:
        msg = lib.lattice_xpbd_error_string(rc).decode()
        need = tile_bytes(sched, nfam) if design == "persistent" else 0
        if need > SMEM_DEFAULT and count.value == 0:
            # the library's raise of the kernel's shared-memory limit was
            # refused: the tile does not fit a block of this card
            raise ValueError(
                f"lattice kernel: a block tile of {sched.chunk} particles "
                f"needs {need} bytes of shared memory, more than a block "
                f"of {dev} holds: {msg} ({rc})")
        raise RuntimeError(f"lattice kernel launch failed: {msg} ({rc})")

    def body(t):
        return t if batched else t[0]

    with profiling.span("lattice.unlayout"):
        out = state.replace(
            positions=body(_unplanes(x, b)),
            velocities=body(_unplanes(v, b)),
            lambda_dist=body(_unrows(lam, nfam, b)),
            lambda_tet=None if lam_t is None else body(_unrows(lam_t, 6,
                                                                b)))
        if with_ext:
            out = out.replace(ext_force=torch.zeros_like(state.ext_force))
    return out


def advance(state: SimState, spec: LatticeSpec, cfg: SolverConfig,
            dt_sub: float, n_substeps: int, with_ext: bool,
            batched: bool = False, approx_math: bool = False) -> SimState:
    """A CUDA state launches the kernel; a CPU state runs the plain engine
    (``batched``: the lane-folded ensemble engine; ``approx_math``: its
    twin); any other device raises."""
    if state.device.type == "cuda":
        return run_substeps_cuda(state, spec, cfg, dt_sub, n_substeps,
                                 with_ext, batched, approx_math)
    if state.device.type == "cpu":
        plain = (_lat.run_substeps_plain_batched if batched
                 else _lat.run_substeps_plain)
        return plain(state, spec, cfg, dt_sub, n_substeps, with_ext,
                     approx_math)
    raise NotImplementedError(
        f"lattice kernel: no path for a state on {state.device}")


def make_cuda_substep_runner(spec: LatticeSpec, cfg: SolverConfig,
                             dt_sub: float, n_substeps: int,
                             with_ext: bool = False,
                             approx_math: bool = False, n_bodies: int = 1,
                             kin_colliders=None, batched=None):
    """``SimState -> SimState`` advancing ``n_substeps`` raw substeps.
    ``with_ext=False``: external forces are neither applied nor cleared
    (rollout semantics); ``with_ext=True``: ``state.ext_force`` is consumed
    on the first substep and zeroed.  ``kin_colliders=(S, B)``: the state's
    ColliderSet of S spheres and B boxes replaces the config's rigid world,
    its poses read by every launch (checked at call time: ``check_kin``; a
    runner built without it refuses a state carrying colliders).

    ``n_bodies > 1`` (or ``batched=True``, ``body_contract``): the
    ensemble of ``make_pallas_substep_runner_streamed(..., n_bodies=B)``,
    a state of batched leaves -- positions, velocities and ext_force
    ``(B, N, 3)``, lambda_dist ``(B, nfam*N)``, lambda_tet ``(B, 6N)``,
    inv_mass ``(B, N)`` or a shared ``(N,)`` -- whose bodies advance in one
    launch a call on a CUDA state (the lane-folded plain engine on a CPU
    state), one shared ColliderSet acting on every body.

    ``approx_math``: the variant ``bench.py`` runs first
    (``csrc/lattice_xpbd.cu``: rsqrtf and the approximate reciprocal in the
    family passes and the tet sweep; on a CPU state the plain twin,
    ``run_substeps_plain(..., approx_math=True)``), single body or
    ensemble.  Self-collision raises ``NotImplementedError`` here, at build
    time, as JAX's streamed runner does."""
    kin = None if kin_colliders is None else tuple(
        int(k) for k in kin_colliders)
    batched = body_contract(n_bodies, batched)
    _check_supported(cfg, spec, kin_colliders=kin)

    def fn(state: SimState) -> SimState:
        check_kin(kin, state.colliders, "lattice runner")
        if batched:
            check_bodies(state, n_bodies, "lattice runner")
        return advance(state, spec, cfg, dt_sub, n_substeps, with_ext,
                       batched, approx_math)

    return fn


def route(cfg: SolverConfig) -> str:
    """The route a lattice step or substep runner built from ``cfg`` takes
    (``make_pallas_step``'s rule, ``lattice_pallas.py:484-487``):
    ``"kernel"`` without self-collision; ``"hybrid"`` (the hybrid contact
    step / runner) for a contact cadence ``self_collision_every >= 2`` that
    divides the frame; ``"plain"`` (the stencil engine alone, on the
    state's device, as JAX runs it) for any other self-colliding config.
    Read from the config when the step is built; on a CPU state every
    kernel of a route runs its plain version."""
    if not cfg.enable_self_collision:
        return "kernel"
    every = cfg.self_collision_every
    if every >= 2 and cfg.substeps % every == 0:
        return "hybrid"
    return "plain"


def make_cuda_step(spec: LatticeSpec, cfg: SolverConfig, dt: float,
                   n_steps: int = 1, kin_colliders=None, n_bodies: int = 1,
                   batched=None):
    """Full step semantics: ``n_steps`` frames of ``cfg.substeps`` substeps,
    ``state.ext_force`` consumed on the first substep and zeroed after
    (drop-in for ``solvers.lattice.make_step``; with ``n_bodies``, for
    ``make_batched_step``); ``kin_colliders``, ``n_bodies`` and
    ``batched`` as in ``make_cuda_substep_runner``.  Routed as
    ``make_pallas_step`` routes (``route``): a single body's ``"hybrid"``
    config goes to ``make_hybrid_contact_step``; any other self-colliding
    config is refused, as by the kernel's runner."""
    if route(cfg) == "hybrid" and not body_contract(n_bodies, batched):
        return make_hybrid_contact_step(spec, cfg, dt, n_steps,
                                        kin_colliders=kin_colliders)
    return make_cuda_substep_runner(spec, cfg, dt / cfg.substeps,
                                    n_steps * cfg.substeps, with_ext=True,
                                    kin_colliders=kin_colliders,
                                    n_bodies=n_bodies, batched=batched)


def _contact_substep(state: SimState, spec: LatticeSpec, cfg: SolverConfig,
                     dt_sub: float, with_ext: bool) -> SimState:
    """One contact substep of the plain stencil engine on the state's
    device (self-collision on; ``ext_force`` applied when ``with_ext``),
    ``ext_force`` zeroed after it, as JAX's ``_from_grid`` zeroes it."""
    out = _lat.run_substeps_plain(state, spec, cfg, dt_sub, 1, with_ext)
    return out.replace(ext_force=torch.zeros_like(state.ext_force))


def _hybrid_checks(cfg: SolverConfig, what: str):
    if not cfg.enable_self_collision or cfg.self_collision_every < 2:
        raise ValueError(f"hybrid contact {what} needs enable_self_collision "
                         f"and self_collision_every >= 2")


def make_hybrid_contact_step(spec: LatticeSpec, cfg: SolverConfig,
                             dt: float, n_steps: int = 1,
                             kin_colliders=None):
    """Step-semantics twin of ``make_hybrid_contact_runner``
    (``lattice_pallas.make_hybrid_contact_step``, ``:1720-1787``):
    ``n_steps`` frames of ``cfg.substeps`` substeps, contact on substeps
    ``j % every == 0`` within each frame, ``state.ext_force`` consumed on
    the first substep of the first frame and zeroed after.  A frame is
    ``substeps // every`` groups of [a contact substep of the plain
    stencil engine; the ``every - 1`` contact-free substeps as one kernel
    launch]; ``kin_colliders=(S, B)``: the state's ColliderSet
    on both halves.  ``ValueError`` without self-collision or with
    ``every < 2``; ``NotImplementedError`` where ``every`` does not divide
    the frame (the stencil engine runs that, ``route``)."""
    _hybrid_checks(cfg, "step")
    every = cfg.self_collision_every
    if cfg.substeps % every != 0:
        raise NotImplementedError(
            "hybrid contact step needs substeps % self_collision_every == 0 "
            "(the stencil engine runs the other cadences)")
    dt_sub = dt / cfg.substeps
    inner = make_cuda_substep_runner(
        spec, cfg.replace(enable_self_collision=False), dt_sub, every - 1,
        kin_colliders=kin_colliders)
    groups = cfg.substeps // every

    def fn(state: SimState) -> SimState:
        for frame in range(n_steps):
            for g in range(groups):
                state = _contact_substep(state, spec, cfg, dt_sub,
                                         frame == 0 and g == 0)
                state = inner(state)
        return state

    fn.route = "hybrid"
    return fn


def make_hybrid_contact_runner(spec: LatticeSpec, cfg: SolverConfig,
                               dt_sub: float, n_substeps: int,
                               approx_math: bool = False,
                               kin_colliders=None):
    """Contact cadence with the kernel
    (``lattice_pallas.make_hybrid_contact_runner``, ``:1790-1859``): the
    semantics of ``solvers.lattice.run_substeps_plain`` with contact on
    substeps ``i % every == 0`` of ``n_substeps`` raw substeps.  Each full
    cadence group is a contact substep of the plain stencil engine (on the
    card its blocked backend is B-4) followed by the ``every - 1``
    contact-free substeps as one kernel launch (``approx_math``
    and ``kin_colliders`` there, as in JAX); a tail of ``t < every``
    substeps is a contact substep and ``t - 1`` contact-free stencil
    substeps.  ``ext_force`` is not applied, and a contact substep zeroes
    it, as JAX's does.  ``ValueError`` without self-collision or with
    ``every < 2``."""
    _hybrid_checks(cfg, "runner")
    every = cfg.self_collision_every
    cfg_free = cfg.replace(enable_self_collision=False)
    inner = make_cuda_substep_runner(spec, cfg_free, dt_sub, every - 1,
                                     approx_math=approx_math,
                                     kin_colliders=kin_colliders)
    n_full, tail = divmod(n_substeps, every)

    def fn(state: SimState) -> SimState:
        for _ in range(n_full):
            state = inner(_contact_substep(state, spec, cfg, dt_sub, False))
        if tail:
            state = _contact_substep(state, spec, cfg, dt_sub, False)
            state = _lat.run_substeps_plain(state, spec, cfg_free, dt_sub,
                                            tail - 1)
        return state

    fn.route = "hybrid"
    return fn
