"""The hand-written CUDA mesh kernel (``csrc/mesh_xpbd.cu``) and its
runners.

Counterpart of ``softbodysimulation_tpu/kernels/mesh_pallas.py``
(``_check_supported``, ``make_mesh_substep_runner``,
``make_mesh_pallas_step``, ``make_mesh_hybrid_contact_step``) for the
distance, dihedral-bending and per-tet volume families with floor, sphere,
box and self-collision contacts: ``make_mesh_cuda_substep_runner``,
``make_mesh_cuda_step`` and ``make_mesh_hybrid_contact_step``.  The TPU
kernel's one-hot block plans have no counterpart: the CUDA kernel gathers
by index, so any topology runs (a windowed one is not needed).

Self-collision runs inside the library's substep loop: the dense backend
as the kernel's all-pairs pass, ``blocked`` and ``blocked_pallas`` (one
semantics) as TPU kernel B-4's pass (``csrc/contact_xpbd.cu``, linked into
this library; its launches count in ``kernels.contact_cuda.launches``).
The ``hash`` and ``sorted`` backends run in the plain engine on the
state's device (``route``): at a cadence that divides the frame,
``make_mesh_hybrid_contact_step`` runs their contact substeps there and
the contact-free ones in the library, as the JAX hybrid step does; the
library itself refuses them on a CUDA state (``check_cuda``), as JAX's
mesh kernel does.

The global volume constraint (``enable_volume``, ``ops/volume.py``) runs
in the library after the tets and before the contacts of every iteration
(``csrc/mesh_xpbd.cu``: a triangle pass, a particle pass, one reduction
block a body, the apply), with one multiplier a body: ``lambda_volume``
is ``()`` for one body and ``(B,)`` for an ensemble, where a shared
scalar raises ``ValueError`` (``general.check_volume_leaf``), as JAX's
kernel does.  ``tet_backend="windowed"`` runs the gather sweep, and
without tet windows raises where JAX's engine does
(``general.check_tet_windows``).

``approx_math`` (``mesh_pallas.py:810-811``) takes the distance
projections' lengths and directions and the bending normals through
rsqrt (``csrc/mesh_xpbd.cu``); the plain twin is ``solvers.general
.run_substeps_plain(..., approx_math=True)``.  The volume stays exact, as
in JAX's kernel.  The TPU kernel's switch to bf16-truncated one-hot
products under ``approx_math`` (``mesh_pallas.py:874-876``) is an artifact
of its matrix unit and is not carried.

Every route runs a call as one launch of the persistent kernel, its
passes separated by barriers, or, with blocked contact, one launch a
stretch between two B-4 passes (the curve order and each correction run
between launches).  ``plan_schedule`` plans it from the shape alone
(``tile_counts``): each block's tiles of particles, edges, hinges, tets,
triangles, colour slots and dense rows, the grid, and the barrier --
``__syncthreads()`` where a block holds whole bodies (no kind of item
above ``BLOCK_BODY_MAX`` a body), else the counting grid barrier in a
cooperative launch sized to what the card holds at once
(``device_occupancy``).  A particle's incidence row longer than
``ops/incidence.HUB_WIDTH`` is summed by a warp (``hub_rows`` lists them,
once per device), in column order, so the sums keep their bits.  The
per-pass loop the persistent kernel replaced (one launch a pass) stays as
its yardstick: ``run_substeps_cuda(..., design="per_pass")``, which no
route takes.

Device dispatch, with no fallback: a state on a CUDA device launches the
kernel (or raises: a refused cooperative launch, a grid that cannot be
co-resident, a failed build); a state on the CPU runs the kernel's plain
version, ``solvers.general.run_substeps_plain``; any other device raises.
The library is built with ``nvcc`` on the first CUDA call
(``kernels/_build.py``), never at import; the topology's tables and the
per-constraint constants go to the card once per runner configuration and
device, on the first call there.

A runner's ``fn(state, materials=None)`` takes traced materials,
``{"rest_lengths": (E,), "compliance": (E,)}`` tensors on the state's
device (``mesh_pallas.py:833-841, 1844-1898`` of the JAX package): the
per-edge rest lengths and alpha (compliance / dt^2 floored at
``min_alpha_tilde``) are built from them on the device per call, with no
host round trip, and the ``max_dlambda_rel`` bound and the warm-start clamp
follow them in the kernel; the topology's own values give the static path
to the bit.

The rigid world reaches the kernel as a collider table
(``ops/collision.RigidWorld.table``, ``csrc/colliders.cuh``): the config's
ground, spheres and boxes, or, for a runner built with
``kin_colliders=(S, B)``, the state's ColliderSet (poses, velocities and
ground), read by every launch; each launch takes its collider counts from
that world (``launch_params``).

``launches`` counts the CUDA kernels this module has launched (the B-4
pass's aside); callers may reset it to 0 to count one run.  Under a
profiler ``diag.profiling`` names the runner's spans
(``run_substeps_cuda``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import numpy as np
import torch

from ..core.colliders import check_kin
from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState, Topology, body_contract, check_bodies
from ..diag import profiling
from ..ops import collision as _collision
from ..ops import incidence as _incidence
from ..ops import integrate as _integrate
from ..ops import volume as _volume
from ..solvers import general as _general
from . import _build
from . import contact_cuda as _contact

LIB_NAME = "mesh_xpbd"
# with mesh_xpbd.cuh; the fused backward (kernels/mesh_diff.py) launches
# mesh_diff_xpbd.cu's entry, whose replay runs this library's forward passes
SOURCES = ("mesh_xpbd.cu", "contact_xpbd.cu", "mesh_diff_xpbd.cu")
# every product and sum rounded as written (no FMA contraction): the
# bending masks near flat hinges must see the plain engine's bits
NVCC_EXTRA = ("-fmad=false",)
# rows of the collider table (csrc/mesh_xpbd.cuh MX_MAX_SPHERES, _BOXES)
MAX_SPHERES = 16
MAX_BOXES = 16

launches = 0   # CUDA kernels launched by this module (plain int)


class MeshParams(ctypes.Structure):
    """Mirror of ``struct MeshParams`` in ``csrc/mesh_xpbd.cu`` (every field
    4 bytes wide, same order)."""

    _fields_ = [
        ("n", ctypes.c_int), ("n_edges", ctypes.c_int),
        ("n_hinges", ctypes.c_int), ("iterations", ctypes.c_int),
        ("colored", ctypes.c_int), ("lambda_mode", ctypes.c_int),
        ("bending", ctypes.c_int), ("gravity_acc", ctypes.c_int),
        ("floor_mode", ctypes.c_int), ("n_spheres", ctypes.c_int),
        ("n_boxes", ctypes.c_int), ("accelerate", ctypes.c_int),
        ("n_colors", ctypes.c_int),
        ("col_width", ctypes.c_int), ("n_bend_colors", ctypes.c_int),
        ("bcol_width", ctypes.c_int), ("n_tets", ctypes.c_int),
        ("tets_on", ctypes.c_int), ("n_tet_colors", ctypes.c_int),
        ("tcol_width", ctypes.c_int), ("sc_mode", ctypes.c_int),
        ("sc_every", ctypes.c_int),
        ("dt", ctypes.c_float), ("gravity", ctypes.c_float * 3),
        ("max_force", ctypes.c_float), ("damp_factor", ctypes.c_float),
        ("max_velocity", ctypes.c_float), ("world_bounds", ctypes.c_float),
        ("lambda_decay", ctypes.c_float), ("max_dlambda", ctypes.c_float),
        ("max_dlambda_rel", ctypes.c_float),
        ("lambda_clamp", ctypes.c_float), ("warm_clamp", ctypes.c_float),
        ("eps_length", ctypes.c_float), ("eps_denominator", ctypes.c_float),
        ("static_eps", ctypes.c_float), ("skip_sin_eps", ctypes.c_float),
        ("soften_sin_eps", ctypes.c_float),
        ("soften_factor", ctypes.c_float),
        ("floor_alpha", ctypes.c_float), ("friction_dt", ctypes.c_float),
        ("floor_offset", ctypes.c_float), ("restitution", ctypes.c_float),
        ("penetration_kick", ctypes.c_float),
        ("normal_force_scale", ctypes.c_float),
        ("floor_friction_coeff", ctypes.c_float),
        ("gamma", ctypes.c_float), ("omega", ctypes.c_float),
        ("tet_pressure", ctypes.c_float), ("sc_omega", ctypes.c_float),
        ("sc_diam", ctypes.c_float), ("n_bodies", ctypes.c_int),
        ("w_stride", ctypes.c_int), ("mat_stride", ctypes.c_int),
        ("approx_math", ctypes.c_int), ("n_tris", ctypes.c_int),
        ("vol_target", ctypes.c_float), ("vol_alpha", ctypes.c_float),
        ("n_inc_hubs", ctypes.c_int), ("n_binc_hubs", ctypes.c_int),
        ("n_tinc_hubs", ctypes.c_int), ("n_vinc_hubs", ctypes.c_int),
    ]


_BUFFERS = ("x", "v", "w", "f", "pred", "cur", "prev", "lam", "blam",
            "contrib", "bcontrib", "edges", "rest", "alpha", "relax",
            "warm_scale", "inc_ptr", "inc_cols", "col_ids", "col_valid",
            "hinges", "brest", "balpha", "brelax", "binc_ptr", "binc_cols",
            "bcol_ids",
            "bcol_valid", "tlam", "tcontrib", "tets", "trest", "talpha",
            "tdeg", "tinc_ptr", "tinc_cols", "tcol_ids", "tcol_valid",
            "sc_corr", "colliders", "vlam", "vdl", "vterm",
            "vcontrib", "vgrad", "vwg", "tris", "vinc_ptr", "vinc_cols",
            "inc_hubs", "binc_hubs", "tinc_hubs", "vinc_hubs")


class MeshBuffers(ctypes.Structure):
    """Mirror of ``struct MeshBuffers`` (device pointers, same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in _BUFFERS]


# the fused backward's stash, then its cotangents
DIFF_BUFFERS = ("st_x", "st_v", "st_wx", "st_wlam", "st_pred", "st_new",
                "st_prev", "st_lam", "gx", "gv", "glam", "grest", "galpha",
                "gp", "gprev", "gq", "gcur", "gcontrib", "gpose", "gpose_out")


class DiffBuffers(ctypes.Structure):
    """Mirror of ``struct DiffBuffers`` in ``csrc/mesh_diff_xpbd.cu``
    (device pointers, same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in DIFF_BUFFERS]


_LAMBDA_MODE = {LambdaMode.RESET: 0, LambdaMode.DECAY: 1,
                LambdaMode.WARM_START: 2}
_FLOOR_MODE = {FloorMode.NONE: 0, FloorMode.XPBD_INEQUALITY: 1,
               FloorMode.VELOCITY_REFLECT: 2}
# self-collision backend -> the library's sc_mode (hash and sorted: the
# plain engine's, ``route``)
_SC_MODE = {"dense": 1, "blocked": 2, "blocked_pallas": 2}


def _check_supported(cfg: SolverConfig, topo: Topology,
                     batched: bool = False, kin_colliders=None, device=None):
    """Build-time refusals: the kernel's fixed table sizes and an edgeless
    topology; with a CUDA ``device``, also what only the plain engine runs
    (``check_cuda``).  An ensemble (``batched``) takes dense self-collision
    only: the blocked pass (B-4) carries one body, and the JAX ensemble
    kernel refuses the other backends too (``mesh_pallas.py:106-111,
    911``)."""
    if device is not None and torch.device(device).type == "cuda":
        check_cuda(cfg, topo)
    if (batched and cfg.enable_self_collision
            and cfg.self_collision_backend != "dense"):
        raise NotImplementedError(
            f"mesh kernel: ensembles take dense self-collision only, not "
            f"the {cfg.self_collision_backend!r} backend, as the JAX mesh "
            f"kernel refuses it (mesh_pallas.py:106-111)")
    n_sph, n_box = ((len(cfg.sphere_colliders), len(cfg.box_colliders))
                    if kin_colliders is None else kin_colliders)
    if n_sph > MAX_SPHERES or n_box > MAX_BOXES:
        raise NotImplementedError(
            f"mesh kernel: at most {MAX_SPHERES} sphere and {MAX_BOXES} box "
            f"colliders")
    if topo.n_edges == 0:
        raise NotImplementedError("mesh kernel needs at least one edge")


def check_cuda(cfg: SolverConfig, topo: Topology):
    """What the library refuses on a CUDA state: the self-collision
    backends it does not run (``hash``, ``sorted``: the plain engine runs
    them on the card, ``route``, as the JAX mesh kernel sends them to its
    XLA engine) and blocked layouts the B-4 kernel does not take."""
    if not cfg.enable_self_collision:
        return
    if cfg.self_collision_backend not in _SC_MODE:
        raise NotImplementedError(
            f"mesh kernel: the {cfg.self_collision_backend!r} self-collision "
            "backend runs in the plain engine (solvers.general.make_step "
            "routes it there), not in the kernel")
    if _SC_MODE[cfg.self_collision_backend] == 2:
        _contact.check_layout(topo.n_particles, cfg)


def make_params(topo: Topology, cfg: SolverConfig, dt: float) -> MeshParams:
    """The kernel's scalar constants, each rounded to float32 as the plain
    engine rounds it; the collider counts are a launch's
    (``launch_params``)."""
    p = MeshParams()
    p.n = topo.n_particles
    p.n_edges = topo.n_edges
    p.n_hinges = topo.n_hinges
    p.iterations = cfg.iterations
    p.colored = int(cfg.solve_mode == SolveMode.COLORED)
    p.lambda_mode = _LAMBDA_MODE[cfg.lambda_mode]
    p.bending = int(cfg.enable_bending)
    p.gravity_acc = int(cfg.gravity_is_acceleration)
    p.floor_mode = _FLOOR_MODE[cfg.floor_mode]
    p.accelerate = int(_general.accelerated(cfg))
    p.n_colors, p.col_width = topo.col_edge_ids.shape
    p.n_bend_colors, p.bcol_width = topo.bcol_hinge_ids.shape
    p.n_tets = topo.n_tets
    p.tets_on = int(cfg.enable_tet_volume and topo.n_tets > 0)
    if topo.n_tets:
        p.n_tet_colors, p.tcol_width = topo.tcol_tet_ids.shape
    if cfg.enable_self_collision:
        p.sc_mode = _SC_MODE.get(cfg.self_collision_backend, 0)
    p.sc_every = _general.contact_every(cfg)
    p.dt = dt
    p.gravity[:] = cfg.gravity
    p.max_force = cfg.max_force
    p.damp_factor = _integrate.damping_factor(cfg, dt)
    p.max_velocity = cfg.max_velocity
    p.world_bounds = cfg.world_bounds
    p.lambda_decay = cfg.lambda_decay
    p.max_dlambda = cfg.max_dlambda
    p.max_dlambda_rel = cfg.max_dlambda_rel
    p.lambda_clamp = cfg.lambda_clamp
    p.warm_clamp = cfg.warm_start_clamp
    p.eps_length = cfg.eps_length
    p.eps_denominator = cfg.eps_denominator
    p.static_eps = cfg.static_inv_mass_eps
    p.skip_sin_eps = cfg.bend_skip_sin_eps
    p.soften_sin_eps = cfg.bend_soften_sin_eps
    p.soften_factor = cfg.bend_soften_factor
    p.floor_alpha = cfg.collision_compliance / (dt * dt)
    p.friction_dt = _collision.friction_step(cfg, dt)
    p.floor_offset = cfg.floor_offset
    p.restitution = cfg.restitution
    p.penetration_kick = cfg.penetration_kick
    p.normal_force_scale = cfg.normal_force_scale
    p.floor_friction_coeff = cfg.floor_friction_coeff
    p.gamma = cfg.jacobi_gamma
    p.omega = cfg.omega if cfg.omega > 0 else 1.0
    p.tet_pressure = cfg.tet_pressure
    p.sc_omega = cfg.self_collision_omega
    p.sc_diam = 2.0 * cfg.particle_radius
    p.n_bodies = 1
    if _general.volume_on(cfg, topo):
        # the engine's rounding: the pressure to float32, then a float32
        # product with the rest volume; alpha as JAX's weak float
        p.n_tris = topo.triangles.shape[0]
        p.vol_target = float(np.float32(cfg.pressure)
                             * topo.rest_volume.cpu().numpy())
        p.vol_alpha = cfg.volume_compliance / (dt * dt)
    return p


def constraint_constants(topo: Topology, cfg: SolverConfig, dt: float):
    """Per-edge, per-hinge and per-tet float32 constants: alpha (compliance
    / dt^2, floored at ``min_alpha_tilde`` for edges), the Jacobi
    relaxation and the warm-start scale, the hinges' alpha and relaxation,
    and the tets' alpha (a true division, as ``ops/tet_volume.py``) — the
    values the plain engine computes, to the bit."""
    inv_dt2 = np.float32(1.0 / (dt * dt))
    alpha = topo.compliance.cpu().numpy() * inv_dt2
    if cfg.min_alpha_tilde > 0:
        alpha = np.maximum(alpha, np.float32(cfg.min_alpha_tilde))
    relax, brelax, warm = _general.relax_scales(topo, cfg)
    out = dict(alpha=alpha, relax=relax, warm_scale=warm,
               balpha=topo.bend_compliance.cpu().numpy() * inv_dt2,
               brelax=brelax)
    if topo.n_tets:
        out["talpha"] = (topo.tet_compliance.cpu().numpy()
                         / np.float32(dt * dt))
    return out


def incidence_csr(incidence: torch.Tensor, pad: int):
    """Padded incidence rows (pad index ``pad``) as CSR (row pointers,
    columns): the pads dropped, the column order kept, so the row sums are
    unchanged."""
    inc = incidence.cpu().numpy()
    real = inc < pad
    ptr = np.concatenate([[0], np.cumsum(real.sum(axis=1))]).astype(np.int32)
    return ptr, inc[real].astype(np.int32)


def material_constants(materials, cfg: SolverConfig, dt: float, n_edges: int,
                       device, lead=()):
    """(rest, alpha) per edge on ``device`` from traced ``materials``:
    alpha = compliance / dt^2, floored at ``min_alpha_tilde``, rounded as
    ``constraint_constants`` and the plain engine round it.  ``lead=(B,)``
    also takes per-body ``(B, E)`` materials."""
    rest = materials["rest_lengths"]
    shape = ((n_edges,) if tuple(rest.shape) == (n_edges,)
             else tuple(lead) + (n_edges,))
    rest = _checked("materials['rest_lengths']", rest, shape,
                    device).contiguous()
    comp = _checked("materials['compliance']", materials["compliance"],
                    shape, device)
    alpha = comp * float(np.float32(1.0 / (dt * dt)))
    if cfg.min_alpha_tilde > 0:
        alpha = torch.clamp(alpha, min=cfg.min_alpha_tilde)
    return rest, alpha.contiguous()


def hub_rows(ptr: np.ndarray) -> np.ndarray:
    """The rows of a CSR table (its row pointers ``ptr``) longer than
    ``ops/incidence.HUB_WIDTH``, ascending: the rows the kernel sums with a
    warp each (``csrc/mesh_xpbd.cu`` ``warp_row_sum``)."""
    return np.flatnonzero(np.diff(ptr) > _incidence.HUB_WIDTH).astype(
        np.int32)


@dataclasses.dataclass(frozen=True)
class _DeviceTables:
    tensors: dict                # MeshBuffers field -> tensor on the device
    params: MeshParams
    om: ctypes.Array             # Chebyshev weight per iteration (host)
    om_dev: torch.Tensor         # the same on the device (at least one)


@functools.lru_cache(maxsize=16)
def _device_tables(topo: Topology, cfg: SolverConfig, dt: float,
                   device: str) -> _DeviceTables:
    """The topology and per-constraint constants on ``device``, built once
    per runner configuration."""
    consts = constraint_constants(topo, cfg, dt)

    def dev(t):
        return torch.as_tensor(t).to(device).contiguous()

    tensors = dict(
        edges=dev(topo.edges), rest=dev(topo.rest_lengths),
        col_ids=dev(topo.col_edge_ids), col_valid=dev(topo.col_valid),
        hinges=dev(topo.hinges), brest=dev(topo.rest_angles),
        bcol_ids=dev(topo.bcol_hinge_ids), bcol_valid=dev(topo.bcol_valid),
        **{k: dev(v) for k, v in consts.items()})
    tables = [("inc", topo.incidence, 2 * topo.n_edges),
              ("binc", topo.bend_incidence, 4 * topo.n_hinges)]
    if _general.volume_on(cfg, topo):
        tables.append(("vinc",) + _volume.corner_table(topo.triangles,
                                                       topo.n_particles))
        tensors.update(tris=dev(topo.triangles))
    if topo.n_tets:
        tables.append(("tinc", topo.tet_incidence, 4 * topo.n_tets))
        tensors.update(tets=dev(topo.tets), trest=dev(topo.rest_tet_volumes),
                       tdeg=dev(topo.tet_degree),
                       tcol_ids=dev(topo.tcol_tet_ids),
                       tcol_valid=dev(topo.tcol_valid))
    params = make_params(topo, cfg, dt)
    for name, inc, pad in tables:
        ptr, cols = incidence_csr(inc, pad)
        tensors.update({f"{name}_ptr": dev(ptr), f"{name}_cols": dev(cols)})
        hubs = hub_rows(ptr)
        if hubs.size:
            tensors[f"{name}_hubs"] = dev(hubs)
            setattr(params, f"n_{name}_hubs", hubs.size)
    oms = _general.chebyshev_omegas(cfg)
    return _DeviceTables(
        tensors=tensors, params=params,
        om=(ctypes.c_float * len(oms))(*oms),
        om_dev=dev(np.asarray(list(oms) or [0.0], np.float32)))


# the persistent kernel's plan (csrc/mesh_xpbd.cuh MX_TILE_*): the items a
# block owns of each kind, counted over every body
TILE_KINDS = ("particles", "edges", "hinges", "tets", "triangles",
              "edge_colour_slots", "hinge_colour_slots", "tet_colour_slots",
              "dense_rows")
THREADS = 256    # csrc/mesh_xpbd.cuh MX_THREADS: threads a block
WARPS = THREADS // 32
# the persistent kernel's barriers (csrc/grid_barrier.cuh BARRIER_BLOCK,
# BARRIER_GRID_CTR), as B-1's: __syncthreads() for a block of whole
# bodies; across blocks, the counting barrier in a cooperative launch
BARRIERS = {"block": 0, "counter": 1}
GRID_BARRIER = "counter"
# the largest body (items of any kind) a block holds whole and steps with
# __syncthreads() alone: one item a thread, B-1's rule
BLOCK_BODY_MAX = THREADS
# B-3's designs: the persistent kernel (every route) and the per-pass loop
# it replaced (one launch a pass), kept as its yardstick
DESIGNS = ("persistent", "per_pass")


def tile_counts(p: MeshParams):
    """Items of each of ``TILE_KINDS`` a body has under the launch's
    parameters ``p``: every particle, edge, hinge and tet (the multipliers'
    lifecycle walks them, active or not), the volume's triangles, the
    colour slots of a COLORED sweep's active families, and one dense row a
    particle with dense self-collision."""
    col = bool(p.colored)
    return (p.n, p.n_edges, p.n_hinges, p.n_tets, p.n_tris,
            p.col_width if col else 0,
            p.bcol_width if col and p.bending and p.n_hinges else 0,
            p.tcol_width if col and p.tets_on and p.n_tets else 0,
            p.n if p.sc_mode == 1 else 0)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One call of the persistent kernel: block ``j`` owns the items ``[j *
    chunks[k], min((j + 1) * chunks[k], n_bodies * counts[k]))`` of each
    tile kind ``k`` (``TILE_KINDS``) for the whole call, its threads those
    at a stride of ``THREADS`` (dense rows: its warps, one a row);
    ``barrier`` separates the passes (a key of ``BARRIERS``)."""

    barrier: str
    grid: int
    chunks: tuple
    counts: tuple
    n_bodies: int

    @property
    def kind(self) -> str:
        """``"block"`` (whole bodies a block) or ``"grid"`` (bodies across
        blocks, a cooperative launch)."""
        return "block" if self.barrier == "block" else "grid"

    def tiles(self, kind: int):
        """Each block's items of tile kind ``kind``, ``(lo, hi)``."""
        total = self.counts[kind] * self.n_bodies
        return [(min(j * self.chunks[kind], total),
                 min((j + 1) * self.chunks[kind], total))
                for j in range(self.grid)]


def choose_barrier(counts) -> str:
    """The barrier a body of ``counts`` (``tile_counts``) gets, from its
    size alone: ``"block"`` when no kind has more than ``BLOCK_BODY_MAX``
    items, else ``GRID_BARRIER``."""
    return "block" if max(counts) <= BLOCK_BODY_MAX else GRID_BARRIER


def plan_schedule(counts, n_bodies: int, n_sms: int, blocks_per_sm: int,
                  barrier=None, grid=None) -> Schedule:
    """The persistent kernel's tiles, barrier and grid for ``n_bodies``
    bodies of ``counts`` items a kind (``tile_counts``) on a card of
    ``n_sms`` SMs holding ``blocks_per_sm`` of the kernel's blocks each at
    once (``device_occupancy``).  ``barrier`` (default ``choose_barrier``)
    and ``grid`` (default the planner's) are for tests and timing.

    ``"block"``: a block holds whole bodies, as many as fill its threads
    but no more than spread the bodies over every SM; no co-residency is
    needed.  A grid barrier: one block for every ``THREADS`` items of the
    largest kind (and every ``WARPS`` dense rows), at most ``n_sms *
    blocks_per_sm``; each kind split into tiles of whole warps (dense rows
    in runs of rows), so the grid may come out smaller than asked, and the
    blocks past the particles' last tile take the hub rows first; a grid
    larger than the card holds at once raises ``ValueError`` (its barrier
    would never open)."""
    counts = tuple(int(c) for c in counts)
    if len(counts) != len(TILE_KINDS) or min(counts) < 0 or counts[0] < 1:
        raise ValueError(f"mesh kernel: tile counts {counts}")
    if n_bodies < 1:
        raise ValueError(f"mesh kernel: {n_bodies} bodies")
    barrier = choose_barrier(counts) if barrier is None else barrier
    if barrier not in BARRIERS:
        raise ValueError(f"mesh kernel: no barrier {barrier!r}")
    row = TILE_KINDS.index("dense_rows")
    if barrier == "block":
        per = (max(1, min(THREADS // max(counts), -(-n_bodies // n_sms)))
               if grid is None else -(-n_bodies // grid))
        return Schedule(barrier, -(-n_bodies // per),
                        tuple(per * c for c in counts), counts, n_bodies)
    cap = n_sms * blocks_per_sm
    totals = [c * n_bodies for c in counts]
    need = max(-(-t // (WARPS if k == row else THREADS))
               for k, t in enumerate(totals))
    g = min(need, cap) if grid is None else grid
    if g < 1 or g > cap:
        raise ValueError(
            f"mesh kernel: a grid of {g} blocks cannot be co-resident on "
            f"{n_sms} SMs x {blocks_per_sm} blocks (the {barrier} barrier "
            f"needs every block resident)")
    chunks = tuple(-(-t // g) if k == row else -(-(-(-t // g)) // 32) * 32
                   for k, t in enumerate(totals))
    used = max(-(-t // c) for t, c in zip(totals, chunks) if t)
    return Schedule(barrier, used, chunks, counts, n_bodies)


def reduction_threads() -> int:
    """``MX_THREADS`` of ``csrc/mesh_xpbd.cuh``: the threads of the
    kernel's reduction blocks, whose tree the plain volume sums copy
    (``ops/volume.BLOCK``)."""
    src = (_build.CSRC_DIR / "mesh_xpbd.cuh").read_text()
    return int(re.search(r"#define MX_THREADS (\d+)", src).group(1))


def hub_width() -> int:
    """``MX_HUB_WIDTH`` of ``csrc/mesh_xpbd.cuh``: rows longer than it are
    summed by a warp, which the wrapper's hub tables (``hub_rows``) must
    list."""
    src = (_build.CSRC_DIR / "mesh_xpbd.cuh").read_text()
    return int(re.search(r"#define MX_HUB_WIDTH (\d+)", src).group(1))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's types."""
    if reduction_threads() != _volume.BLOCK:
        raise RuntimeError(
            f"MX_THREADS ({reduction_threads()}) is not ops/volume.BLOCK "
            f"({_volume.BLOCK}): the plain volume sums would not be the "
            "kernel's")
    if hub_width() != _incidence.HUB_WIDTH:
        raise RuntimeError("MX_HUB_WIDTH differs between mesh_xpbd.cuh and "
                           "ops/incidence.HUB_WIDTH")
    lib = _build.load_library(LIB_NAME, SOURCES, NVCC_EXTRA)
    _contact.declare(lib)
    lib.mesh_xpbd_params_size.argtypes = []
    lib.mesh_xpbd_params_size.restype = ctypes.c_int
    lib.mesh_xpbd_buffers_size.argtypes = []
    lib.mesh_xpbd_buffers_size.restype = ctypes.c_int
    lib.mesh_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.mesh_xpbd_error_string.restype = ctypes.c_char_p
    ci, vp = ctypes.c_int, ctypes.c_void_p
    head = [ctypes.POINTER(MeshParams), ctypes.POINTER(MeshBuffers),
            ctypes.POINTER(_contact.ContactParams),
            ctypes.POINTER(_contact.ContactBuffers), ci, ci, ci]
    counts = [ctypes.POINTER(ctypes.c_longlong),
              ctypes.POINTER(ctypes.c_longlong), vp]
    lib.mesh_xpbd_run.argtypes = head + [
        vp, ci, ci, ctypes.POINTER(ci), vp] + counts
    lib.mesh_xpbd_run.restype = ci
    lib.mesh_xpbd_run_per_pass.argtypes = head + [
        ctypes.POINTER(ctypes.c_float)] + counts
    lib.mesh_xpbd_run_per_pass.restype = ci
    cip = ctypes.POINTER(ci)
    lib.mesh_xpbd_occupancy.argtypes = [ci, ci, cip, cip, cip, cip]
    lib.mesh_xpbd_occupancy.restype = ci
    lib.mesh_diff_xpbd_buffers_size.argtypes = []
    lib.mesh_diff_xpbd_buffers_size.restype = ctypes.c_int
    lib.mesh_diff_xpbd_run.argtypes = [
        ctypes.POINTER(MeshParams), ctypes.POINTER(MeshBuffers),
        ctypes.POINTER(DiffBuffers), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_void_p]
    lib.mesh_diff_xpbd_run.restype = ctypes.c_int
    sizes = (lib.mesh_xpbd_params_size(), lib.mesh_xpbd_buffers_size(),
             lib.mesh_diff_xpbd_buffers_size())
    if sizes != tuple(ctypes.sizeof(s) for s in (MeshParams, MeshBuffers,
                                                 DiffBuffers)):
        raise RuntimeError("MeshParams / MeshBuffers / DiffBuffers layout "
                           "differs between the wrappers and the sources")
    return lib


@functools.lru_cache(maxsize=None)
def device_occupancy(index: int, barrier: str):
    """(SMs, blocks of the persistent kernel one SM holds at once) for the
    kernel of ``barrier`` on CUDA device ``index``; raises where a grid
    barrier has no cooperative launch."""
    lib = _library()
    threads, per_sm, sms, coop = (ctypes.c_int() for _ in range(4))
    rc = lib.mesh_xpbd_occupancy(index, BARRIERS[barrier],
                                 ctypes.byref(threads), ctypes.byref(per_sm),
                                 ctypes.byref(sms), ctypes.byref(coop))
    if rc != 0:
        msg = lib.mesh_xpbd_error_string(rc).decode()
        raise RuntimeError(f"mesh kernel occupancy failed: {msg} ({rc})")
    if threads.value != THREADS:
        raise RuntimeError(f"mesh kernel: {threads.value} threads a block in "
                           f"the library, {THREADS} here")
    if barrier != "block" and not coop.value:
        raise RuntimeError(f"mesh kernel: device {index} has no cooperative "
                           f"launch for the {barrier} barrier")
    return sms.value, per_sm.value


def schedule_for(counts, n_bodies: int, device: torch.device,
                 barrier=None) -> Schedule:
    """``plan_schedule`` with the occupancy of ``device``."""
    barrier = choose_barrier(counts) if barrier is None else barrier
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms, per_sm = device_occupancy(index, barrier)
    return plan_schedule(counts, n_bodies, sms, per_sm, barrier=barrier)


def launch_params(tables: _DeviceTables, world) -> MeshParams:
    """A launch's copy of the runner configuration's constants, with the
    collider counts of its rigid world (``ops/collision.RigidWorld``)."""
    p = MeshParams.from_buffer_copy(tables.params)
    p.n_spheres, p.n_boxes = world.n_spheres, world.n_boxes
    return p


def _checked(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"mesh kernel: {name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mesh kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t


def run_substeps_cuda(state: SimState, topo: Topology, cfg: SolverConfig,
                      dt_sub: float, n_substeps: int,
                      with_ext: bool = False, materials=None,
                      batched: bool = False,
                      per_body_mass: bool = False,
                      approx_math: bool = False, *,
                      contact_design: str = "culled",
                      design: str = "persistent",
                      schedule=None) -> SimState:
    """Launch the kernel for ``n_substeps`` substeps of a CUDA state; the
    semantics of ``solvers.general.run_substeps_plain`` (``batched``: of
    ``run_substeps_plain_batched``, every body in the same launches;
    ``approx_math`` as there), the state's ColliderSet (if any) replacing
    the config's rigid world.  One launch of the persistent kernel a call,
    or, with blocked contact, one a stretch between two B-4 passes
    (``schedule_for``).  ``design="per_pass"`` runs B-3's yardstick, one
    launch a pass; ``schedule`` (a ``Schedule`` for this shape) another
    plan than the shape's; ``contact_design="serial"`` B-4's yardstick
    (``kernels.contact_cuda``) in the blocked contact passes: each for the
    card tests and ``chip_smoke.py``, never a route.  No host sync.  Under
    a profiler the call is the span ``sbs.mesh.call``, its phases
    ``sbs.mesh.layout`` (checks, leaves to planes, scratch, the device
    tables and constants), ``sbs.mesh.launch`` (the library, the B-4
    pass's tables, the schedule, the launches) and ``sbs.mesh.unlayout``
    (planes to leaves)."""
    with profiling.span("mesh.call"):
        return _run_substeps_cuda(state, topo, cfg, dt_sub, n_substeps,
                                  with_ext, materials, batched,
                                  per_body_mass, approx_math,
                                  contact_design, design, schedule)


def _run_substeps_cuda(state, topo, cfg, dt_sub, n_substeps, with_ext,
                       materials, batched, per_body_mass, approx_math,
                       contact_design, design, schedule):
    global launches
    _general.check_state(state)
    dev = state.device
    with profiling.span("mesh.layout"):
        world = _collision.RigidWorld.of(cfg, state.colliders, dev)
        _check_supported(cfg, topo, batched=batched,
                         kin_colliders=(world.n_spheres, world.n_boxes))
        check_cuda(cfg, topo)
        _general.check_tet_windows(cfg, topo, state)
        if batched:
            _general.check_volume_leaf(cfg, topo, state)
        if dev.type != "cuda":
            raise ValueError(f"mesh kernel: state on {dev}, not CUDA")
        n, e, h = topo.n_particles, topo.n_edges, topo.n_hinges
        b = state.positions.shape[0] if batched else 1
        lead = (b,) if batched else ()
        tables = _device_tables(topo, cfg, dt_sub, str(dev))
        params = launch_params(tables, world)
        params.n_bodies = b
        params.w_stride = n if per_body_mass else 0
        params.approx_math = int(approx_math)
        if state.lambda_tet is None and topo.n_tets:
            # no multipliers, no tet sweep (general._substep's has_tets)
            params.n_tets = params.tets_on = 0

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        def planes(name, t):
            """(B, N, 3) leaves -> (B, 3, N) structure of arrays, once per
            call."""
            return _checked(name, t, lead + (n, 3), dev).reshape(
                b, n, 3).permute(0, 2, 1).contiguous()

        def owned(name, t, k):
            return _checked(name, t, lead + (k,), dev).clone(
                memory_format=torch.contiguous_format)

        x = planes("positions", state.positions)
        v = planes("velocities", state.velocities)
        w = _checked("inv_mass", state.inv_mass,
                     lead + (n,) if per_body_mass else (n,), dev).contiguous()
        f = planes("ext_force", state.ext_force)
        lam = owned("lambda_dist", state.lambda_dist, e)
        blam = owned("lambda_bend", state.lambda_bend, h)
        plane = f32(3, b, 3, n)
        work = dict(x=x, v=v, w=w, f=f, pred=plane[0], cur=plane[1],
                    prev=plane[2], lam=lam, blam=blam,
                    contrib=f32(b, 2 * e, 3),
                    bcontrib=f32(b, max(4 * h, 1), 3),
                    colliders=world.table,
                    **tables.tensors)
        if materials is not None:
            work["rest"], work["alpha"] = material_constants(
                materials, cfg, dt_sub, e, dev, lead)
            params.mat_stride = e if work["rest"].ndim == 2 else 0
        if params.n_tets:
            t = topo.n_tets
            work.update(tlam=owned("lambda_tet", state.lambda_tet, t),
                        tcontrib=f32(b, 4 * t, 3))
        if params.n_tris:
            t = params.n_tris
            work.update(vlam=_checked("lambda_volume", state.lambda_volume,
                                      lead, dev).reshape(b).clone(),
                        vdl=f32(b), vterm=f32(b, t),
                        vcontrib=f32(b, 3 * t, 3),
                        vgrad=f32(b, 3, n), vwg=f32(b, n))
        if params.sc_mode == 1:
            work.update(sc_corr=f32(b, 3, n))
        bufs = MeshBuffers(**{k: ctypes.c_void_p(work[k].data_ptr())
                              for k in _BUFFERS if k in work})
    with profiling.span("mesh.launch"):
        lib = _library()
        cp = cb = None
        if params.sc_mode == 2:
            # the B-4 pass over the pred plane (element (i, c) at c * n + i)
            cp = _contact.make_params(n, cfg, 1, n, contact_design)
            ct = _contact.scratch(lib, n, cfg, dev, contact_design)
            ct.update(pred=work["pred"], w=w)
            cb = _contact.buffers(ct)
        count, ccount = ctypes.c_longlong(0), ctypes.c_longlong(0)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        head = (ctypes.byref(params), ctypes.byref(bufs),
                None if cp is None else ctypes.byref(cp),
                None if cb is None else ctypes.byref(cb), dev.index,
                n_substeps, int(with_ext))
        if design == "per_pass":
            rc = lib.mesh_xpbd_run_per_pass(*head, tables.om,
                                            ctypes.byref(count),
                                            ctypes.byref(ccount), stream)
        elif design == "persistent":
            counts = tile_counts(params)
            sched = schedule or schedule_for(counts, b, dev)
            if (sched.counts, sched.n_bodies) != (counts, b):
                raise ValueError("mesh kernel: the schedule is for another "
                                 "shape")
            # the counting barrier's word, zeroed by the library before each
            # launch
            counter = torch.empty(1, dtype=torch.int64, device=dev)
            chunks = (ctypes.c_int * len(TILE_KINDS))(*sched.chunks)
            rc = lib.mesh_xpbd_run(
                *head, ctypes.c_void_p(tables.om_dev.data_ptr()),
                BARRIERS[sched.barrier], sched.grid, chunks,
                ctypes.c_void_p(counter.data_ptr()), ctypes.byref(count),
                ctypes.byref(ccount), stream)
        else:
            raise ValueError(f"mesh kernel: no design {design!r}")
    launches += count.value
    _contact.launches += ccount.value
    if rc != 0:
        msg = lib.mesh_xpbd_error_string(rc).decode()
        raise RuntimeError(f"mesh kernel launch failed: {msg} ({rc})")

    def body(t):
        return t if batched else t[0]

    with profiling.span("mesh.unlayout"):
        out = state.replace(
            positions=body(x.permute(0, 2, 1).contiguous()),
            velocities=body(v.permute(0, 2, 1).contiguous()),
            lambda_dist=lam, lambda_bend=blam)
        if params.n_tets:
            out = out.replace(lambda_tet=work["tlam"])
        if params.n_tris:
            out = out.replace(lambda_volume=work["vlam"].reshape(lead))
        if with_ext:
            out = out.replace(ext_force=torch.zeros_like(state.ext_force))
    return out


def advance(state: SimState, topo: Topology, cfg: SolverConfig,
            dt_sub: float, n_substeps: int, with_ext: bool,
            materials=None, batched: bool = False,
            per_body_mass: bool = False,
            approx_math: bool = False) -> SimState:
    """A CUDA state launches the kernel; a CPU state runs the plain engine
    (``batched``: body by body; ``approx_math``: its twin); any other
    device raises."""
    if state.device.type == "cuda":
        return run_substeps_cuda(state, topo, cfg, dt_sub, n_substeps,
                                 with_ext, materials, batched, per_body_mass,
                                 approx_math)
    if state.device.type == "cpu":
        plain = (_general.run_substeps_plain_batched if batched
                 else _general.run_substeps_plain)
        return plain(state, topo, cfg, dt_sub, n_substeps, with_ext,
                     materials, approx_math)
    raise NotImplementedError(
        f"mesh kernel: no path for a state on {state.device}")


def make_mesh_cuda_substep_runner(topo: Topology, cfg: SolverConfig,
                                  dt_sub: float, n_substeps: int,
                                  with_ext: bool = False,
                                  approx_math: bool = False,
                                  n_bodies: int = 1, kin_colliders=None,
                                  device=None, batched=None,
                                  per_body_mass: bool = False):
    """``fn(state, materials=None) -> SimState`` advancing ``n_substeps``
    raw substeps, self-collision on substep i iff ``i %
    self_collision_every == 0``; ``materials`` as the module docstring says.
    ``with_ext=False``: external forces are neither applied nor cleared
    (rollout semantics); ``with_ext=True``: ``state.ext_force`` is consumed
    on the first substep and zeroed.  ``kin_colliders=(S, B)``: the state's
    ColliderSet of S spheres and B boxes replaces the config's rigid world,
    its poses read by every launch (checked at call time; a runner built
    without it refuses a state carrying colliders).

    ``n_bodies > 1`` (or ``batched=True`` at one body, a one-body shard;
    ``core/state.body_contract``): the ensemble contract of
    ``mesh_pallas.make_mesh_substep_runner`` (``:814-861``): positions,
    velocities, ext_force ``(B, N, 3)``, lambda_dist ``(B, E)``,
    lambda_bend ``(B, H)``, lambda_tet ``(B, T)``, with the volume on
    lambda_volume ``(B,)`` (``ValueError`` otherwise); inv_mass a shared
    ``(N,)`` leaf, or with ``per_body_mass=True`` a per-body ``(B, N)``
    one (``ValueError`` without the batched contract, as in JAX);
    ``materials`` shared ``(E,)`` or per body ``(B, E)``; one ColliderSet
    for every body.  On a CUDA state every body advances in one launch a
    pass; on a CPU state ``general.run_substeps_plain_batched``.

    ``approx_math``: the kernel's rsqrt variant (module docstring), one
    body or an ensemble; on a CPU state its plain twin.

    An ensemble with another self-collision backend than ``dense`` raises
    ``NotImplementedError`` here, at build time, as do more colliders than
    the kernel's table holds and, when ``device`` names a CUDA device, what
    a CUDA state is refused (``check_cuda``; a CUDA state is checked again
    when it arrives)."""
    kin = None if kin_colliders is None else tuple(
        int(k) for k in kin_colliders)
    batched = body_contract(n_bodies, batched)
    if per_body_mass and not batched:
        raise ValueError("per_body_mass requires the batched contract")
    _check_supported(cfg, topo, batched=batched, kin_colliders=kin,
                     device=device)

    def fn(state: SimState, materials=None) -> SimState:
        check_kin(kin, state.colliders, "mesh runner")
        if batched:
            check_bodies(state, n_bodies, "mesh runner")
            want = 2 if per_body_mass else 1
            if state.inv_mass.ndim != want:
                raise ValueError(
                    f"mesh runner: inv_mass of shape "
                    f"{tuple(state.inv_mass.shape)}; per_body_mass="
                    f"{per_body_mass} takes a "
                    f"{'(B, N)' if per_body_mass else 'shared (N,)'} leaf")
        return advance(state, topo, cfg, dt_sub, n_substeps, with_ext,
                       materials, batched, per_body_mass, approx_math)

    return fn


def route(cfg: SolverConfig) -> str:
    """The route ``solvers.general.make_step`` takes for ``cfg``, read from
    the config when the step is built: ``"kernel"`` (this library, through
    ``make_mesh_cuda_step``) without self-collision or with a backend the
    library runs (dense, blocked, blocked_pallas); for ``hash`` (the JAX
    default) and ``sorted``, ``"hybrid"``
    (``make_mesh_hybrid_contact_step``) at a cadence
    ``self_collision_every >= 2`` that divides the frame, else ``"plain"``
    (the plain engine alone on the state's device, what JAX's
    ``general.make_step`` runs).  On a CPU state every kernel of a route
    runs its plain version."""
    if (not cfg.enable_self_collision
            or cfg.self_collision_backend in _SC_MODE):
        return "kernel"
    every = cfg.self_collision_every
    if every >= 2 and cfg.substeps % every == 0:
        return "hybrid"
    return "plain"


def make_mesh_cuda_step(topo: Topology, cfg: SolverConfig, dt: float,
                        n_steps: int = 1, device=None, kin_colliders=None,
                        n_bodies: int = 1, batched=None,
                        per_body_mass: bool = False):
    """Full step semantics: ``n_steps`` frames of ``cfg.substeps`` substeps,
    ``state.ext_force`` consumed on the first substep and zeroed after
    (drop-in for ``solvers.general.make_step``), routed as
    ``make_mesh_pallas_step`` routes: dense self-collision runs in the
    library's loop, its cadence gated on the raw substep index, so a
    cadence that does not divide the frame is refused; the other backends
    with ``self_collision_every >= 2`` go to
    ``make_mesh_hybrid_contact_step``.  ``kin_colliders``, ``n_bodies``,
    ``batched`` and ``per_body_mass`` as in
    ``make_mesh_cuda_substep_runner``."""
    one = not body_contract(n_bodies, batched)
    if cfg.enable_self_collision and cfg.self_collision_every >= 2:
        if cfg.self_collision_backend != "dense" and one:
            return make_mesh_hybrid_contact_step(
                topo, cfg, dt, n_steps, device=device,
                kin_colliders=kin_colliders)
        if cfg.substeps % cfg.self_collision_every != 0:
            raise NotImplementedError(
                "fused dense contact cadence needs substeps % "
                "self_collision_every == 0 (the engine's per-frame pattern "
                "must equal the kernel's raw-substep gate)")
    return make_mesh_cuda_substep_runner(topo, cfg, dt / cfg.substeps,
                                         n_steps * cfg.substeps,
                                         with_ext=True, device=device,
                                         kin_colliders=kin_colliders,
                                         n_bodies=n_bodies, batched=batched,
                                         per_body_mass=per_body_mass)


def make_mesh_hybrid_contact_step(topo: Topology, cfg: SolverConfig,
                                  dt: float, n_steps: int = 1, device=None,
                                  kin_colliders=None):
    """Contact-cadence step (``mesh_pallas.make_mesh_hybrid_contact_step``,
    ``:2119-2170``): ``n_steps`` frames in which substep i of a frame
    projects self-collision iff ``i % self_collision_every == 0``, exactly
    ``general.step_fn``'s cadence, and ``ext_force`` is consumed on the
    first substep of the first step and zeroed after.  For ``hash`` and
    ``sorted``, as in JAX, a frame is ``substeps // every`` groups of [a
    contact substep of the plain engine on the state's device; the ``every
    - 1`` contact-free substeps in the library]; for the backends the
    library runs (blocked, blocked_pallas; on the card the B-4 pass), every
    substep runs in the library's loop, whose raw-substep gate is the
    per-frame pattern since the cadence divides the frame.
    ``kin_colliders``: the state's ColliderSet on both halves."""
    every = cfg.self_collision_every
    if not cfg.enable_self_collision or every < 2:
        raise ValueError("mesh hybrid contact step needs "
                         "enable_self_collision and "
                         "self_collision_every >= 2")
    if cfg.substeps % every != 0:
        raise NotImplementedError(
            "mesh hybrid contact step needs substeps % "
            "self_collision_every == 0 (use the plain engine otherwise)")
    dt_sub = dt / cfg.substeps
    if cfg.self_collision_backend in _SC_MODE:
        return make_mesh_cuda_substep_runner(topo, cfg, dt_sub,
                                             n_steps * cfg.substeps,
                                             with_ext=True, device=device,
                                             kin_colliders=kin_colliders)
    inner = make_mesh_cuda_substep_runner(
        topo, cfg.replace(enable_self_collision=False), dt_sub, every - 1,
        device=device, kin_colliders=kin_colliders)
    groups = cfg.substeps // every

    def fn(state: SimState) -> SimState:
        for frame in range(n_steps):
            for g in range(groups):
                state = _general.run_substeps_plain(
                    state, topo, cfg, dt_sub, 1,
                    with_ext=frame == 0 and g == 0)
                state = inner(state)
        return state.replace(ext_force=torch.zeros_like(state.ext_force))

    fn.route = "hybrid"
    return fn
