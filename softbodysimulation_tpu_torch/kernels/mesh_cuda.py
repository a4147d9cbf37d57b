"""The hand-written CUDA mesh kernel (``csrc/mesh_xpbd.cu``) and its
runners.

Counterpart of ``softbodysimulation_tpu/kernels/mesh_pallas.py``
(``_check_supported``, ``make_mesh_substep_runner``,
``make_mesh_pallas_step``) for the distance + dihedral-bending family:
``make_mesh_cuda_substep_runner`` and ``make_mesh_cuda_step``.  The TPU
kernel's one-hot block plans have no counterpart: the CUDA kernel gathers
by index, so any topology runs (a windowed one is not needed).

Device dispatch, with no fallback: a state on a CUDA device launches the
kernel (or raises); a state on the CPU runs the kernel's plain version,
``solvers.general.run_substeps_plain``; any other device raises.  The
library is built with ``nvcc`` on the first CUDA call
(``kernels/_build.py``), never at import; the topology's tables and the
per-constraint constants go to the card once per runner configuration and
device, on the first call there.

``launches`` counts the CUDA kernels this module has launched; callers may
reset it to 0 to count one run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState, Topology
from ..ops import collision as _collision
from ..ops import integrate as _integrate
from ..solvers import general as _general
from . import _build

LIB_NAME = "mesh_xpbd"
SOURCES = ("mesh_xpbd.cu",)
# every product and sum rounded as written (no FMA contraction): the
# bending masks near flat hinges must see the plain engine's bits
NVCC_EXTRA = ("-fmad=false",)
MAX_SPHERES = 16

launches = 0   # CUDA kernels launched by this module (plain int)


class MeshParams(ctypes.Structure):
    """Mirror of ``struct MeshParams`` in ``csrc/mesh_xpbd.cu`` (every field
    4 bytes wide, same order)."""

    _fields_ = [
        ("n", ctypes.c_int), ("n_edges", ctypes.c_int),
        ("n_hinges", ctypes.c_int), ("inc_width", ctypes.c_int),
        ("binc_width", ctypes.c_int), ("iterations", ctypes.c_int),
        ("colored", ctypes.c_int), ("lambda_mode", ctypes.c_int),
        ("bending", ctypes.c_int), ("gravity_acc", ctypes.c_int),
        ("floor_mode", ctypes.c_int), ("n_spheres", ctypes.c_int),
        ("accelerate", ctypes.c_int), ("n_colors", ctypes.c_int),
        ("col_width", ctypes.c_int), ("n_bend_colors", ctypes.c_int),
        ("bcol_width", ctypes.c_int),
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
        ("ground_height", ctypes.c_float), ("floor_alpha", ctypes.c_float),
        ("friction_dt", ctypes.c_float), ("floor_rest", ctypes.c_float),
        ("restitution", ctypes.c_float),
        ("penetration_kick", ctypes.c_float),
        ("normal_force_scale", ctypes.c_float),
        ("floor_friction_coeff", ctypes.c_float),
        ("gamma", ctypes.c_float),
        ("spheres", (ctypes.c_float * 4) * MAX_SPHERES),
    ]


_BUFFERS = ("x", "v", "w", "f", "pred", "cur", "prev", "lam", "blam",
            "contrib", "bcontrib", "edges", "rest", "alpha", "relax",
            "warm_scale", "incidence", "col_ids", "col_valid", "hinges",
            "brest", "balpha", "brelax", "bend_incidence", "bcol_ids",
            "bcol_valid")


class MeshBuffers(ctypes.Structure):
    """Mirror of ``struct MeshBuffers`` (device pointers, same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in _BUFFERS]


_LAMBDA_MODE = {LambdaMode.RESET: 0, LambdaMode.DECAY: 1,
                LambdaMode.WARM_START: 2}
_FLOOR_MODE = {FloorMode.NONE: 0, FloorMode.XPBD_INEQUALITY: 1,
               FloorMode.VELOCITY_REFLECT: 2}


def _check_supported(cfg: SolverConfig, topo: Topology,
                     approx_math: bool = False, n_bodies: int = 1,
                     kin_colliders=None):
    """Build-time refusals: the plain engine's, plus the kernel's options
    that are not ported and its fixed table sizes."""
    _general.check_supported(cfg)
    if approx_math:
        raise NotImplementedError(
            "mesh kernel: approx_math (rsqrt / approximate reciprocal) is "
            "not ported")
    if n_bodies != 1:
        raise NotImplementedError(
            "mesh kernel: stacked-body ensembles (n_bodies > 1) are not "
            "ported")
    if kin_colliders is not None:
        raise NotImplementedError(
            "mesh kernel: kinematic collider poses are not ported")
    if len(cfg.sphere_colliders) > MAX_SPHERES:
        raise NotImplementedError(
            f"mesh kernel: at most {MAX_SPHERES} sphere colliders")
    if topo.n_edges == 0:
        raise NotImplementedError("mesh kernel needs at least one edge")


def make_params(topo: Topology, cfg: SolverConfig, dt: float) -> MeshParams:
    """The kernel's scalar constants, each rounded to float32 as the plain
    engine rounds it."""
    p = MeshParams()
    p.n = topo.n_particles
    p.n_edges = topo.n_edges
    p.n_hinges = topo.n_hinges
    p.inc_width = topo.incidence.shape[1]
    p.binc_width = topo.bend_incidence.shape[1]
    p.iterations = cfg.iterations
    p.colored = int(cfg.solve_mode == SolveMode.COLORED)
    p.lambda_mode = _LAMBDA_MODE[cfg.lambda_mode]
    p.bending = int(cfg.enable_bending)
    p.gravity_acc = int(cfg.gravity_is_acceleration)
    p.floor_mode = _FLOOR_MODE[cfg.floor_mode]
    p.n_spheres = len(cfg.sphere_colliders)
    p.accelerate = int(_general.accelerated(cfg))
    p.n_colors, p.col_width = topo.col_edge_ids.shape
    p.n_bend_colors, p.bcol_width = topo.bcol_hinge_ids.shape
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
    p.ground_height = cfg.ground_height
    p.floor_alpha = cfg.collision_compliance / (dt * dt)
    p.friction_dt = _collision.friction_step(cfg, dt)
    p.floor_rest = cfg.ground_height + cfg.floor_offset
    p.restitution = cfg.restitution
    p.penetration_kick = cfg.penetration_kick
    p.normal_force_scale = cfg.normal_force_scale
    p.floor_friction_coeff = cfg.floor_friction_coeff
    p.gamma = cfg.jacobi_gamma
    for si, sphere in enumerate(cfg.sphere_colliders):
        p.spheres[si][:] = sphere
    return p


def constraint_constants(topo: Topology, cfg: SolverConfig, dt: float):
    """Per-edge and per-hinge float32 constants: alpha (compliance / dt^2,
    floored at ``min_alpha_tilde``), the Jacobi relaxation and the
    warm-start scale, and the hinges' alpha and relaxation — the values the
    plain engine computes, to the bit."""
    inv_dt2 = np.float32(1.0 / (dt * dt))
    alpha = topo.compliance.cpu().numpy() * inv_dt2
    if cfg.min_alpha_tilde > 0:
        alpha = np.maximum(alpha, np.float32(cfg.min_alpha_tilde))
    relax, brelax, warm = _general.relax_scales(topo, cfg)
    return dict(alpha=alpha, relax=relax, warm_scale=warm,
                balpha=topo.bend_compliance.cpu().numpy() * inv_dt2,
                brelax=brelax)


@dataclasses.dataclass(frozen=True)
class _DeviceTables:
    tensors: dict                # MeshBuffers field -> tensor on the device
    params: MeshParams
    om: ctypes.Array             # Chebyshev weight per iteration


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
        incidence=dev(topo.incidence), col_ids=dev(topo.col_edge_ids),
        col_valid=dev(topo.col_valid), hinges=dev(topo.hinges),
        brest=dev(topo.rest_angles), bend_incidence=dev(topo.bend_incidence),
        bcol_ids=dev(topo.bcol_hinge_ids), bcol_valid=dev(topo.bcol_valid),
        **{k: dev(v) for k, v in consts.items()})
    oms = _general.chebyshev_omegas(cfg)
    return _DeviceTables(tensors=tensors, params=make_params(topo, cfg, dt),
                         om=(ctypes.c_float * len(oms))(*oms))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's types."""
    lib = _build.load_library(LIB_NAME, SOURCES, NVCC_EXTRA)
    lib.mesh_xpbd_params_size.argtypes = []
    lib.mesh_xpbd_params_size.restype = ctypes.c_int
    lib.mesh_xpbd_buffers_size.argtypes = []
    lib.mesh_xpbd_buffers_size.restype = ctypes.c_int
    lib.mesh_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.mesh_xpbd_error_string.restype = ctypes.c_char_p
    lib.mesh_xpbd_run.argtypes = [
        ctypes.POINTER(MeshParams), ctypes.POINTER(MeshBuffers),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_void_p]
    lib.mesh_xpbd_run.restype = ctypes.c_int
    if (lib.mesh_xpbd_params_size() != ctypes.sizeof(MeshParams)
            or lib.mesh_xpbd_buffers_size() != ctypes.sizeof(MeshBuffers)):
        raise RuntimeError("MeshParams / MeshBuffers layout differs between "
                           "mesh_cuda.py and mesh_xpbd.cu")
    return lib


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
                      with_ext: bool = False) -> SimState:
    """Launch the kernel for ``n_substeps`` substeps of a CUDA state; the
    semantics of ``solvers.general.run_substeps_plain``.  No host sync."""
    global launches
    _check_supported(cfg, topo)
    _general.check_state(state)
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"mesh kernel: state on {dev}, not CUDA")
    n, e, h = topo.n_particles, topo.n_edges, topo.n_hinges
    tables = _device_tables(topo, cfg, dt_sub, str(dev))
    # (N, 3) -> (3, N) structure of arrays, once per call
    x = _checked("positions", state.positions, (n, 3), dev).t().contiguous()
    v = _checked("velocities", state.velocities, (n, 3), dev).t().contiguous()
    w = _checked("inv_mass", state.inv_mass, (n,), dev).contiguous()
    f = _checked("ext_force", state.ext_force, (n, 3), dev).t().contiguous()
    lam = _checked("lambda_dist", state.lambda_dist, (e,), dev).clone()
    blam = _checked("lambda_bend", state.lambda_bend, (h,), dev).clone()
    plane = torch.empty((3, 3, n), dtype=torch.float32, device=dev)
    work = dict(x=x, v=v, w=w, f=f, pred=plane[0], cur=plane[1],
                prev=plane[2], lam=lam, blam=blam,
                contrib=torch.empty((2 * e, 3), dtype=torch.float32,
                                    device=dev),
                bcontrib=torch.empty((max(4 * h, 1), 3), dtype=torch.float32,
                                     device=dev),
                **tables.tensors)
    bufs = MeshBuffers(**{k: ctypes.c_void_p(work[k].data_ptr())
                          for k in _BUFFERS})
    lib = _library()
    count = ctypes.c_longlong(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mesh_xpbd_run(ctypes.byref(tables.params), ctypes.byref(bufs),
                           dev.index, n_substeps, int(with_ext), tables.om,
                           ctypes.byref(count), ctypes.c_void_p(stream))
    launches += count.value
    if rc != 0:
        msg = lib.mesh_xpbd_error_string(rc).decode()
        raise RuntimeError(f"mesh kernel launch failed: {msg} ({rc})")
    out = state.replace(positions=x.t().contiguous(),
                        velocities=v.t().contiguous(), lambda_dist=lam,
                        lambda_bend=blam)
    if with_ext:
        out = out.replace(ext_force=torch.zeros_like(state.ext_force))
    return out


def advance(state: SimState, topo: Topology, cfg: SolverConfig,
            dt_sub: float, n_substeps: int, with_ext: bool) -> SimState:
    """A CUDA state launches the kernel; a CPU state runs the plain engine;
    any other device raises."""
    if state.device.type == "cuda":
        return run_substeps_cuda(state, topo, cfg, dt_sub, n_substeps,
                                 with_ext)
    if state.device.type == "cpu":
        return _general.run_substeps_plain(state, topo, cfg, dt_sub,
                                           n_substeps, with_ext)
    raise NotImplementedError(
        f"mesh kernel: no path for a state on {state.device}")


def make_mesh_cuda_substep_runner(topo: Topology, cfg: SolverConfig,
                                  dt_sub: float, n_substeps: int,
                                  with_ext: bool = False,
                                  approx_math: bool = False,
                                  n_bodies: int = 1, kin_colliders=None):
    """``SimState -> SimState`` advancing ``n_substeps`` raw substeps.
    ``with_ext=False``: external forces are neither applied nor cleared
    (rollout semantics); ``with_ext=True``: ``state.ext_force`` is consumed
    on the first substep and zeroed.  ``approx_math``, ``n_bodies > 1`` and
    ``kin_colliders`` are not ported and raise ``NotImplementedError`` here,
    at build time, as do the configurations the plain engine refuses."""
    _check_supported(cfg, topo, approx_math=approx_math, n_bodies=n_bodies,
                     kin_colliders=kin_colliders)

    def fn(state: SimState) -> SimState:
        return advance(state, topo, cfg, dt_sub, n_substeps, with_ext)

    return fn


def make_mesh_cuda_step(topo: Topology, cfg: SolverConfig, dt: float,
                        n_steps: int = 1):
    """Full step semantics: ``n_steps`` frames of ``cfg.substeps`` substeps,
    ``state.ext_force`` consumed on the first substep and zeroed after
    (drop-in for ``solvers.general.make_step``)."""
    return make_mesh_cuda_substep_runner(topo, cfg, dt / cfg.substeps,
                                         n_steps * cfg.substeps,
                                         with_ext=True)
