"""Scenes, as build functions returning ``(state, step, info)``.

Counterpart of ten scenes of ``softbodysimulation_tpu/core/scenes.py``:
the lattice scenes ``flagship`` (the reference's
Scenes/SoftBodySimulator.unity), ``flagship_perf`` (the ``bench.py``
workload), ``solid_lattice`` (``flagship_perf`` with per-cell tets) and
``sphere_sweep`` (a scripted kinematic sphere through a slab),
the mesh scenes ``cpu_mesh`` (Scenes/CpuMesh.unity), ``cloth``
and ``cloth_xl``, the solids ``tet_cube`` and ``tet_ball``, and the
multi-body contact scene ``ball_on_cloth``.  ``step`` is
``kernels.lattice_cuda.make_cuda_step`` or
``kernels.mesh_cuda.make_mesh_cuda_step``, which launch the CUDA kernel
for a state on a CUDA device and run the plain engine for a CPU state.

The state lies on ``device``, the card unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device a scene raises rather than move
to the CPU.  A mesh scene's topology stays on the CPU
(``info["topology"]``), and the kernel wrapper moves its tables to the
card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..interact import forces as _forces
from ..kernels.lattice_cuda import make_cuda_step
from ..kernels.mesh_cuda import make_mesh_cuda_step
from ..solvers import lattice as _lat_engine
from ..topology import build as _build
from ..topology import edges as _edges
from ..topology import lattice as _lattice
from ..topology import mesh as _mesh
from ..topology import tets as _tets
from ..topology.objloader import load_obj
from .colliders import make_colliders
from .config import DampingMode, FloorMode, LambdaMode, SolveMode, SolverConfig
from .state import on_device, state_from_topology

# OBJ assets are data, not code; the reference's bunny is used when present
BUNNY_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                          "LowResBunny.obj")


def _device(device) -> torch.device:
    """The scene's device; a CUDA device where there is none raises (no
    silent move to the CPU)."""
    return on_device(device, "scene")


def flagship(dt: float = 1 / 60, res: int = 4, gravity_on: bool = False,
             device="cuda"):
    """Flagship lattice scene (Scenes/SoftBodySimulator.unity: res 4, 9
    iterations, lambda decay 0.99, structural/shear/bend compliance
    1e-4/1e-3/1e-2; the scene serializes gravity 0)."""
    device = _device(device)
    spec = _lattice.lattice_spec(res)
    cfg = SolverConfig(
        substeps=4, iterations=9, damping=0.01,
        damping_mode=DampingMode.PER_DT,
        gravity=(0.0, -9.81, 0.0) if gravity_on else (0.0, 0.0, 0.0),
        solve_mode=SolveMode.COLORED,
        lambda_mode=LambdaMode.DECAY, lambda_decay=0.99,
        max_dlambda_rel=0.1, lambda_clamp=100.0, min_alpha_tilde=1e-10,
        floor_mode=FloorMode.VELOCITY_REFLECT, ground_height=-5.0)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.0, 0.0),
                                           device=device)
    step = make_cuda_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt}


def flagship_perf(dt: float = 1 / 60, res: int = 40, device="cuda"):
    """The performance workload (bench.py): braced res-40 lattice, small
    steps, one RESET Jacobi pass per substep."""
    device = _device(device)
    spec = _lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=8, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        fast_math=True,
        ground_height=0.0, friction=0.3)
    # particle mass 1 g: a 40-high stack of unit masses would exceed 100%
    # strain at structural compliance 1e-4 (it would pancake — physically)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                           mass=0.001, device=device)
    step = make_cuda_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt}


def solid_lattice(dt: float = 1 / 60, res: int = 40, device="cuda"):
    """Solid (volumetric) flagship-scale body on the stencil engine: the
    res-40 braced lattice with per-cell tet volume constraints, 6 Kuhn
    tets per cell as gather-free offset families
    (``solvers/lattice._tet_sweep``; in the CUDA lattice kernel on the
    card)."""
    device = _device(device)
    spec = _lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=8, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        fast_math=True,
        enable_tet_volume=True,
        ground_height=0.0, friction=0.3)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                           mass=0.001, tet_volume=True,
                                           device=device)
    step = make_cuda_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt}


def sphere_sweep(dt: float = 1 / 60, res: int = 8, speed: float = 2.0,
                 device="cuda"):
    """Kinematic rigid-collider scene: a scripted rigid sphere sweeps along
    +x through a soft lattice slab resting on the floor (the reference's
    moving PhysX colliders, ``SoftBodyController.cs:110-118``).  The
    sphere's pose is a ColliderSet leaf of the state;
    ``info["animate"](i, state)`` sets frame i's pose and velocity, and the
    same step (the lattice kernel built with ``info["kin_colliders"] = (1,
    0)`` on the card, its pose table read by every launch) serves every
    pose."""
    device = _device(device)
    spec = _lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(substeps=4, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.RESET,
                       gravity_is_acceleration=True,
                       ground_height=0.0, friction=0.3)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                           mass=0.001, device=device)
    radius, sy, x0 = 0.35, 0.5, -1.6
    state = state.replace(colliders=make_colliders(
        spheres=[(x0, sy, 0.0, radius)], ground_height=0.0, device=device))

    def animate(i, st):
        """Frame i's collider pose (host side; the scripted-trajectory
        spelling is ``interact.animator.kinematic_rollout``)."""
        x = x0 + speed * i * dt
        return st.replace(colliders=st.colliders.with_sphere(
            0, center=(x, sy, 0.0), velocity=(speed, 0.0, 0.0)))

    kin = (1, 0)
    step = make_cuda_step(spec, cfg, dt, kin_colliders=kin)
    return state, step, {"spec": spec, "config": cfg, "dt": dt,
                         "animate": animate, "kin_colliders": kin}


def cpu_mesh(dt: float = 0.02, fallback_subdiv: int = 3, device="cuda"):
    """Bunny-mesh scene (Scenes/CpuMesh.unity: 15 iterations, compliance
    1e-10, gravity (0,-1,0), bending off, dlambda clamp 1e-3).  Falls back
    to a dense icosphere when the bunny OBJ asset is absent.  Built with
    the colour-major windowed ordering of the JAX scene, so both packages
    number particles and edges alike."""
    device = _device(device)
    if os.path.exists(BUNNY_PATH):
        m = load_obj(BUNNY_PATH)
    else:
        m = _mesh.icosphere(fallback_subdiv, radius=0.5)
    pos, topo = _build.topology_from_mesh(m, compliance=1e-10, bending=False,
                                          windowed="colored")
    pos = pos + np.array([0, 1.0, 0], np.float32)
    cfg = SolverConfig(substeps=1, iterations=15, damping=0.01,
                       gravity=(0.0, -1.0, 0.0),
                       solve_mode=SolveMode.COLORED, max_dlambda=1e-3,
                       ground_height=0.0, friction=0.1)
    state = state_from_topology(topo, pos, device=device)
    step = make_mesh_cuda_step(topo, cfg, dt, device=device)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "mesh": m}


def cloth(dt: float = 1 / 60, res: int = 16, device="cuda"):
    """Hanging cloth: grid plane with edge + dihedral bending constraints,
    top row pinned (the canonical mesh-driven workload of the
    InitializeSoftBodyFromMesh path, exercised as cloth), RCM-renumbered
    as the JAX scene is."""
    device = _device(device)
    m = _mesh.grid_plane(1.0, res)
    # stand the plane up vertically (x stays, y <- z)
    verts = m.vertices[:, [0, 2, 1]].copy()
    verts[:, 2] *= 0.0
    mm = _mesh.TriMesh(verts, m.triangles)
    pos, topo = _build.topology_from_mesh(
        mm, compliance=1e-5, bending=True, bend_compliance=1e-3,
        windowed=True)
    pos = pos + np.array([0.0, 1.2, 0.0], np.float32)
    cfg = SolverConfig(substeps=4, iterations=2, damping=0.03,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
                       enable_bending=True,
                       ground_height=0.0, friction=0.4)
    state = state_from_topology(topo, pos, device=device)
    top = np.flatnonzero(pos[:, 1] > pos[:, 1].max() - 1e-4)
    state = _forces.pin_indices(state, top, pinned=True)
    step = make_mesh_cuda_step(topo, cfg, dt, device=device)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "pinned": top}


def cloth_xl(dt: float = 1 / 60, res: int = 129, device="cuda"):
    """Large hanging cloth (default 129 x 129 = 16,641 particles, 49,408
    edge and 48,896 hinge constraints): the ``cloth`` scene at scale."""
    return cloth(dt=dt, res=res, device=device)


def tet_cube(dt: float = 1 / 60, res: int = 6, device="cuda"):
    """Solid (tetrahedral) jelly cube dropped on the floor: every lattice
    cell carries 6 Kuhn tets with per-tet XPBD volume constraints plus edge
    distance constraints (COLORED)."""
    device = _device(device)
    pos = _lattice.lattice_points(res) + np.array([0, 1.0, 0], np.float32)
    tt = _tets.fix_orientation(pos, _tets.cube_lattice_tets(res))
    topo = _build.build_topology(
        pos, _tets.tet_edges(tt), compliance=1e-4,
        tets=tt, tet_compliance=1e-6,
        triangles=_tets.boundary_faces(tt))
    cfg = SolverConfig(substeps=4, iterations=6, damping=0.01,
                       solve_mode=SolveMode.COLORED,
                       enable_tet_volume=True,
                       ground_height=0.0, friction=0.2)
    state = state_from_topology(topo, pos, device=device)
    step = make_mesh_cuda_step(topo, cfg, dt, device=device)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def tet_ball(dt: float = 1 / 60, subdiv: int = 2, device="cuda"):
    """Soft solid ball: an icosphere filled with a centroid tet fan
    (``topology/tets.py:tets_from_surface_centroid``), incompressible and
    slightly pressurized (tet_pressure 1.05), JACOBI, RCM-renumbered as the
    JAX scene is."""
    device = _device(device)
    m = _mesh.icosphere(subdiv, radius=0.5)
    verts, tt = _tets.tets_from_surface_centroid(m.vertices, m.triangles)
    pos2, topo = _build.build_windowed_topology(
        verts, _tets.tet_edges(tt), 1e-4,
        tets=tt, tet_compliance=0.0,
        triangles=_tets.boundary_faces(tt))
    pos = pos2 + np.array([0, 1.0, 0], np.float32)
    cfg = SolverConfig(substeps=4, iterations=8, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       enable_tet_volume=True, tet_pressure=1.05,
                       ground_height=0.0, friction=0.3)
    state = state_from_topology(topo, pos, device=device)
    step = make_mesh_cuda_step(topo, cfg, dt, device=device)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def ball_on_cloth(dt: float = 1 / 60, cloth_res: int = 24,
                  ball_subdiv: int = 1, device="cuda"):
    """Two soft bodies in contact: a pressurized solid ball dropped onto a
    horizontal cloth pinned around its rim.  Both bodies are merged into
    one topology (``merge_topologies``, disjoint constraint ranges), and the
    self-collision backend (dense, every substep) resolves the contact
    between them as it resolves contact within one body.  ``info["n_cloth"]``
    counts the cloth's particles (the first ones); ``info["pinned"]`` is
    the rim."""
    device = _device(device)
    cm = _mesh.grid_plane(1.2, cloth_res)
    cverts = cm.vertices + np.array([0.0, 1.0, 0.0], np.float32)
    bm = _mesh.icosphere(ball_subdiv, radius=0.18)
    bverts, btets = _tets.tets_from_surface_centroid(bm.vertices,
                                                     bm.triangles)
    bverts = (bverts + np.array([0.0, 1.45, 0.0])).astype(np.float32)
    nc = cverts.shape[0]
    pos, topo, _ = _build.merge_topologies([
        _build.BodySpec(cverts, _edges.unique_edges(cm.triangles), 1e-5,
                        hinges=_edges.hinges(cm.triangles),
                        bend_compliance=1e-3, triangles=cm.triangles),
        _build.BodySpec(bverts, _tets.tet_edges(btets), 1e-4,
                        triangles=_tets.boundary_faces(btets), tets=btets,
                        tet_compliance=0.0),
    ], windowed=True)
    # 2r stays under the cloth spacing (bonded neighbours never touch) and r
    # above the per-substep fall distance (~0.007, no tunnelling)
    spacing = 1.2 / (cloth_res - 1)
    particle_radius = round(0.45 * spacing, 4)
    if not (2.0 * particle_radius < spacing and particle_radius > 0.008):
        raise ValueError(f"cloth_res={cloth_res}: contact radius "
                         f"{particle_radius} would let the ball tunnel")
    cfg = SolverConfig(substeps=6, iterations=4, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       enable_bending=True,
                       enable_tet_volume=True, tet_pressure=1.05,
                       enable_self_collision=True,
                       self_collision_backend="dense",
                       particle_radius=particle_radius,
                       ground_height=0.0, friction=0.3)
    state = state_from_topology(topo, pos, device=device)
    ii, jj = np.divmod(np.arange(nc), cloth_res)
    rim = np.flatnonzero((ii % (cloth_res - 1) == 0)
                         | (jj % (cloth_res - 1) == 0))
    state = _forces.pin_indices(state, rim, pinned=True)
    step = make_mesh_cuda_step(topo, cfg, dt, device=device)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "n_cloth": nc, "pinned": rim}
