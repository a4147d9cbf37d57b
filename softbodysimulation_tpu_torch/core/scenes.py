"""Scenes, as build functions returning ``(state, step, info)``.

Counterpart of five scenes of ``softbodysimulation_tpu/core/scenes.py``:
the lattice scenes ``flagship`` (the reference's
Scenes/SoftBodySimulator.unity) and ``flagship_perf`` (the ``bench.py``
workload), and the mesh scenes ``cpu_mesh`` (Scenes/CpuMesh.unity),
``cloth`` and ``cloth_xl``.  ``step`` is ``kernels.lattice_cuda.
make_cuda_step`` or ``kernels.mesh_cuda.make_mesh_cuda_step``, which launch
the CUDA kernel for a state on a CUDA device and run the plain engine for a
CPU state.  The state lies on ``device``; a mesh scene's topology stays on
the CPU (``info["topology"]``), and the kernel wrapper moves its tables to
the card.
"""

from __future__ import annotations

import os

import numpy as np

from ..interact import forces as _forces
from ..kernels.lattice_cuda import make_cuda_step
from ..kernels.mesh_cuda import make_mesh_cuda_step
from ..solvers import lattice as _lat_engine
from ..topology import build as _build
from ..topology import lattice as _lattice
from ..topology import mesh as _mesh
from ..topology.objloader import load_obj
from .config import DampingMode, FloorMode, LambdaMode, SolveMode, SolverConfig
from .state import state_from_topology

# OBJ assets are data, not code; the reference's bunny is used when present
BUNNY_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                          "LowResBunny.obj")


def flagship(dt: float = 1 / 60, res: int = 4, gravity_on: bool = False,
             device="cpu"):
    """Flagship lattice scene (Scenes/SoftBodySimulator.unity: res 4, 9
    iterations, lambda decay 0.99, structural/shear/bend compliance
    1e-4/1e-3/1e-2; the scene serializes gravity 0)."""
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


def flagship_perf(dt: float = 1 / 60, res: int = 40, device="cpu"):
    """The performance workload (bench.py): braced res-40 lattice, small
    steps, one RESET Jacobi pass per substep."""
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


def cpu_mesh(dt: float = 0.02, fallback_subdiv: int = 3, device="cpu"):
    """Bunny-mesh scene (Scenes/CpuMesh.unity: 15 iterations, compliance
    1e-10, gravity (0,-1,0), bending off, dlambda clamp 1e-3).  Falls back
    to a dense icosphere when the bunny OBJ asset is absent.  Built with
    the colour-major windowed ordering of the JAX scene, so both packages
    number particles and edges alike."""
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
    step = make_mesh_cuda_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "mesh": m}


def cloth(dt: float = 1 / 60, res: int = 16, device="cpu"):
    """Hanging cloth: grid plane with edge + dihedral bending constraints,
    top row pinned (the canonical mesh-driven workload of the
    InitializeSoftBodyFromMesh path, exercised as cloth), RCM-renumbered
    as the JAX scene is."""
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
    step = make_mesh_cuda_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "pinned": top}


def cloth_xl(dt: float = 1 / 60, res: int = 129, device="cpu"):
    """Large hanging cloth (default 129 x 129 = 16,641 particles, 49,408
    edge and 48,896 hinge constraints): the ``cloth`` scene at scale."""
    return cloth(dt=dt, res=res, device=device)
