"""Lattice scenes, as build functions returning ``(state, step, info)``.

Counterpart of the two lattice scenes of
``softbodysimulation_tpu/core/scenes.py``: ``flagship`` (the reference's
Scenes/SoftBodySimulator.unity) and ``flagship_perf`` (the ``bench.py``
workload).  ``step`` is ``kernels.lattice_cuda.make_cuda_step``, which
launches the CUDA lattice kernel for a state on a CUDA device and runs the
plain engine for a CPU state.
"""

from __future__ import annotations

from ..kernels.lattice_cuda import make_cuda_step
from ..solvers import lattice as _lat_engine
from ..topology import lattice as _lattice
from .config import DampingMode, FloorMode, LambdaMode, SolveMode, SolverConfig


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
