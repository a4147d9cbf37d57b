"""Example 3 -- a pressurized (volume-preserving) ball dropped onto a
sphere collider with friction (BASELINE config 3).

Counterpart of ``softbodysimulation_tpu/examples/config3_inflated_ball.py``:
the global volume constraint C = V - pressure * V0 (``ops/volume.py``)
through ``solvers.general.make_step`` -- on the card the mesh kernel's
volume passes (TPU kernel B-3's volume sweep), on the CPU the plain
general engine.

    python -m softbodysimulation_tpu_torch.examples.config3_inflated_ball
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..diag.diagnostics import diagnostics, format_diagnostics
from ..ops.volume import enclosed_volume
from ..solvers import general
from ..topology import build, mesh


def config(pressure: float = 1.15) -> SolverConfig:
    """The example's solver configuration."""
    return SolverConfig(
        substeps=4, iterations=4, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        enable_volume=True, volume_compliance=0.0, pressure=pressure,
        sphere_colliders=((0.0, 0.0, 0.0, 0.8),),
        ground_height=-2.0, friction=0.4)


def run(subdivisions: int = 2, steps: int = 400, dt: float = 1 / 60,
        pressure: float = 1.15, verbose: bool = True, device="cuda"):
    """Returns ``(state, topology)`` after ``steps`` frames."""
    m = mesh.icosphere(subdivisions, radius=0.4)
    pos, topo = build.topology_from_mesh(m, compliance=5e-4, bending=False)
    pos = pos + np.array([0.1, 2.0, 0.0], np.float32)
    state = state_from_topology(topo, pos, device=device)
    state = general.make_step(topo, config(pressure), dt,
                              n_steps=steps)(state)

    if verbose:
        v0 = float(topo.rest_volume)
        v = float(enclosed_volume(state.positions,
                                  topo.triangles.to(state.device)))
        print(format_diagnostics(diagnostics(state, topo,
                                             ground_height=-2.0)))
        print(f"volume: rest={v0:.4f} inflated target={pressure * v0:.4f} "
              f"actual={v:.4f}")
        r = torch.linalg.norm(state.positions, dim=1)
        print(f"min distance to collider centre: {float(r.min()):.3f} "
              f"(collider radius 0.8)")
    return state, topo


if __name__ == "__main__":
    run()
