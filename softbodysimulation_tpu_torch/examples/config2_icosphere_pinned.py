"""Example 2 -- an icosphere with XPBD distance and bending constraints, 8
Jacobi substeps, hanging from pinned anchor vertices (BASELINE config 2).

Counterpart of ``softbodysimulation_tpu/examples/config2_icosphere_pinned.py``
through ``solvers.general.make_step`` (the mesh kernel on the card, the
plain general engine on the CPU).

    python -m softbodysimulation_tpu_torch.examples.config2_icosphere_pinned
"""

from __future__ import annotations

import numpy as np

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..diag.diagnostics import diagnostics, format_diagnostics
from ..interact import forces
from ..solvers import general
from ..topology import build, mesh


def run(subdivisions: int = 2, steps: int = 300, dt: float = 1 / 60,
        verbose: bool = True, device="cuda"):
    """Returns ``(state, topology)`` after ``steps`` frames."""
    m = mesh.icosphere(subdivisions, radius=0.5)
    pos, topo = build.topology_from_mesh(
        m, compliance=1e-4, bending=True, bend_compliance=1e-2)
    pos = pos + np.array([0.0, 1.5, 0.0], np.float32)
    state = state_from_topology(topo, pos, device=device)

    # the top cap pinned as anchors: the sphere hangs from them
    top = np.flatnonzero(pos[:, 1] > pos[:, 1].max() - 0.05)
    state = forces.pin_indices(state, top, pinned=True)

    cfg = SolverConfig(
        substeps=8, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
        enable_bending=True,
        ground_height=0.0, friction=0.3)
    state = general.make_step(topo, cfg, dt, n_steps=steps)(state)

    if verbose:
        print(format_diagnostics(diagnostics(state, topo)))
        p = state.positions.cpu().numpy()
        print(f"anchors fixed: "
              f"{np.allclose(p[top], pos[top], atol=1e-5)}; "
              f"ymin={p[:, 1].min():.4f}")
    return state, topo


if __name__ == "__main__":
    run()
