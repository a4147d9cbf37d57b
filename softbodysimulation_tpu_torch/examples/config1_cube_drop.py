"""Example 1 -- a single soft-body cube: mass-spring, gravity and the
ground plane (BASELINE config 1; the 'CpuCube' / 'SoftBodySimulator'
scene).

Counterpart of ``softbodysimulation_tpu/examples/config1_cube_drop.py``:
the braced res^3 lattice dropped from y = 1.5 through
``solvers.lattice.make_step`` (the lattice kernel on the card, its plain
stencil engine on the CPU).

    python -m softbodysimulation_tpu_torch.examples.config1_cube_drop
"""

from __future__ import annotations

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..diag.diagnostics import diagnostics, format_diagnostics
from ..solvers import lattice as lat_engine
from ..topology import build, lattice


def run(res: int = 8, steps: int = 300, dt: float = 1 / 60,
        verbose: bool = True, device="cuda"):
    """Returns the state after ``steps`` frames."""
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=4, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
        ground_height=0.0, friction=0.3)
    state = lat_engine.make_lattice_state(spec, center=(0.0, 1.5, 0.0),
                                          device=device)
    state = lat_engine.make_step(spec, cfg, dt, n_steps=steps)(state)

    if verbose:
        # an explicit topology of the same lattice for the diagnostics
        pos = lattice.lattice_points(res, center=(0.0, 1.5, 0.0))
        edges, comp = lattice.lattice_edges(res, braced=True)
        topo = build.build_topology(pos, edges, comp, color=False)
        print(format_diagnostics(diagnostics(state, topo)))
        y = state.positions[:, 1]
        print(f"rest height: {float(y.max() - y.min()):.4f} "
              f"(ymin={float(y.min()):.4f})")
    return state


if __name__ == "__main__":
    run()
