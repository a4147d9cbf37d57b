"""Example 4 -- interactive poke impulses with self-collision through the
spatial-hash grid (BASELINE config 4).

Counterpart of ``softbodysimulation_tpu/examples/config4_interactive_poke.py``:
two soft cubes dropped into the same spot collide through the ``hash``
self-collision backend (the config's default) of the general engine;
scripted pokes stand in for the mouse.  ``solvers.general.make_step``
routes the ``hash`` backend to the plain engine on the state's device
(``kernels/mesh_cuda.route``), on the card as on the CPU.

    python -m softbodysimulation_tpu_torch.examples.config4_interactive_poke
"""

from __future__ import annotations

import numpy as np

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..core.state import make_state
from ..interact import forces
from ..solvers import general
from ..topology import build, lattice


def scene(res: int = 4, device="cuda"):
    """(topology, config, initial state) of the example: two braced res^3
    lattices, one above the other."""
    spacing = 1.0 / (res - 1)
    pos_a = lattice.lattice_points(res, center=(0.0, 0.8, 0.0))
    pos_b = lattice.lattice_points(res, center=(0.15, 2.1, 0.1))
    pos = np.concatenate([pos_a, pos_b])
    e, comp = lattice.lattice_edges(res, braced=True)
    edges = np.concatenate([e, e + res ** 3])
    comp = np.concatenate([comp, comp])
    topo = build.build_topology(pos, edges, comp, color=False)
    cfg = SolverConfig(
        substeps=4, iterations=2, damping=0.03,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
        enable_self_collision=True,
        particle_radius=0.45 * spacing, hash_grid_dim=32,
        ground_height=0.0, friction=0.3)
    return topo, cfg, make_state(pos, n_edges=topo.n_edges, device=device)


def pokes(steps: int):
    """{frame: (force, position, radius)} of the scripted pokes."""
    return {steps // 2: ((80.0, 60.0, 0.0), (0.0, 0.3, 0.0), 0.6),
            3 * steps // 4: ((-60.0, 40.0, 20.0), (0.3, 0.5, 0.0), 0.8)}


def run(res: int = 4, steps: int = 400, dt: float = 1 / 60,
        verbose: bool = True, device="cuda"):
    """Returns ``(state, topology)`` after ``steps`` frames."""
    topo, cfg, state = scene(res, device)
    step = general.make_step(topo, cfg, dt, n_steps=1)
    poke_at = pokes(steps)
    for i in range(steps):
        if i in poke_at:
            f, p, r = poke_at[i]
            state = forces.add_force(state, f, p, radius=r)
        state = step(state)

    if verbose:
        p = state.positions.cpu().numpy()
        n = res ** 3
        d = np.linalg.norm(p[:n, None, :] - p[None, n:, :], axis=-1)
        print(f"finite={np.isfinite(p).all()} ymin={p[:, 1].min():.4f} "
              f"min inter-body distance={d.min():.4f} "
              f"(2r={2 * cfg.particle_radius:.4f}) route={step.route}")
    return state, topo


if __name__ == "__main__":
    run()
