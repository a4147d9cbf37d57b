"""Example 9 -- a solid (tetrahedral) soft body: a Kuhn-subdivided jelly
cube dropped on the floor, its per-tet XPBD volume constraints keeping
its volume as it squashes.

Counterpart of ``softbodysimulation_tpu/examples/config9_tet_solid.py``
through ``solvers.general.make_step`` in COLORED mode (the mesh kernel's
tet colours on the card, the plain general engine on the CPU); see
``topology/tets.py`` and ``ops/tet_volume.py``.

    python -m softbodysimulation_tpu_torch.examples.config9_tet_solid
"""

from __future__ import annotations

import numpy as np

from ..core.config import SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..diag.diagnostics import diagnostics, format_diagnostics
from ..ops.tet_volume import tet_volumes6
from ..solvers import general
from ..topology import build, lattice, tets


def run(res: int = 6, steps: int = 300, dt: float = 1 / 60,
        verbose: bool = True, device="cuda"):
    """Returns ``(state, topology)`` after ``steps`` frames."""
    pos = lattice.lattice_points(res) + np.array([0, 1.5, 0], np.float32)
    tt = tets.fix_orientation(pos, tets.cube_lattice_tets(res))
    topo = build.build_topology(
        pos, tets.tet_edges(tt), compliance=1e-3,
        tets=tt, tet_compliance=1e-7,
        triangles=tets.boundary_faces(tt))
    state = state_from_topology(topo, pos, device=device)

    cfg = SolverConfig(
        substeps=4, iterations=6, damping=0.02,
        solve_mode=SolveMode.COLORED,
        enable_tet_volume=True,
        ground_height=0.0, friction=0.3)
    state = general.make_step(topo, cfg, dt, n_steps=steps)(state)

    if verbose:
        v0 = float(topo.rest_tet_volumes.sum()) / 6.0
        v = float(tet_volumes6(state.positions,
                               topo.tets.to(state.device)).sum()) / 6.0
        print(format_diagnostics(diagnostics(state, topo)))
        print(f"solid volume: rest={v0:.4f} settled={v:.4f} "
              f"({100 * (v / v0 - 1):+.2f}%) over {topo.n_tets} tets")
        y = state.positions[:, 1]
        print(f"height span after settling: [{float(y.min()):.3f}, "
              f"{float(y.max()):.3f}]")
    return state, topo


if __name__ == "__main__":
    run()
