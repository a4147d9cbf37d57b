"""The port's general engine against the frozen NumPy oracle
(``softbodysimulation_tpu/solvers/reference_cpu.py``), on the CPU.

Mirror of the non-slow cases of ``tests/test_oracle_drift.py`` with the
port's builders, configs and ``solvers.general.make_step`` (the plain
general engine on a CPU state) in place of the JAX engine, at that file's
scenes, horizons and gates: here cube8, lattice3 (chaotic bounce at
contact: 1e-3), bending_plane and clamped; in
``test_torch_oracle_rest.py`` the 1000-step settle run, the Jacobi rest
state, acceleration gravity and, marked slow, the 10k-step headline drift
(BASELINE.md: <= 1e-3); in ``test_torch_oracle_warm.py`` the COLORED +
WARM_START oracle and the pinned lattice.  Three files, each under about
40 s on one worker: the plain engine's colour sweeps are many small torch
operations (about 65 ms a lattice3 step here).  The oracle is the JAX
package's NumPy module, used as it is (the port does not carry it); it
takes the JAX package's ``SolverConfig``, so each scene's config is built
in both packages.
"""

import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.solvers import reference_cpu

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.solvers import general
from softbodysimulation_tpu_torch.topology import build, lattice, mesh

from test_torch_state import port_config

torch.set_num_threads(1)

DT = 0.02


def make_scene(kind: str):
    """(positions, port topology, JAX config) of
    ``tests/test_oracle_drift.py``'s scene."""
    C = jconfig
    if kind == "cube8":
        pos = mesh.cube_corners(1.0) + np.array([0, 2.0, 0], np.float32)
        topo = build.build_topology(pos, lattice.cube8_edges(),
                                    compliance=0.01)
        cfg = C.SolverConfig(substeps=1, iterations=10, damping=0.01,
                             solve_mode=C.SolveMode.COLORED,
                             ground_height=0.0)
    elif kind == "lattice3":
        pos = lattice.lattice_points(3, center=(0, 1.5, 0))
        edges, comp = lattice.lattice_edges(3)
        topo = build.build_topology(pos, edges, comp)
        cfg = C.SolverConfig(substeps=2, iterations=8, damping=0.02,
                             solve_mode=C.SolveMode.COLORED,
                             ground_height=0.0, friction=0.3)
    elif kind == "bending_plane":
        pos, topo = build.topology_from_mesh(
            mesh.grid_plane(1.0, 4), compliance=1e-4, bending=True,
            bend_compliance=1e-3)
        pos = pos + np.array([0, 1.0, 0], np.float32)
        cfg = C.SolverConfig(substeps=1, iterations=6, damping=0.02,
                             solve_mode=C.SolveMode.COLORED,
                             ground_height=0.0, enable_bending=True)
    elif kind == "clamped":
        pos = mesh.cube_corners(1.0) + np.array([0, 1.0, 0], np.float32)
        topo = build.build_topology(pos, lattice.cube8_edges(),
                                    compliance=1e-6)
        cfg = C.SolverConfig(substeps=1, iterations=15, damping=0.01,
                             solve_mode=C.SolveMode.COLORED,
                             ground_height=0.0, max_dlambda=1e-3)
    else:
        raise KeyError(kind)
    return pos, topo, cfg


def make_oracle(pos, topo, cfg, inv_mass, **kw):
    hinges = topo.hinges.numpy()
    return reference_cpu.ReferenceSolver(
        pos, topo.edges.numpy(), topo.rest_lengths.numpy(),
        topo.compliance.numpy(), inv_mass, cfg,
        hinges=hinges if len(hinges) and cfg.enable_bending else None,
        rest_angles=topo.rest_angles.numpy(),
        bend_compliance=topo.bend_compliance.numpy(),
        colors=topo.colors.numpy(), bend_colors=topo.bend_colors.numpy(),
        **kw)


def drift(state, oracle) -> float:
    return float(np.abs(state.positions.numpy() - oracle.x).max())


@pytest.mark.parametrize(
    "kind,steps,tol",
    [("cube8", 150, 5e-5), ("lattice3", 300, 1e-3),
     ("bending_plane", 150, 5e-5), ("clamped", 150, 5e-5)])
def test_colored_engine_matches_oracle(kind, steps, tol):
    pos, topo, cfg = make_scene(kind)
    state = port.state_from_topology(topo, pos, device="cpu")
    oracle = make_oracle(pos, topo, cfg, state.inv_mass.numpy())
    step = general.make_step(topo, port_config(cfg), DT)
    for _ in range(steps):
        state = step(state)
        oracle.step(DT)
    assert drift(state, oracle) < tol, (kind, drift(state, oracle))
