"""The port's general engine against the frozen NumPy oracle, continued
(``test_torch_oracle_drift.py`` says what is mirrored): the settle run at
its full 1000 steps, the Jacobi rest state, acceleration gravity and,
marked slow, the 10k-step headline drift.
"""

import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.solvers import general
from softbodysimulation_tpu_torch.topology import build, lattice, mesh

from test_torch_oracle_drift import DT, drift, make_oracle, make_scene
from test_torch_state import port_config

torch.set_num_threads(1)


def test_colored_engine_drift_after_settling():
    """The settle run, its full 1000 steps: both land on the same rest
    state, at rest."""
    pos, topo, cfg = make_scene("cube8")
    state = port.state_from_topology(topo, pos, device="cpu")
    oracle = make_oracle(pos, topo, cfg, state.inv_mass.numpy())
    state = general.make_step(topo, port_config(cfg), DT,
                              n_steps=1000)(state)
    for _ in range(1000):
        oracle.step(DT)
    assert drift(state, oracle) < 1e-3
    assert float(state.velocities.abs().max()) < 1e-3
    assert np.abs(oracle.v).max() < 1e-3


def test_jacobi_reaches_same_rest_state():
    """Jacobi (20 iterations) settles on the oracle's constraint manifold
    and resting height."""
    pos, topo, cfg = make_scene("cube8")
    state = port.state_from_topology(topo, pos, device="cpu")
    oracle = make_oracle(pos, topo, cfg, state.inv_mass.numpy())
    cfg_j = port_config(cfg).replace(solve_mode=port.SolveMode.JACOBI,
                                     iterations=20)
    state = general.make_step(topo, cfg_j, DT, n_steps=1000)(state)
    for _ in range(1000):
        oracle.step(DT)
    e = topo.edges.numpy()
    rest = topo.rest_lengths.numpy()

    def edge_err(p):
        return np.abs(np.linalg.norm(p[e[:, 1]] - p[e[:, 0]], axis=1) - rest)

    p = state.positions.numpy()
    assert edge_err(p).max() < max(2 * edge_err(oracle.x).max(), 2e-3)
    assert abs(p[:, 1].min() - oracle.x[:, 1].min()) < 2e-3


def test_acceleration_gravity_matches_oracle():
    pos = mesh.cube_corners(1.0) + np.array([0, 1.5, 0], np.float32)
    topo = build.build_topology(pos, lattice.cube8_edges(), compliance=0.01)
    cfg = jconfig.SolverConfig(substeps=2, iterations=8, damping=0.02,
                               solve_mode=jconfig.SolveMode.COLORED,
                               ground_height=0.0,
                               gravity_is_acceleration=True)
    state = port.state_from_topology(topo, pos, mass=2.0, device="cpu")
    oracle = make_oracle(pos, topo, cfg, state.inv_mass.numpy())
    step = general.make_step(topo, port_config(cfg), DT)
    for _ in range(150):
        state = step(state)
        oracle.step(DT)
    assert drift(state, oracle) < 1e-4


@pytest.mark.slow
def test_drift_10k_steps():
    """The headline metric (BASELINE.md): 10k steps of cube8, drift <=
    1e-3 from the oracle."""
    pos, topo, cfg = make_scene("cube8")
    state = port.state_from_topology(topo, pos, device="cpu")
    oracle = make_oracle(pos, topo, cfg, state.inv_mass.numpy())
    state = general.make_step(topo, port_config(cfg), DT,
                              n_steps=10000)(state)
    for _ in range(10000):
        oracle.step(DT)
    assert drift(state, oracle) <= 1e-3
