"""The benchmark's frozen reference against the port's plain engine on the
CPU: the same bits for one body and for an ensemble at res 4, and the
topology it copies."""

import numpy as np
import pytest
import torch

from portbench.reference import lattice as ref
from softbodysimulation_tpu_torch.core.config import (DampingMode, FloorMode,
                                                      LambdaMode, SolveMode,
                                                      SolverConfig)
from softbodysimulation_tpu_torch.solvers import lattice as lat
from softbodysimulation_tpu_torch.topology import lattice as top

BODY = {"res": 4, "braced": True, "size_m": [1.0, 1.0, 1.0],
        "structural_compliance": 1e-4, "shear_compliance": 1e-3,
        "bend_compliance": 1e-2}
BASE = {"substeps": 8, "iterations": 1, "gravity": [0.0, -9.81, 0.0],
        "gravity_is_acceleration": True, "damping": 0.02,
        "damping_mode": "per_step", "max_velocity": 0.0, "max_force": 0.0,
        "world_bounds": 0.0, "solve_mode": "jacobi", "omega": 0.0,
        "lambda_mode": "reset", "lambda_decay": 0.99, "max_dlambda": 0.0,
        "max_dlambda_rel": 0.0, "lambda_clamp": 0.0,
        "warm_start_clamp": 0.5, "warm_start_fraction": 0.5,
        "min_alpha_tilde": 0.0, "floor_mode": "xpbd_inequality",
        "ground_height": 0.0, "collision_compliance": 0.0, "friction": 0.3,
        "eps_length": 1e-5, "eps_denominator": 1e-5,
        "static_inv_mass_eps": 1e-5, "fast_math": True}
CASES = {
    "rollout_reset_fast_math": dict(BASE),
    "warm_start": dict(BASE, lambda_mode="warm_start", lambda_decay=1.0,
                       substeps=4, fast_math=False,
                       gravity_is_acceleration=False),
    "colored_two_iterations": dict(BASE, solve_mode="colored", iterations=2,
                                   lambda_mode="decay"),
}
ENUMS = {"damping_mode": DampingMode, "solve_mode": SolveMode,
         "lambda_mode": LambdaMode, "floor_mode": FloorMode}


def port_config(s):
    kw = {k: (ENUMS[k](v) if k in ENUMS else v) for k, v in s.items()}
    kw["gravity"] = tuple(kw["gravity"])
    return SolverConfig(**kw)


def shaken(bodies, seed, mass):
    """Batched leaves of ``bodies`` res-4 lattices, perturbed from rest and
    raised off the floor by a few centimetres, with some velocity."""
    g = np.random.default_rng(seed)
    pts = ref.lattice_points(4, center=(0.0, 0.52, 0.0))
    pos = pts[None] + g.normal(0, 0.02, (bodies, 64, 3)).astype(np.float32)
    vel = g.normal(0, 0.5, (bodies, 64, 3)).astype(np.float32)
    ext = g.normal(0, 0.1, (bodies, 64, 3)).astype(np.float32)
    lam = g.normal(0, 1e-3, (bodies, 13 * 64)).astype(np.float32)
    w = np.full((bodies, 64), ref.inverse_mass(mass), np.float32)
    return {k: torch.as_tensor(a) for k, a in
            (("positions", pos), ("velocities", vel), ("ext_force", ext),
             ("lambda_dist", lam), ("inv_mass", w))}


def assert_bits(a, b):
    assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bodies", [1, 3])
def test_reference_equals_port_plain_engine(case, bodies):
    s = CASES[case]
    spec = top.lattice_spec(4, braced=True)
    cfg = port_config(s)
    leaves = shaken(bodies, 7, mass=0.001 if bodies == 1 else 1.0)
    eng = ref.Engine(ref.Lattice.of({"body": BODY}), s, bodies, "cpu")
    dt = 1.0 / 60.0 / s["substeps"]
    want = eng.run(leaves, dt, 6, with_ext=True)
    state = lat.make_lattice_state(spec, device="cpu")
    one = (lambda t: t[0]) if bodies == 1 else (lambda t: t)
    state = state.replace(**{k: one(leaves[k]) for k in leaves})
    run = (lat.run_substeps_plain if bodies == 1
           else lat.run_substeps_plain_batched)
    got = run(state, spec, cfg, dt, 6, with_ext=True)
    for k in ("positions", "velocities", "lambda_dist", "ext_force"):
        assert_bits(one(want[k]), getattr(got, k))


def test_reference_topology_equals_port():
    spec = top.lattice_spec(5, braced=True, size=(1.0, 1.2, 0.8))
    mine = ref.Lattice.of({"body": dict(BODY, res=5, size_m=[1.0, 1.2, 0.8])})
    assert mine.rest == spec.rest_lengths
    assert mine.compliance == spec.compliances
    assert tuple(f for f in ref.BRACED_FAMILIES) == spec.families
    np.testing.assert_array_equal(ref.lattice_points(5, (1.0, 1.2, 0.8),
                                                     (0.1, 0.6, 0.0)),
                                  top.lattice_points(5, (1.0, 1.2, 0.8),
                                                     (0.1, 0.6, 0.0)))
