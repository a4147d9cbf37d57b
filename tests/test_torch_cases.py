"""Lattice scenarios that hold two engines against each other, and tests of
the scenarios themselves.

Each case is a solver configuration, the inputs of a small lattice body
made by numpy from a seed (velocity jitter, pinned particles, an ext-force
patch), and a run length.  ``test_torch_lattice_engine.py`` holds the
port's plain engine against the JAX package's engine with them on the CPU;
``test_torch_kernel_on_card.py`` and ``chip_smoke.py`` hold the CUDA kernel
against the plain engine with them on the card.  Both packages'
``SolverConfig`` modules have the same fields, so ``parity_cases(config)``
builds the cases for either.  This module imports neither jax nor pytest,
so the card's scripts can import it on a host without JAX.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from softbodysimulation_tpu_torch.core import config as _port_config
from softbodysimulation_tpu_torch.topology.lattice import (lattice_points,
                                                           lattice_spec)


def parity_cases(C=_port_config):
    """``{name: (config, input kwargs, substeps)}``; ``substeps == "step"``
    means 3 frames of ``make_step`` (the ext-force lifecycle), else a raw
    substep runner at dt_sub = 1/480.  Input kwargs go to
    ``seeded_inputs`` (defaults: braced, mass 0.01, bottom layer 5 mm into
    the floor)."""
    floor = dict(ground_height=0.0, friction=0.3)
    ext = dict(ext_patch=(10, (90.0, 120.0, -70.0)))
    return {
        # bench.py:103-117
        "bench": (C.SolverConfig(
            substeps=8, iterations=1, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, lambda_mode=C.LambdaMode.RESET,
            gravity_is_acceleration=True, fast_math=True, **floor),
            dict(mass=0.001), 12),
        # __graft_entry__.py:19-28
        "entry": (C.SolverConfig(
            substeps=4, iterations=1, damping=0.02,
            solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, lambda_decay=1.0, **floor),
            dict(mass=1.0), 12),
        # core/scenes.py flagship with the body on its floor: non-braced
        # (reference anchor bounds), COLORED x 9, DECAY, clamps,
        # VELOCITY_REFLECT
        "flagship": (C.SolverConfig(
            substeps=4, iterations=9, damping=0.01,
            damping_mode=C.DampingMode.PER_DT,
            solve_mode=C.SolveMode.COLORED, lambda_mode=C.LambdaMode.DECAY,
            lambda_decay=0.99, max_dlambda_rel=0.1, lambda_clamp=100.0,
            min_alpha_tilde=1e-10,
            floor_mode=C.FloorMode.VELOCITY_REFLECT, restitution=0.3,
            floor_offset=0.001, ground_height=0.0),
            dict(braced=False, mass=1.0), 12),
        "colored_warm_start": (C.SolverConfig(
            substeps=6, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.COLORED,
            lambda_mode=C.LambdaMode.WARM_START, lambda_decay=0.98,
            warm_start_fraction=0.5, **floor), dict(), 18),
        "sphere_collider": (C.SolverConfig(
            substeps=6, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.COLORED, lambda_mode=C.LambdaMode.DECAY,
            sphere_colliders=((0.0, 0.35, 0.0, 0.45),), **floor),
            dict(center=(0.0, 0.8, 0.0)), 18),
        "velocity_world_clamps": (C.SolverConfig(
            substeps=6, iterations=2, damping=0.02,
            damping_mode=C.DampingMode.PER_DT,
            solve_mode=C.SolveMode.COLORED, lambda_mode=C.LambdaMode.DECAY,
            max_velocity=0.5, world_bounds=0.9, **floor),
            dict(jitter=0.5), 18),
        "guarded_jacobi_omega": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, lambda_mode=C.LambdaMode.DECAY,
            omega=1.5, max_dlambda=1e-3, collision_compliance=1e-6,
            **floor), dict(), 12),
        "pinned": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, **floor),
            dict(pins=(0, 5, 100, 215)), 12),
        # ext-force lifecycle in both gravity modes with max_force
        # clamping (tests/test_pallas_kernel.py:108-128)
        "ext_force_units": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.COLORED, max_force=60.0, **floor),
            ext, "step"),
        "ext_accel": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.COLORED, gravity_is_acceleration=True,
            max_force=60.0, **floor), ext, "step"),
    }


def run_length(cfg, substeps) -> Tuple[float, int, bool]:
    """(dt_sub, number of substeps, with_ext) of a case."""
    if substeps == "step":
        return 1 / 60 / cfg.substeps, 3 * cfg.substeps, True
    return 1 / 480, substeps, False


def seeded_inputs(res: int, braced: bool = True,
                  center=(0.0, 0.495, 0.0), mass: float = 0.01,
                  seed: int = 0, jitter: float = 0.05, pins=(),
                  ext_patch: Optional[Tuple[int, tuple]] = None
                  ) -> Dict[str, np.ndarray]:
    """The state fields of a res^3 lattice as float32 numpy arrays: rest
    positions, velocity jitter ~ N(0, jitter) from ``seed``, ``pins``
    pinned (w = 0, v = 0), and ``ext_patch=(count, force)`` on the first
    ``count`` particles; zero multipliers."""
    spec = lattice_spec(res, braced=braced)
    pos = lattice_points(res, spec.size, center)
    n = pos.shape[0]
    rng = np.random.default_rng(seed)
    vel = rng.normal(0.0, jitter, (n, 3)).astype(np.float32)
    w = np.full((n,), 0.0 if mass <= 1e-4 else 1.0 / mass, np.float32)
    w[list(pins)] = 0.0
    vel[list(pins)] = 0.0
    f = np.zeros((n, 3), np.float32)
    if ext_patch is not None:
        f[:ext_patch[0]] = ext_patch[1]
    return {
        "positions": pos, "velocities": vel, "inv_mass": w, "ext_force": f,
        "lambda_dist": np.zeros((spec.n_families * n,), np.float32),
        "lambda_bend": np.zeros((0,), np.float32),
        "lambda_volume": np.zeros((), np.float32),
    }


# ---- the scenarios cover what the slice promises --------------------------

def test_cases_cover_the_slice():
    """Every mode and knob the lattice slice supports is switched on by at
    least one case, so the parity tests that loop over the cases reach it."""
    C = _port_config
    cases = parity_cases()
    cfgs = [cfg for cfg, _, _ in cases.values()]
    kws = [kw for _, kw, _ in cases.values()]
    for mode in C.SolveMode:
        assert any(c.solve_mode == mode for c in cfgs), mode
    for mode in (C.LambdaMode.RESET, C.LambdaMode.DECAY,
                 C.LambdaMode.WARM_START):
        assert any(c.lambda_mode == mode for c in cfgs), mode
    for mode in (C.FloorMode.XPBD_INEQUALITY, C.FloorMode.VELOCITY_REFLECT):
        assert any(c.floor_mode == mode for c in cfgs), mode
    for mode in C.DampingMode:
        assert any(c.damping_mode == mode for c in cfgs), mode
    assert {c.fast_math for c in cfgs} == {True, False}
    assert {c.gravity_is_acceleration
            for c, _, n in cases.values() if n == "step"} == {True, False}
    assert all(c.max_force > 0 for c, _, n in cases.values() if n == "step")
    for knob in ("sphere_colliders", "max_velocity", "world_bounds",
                 "max_dlambda", "max_dlambda_rel", "lambda_clamp",
                 "min_alpha_tilde", "omega"):
        assert any(getattr(c, knob) for c in cfgs), knob
    assert {c.solve_mode for c in cfgs
            if c.lambda_mode == C.LambdaMode.WARM_START} == set(C.SolveMode)
    assert any(kw.get("pins") for kw in kws)
    assert any(kw.get("braced") is False for kw in kws)
    assert all(1 / 480 <= run_length(c, n)[0] and 12 <= run_length(c, n)[1]
               <= 18 for c, _, n in cases.values())


def test_seeded_inputs_are_reproducible_and_shaped():
    """Same seed, same arrays; the pins are fixed, the ext patch is where
    it was asked for, and the multiplier plane matches the lattice."""
    a = seeded_inputs(5, pins=(0, 7), ext_patch=(3, (1.0, 2.0, 3.0)))
    b = seeded_inputs(5, pins=(0, 7), ext_patch=(3, (1.0, 2.0, 3.0)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32, k
    n = 5 ** 3
    assert a["positions"].shape == (n, 3)
    assert a["lambda_dist"].shape == (
        lattice_spec(5, braced=True).n_families * n,)
    assert (a["inv_mass"][[0, 7]] == 0).all()
    assert (a["velocities"][[0, 7]] == 0).all()
    np.testing.assert_array_equal(a["ext_force"][:3], [[1.0, 2.0, 3.0]] * 3)
    assert not a["ext_force"][3:].any()
    c = seeded_inputs(5, seed=1)
    assert not np.array_equal(a["velocities"][1:7], c["velocities"][1:7])
