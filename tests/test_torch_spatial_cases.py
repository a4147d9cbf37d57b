"""Spatial (x-slab sharded) lattice scenarios that hold two engines against
each other, and tests of the scenarios themselves.

Each case is a solver configuration, the inputs of a small lattice body
made by numpy from a seed (``test_torch_cases.seeded_inputs``: velocity
jitter, pinned particles, an ext-force patch), a number of slabs D, the
lattice resolution and a number of frames.  ``test_torch_spatial.py``
holds the port's sharded engine against the JAX package's
``make_spatial_lattice_step`` with them on the CPU;
``test_torch_kernel_on_card.py`` and ``chip_smoke.py`` hold the slab
kernel (B-6) against the sharded engine with them on the card, for the
cases it carries (no tets or spheres, at least 2 planes a slab, D <= 4).
Both packages' ``SolverConfig`` modules have the same fields, so
``spatial_cases(config)`` builds the cases for either.  This module
imports neither jax nor pytest.
"""

import numpy as np

from softbodysimulation_tpu_torch.core import config as _port_config

from test_torch_cases import seeded_inputs

DT = 1 / 60


def spatial_cases(C=_port_config):
    """``{name: (config, input kwargs, D, res, frames)}``; the frames run
    as one call of the spatial step (ext force consumed on its first
    substep)."""
    floor = dict(ground_height=0.0, friction=0.3)
    base = dict(substeps=2, iterations=2, damping=0.02, **floor)
    J, CO = C.SolveMode.JACOBI, C.SolveMode.COLORED
    L = C.LambdaMode
    return {
        "colored_reset": (C.SolverConfig(
            solve_mode=CO, lambda_mode=L.RESET, **base), dict(), 4, 8, 6),
        "jacobi_decay": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.DECAY, lambda_decay=0.97, omega=1.3,
            max_dlambda_rel=0.2, lambda_clamp=50.0, **base),
            dict(), 2, 8, 6),
        "jacobi_warm_start": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.WARM_START, lambda_decay=0.99,
            warm_start_fraction=0.7, **base), dict(), 4, 8, 8),
        "colored_warm_start": (C.SolverConfig(
            solve_mode=CO, lambda_mode=L.WARM_START, lambda_decay=0.98,
            **base), dict(), 8, 8, 6),
        "velocity_reflect": (C.SolverConfig(
            solve_mode=CO, lambda_mode=L.DECAY, lambda_decay=0.99,
            floor_mode=C.FloorMode.VELOCITY_REFLECT, restitution=0.3,
            floor_offset=0.001, damping_mode=C.DampingMode.PER_DT,
            **base), dict(center=(0.0, 0.49, 0.0)), 1, 8, 8),
        "pinned": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.RESET, **base),
            dict(pins=(0, 100, 300, 511)), 4, 8, 8),
        "ext_force": (C.SolverConfig(
            solve_mode=CO, lambda_mode=L.DECAY, gravity_is_acceleration=True,
            max_force=60.0, **base),
            dict(ext_patch=(130, (90.0, 120.0, -70.0))), 2, 8, 4),
        "tets": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.RESET, enable_tet_volume=True,
            **base), dict(tets=True), 4, 8, 6),
        "tets_decay": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.DECAY, lambda_decay=0.97,
            enable_tet_volume=True, tet_compliance=1e-7, **base),
            dict(tets=True), 2, 8, 6),
        "sphere": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.DECAY, gravity_is_acceleration=True,
            sphere_colliders=((0.0, 0.25, 0.0, 0.45),), **base),
            dict(center=(0.0, 0.9, 0.0)), 4, 8, 10),
        # bench.py:103-117 with fast_math off (no spatial engine reads it)
        "bench": (C.SolverConfig(
            substeps=8, iterations=1, damping=0.02, solve_mode=J,
            lambda_mode=L.RESET, gravity_is_acceleration=True, **floor),
            dict(mass=0.001), 4, 8, 2),
        # the JAX suite's spatial-kernel shape (tests/test_spatial_pallas.py)
        "res16_over_8": (C.SolverConfig(
            solve_mode=J, lambda_mode=L.RESET, **base), dict(), 8, 16, 3),
    }


def case_inputs(res, tets=False, mass=1.0, **kw):
    """The state fields of a case (``seeded_inputs``; 1 kg particles unless
    the case says otherwise, stable at these substeps), with zero tet
    multipliers when ``tets``."""
    fields = seeded_inputs(res, mass=mass, **kw)
    if tets:
        fields["lambda_tet"] = np.zeros((6 * res ** 3,), np.float32)
    return fields


def kernel_carries(cfg, n_slabs, res) -> bool:
    """Whether the slab kernel B-6 carries a case: no tets or SDFs, at least
    two planes a slab, and at most four slabs (one card's cases)."""
    return (not cfg.enable_tet_volume and not cfg.sphere_colliders
            and res // n_slabs >= 2 and n_slabs <= 4)


# ---- the scenarios cover what the slice promises --------------------------

def test_spatial_cases_cover_the_slice():
    """Every mode, knob and slab count the spatial slice promises is
    switched on by at least one case, and the kernel carries most cases."""
    C = _port_config
    cases = spatial_cases()
    cfgs = [c for c, _, _, _, _ in cases.values()]
    for mode in C.SolveMode:
        assert any(c.solve_mode == mode for c in cfgs), mode
    for mode in (C.LambdaMode.RESET, C.LambdaMode.DECAY,
                 C.LambdaMode.WARM_START):
        assert any(c.lambda_mode == mode for c in cfgs), mode
    for mode in (C.FloorMode.XPBD_INEQUALITY, C.FloorMode.VELOCITY_REFLECT):
        assert any(c.floor_mode == mode for c in cfgs), mode
    assert {d for _, _, d, _, _ in cases.values()} == {1, 2, 4, 8}
    assert any(kw.get("pins") for _, kw, _, _, _ in cases.values())
    assert any(kw.get("ext_patch") for _, kw, _, _, _ in cases.values())
    assert {c.lambda_mode for c in cfgs if c.enable_tet_volume} == {
        C.LambdaMode.RESET, C.LambdaMode.DECAY}
    assert any(c.sphere_colliders for c in cfgs)
    assert any(res == 16 and d == 8 for _, _, d, res, _ in cases.values())
    assert all(res % d == 0 and frames <= 10
               for _, _, d, res, frames in cases.values())
    carried = [n for n, (c, _, d, r, _) in cases.items()
               if kernel_carries(c, d, r)]
    assert len(carried) == 7, carried


def test_case_inputs_pins_land_on_two_slabs():
    """The pinned case pins particles on different slabs, and its inputs
    are reproducible."""
    cfg, kw, d, res, _ = spatial_cases()["pinned"]
    a, b = case_inputs(res, **kw), case_inputs(res, **kw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    pinned = np.flatnonzero(a["inv_mass"] == 0)
    per_slab = res ** 3 // d
    assert len({int(i) // per_slab for i in pinned}) >= 2
    t = case_inputs(4, tets=True)
    assert t["lambda_tet"].shape == (6 * 64,)
