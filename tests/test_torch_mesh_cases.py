"""Mesh scenarios that hold two engines against each other, and tests of
the scenarios themselves.

Each case is a solver configuration, a small mesh body (an icosphere of
162 particles / 480 edges, or a 12 x 12 cloth of 144 particles whose rest
shape has seeded out-of-plane jitter, so that no hinge sits at the flat
boundary of the bending masks), the inputs of its state made by numpy
from a seed (velocity jitter, pinned particles, an ext-force patch), and a
number of 1/60 s frames.  ``test_torch_general_engine.py`` holds the
port's plain general engine against the JAX package's with them on the
CPU; ``test_torch_kernel_on_card.py`` and ``chip_smoke.py`` hold the CUDA
mesh kernel against the plain engine with them on the card.  Both
packages' builder modules have the same functions, so
``case_topology(kind, build, mesh)`` builds the body with either.  This
module imports neither jax nor pytest.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from softbodysimulation_tpu_torch.core import config as _port_config
from softbodysimulation_tpu_torch.topology import build as _port_build
from softbodysimulation_tpu_torch.topology import mesh as _port_mesh

# gates of the JAX suite's mesh kernel-vs-engine tests
# (tests/test_mesh_pallas.py:48,182,203,221,530)
DX_JACOBI = 2e-5
DX_COLORED = 1e-5
DLAM_DIST = 1e-6
DLAM_BEND = 5e-6


def _cloth_mesh(mesh, res=12, seed=7, z_jitter=0.01):
    """The cloth scene's standing plane with seeded out-of-plane jitter."""
    m = mesh.grid_plane(1.0, res)
    verts = m.vertices[:, [0, 2, 1]].copy()
    verts[:, 2] = np.random.default_rng(seed).normal(
        0.0, z_jitter, verts.shape[0]).astype(np.float32)
    return mesh.TriMesh(verts, m.triangles)


# kind -> (mesh builder, topology_from_mesh kwargs, lift along y)
KINDS = {
    "sphere": (lambda mesh: mesh.icosphere(2),
               dict(compliance=1e-3, windowed=True), 0.98),
    "sphere_bend": (lambda mesh: mesh.icosphere(2),
                    dict(compliance=1e-3, bending=True,
                         bend_compliance=1e-3, windowed=True), 0.98),
    # clear of the floor: contact switching at pen ~ 0 amplifies ulps
    # (tests/test_mesh_pallas.py:137-148)
    "sphere_bend_high": (lambda mesh: mesh.icosphere(2),
                         dict(compliance=1e-3, bending=True,
                              bend_compliance=1e-3, windowed=True), 5.0),
    # the cpu_mesh scene's body at icosphere 2
    "sphere_colored": (lambda mesh: mesh.icosphere(2, radius=0.5),
                       dict(compliance=1e-10, windowed="colored"), 0.49),
    "sphere_colored_bend": (lambda mesh: mesh.icosphere(2),
                            dict(compliance=1e-3, bending=True,
                                 bend_compliance=1e-3, windowed="colored"),
                            0.98),
    "cloth": (_cloth_mesh,
              dict(compliance=1e-5, bending=True, bend_compliance=1e-3,
                   windowed=True), 1.2),
}


def case_topology(kind: str, build=_port_build, mesh=_port_mesh):
    """(positions (N,3) f32, topology) of a case's body, built with the
    given package's ``topology.build`` and ``topology.mesh`` modules."""
    make, kw, lift = KINDS[kind]
    pos, topo = build.topology_from_mesh(make(mesh), **kw)
    return pos + np.array([0.0, lift, 0.0], np.float32), topo


def mesh_cases(C=_port_config):
    """``{name: (config, kind, input kwargs, frames)}``.  Input kwargs go to
    ``seeded_inputs``; every case runs ``frames`` frames of ``make_step``
    at dt = 1/60 (12-20 substeps), the ext force consumed on the first."""
    floor = dict(ground_height=0.0, friction=0.3)
    jac = dict(substeps=4, iterations=4, damping=0.02,
               solve_mode=C.SolveMode.JACOBI, lambda_decay=0.98, **floor)
    cases = {}
    for lmode in (C.LambdaMode.RESET, C.LambdaMode.DECAY,
                  C.LambdaMode.WARM_START):
        for rho in (0.0, 0.9):
            name = f"jacobi_{lmode.value}_rho{rho:g}"
            cases[name] = (C.SolverConfig(lambda_mode=lmode, jacobi_rho=rho,
                                          **jac), "sphere", {}, 4)
    ext = dict(ext_patch=(10, (4.0, 8.0, 2.0)))
    cases.update({
        "velocity_reflect": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            damping_mode=C.DampingMode.PER_DT,
            solve_mode=C.SolveMode.JACOBI, lambda_mode=C.LambdaMode.DECAY,
            floor_mode=C.FloorMode.VELOCITY_REFLECT, restitution=0.3,
            floor_offset=0.001, ground_height=0.0), "sphere", {}, 4),
        # core/scenes.py cpu_mesh at icosphere 2, with 0.2 kg particles:
        # its near-rigid edges (compliance 1e-10) turn an ulp of length
        # into ~ulp / (w_a + w_b) of multiplier, which unit masses would
        # bring to the 1e-6 gate over 180 Gauss-Seidel sweeps
        "colored": (C.SolverConfig(
            substeps=1, iterations=15, damping=0.01,
            gravity=(0.0, -1.0, 0.0), solve_mode=C.SolveMode.COLORED,
            max_dlambda=1e-3, ground_height=0.0, friction=0.1),
            "sphere_colored", dict(mass=0.2), 12),
        "colored_bending": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.COLORED,
            lambda_mode=C.LambdaMode.WARM_START, lambda_decay=0.98,
            enable_bending=True, lambda_clamp=0.05, **floor),
            "sphere_colored_bend", {}, 4),
        # core/scenes.py cloth, top row pinned
        "cloth": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.03,
            solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, lambda_decay=1.0,
            enable_bending=True, ground_height=0.0, friction=0.4),
            "cloth", dict(pins="top"), 4),
        "sphere_collider_clamps": (C.SolverConfig(
            substeps=4, iterations=4, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, lambda_mode=C.LambdaMode.DECAY,
            sphere_colliders=((0.9, 1.0, 0.0, 0.3),),
            max_dlambda=5e-3, max_dlambda_rel=0.1, lambda_clamp=0.02,
            min_alpha_tilde=1e-3, max_velocity=0.5, world_bounds=1.5,
            omega=0.8, **floor), "sphere", {}, 4),
        # ext-force lifecycle in both gravity modes with max_force
        "ext_force_units": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, max_force=6.0, **floor),
            "sphere", ext, 3),
        "ext_accel": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, gravity_is_acceleration=True,
            max_force=6.0, **floor), "sphere", ext, 3),
        "pinned": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, enable_bending=True,
            **floor), "sphere_bend", dict(pins=(0, 5, 40, 100)), 4),
    })
    return cases


def seeded_inputs(positions: np.ndarray, n_edges: int, n_hinges: int,
                  seed: int = 0, jitter: float = 0.05, mass: float = 1.0,
                  pins=(),
                  ext_patch: Optional[Tuple[int, tuple]] = None
                  ) -> Dict[str, np.ndarray]:
    """The state fields of a body at ``positions`` as float32 numpy arrays:
    particles of ``mass``, velocity jitter ~ N(0, jitter) from ``seed``,
    ``pins`` pinned (w = 0, v = 0; "top" = the highest row), and
    ``ext_patch=(count, force)`` on the first ``count`` particles; zero
    multipliers."""
    n = positions.shape[0]
    if isinstance(pins, str):
        pins = np.flatnonzero(positions[:, 1] > positions[:, 1].max() - 1e-4)
    pins = list(pins)
    vel = np.random.default_rng(seed).normal(0.0, jitter,
                                             (n, 3)).astype(np.float32)
    w = np.full((n,), 1.0 / mass, np.float32)
    w[pins] = 0.0
    vel[pins] = 0.0
    f = np.zeros((n, 3), np.float32)
    if ext_patch is not None:
        f[:ext_patch[0]] = ext_patch[1]
    return {
        "positions": np.asarray(positions, np.float32), "velocities": vel,
        "inv_mass": w, "ext_force": f,
        "lambda_dist": np.zeros((n_edges,), np.float32),
        "lambda_bend": np.zeros((n_hinges,), np.float32),
        "lambda_volume": np.zeros((), np.float32),
    }


def case_inputs(kind: str, build=_port_build, mesh=_port_mesh, **kw):
    """(topology, state fields) of a case, with either package's
    builders."""
    pos, topo = case_topology(kind, build, mesh)
    return topo, seeded_inputs(pos, int(topo.n_edges), int(topo.n_hinges),
                               **kw)


def dx_gate(cfg) -> float:
    return DX_COLORED if cfg.solve_mode.value == "colored" else DX_JACOBI


# ---- the scenarios cover what the slice promises --------------------------

def test_mesh_cases_cover_the_slice():
    """Every mode and knob the mesh slice supports is switched on by at
    least one case, so the parity tests that loop over the cases reach
    it."""
    C = _port_config
    cases = mesh_cases()
    cfgs = [cfg for cfg, _, _, _ in cases.values()]
    jacobi = [c for c in cfgs if c.solve_mode == C.SolveMode.JACOBI]
    for lmode in (C.LambdaMode.RESET, C.LambdaMode.DECAY,
                  C.LambdaMode.WARM_START):
        assert {c.jacobi_rho > 0 and c.iterations > c.jacobi_cheby_delay
                for c in jacobi if c.lambda_mode == lmode} == {True, False}
    for mode in (C.FloorMode.XPBD_INEQUALITY, C.FloorMode.VELOCITY_REFLECT):
        assert any(c.floor_mode == mode for c in cfgs), mode
    for mode in C.DampingMode:
        assert any(c.damping_mode == mode for c in cfgs), mode
    assert {(c.solve_mode, c.enable_bending) for c in cfgs} == {
        (m, b) for m in C.SolveMode for b in (False, True)}
    assert {c.gravity_is_acceleration for c, _, kw, _ in cases.values()
            if kw.get("ext_patch")} == {True, False}
    assert all(c.max_force > 0 for c, _, kw, _ in cases.values()
               if kw.get("ext_patch"))
    for knob in ("sphere_colliders", "max_velocity", "world_bounds",
                 "max_dlambda", "max_dlambda_rel", "lambda_clamp",
                 "min_alpha_tilde", "omega"):
        assert any(getattr(c, knob) for c in cfgs), knob
    assert any(kw.get("pins") for _, _, kw, _ in cases.values())
    assert all(12 <= c.substeps * frames <= 20
               for c, _, _, frames in cases.values())


def test_case_bodies_are_seeded_and_shaped():
    """Same seed, same arrays; the cloth's rest shape is out of plane, the
    top row is what "top" pins, and the multipliers match the topology."""
    topo, a = case_inputs("cloth", pins="top", ext_patch=(3, (1.0, 2.0,
                                                              3.0)))
    _, b = case_inputs("cloth", pins="top", ext_patch=(3, (1.0, 2.0, 3.0)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32, k
    pos = a["positions"]
    assert pos.shape == (144, 3) and np.abs(pos[:, 2]).min() > 0
    top = a["inv_mass"] == 0
    assert top.sum() == 12
    assert np.allclose(pos[top, 1], pos[:, 1].max())
    assert a["lambda_dist"].shape == (topo.n_edges,)
    assert a["lambda_bend"].shape == (topo.n_hinges,) and topo.n_hinges > 0
    np.testing.assert_array_equal(a["ext_force"][:3], [[1.0, 2.0, 3.0]] * 3)
    sph, _ = case_topology("sphere")
    assert sph.shape == (162, 3)
