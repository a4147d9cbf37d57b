"""Scenarios of the global volume (pressure) constraint that hold two engines
against each other, and tests of the scenarios themselves.

Each case is a solver configuration with ``enable_volume``, a body count
and a number of 1/60 s frames.  The body is example 3's inflated ball cut
to ``icosphere(2, 0.4)`` (162 particles, 320 triangles; a windowed
topology, compliance 5e-4) above a sphere collider, as
``tests/test_mesh_pallas.py:760-805`` and ``examples/config3_inflated_ball
.py`` set it up; with the per-tet volume the ball is filled with a
centroid fan (320 tets about one more particle); an ensemble is
``n_bodies`` copies, body b shifted by b x (0.11, 0.05, -0.07), with seeded
velocity noise and a ``(B,)`` ``lambda_volume``.  ``test_torch_volume.py`` holds the port's plain engine
and the B-3 runners' plain twins against the JAX package with them on the
CPU; ``test_torch_kernel_on_card.py`` and ``chip_smoke.py`` (phase 38)
hold B-3 against its plain twin with them on the card.  This module
imports neither jax nor pytest.
"""

from typing import Dict

import numpy as np

from softbodysimulation_tpu_torch.core import config as _port_config
from softbodysimulation_tpu_torch.topology import build as _port_build
from softbodysimulation_tpu_torch.topology import mesh as _port_mesh
from softbodysimulation_tpu_torch.topology import tets as _port_tets

DT = 1.0 / 60.0
# gates: positions as the mesh cases' JACOBI gate (COLORED 1e-5), and the
# volume multiplier within the JAX suite's own band between its kernel and
# its engine (tests/test_mesh_pallas.py:781)
DX = 2e-5
DX_COLORED = 1e-5
DLAM_VOLUME = 1e-4
# On the card B-3 equals its plain twin to the bit, except beside dense
# contact: the kernel adds a particle's pairs in its own order, the plain
# pass through matrix products, so there positions are held to the contact
# cases' 2e-4 (test_torch_contact_cases.DX_CONTACT), the volume multiplier
# to DLAM_VOLUME and the others to 1 % of their largest
DX_CARD_CONTACT = 2e-4
# dense contact between the ball's own particles: twice this is above the
# shorter of its edges (0.110-0.130), so the contact fires from the start
CONTACT_RADIUS = 0.058


def volume_cases(C=_port_config):
    """``{name: (config, n_bodies, frames)}``: every solve mode (COLORED,
    JACOBI, Chebyshev) under every lambda mode, example 3's own config,
    bending with pins, dense self-collision (the contacts after the
    volume) and the per-tet volume (the tets before it) in JACOBI and
    COLORED and dense contact in an ensemble, and ensembles of two and
    three bodies."""
    vol = dict(enable_volume=True, pressure=1.5, volume_compliance=1e-4,
               damping=0.02, lambda_decay=0.97,
               sphere_colliders=((0.0, 0.0, 0.0, 0.8),),
               ground_height=-2.0, friction=0.4)
    contact = dict(enable_self_collision=True, self_collision_backend="dense",
                   particle_radius=CONTACT_RADIUS)
    tet = dict(enable_tet_volume=True, tet_pressure=1.2)
    cases = {}
    for lmode in (C.LambdaMode.RESET, C.LambdaMode.DECAY,
                  C.LambdaMode.WARM_START):
        for mode, rho in (("colored", 0.0), ("jacobi", 0.0),
                          ("cheby", 0.9)):
            solve = (C.SolveMode.COLORED if mode == "colored"
                     else C.SolveMode.JACOBI)
            cases[f"{mode}_{lmode.value}"] = (C.SolverConfig(
                substeps=4, iterations=3, solve_mode=solve, jacobi_rho=rho,
                lambda_mode=lmode, **vol), 1, 3)
    cases.update({
        # examples/config3_inflated_ball.py's config
        "inflated_ball": (C.SolverConfig(
            substeps=4, iterations=4, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, enable_volume=True,
            volume_compliance=0.0, pressure=1.15,
            sphere_colliders=((0.0, 0.0, 0.0, 0.8),), ground_height=-2.0,
            friction=0.4), 1, 4),
        "contact_jacobi": (C.SolverConfig(
            substeps=4, iterations=3, solve_mode=C.SolveMode.JACOBI,
            **contact, **vol), 1, 3),
        "contact_colored": (C.SolverConfig(
            substeps=4, iterations=3, solve_mode=C.SolveMode.COLORED,
            **contact, **vol), 1, 3),
        "tets_jacobi": (C.SolverConfig(
            substeps=4, iterations=3, solve_mode=C.SolveMode.JACOBI,
            **tet, **vol), 1, 3),
        # the fan's centre is in every tet: 320 tet colours, so cut short
        "tets_colored": (C.SolverConfig(
            substeps=2, iterations=2, solve_mode=C.SolveMode.COLORED,
            **tet, **vol), 1, 1),
        "bending_clamps": (C.SolverConfig(
            substeps=4, iterations=2, solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, enable_bending=True,
            max_dlambda=5e-3, lambda_clamp=0.05, omega=0.8, **vol), 1, 3),
        # tests/test_mesh_pallas.py:799's ensemble, and three bodies with
        # Chebyshev
        "ensemble_decay": (C.SolverConfig(
            substeps=2, iterations=2, solve_mode=C.SolveMode.JACOBI,
            jacobi_rho=0.9, lambda_mode=C.LambdaMode.DECAY, **vol), 2, 2),
        "ensemble_warm": (C.SolverConfig(
            substeps=4, iterations=3, solve_mode=C.SolveMode.JACOBI,
            jacobi_rho=0.9, lambda_mode=C.LambdaMode.WARM_START, **vol), 3,
            2),
        "ensemble_contact": (C.SolverConfig(
            substeps=2, iterations=2, solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.DECAY, **contact, **vol), 2, 2),
    })
    return cases


def mixed(cfg) -> bool:
    """The volume beside dense contact or the per-tet volume."""
    return cfg.enable_self_collision or cfg.enable_tet_volume


def card_exact(cfg) -> bool:
    """Whether the kernel must equal its plain twin to the bit on the
    card (``DX_CARD_CONTACT`` says why not beside dense contact)."""
    return not cfg.enable_self_collision


def dx_gate(cfg) -> float:
    return DX_COLORED if cfg.solve_mode.value == "colored" else DX


def ball(build=_port_build, mesh=_port_mesh, bending=False, solid=False,
         tets=_port_tets):
    """(positions (N, 3) f32 lifted to y = 1.3, topology) of the ball, with
    either package's builders; ``bending=True`` adds its hinges,
    ``solid=True`` fills it with a centroid fan of tets (compliance 1e-5)
    whose surface is the ball's triangles."""
    m = mesh.icosphere(2, radius=0.4)
    if solid:
        verts, tt = tets.tets_from_surface_centroid(m.vertices, m.triangles)
        pos, topo = build.build_windowed_topology(
            verts.astype(np.float32), tets.tet_edges(tt), 5e-4,
            triangles=m.triangles, tets=tt, tet_compliance=1e-5)
    else:
        kw = dict(bending=True, bend_compliance=1e-3) if bending else {}
        pos, topo = build.topology_from_mesh(m, compliance=5e-4,
                                             windowed=True, **kw)
    return pos + np.array([0.1, 1.3, 0.0], np.float32), topo


def inputs(pos, topo, n_bodies: int = 1, seed: int = 0,
           pins=()) -> Dict[str, np.ndarray]:
    """State fields as float32 numpy arrays: velocities ~ N(0, 0.05) from
    ``seed``, ``pins`` pinned, zero multipliers; with ``n_bodies > 1`` a
    batched state (body b shifted, its own noise, a shared ``(N,)``
    inv_mass, a ``(B,)`` lambda_volume)."""
    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    w = np.ones((n,), np.float32)
    w[list(pins)] = 0.0
    bodies = []
    for b in range(n_bodies):
        v = rng.normal(0.0, 0.05, (n, 3)).astype(np.float32)
        v[list(pins)] = 0.0
        bodies.append({
            "positions": (pos + np.array([0.11 * b, 0.05 * b, -0.07 * b],
                                         np.float32)).astype(np.float32),
            "velocities": v, "ext_force": np.zeros((n, 3), np.float32),
            "lambda_dist": np.zeros((int(topo.n_edges),), np.float32),
            "lambda_bend": np.zeros((int(topo.n_hinges),), np.float32),
            "lambda_volume": np.zeros((), np.float32)})
        if topo.n_tets:
            bodies[-1]["lambda_tet"] = np.zeros((int(topo.n_tets),),
                                                np.float32)
    if n_bodies == 1:
        return dict(bodies[0], inv_mass=w)
    out = {k: np.stack([b[k] for b in bodies]) for k in bodies[0]}
    out["inv_mass"] = w
    return out


def case_inputs(name: str, build=_port_build, mesh=_port_mesh, C=None,
                tets=_port_tets):
    """(config, topology, state fields, n_bodies, frames) of a case."""
    cfg, nb, frames = volume_cases(C or _port_config)[name]
    pos, topo = ball(build, mesh, bending=cfg.enable_bending,
                     solid=cfg.enable_tet_volume, tets=tets)
    pins = (0, 5) if cfg.enable_bending else ()
    return cfg, topo, inputs(pos, topo, nb, pins=pins), nb, frames


# ---- the scenarios cover what the slice promises --------------------------

def test_volume_cases_cover_the_slice():
    """Every solve mode under every lambda mode, the pressure without
    compliance, bending, dense contact and tets in JACOBI and COLORED,
    and ensembles (with and without Chebyshev, with contact)."""
    C = _port_config
    cfgs = volume_cases()
    assert all(c.enable_volume for c, _, _ in cfgs.values())
    for lmode in C.LambdaMode:
        for solve in C.SolveMode:
            assert any(c.lambda_mode == lmode and c.solve_mode == solve
                       for c, nb, _ in cfgs.values() if nb == 1)
    assert any(c.volume_compliance == 0.0 for c, _, _ in cfgs.values())
    assert any(c.enable_bending for c, _, _ in cfgs.values())
    assert {nb for _, nb, _ in cfgs.values()} == {1, 2, 3}
    for flag in ("enable_self_collision", "enable_tet_volume"):
        assert {c.solve_mode for c, nb, _ in cfgs.values()
                if getattr(c, flag) and nb == 1} == {C.SolveMode.JACOBI,
                                                     C.SolveMode.COLORED}
    assert any(c.enable_self_collision for c, nb, _ in cfgs.values()
               if nb > 1)


def test_case_inputs_are_seeded_and_batched():
    _, topo, a, _, _ = case_inputs("ensemble_warm")
    _, _, b, _, _ = case_inputs("ensemble_warm")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32, k
    assert a["positions"].shape == (3, topo.n_particles, 3)
    assert a["lambda_volume"].shape == (3,)
    assert a["inv_mass"].shape == (topo.n_particles,)
    assert topo.triangles.shape[0] == 320
    _, topo, f, _, _ = case_inputs("tets_colored")
    assert (topo.n_particles, topo.n_tets) == (163, 320)
    assert f["lambda_tet"].shape == (320,)
