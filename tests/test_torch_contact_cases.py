"""Tet and contact scenarios that hold two engines against each other, and
tests of the scenarios themselves.

* Clouds: seeded uniform particle clouds in [-0.5, 0.5]^3 (1,000 particles
  of unit mass; 777 with every fifth particle pinned, so the last block is
  padded), for one self-collision pass of each backend.
* Tet bodies: ``cube3``, the ``tet_cube`` scene's res-3 Kuhn lattice (48
  tets, COLORED), and ``ball1``, the ``tet_ball`` scene's centroid-fan
  icosphere 1 (80 tets around one hub particle, JACOBI), with seeded
  velocity jitter.
* Contact scenes: the ``ball_on_cloth`` shape at cloth_res 14 with the ball
  already touching the cloth (``contact_scene``), so that contact fires from
  the first substep; and the 20,243-particle ball-on-cloth of
  ``scripts/bench_multibody_scale.py`` (``scaled_ball_on_cloth``, run only
  on the card).

Both packages' builder modules have the same functions, so every builder
here takes the package's modules (``modules()``).  ``test_torch_tets.py``,
``test_torch_contact.py`` and ``test_torch_multibody.py`` hold the port's
plain engine against the JAX package's with these cases on the CPU;
``test_torch_kernel_on_card.py`` and ``chip_smoke.py`` hold the CUDA
kernels against the plain engine with them on the card.  This module
imports neither jax nor pytest.
"""

import importlib
import types
from typing import Dict

import numpy as np

from softbodysimulation_tpu_torch.core import config as _port_config

import test_torch_mesh_cases as mesh_cases

# gates of the JAX suite: one contact pass (tests/test_contact_pallas.py:45,
# 60); tets, kernel or engine (tests/test_tets.py:382-383, 520-521);
# contact-rich rollouts of <= 3 frames, where Jacobi frames amplify the
# ~1e-7 Gram-boundary noise (tests/test_mesh_pallas.py:889-891)
DX_PASS = 1e-5
DX_TET = 2e-5
DLAM_TET = 1e-5
DX_CONTACT = 2e-4


def modules(package: str = "softbodysimulation_tpu_torch"):
    """The topology modules of a package (``build``, ``mesh``, ``tets``,
    ``edges``, ``lattice``)."""
    return types.SimpleNamespace(**{
        m: importlib.import_module(f"{package}.topology.{m}")
        for m in ("build", "mesh", "tets", "edges", "lattice")})


# ---- clouds -----------------------------------------------------------------

# name -> (particles, seed, every fifth pinned, block_neighbors)
CLOUDS = {"cloud1000": (1000, 0, False, 4), "cloud777": (777, 3, True, 3)}
BACKENDS = ("hash", "dense", "blocked", "sorted")


def cloud(name: str):
    """(positions (N, 3), inverse masses (N,)) float32 of a seeded cloud."""
    n, seed, mixed, _ = CLOUDS[name]
    x = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, 3))
    w = (np.where(np.arange(n) % 5 == 0, 0.0, 1.0) if mixed
         else np.ones(n))
    return x.astype(np.float32), w.astype(np.float32)


def cloud_config(name: str, backend: str, C=_port_config, **kw):
    """One pass of ``backend`` at contact radius 0.05, blocks of 128."""
    base = dict(enable_self_collision=True, self_collision_backend=backend,
                particle_radius=0.05, collision_block_size=128,
                block_neighbors=CLOUDS[name][3], sorted_window=4)
    base.update(kw)
    return C.SolverConfig(**base)


# ---- tet bodies -------------------------------------------------------------

def tet_body(kind: str, mods):
    """(positions (N, 3) f32, topology) of a tet body, built with the given
    package's modules."""
    if kind == "cube3":
        pos = (mods.lattice.lattice_points(3)
               + np.array([0, 1.0, 0], np.float32))
        tt = mods.tets.fix_orientation(pos, mods.tets.cube_lattice_tets(3))
        topo = mods.build.build_topology(
            pos, mods.tets.tet_edges(tt), compliance=1e-4, tets=tt,
            tet_compliance=1e-6, triangles=mods.tets.boundary_faces(tt))
        return np.asarray(pos, np.float32), topo
    m = mods.mesh.icosphere(1, radius=0.5)
    verts, tt = mods.tets.tets_from_surface_centroid(m.vertices, m.triangles)
    pos, topo = mods.build.build_windowed_topology(
        verts, mods.tets.tet_edges(tt), 1e-4, tets=tt, tet_compliance=0.0,
        triangles=mods.tets.boundary_faces(tt))
    return pos + np.array([0, 1.0, 0], np.float32), topo


def tet_cases(C=_port_config):
    """``{name: (config, kind, input kwargs, frames)}``: the ``tet_cube``
    (COLORED) and ``tet_ball`` (JACOBI, Chebyshev, tet_pressure 1.05)
    configurations in each lambda mode, and a pinned ball."""
    cases = {}
    for lmode in (C.LambdaMode.RESET, C.LambdaMode.DECAY,
                  C.LambdaMode.WARM_START):
        cases[f"cube_colored_{lmode.value}"] = (C.SolverConfig(
            substeps=4, iterations=6, damping=0.01,
            solve_mode=C.SolveMode.COLORED, enable_tet_volume=True,
            lambda_mode=lmode, lambda_decay=0.98, ground_height=0.0,
            friction=0.2), "cube3", {}, 3)
        # the fan's thin tets turn an ulp of position into ~1e-4 of their
        # multiplier's size, which DECAY accumulates: one frame there
        cases[f"ball_jacobi_{lmode.value}"] = (C.SolverConfig(
            substeps=4, iterations=8, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, enable_tet_volume=True,
            tet_pressure=1.05, lambda_mode=lmode, lambda_decay=0.98,
            ground_height=0.0, friction=0.3), "ball1", {},
            1 if lmode == C.LambdaMode.DECAY else 3)
    cases["ball_pinned"] = (C.SolverConfig(
        substeps=4, iterations=8, damping=0.02,
        solve_mode=C.SolveMode.JACOBI, enable_tet_volume=True,
        tet_pressure=1.05, ground_height=0.0, friction=0.3), "ball1",
        dict(pins=(0, 5, 40)), 2)
    return cases


def tet_inputs(kind: str, mods, **kw):
    """(topology, state fields) of a tet case: the mesh cases' seeded
    inputs plus zero tet multipliers."""
    pos, topo = tet_body(kind, mods)
    fields = mesh_cases.seeded_inputs(pos, int(topo.n_edges),
                                      int(topo.n_hinges), **kw)
    fields["lambda_tet"] = np.zeros((int(topo.n_tets),), np.float32)
    return topo, fields


# ---- contact scenes ---------------------------------------------------------

def ball_on_cloth_body(mods, cloth_res=24, cloth_size=1.2, ball_subdiv=1,
                       ball_radius=0.18, ball_y=1.45):
    """(positions, topology, cloth particle count) of a ball-on-cloth: an XZ
    cloth at y = 1 (stiff, bending) and a centroid-fan ball centred at
    ``ball_y`` (softer shell, incompressible tets), merged with identity
    order (``core/scenes.py:378-446`` of the JAX package)."""
    cm = mods.mesh.grid_plane(cloth_size, cloth_res)
    cverts = cm.vertices + np.array([0.0, 1.0, 0.0], np.float32)
    bm = mods.mesh.icosphere(ball_subdiv, radius=ball_radius)
    bverts, btets = mods.tets.tets_from_surface_centroid(bm.vertices,
                                                         bm.triangles)
    bverts = (bverts + np.array([0.0, ball_y, 0.0])).astype(np.float32)
    pos, topo, _ = mods.build.merge_topologies([
        mods.build.BodySpec(cverts, mods.edges.unique_edges(cm.triangles),
                            1e-5, hinges=mods.edges.hinges(cm.triangles),
                            bend_compliance=1e-3, triangles=cm.triangles),
        mods.build.BodySpec(bverts, mods.tets.tet_edges(btets), 1e-4,
                            triangles=mods.tets.boundary_faces(btets),
                            tets=btets, tet_compliance=0.0),
    ], windowed=True)
    return pos, topo, cverts.shape[0]


def rim(n_cloth: int, cloth_res: int) -> np.ndarray:
    ii, jj = np.divmod(np.arange(n_cloth), cloth_res)
    return np.flatnonzero((ii % (cloth_res - 1) == 0)
                          | (jj % (cloth_res - 1) == 0))


def contact_fields(pos, topo, pins) -> Dict[str, np.ndarray]:
    """Unit masses at rest, ``pins`` pinned, zero multipliers."""
    n = pos.shape[0]
    w = np.ones(n, np.float32)
    w[pins] = 0.0
    z = np.zeros
    return {"positions": np.asarray(pos, np.float32),
            "velocities": z((n, 3), np.float32), "inv_mass": w,
            "ext_force": z((n, 3), np.float32),
            "lambda_dist": z((int(topo.n_edges),), np.float32),
            "lambda_bend": z((int(topo.n_hinges),), np.float32),
            "lambda_volume": z((), np.float32),
            "lambda_tet": z((int(topo.n_tets),), np.float32)}


CONTACT_RES = 14


def contact_scene(mods, seed=11, jitter=0.004):
    """(topology, state fields, cloth particles) of the small contact scene
    (``tests/test_mesh_pallas.py:830-867``): cloth_res 14, the ball's lower
    pole at the cloth plane, the rim pinned.  The cloth's particles start
    off its plane by seeded jitter ~ N(0, 0.004) (its rest shape stays
    flat), so that no hinge sits at the flat boundary of the bending masks,
    where one ulp of contact correction flips them."""
    pos, topo, nc = ball_on_cloth_body(mods, cloth_res=CONTACT_RES,
                                       ball_y=1.17)
    pos = pos.copy()
    pos[:nc, 1] += np.random.default_rng(seed).normal(
        0.0, jitter, nc).astype(np.float32)
    return topo, contact_fields(pos, topo, rim(nc, CONTACT_RES)), nc


def contact_cases(C=_port_config):
    """``{name: (config, frames)}`` on ``contact_scene``: dense contact on
    every substep and every 2nd, blocked (blocks of 32, 4 candidates) every
    3rd of 6 substeps."""
    spacing = 1.2 / (CONTACT_RES - 1)
    base = dict(substeps=4, iterations=3, damping=0.02,
                solve_mode=C.SolveMode.JACOBI, enable_bending=True,
                enable_tet_volume=True, tet_pressure=1.05,
                enable_self_collision=True, self_collision_backend="dense",
                particle_radius=round(0.45 * spacing, 4),
                ground_height=0.0, friction=0.3)
    return {
        "dense_every1": (C.SolverConfig(**base), 3),
        "dense_every2": (C.SolverConfig(**dict(
            base, self_collision_every=2)), 2),
        "blocked_every3": (C.SolverConfig(**dict(
            base, substeps=6, self_collision_backend="blocked",
            collision_block_size=32, block_neighbors=4,
            self_collision_every=3)), 3),
    }


def scaled_ball_on_cloth(mods, C=_port_config, cloth_res=140,
                         cloth_size=3.5, ball_radius=0.3):
    """The ball-on-cloth of ``scripts/bench_multibody_scale.py:55-102`` at
    its parameters: a res-140 cloth of size 3.5 and an icosphere-3 ball of
    radius 0.3 (20,243 particles, 1,280 tets), 6 substeps x 4 iterations,
    JACOBI, bending, tet_pressure 1.05, blocked contact every 3rd substep
    in blocks of 128 with 32 candidates (the script's ``blocked_pallas``
    row), the rim pinned.  Returns (topology, state fields, config,
    cloth particles)."""
    pos, topo, nc = ball_on_cloth_body(
        mods, cloth_res=cloth_res, cloth_size=cloth_size, ball_subdiv=3,
        ball_radius=ball_radius, ball_y=1.0 + ball_radius + 0.15)
    spacing = cloth_size / (cloth_res - 1)
    radius = round(0.45 * spacing, 4)
    if not (2.0 * radius < spacing and radius > 0.008):
        raise ValueError("contact radius below the tunnelling floor")
    cfg = C.SolverConfig(substeps=6, iterations=4, damping=0.02,
                         solve_mode=C.SolveMode.JACOBI, enable_bending=True,
                         enable_tet_volume=True, tet_pressure=1.05,
                         enable_self_collision=True,
                         self_collision_backend="blocked_pallas",
                         collision_block_size=128, block_neighbors=32,
                         self_collision_every=3, particle_radius=radius,
                         ground_height=0.0, friction=0.3)
    return (topo, contact_fields(pos, topo, rim(nc, cloth_res)), cfg, nc)


# ---- the scenarios cover what the slice promises --------------------------

def test_cases_cover_the_slice():
    """Both solve modes, every lambda mode, pins and the hub of a centroid
    fan in the tet cases; dense and blocked contact, with and without a
    cadence, in the contact cases; and every case is short."""
    C = _port_config
    tcases = tet_cases()
    assert {(c.solve_mode, c.lambda_mode) for c, _, _, _ in tcases.values()
            } >= {(m, l) for m in C.SolveMode for l in C.LambdaMode}
    assert any(kw.get("pins") for _, _, kw, _ in tcases.values())
    assert all(c.substeps * f <= 12 for c, _, _, f in tcases.values())
    ccases = contact_cases()
    assert {(c.self_collision_backend, c.self_collision_every)
            for c, _ in ccases.values()} == {("dense", 1), ("dense", 2),
                                             ("blocked", 3)}
    assert all(f <= 3 and c.substeps % c.self_collision_every == 0
               for c, f in ccases.values())
    mods = modules()
    _, topo = tet_body("ball1", mods)
    assert topo.n_tets == 80 and int(topo.tet_degree.max()) == 80


def test_contact_scene_is_seeded_and_touching():
    """The contact scene's ball touches the cloth plane at the start, its
    rim is pinned, and two builds give the same arrays."""
    mods = modules()
    topo, a, nc = contact_scene(mods)
    _, b, _ = contact_scene(mods)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    pos = a["positions"]
    assert nc == CONTACT_RES ** 2 and pos.shape[0] == nc + 43
    assert abs(pos[nc:, 1].min() - 0.99) < 1e-3
    assert 0 < np.abs(pos[:nc, 1] - 1.0).max() < 0.02
    assert (a["inv_mass"][:nc] == 0).sum() == 4 * (CONTACT_RES - 1)
    assert a["lambda_tet"].shape == (topo.n_tets,) == (80,)
    x, w = cloud("cloud777")
    assert x.shape == (777, 3) and (w == 0).sum() == 156
