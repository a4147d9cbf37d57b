"""Ensemble scenarios that hold two engines against each other, and tests of
the scenarios themselves.

An ensemble is B bodies of one lattice spec or one mesh topology advanced
together (leaves with a leading body axis).  Each lattice case is a solver
configuration, the bodies' inputs made by numpy from seeds (the lattice
cases' ``seeded_inputs`` a body, each body shifted), the body count and a
number of 1/60 s frames; each mesh case a configuration, a body, the body
count and frames, with the JAX mesh ensemble tests' per-body inputs
(``tests/test_mesh_pallas.py:564-583``: shifted positions, velocity noise,
shared pins, a poke on six particles).  ``test_torch_ensemble.py`` holds
the port's plain ensemble engines against the JAX package with them on the
CPU; ``test_torch_kernel_on_card.py`` and ``chip_smoke.py`` hold the B-1
and B-3 ensembles against the single-body kernels (every row to the bit)
and against their plain twins on the card.  The bodies build with either
package's topology modules (``test_torch_contact_cases.modules``).  This
module imports neither jax nor pytest.
"""

from typing import Dict, Optional

import numpy as np

from softbodysimulation_tpu_torch.core import config as _port_config

import test_torch_cases as lattice_cases
import test_torch_contact_cases as contact_cases

DT = 1.0 / 60.0
# a shared kinematic sphere for the cases that carry one (kin_colliders =
# (1, 0)): (cx, cy, cz, r), its velocity, the ground
KIN_SPHERE = dict(spheres=[(0.0, 0.35, 0.0, 0.45)],
                  sphere_velocities=[(0.4, 0.0, 0.0)], ground_height=0.0)


# ---- lattices (B-1) ---------------------------------------------------------

def lattice_ensemble_cases(C=_port_config):
    """``{name: (config, input kwargs, n_bodies, frames, kin_colliders,
    batched)}``; every case runs ``frames`` frames of the full step (the
    ext force consumed on the first substep).  Input kwargs go to
    ``lattice_inputs``."""
    floor = dict(ground_height=0.0, friction=0.3)
    return {
        # tests/test_parallel.py:188's configuration, a poke on one body
        "warm_jacobi_ext": (C.SolverConfig(
            substeps=3, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, lambda_decay=1.0,
            **floor), dict(ext_body=2), 5, 4, None, None),
        "colored_decay": (C.SolverConfig(
            substeps=4, iterations=3, damping=0.02,
            solve_mode=C.SolveMode.COLORED, lambda_mode=C.LambdaMode.DECAY,
            lambda_decay=0.98, **floor), {}, 4, 3, None, None),
        # tests/test_pallas_kernel.py:251's configuration
        "reset": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, lambda_mode=C.LambdaMode.RESET,
            **floor), {}, 5, 3, None, None),
        "solid_tets": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, lambda_mode=C.LambdaMode.DECAY,
            lambda_decay=0.98, enable_tet_volume=True, **floor),
            dict(tets=True), 3, 3, None, None),
        "kin_sphere": (C.SolverConfig(
            substeps=6, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.COLORED, lambda_mode=C.LambdaMode.DECAY,
            **floor), dict(center=(0.0, 0.8, 0.0)), 4, 3, (1, 0), None),
        # one body of a sharded farm: the batched contract at n_bodies=1
        "one_body_batched": (C.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.JACOBI,
            lambda_mode=C.LambdaMode.WARM_START, **floor),
            dict(ext_body=0), 1, 3, None, True),
    }


def lattice_inputs(res: int, n_bodies: int, ext_body: Optional[int] = None,
                   tets: bool = False, center=(0.0, 0.495, 0.0),
                   **kw) -> Dict[str, np.ndarray]:
    """Batched state fields of ``n_bodies`` res^3 lattices: body b has the
    lattice cases' seeded inputs of seed b, its centre shifted by b x
    (0.11, 0.05, -0.07), and only ``ext_body`` the ext-force patch;
    ``tets`` adds zero tet multipliers ``(B, 6N)``."""
    bodies = []
    for b in range(n_bodies):
        c = np.asarray(center) + b * np.array([0.11, 0.05, -0.07])
        fields = lattice_cases.seeded_inputs(
            res, center=tuple(c), seed=b,
            ext_patch=(10, (90.0, 120.0, -70.0)) if b == ext_body else None,
            **kw)
        if tets:
            fields["lambda_tet"] = np.zeros((6 * res ** 3,), np.float32)
        bodies.append(fields)
    return {k: np.stack([f[k] for f in bodies]) for k in bodies[0]}


# ---- meshes (B-3) -----------------------------------------------------------

def mesh_ensemble_cases(C=_port_config):
    """``{name: (config, kind, n_bodies, frames, options)}``: the JAX mesh
    ensemble tests' configurations (``tests/test_mesh_pallas.py:614-733,
    940``) with, in ``options``, ``per_body_mass``, per-body
    ``materials``, a shared kinematic sphere (``kin``) and the inputs'
    ``pins`` / ``poke`` (``body_inputs``)."""
    jac = dict(substeps=2, iterations=3, damping=0.02,
               solve_mode=C.SolveMode.JACOBI,
               lambda_mode=C.LambdaMode.DECAY, lambda_decay=0.98,
               jacobi_rho=0.9, ground_height=0.0, friction=0.3)
    bend = dict(substeps=2, iterations=2, damping=0.02,
                solve_mode=C.SolveMode.JACOBI, jacobi_rho=0.9,
                lambda_mode=C.LambdaMode.DECAY, lambda_decay=0.98,
                enable_bending=True, ground_height=0.0, friction=0.3)
    return {
        "shared_mass": (C.SolverConfig(**jac), "sphere", 3, 2, {}),
        "per_body_mass": (C.SolverConfig(**jac), "sphere", 3, 2,
                          dict(per_body_mass=True, pins=())),
        "materials": (C.SolverConfig(**jac), "sphere", 3, 2,
                      dict(materials=True)),
        "bending": (C.SolverConfig(**bend), "sphere_bend", 2, 1,
                    dict(pins=(0, 3), poke=False)),
        "colored": (C.SolverConfig(
            substeps=2, iterations=2, solve_mode=C.SolveMode.COLORED,
            lambda_mode=C.LambdaMode.RESET, ground_height=0.0,
            friction=0.3), "sphere_colored", 2, 1,
            dict(pins=(1,), seed=3)),
        "tets": (C.SolverConfig(
            substeps=4, iterations=8, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, enable_tet_volume=True,
            tet_pressure=1.05, ground_height=0.0, friction=0.3), "ball1", 3,
            2, {}),
        "dense_contact": (C.SolverConfig(
            substeps=2, iterations=2, damping=0.02,
            solve_mode=C.SolveMode.JACOBI, jacobi_rho=0.0,
            lambda_mode=C.LambdaMode.RESET, enable_self_collision=True,
            particle_radius=0.3, self_collision_backend="dense",
            ground_height=0.0, friction=0.3), "two_spheres", 2, 2,
            dict(pins=(), poke=False)),
        "kin_sphere": (C.SolverConfig(**jac), "sphere", 3, 2,
                       dict(kin=(1, 0))),
    }


def mesh_body(kind: str, mods):
    """(positions (N, 3) f32, topology) of a mesh ensemble's body, built
    with the given package's topology modules."""
    if kind == "ball1":
        return contact_cases.tet_body("ball1", mods)
    m = mods.mesh.icosphere(2)
    if kind == "sphere":       # tests/test_mesh_pallas.py:20-25
        pos, topo = mods.build.build_windowed_topology(
            m.vertices, mods.edges.unique_edges(m.triangles), 1e-3,
            triangles=m.triangles)
        lift = 0.8
    elif kind == "sphere_bend":    # :137-148, clear of the floor
        pos, topo = mods.build.topology_from_mesh(
            m, compliance=1e-3, bending=True, bend_compliance=1e-3,
            windowed=True)
        lift = 5.0
    elif kind == "sphere_colored":   # :733
        pos, topo = mods.build.topology_from_mesh(m, compliance=1e-3,
                                                  windowed="colored")
        lift = 0.8
    elif kind == "two_spheres":      # :940, two icospheres in one body
        m = mods.mesh.icosphere(1)
        n1 = m.vertices.shape[0]
        verts = np.concatenate([m.vertices, m.vertices
                                + np.array([0.1, 2.1, 0.0], np.float32)])
        tris = np.concatenate([m.triangles, m.triangles + n1])
        pos, topo = mods.build.build_windowed_topology(
            verts, mods.edges.unique_edges(tris), 1e-4, triangles=tris)
        lift = 1.3
    else:
        raise ValueError(kind)
    return (np.asarray(pos, np.float32) + np.array([0.0, lift, 0.0],
                                                   np.float32), topo)


def body_inputs(pos, topo, n_bodies: int, pins=(0, 5), poke=True,
                seed=0, per_body_mass=False) -> Dict[str, np.ndarray]:
    """Batched state fields of ``n_bodies`` copies of a body
    (``tests/test_mesh_pallas.py:564-583``): body b shifted by b x (0.11,
    0.05, -0.07), velocities ~ N(0, 0.1) and, with ``poke``, a force
    ~ N(0, 3) on its first six particles, from one generator of ``seed``
    in body order; ``pins`` pinned in every body.  ``inv_mass`` is the
    shared ``(N,)`` leaf, or with ``per_body_mass`` a ``(B, N)`` leaf of
    body b's masses scaled by 0.5 + 0.5 b with particle b pinned too
    (``:638-651``)."""
    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    w = np.ones((n,), np.float32)
    if len(pins):
        w[np.asarray(pins)] = 0.0
    out = {k: [] for k in ("positions", "velocities", "ext_force")}
    for b in range(n_bodies):
        out["positions"].append(pos + np.array([0.11 * b, 0.05 * b,
                                                -0.07 * b], np.float32))
        out["velocities"].append(rng.normal(0.0, 0.1, (n, 3)).astype(
            np.float32))
        f = np.zeros((n, 3), np.float32)
        if poke:
            f[:6] = rng.normal(0.0, 3.0, (6, 3)).astype(np.float32)
        out["ext_force"].append(f)
    fields = {k: np.stack(v) for k, v in out.items()}
    if per_body_mass:
        wb = np.stack([w * np.float32(0.5 + 0.5 * b)
                       for b in range(n_bodies)])
        for b in range(n_bodies):
            wb[b, b] = 0.0
        w = wb
    z = np.zeros
    fields.update(
        inv_mass=w,
        lambda_dist=z((n_bodies, int(topo.n_edges)), np.float32),
        lambda_bend=z((n_bodies, int(topo.n_hinges)), np.float32),
        lambda_volume=z((), np.float32))
    if topo.n_tets:
        fields["lambda_tet"] = z((n_bodies, int(topo.n_tets)), np.float32)
    return fields


def mesh_case_inputs(kind: str, n_bodies: int, mods, options=None):
    """(topology, batched fields, per-body materials or None) of a mesh
    case; the materials scale body b's rest lengths by 1 + 0.04 b and its
    compliances by 1 + 3 b (``tests/test_diff_kernels.py:370-371``)."""
    opts = dict(options or {})
    pos, topo = mesh_body(kind, mods)
    fields = body_inputs(pos, topo, n_bodies, pins=opts.get("pins", (0, 5)),
                         poke=opts.get("poke", True),
                         seed=opts.get("seed", 0),
                         per_body_mass=opts.get("per_body_mass", False))
    mats = None
    if opts.get("materials"):
        rest = np.asarray(topo.rest_lengths, np.float32)
        comp = np.asarray(topo.compliance, np.float32)
        mats = {"rest_lengths": np.stack([rest * np.float32(1 + 0.04 * b)
                                          for b in range(n_bodies)]),
                "compliance": np.stack([comp * np.float32(1 + 3 * b)
                                        for b in range(n_bodies)])}
    return topo, fields, mats


# ---- one case on a device ---------------------------------------------------

def lattice_case(name: str, res: int, device):
    """(spec, config, batched state, frames, kin_colliders, batched) of a
    lattice case on ``device``; a case with ``kin_colliders`` carries the
    shared ``KIN_SPHERE``."""
    from softbodysimulation_tpu_torch import make_colliders, state_from_numpy
    from softbodysimulation_tpu_torch.topology.lattice import lattice_spec

    cfg, kw, nb, frames, kin, batched = lattice_ensemble_cases()[name]
    st = state_from_numpy(lattice_inputs(res, nb, **kw), device=device)
    if kin:
        st = st.replace(colliders=make_colliders(**KIN_SPHERE,
                                                 device=device))
    return lattice_spec(res, braced=True), cfg, st, frames, kin, batched


def mesh_case(name: str, device, mods=None):
    """(topology, config, batched state, materials or None, frames,
    options) of a mesh case on ``device``."""
    import torch

    from softbodysimulation_tpu_torch import make_colliders, state_from_numpy

    cfg, kind, nb, frames, opts = mesh_ensemble_cases()[name]
    topo, fields, mats = mesh_case_inputs(kind, nb,
                                          mods or contact_cases.modules(),
                                          opts)
    st = state_from_numpy(fields, device=device)
    if opts.get("kin"):
        st = st.replace(colliders=make_colliders(**KIN_SPHERE,
                                                 device=device))
    if mats is not None:
        mats = {k: torch.as_tensor(v, device=device) for k, v in mats.items()}
    return topo, cfg, st, mats, frames, opts


def row_mismatches(out, singles, keys):
    """The (body, leaf) pairs where an ensemble's row differs from the
    one-body run of that body by a single bit."""
    import torch

    return [(i, k) for i, one in enumerate(singles) for k in keys
            if getattr(one, k) is not None
            and not torch.equal(getattr(out, k)[i], getattr(one, k))]


def dx_gate(cfg) -> float:
    """The JAX suite's mesh gates: 2e-5 JACOBI, 1e-5 COLORED, 2e-4 with
    contact."""
    if cfg.enable_self_collision:
        return contact_cases.DX_CONTACT
    return 1e-5 if cfg.solve_mode.value == "colored" else 2e-5


# ---- the scenarios cover what the slice promises --------------------------

def test_ensemble_cases_cover_the_slice():
    """The cases switch on what the ensembles carry: B-1 with WARM_START
    and an ext force on one body, COLORED, RESET, tets, a shared kinematic
    sphere and the batched contract at one body; B-3 with shared and
    per-body masses, per-body materials, bending, COLORED, tets, dense
    contact and a shared kinematic sphere."""
    C = _port_config
    lat = lattice_ensemble_cases()
    cfgs = [c for c, *_ in lat.values()]
    assert {c.lambda_mode for c in cfgs} == {
        C.LambdaMode.RESET, C.LambdaMode.DECAY, C.LambdaMode.WARM_START}
    assert {c.solve_mode for c in cfgs} == set(C.SolveMode)
    assert any(c.enable_tet_volume for c in cfgs)
    assert any(kin for *_, kin, _ in lat.values())
    assert any(b and n == 1 for _, _, n, _, _, b in lat.values())
    assert any(kw.get("ext_body") is not None and n > 1
               for _, kw, n, *_ in lat.values())
    mesh = mesh_ensemble_cases()
    opts = [o for *_, o in mesh.values()]
    for key in ("per_body_mass", "materials", "kin"):
        assert any(o.get(key) for o in opts), key
    mcfgs = [c for c, *_ in mesh.values()]
    assert any(c.enable_bending for c in mcfgs)
    assert any(c.solve_mode == C.SolveMode.COLORED for c in mcfgs)
    assert any(c.enable_tet_volume for c in mcfgs)
    assert any(c.enable_self_collision
               and c.self_collision_backend == "dense" for c in mcfgs)


def test_ensemble_inputs_are_seeded_and_shaped():
    """Same seeds, same arrays; bodies differ; the contract's shapes."""
    a = lattice_inputs(4, 3, ext_body=1, tets=True)
    b = lattice_inputs(4, 3, ext_body=1, tets=True)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["positions"].shape == (3, 64, 3)
    assert a["lambda_tet"].shape == (3, 6 * 64)
    assert not a["ext_force"][[0, 2]].any() and a["ext_force"][1].any()
    assert not np.array_equal(a["positions"][0], a["positions"][1])
    mods = contact_cases.modules()
    topo, f, mats = mesh_case_inputs("sphere", 3, mods,
                                     dict(per_body_mass=True,
                                          materials=True, pins=()))
    assert f["inv_mass"].shape == (3, 162)
    assert [f["inv_mass"][i, i] for i in range(3)] == [0.0] * 3
    assert mats["rest_lengths"].shape == (3, topo.n_edges)
    topo, f, _ = mesh_case_inputs("ball1", 2, mods)
    assert f["inv_mass"].shape == (topo.n_particles,)
    assert f["lambda_tet"].shape == (2, topo.n_tets)
