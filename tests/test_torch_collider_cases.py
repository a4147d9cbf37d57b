"""Rigid-world scenarios that hold two engines against each other, and
tests of the scenarios themselves.

Each lattice or mesh case is a solver configuration, a rigid world -- the
config's box colliders, or a ColliderSet (kinematic spheres and boxes
with nonzero velocities, an animated ground) whose poses replace the
config's -- and a run length, on the bodies of ``test_torch_cases.py``
(a res-6 lattice whose inputs are made by numpy from a seed) and
``test_torch_mesh_cases.py`` (an icosphere of 162 particles).  A case may
move its poses once (``moved``): the same runner then takes the second
pose, which must change the result.  ``KIN_DIFF`` is the fused-backward
pose-cotangent set-up of the JAX suite
(``tests/test_mesh_diff_pallas.py:279-407``): a kinematic sphere that
overlaps the shell from the first substep, and a random-weighted loss.

``test_torch_colliders.py`` holds the port's plain engines against the JAX
package's with them on the CPU; ``test_torch_kernel_on_card.py`` and
``chip_smoke.py`` hold the CUDA kernels against the plain engines with
them on the card.  This module imports neither jax nor pytest.
"""

import numpy as np
import torch

from softbodysimulation_tpu_torch import make_colliders, state_from_numpy
from softbodysimulation_tpu_torch import state_from_topology
from softbodysimulation_tpu_torch.core import config as _port_config

import test_torch_cases as _lattice_cases
import test_torch_diff_cases as _diff_cases
import test_torch_mesh_cases as _mesh_cases

# (spheres, boxes, ground, sphere velocities, box velocities) of a
# ColliderSet, as make_colliders keywords
LATTICE_KIN = dict(spheres=[(0.0, 0.35, 0.0, 0.45)],
                   boxes=[(0.4, 0.2, 0.1, 0.2, 0.3, 0.2)],
                   sphere_velocities=[(1.0, 0.5, -0.3)],
                   box_velocities=[(-0.5, 0.0, 0.7)], ground_height=0.03)
LATTICE_MOVED = dict(sphere=dict(center=(0.1, 0.5, 0.0),
                                 velocity=(0.0, 2.0, 0.0)), ground=0.06)
MESH_KIN = dict(spheres=[(0.3, 0.4, 0.0, 0.35)],
                boxes=[(-0.6, 0.3, 0.0, 0.25, 0.25, 0.25)],
                sphere_velocities=[(0.5, 0.0, 0.2)],
                box_velocities=[(0.0, 0.0, -0.4)], ground_height=0.0)
MESH_MOVED = dict(sphere=dict(center=(0.0, 0.9, 0.0),
                              velocity=(0.0, 1.0, 0.0)), ground=0.02)


def lattice_collider_cases(C=_port_config):
    """``{name: (config, ColliderSet kwargs or None, moved or None,
    substeps)}`` on the res-6 lattice at dt_sub = 1/480.  The config's
    ground height of the kinematic cases is bogus on purpose: the
    ColliderSet's must replace it."""
    base = dict(substeps=6, iterations=2, damping=0.02,
                solve_mode=C.SolveMode.COLORED,
                lambda_mode=C.LambdaMode.DECAY, ground_height=0.0,
                friction=0.3)
    box = ((0.3, 0.2, 0.0, 0.3, 0.25, 0.3),)
    return {
        "config_box": (C.SolverConfig(box_colliders=box, **base), None,
                       None, 18),
        "config_box_jacobi": (C.SolverConfig(**dict(
            base, solve_mode=C.SolveMode.JACOBI), box_colliders=box), None,
            None, 18),
        "kin_spheres_boxes": (C.SolverConfig(**dict(base,
                                                    ground_height=7.0)),
                              LATTICE_KIN, LATTICE_MOVED, 18),
        "kin_velocity_reflect": (C.SolverConfig(**dict(
            base, ground_height=7.0,
            floor_mode=C.FloorMode.VELOCITY_REFLECT, floor_offset=0.001,
            restitution=0.3)), LATTICE_KIN, LATTICE_MOVED, 18),
        "kin_ground_only": (C.SolverConfig(**dict(base, ground_height=7.0)),
                            dict(ground_height=0.04), dict(ground=0.08), 12),
    }


def mesh_collider_cases(C=_port_config):
    """``{name: (config, ColliderSet kwargs or None, moved or None,
    frames)}`` on the 162-particle icosphere of ``test_torch_mesh_cases``
    (kind ``sphere``), 1/60 s frames.  JACOBI without Chebyshev: a box's
    push axis is discontinuous at its edges, and the momentum step
    amplifies a one-ulp branch flip there (the JAX suite's own reason,
    ``tests/test_kinematic_colliders.py:360-363``)."""
    base = dict(substeps=2, iterations=4, damping=0.02,
                solve_mode=C.SolveMode.JACOBI, jacobi_rho=0.0,
                ground_height=0.0, friction=0.3)
    return {
        "config_box": (C.SolverConfig(box_colliders=(
            (-0.6, 0.3, 0.0, 0.25, 0.25, 0.25),), **base), None, None, 4),
        "kin_spheres_boxes": (C.SolverConfig(**dict(base,
                                                    ground_height=77.0)),
                              MESH_KIN, MESH_MOVED, 4),
        "kin_colored": (C.SolverConfig(**dict(
            base, ground_height=77.0, solve_mode=C.SolveMode.COLORED)),
            MESH_KIN, MESH_MOVED, 4),
    }


def moved(colliders, change):
    """The ColliderSet with sphere 0 and the ground moved as ``change``
    says."""
    if "sphere" in change:
        colliders = colliders.with_sphere(0, **change["sphere"])
    if "ground" in change:
        colliders = colliders.with_ground(change["ground"])
    return colliders


# the fused-backward pose-cotangent set-up: the JAX suite's scene of
# tests/test_torch_diff_cases.py (icosphere(2), lifted 0.45), a sphere
# overlapping its +x shell, the config's ground bogus on purpose
KIN_DIFF = dict(spheres=[(0.6, 0.45, 0.0, 0.2)],
                sphere_velocities=[(0.4, 0.0, 0.1)], ground_height=0.0)
# (substeps, iterations, jacobi_rho, gate on max |dg| / max |g| of the
# pose leaves against jax.grad of the JAX engine): the JAX suite's cases
# and bands (tests/test_mesh_diff_pallas.py:293-309)
KIN_DIFF_RUNS = ((1, 1, 0.0, 1e-4), (3, 2, 0.0, 5e-3), (5, 4, 0.9, 5e-2))


def loss_weights(n: int) -> np.ndarray:
    """The random loss weights (n, 3) of the JAX suite's pose test."""
    return np.random.RandomState(3).randn(n, 3).astype(np.float32)


def lattice_runs(name, device, run_kernel, run_plain):
    """[(kernel result, plain result, start state)] of a lattice case on
    ``device``: the case's world and, for a kinematic case, its moved one
    -- through ONE kernel runner, so a new pose reaches the kernel with
    nothing rebuilt.  ``run_kernel(spec, cfg, dt_sub, n, kin)`` builds a
    runner; ``run_plain(state, spec, cfg, dt_sub, n)`` is the plain
    engine."""
    from softbodysimulation_tpu_torch.topology.lattice import lattice_spec

    cfg, kin, move, n = lattice_collider_cases()[name]
    spec = lattice_spec(6, braced=True)
    st = state_from_numpy(_lattice_cases.seeded_inputs(6), device=device)
    worlds = [None]
    if kin is not None:
        c = make_colliders(device=device, **kin)
        worlds = [c, moved(c, move)]
    run = run_kernel(spec, cfg, 1 / 480, n, None if kin is None else (
        worlds[0].n_spheres, worlds[0].n_boxes))
    out = []
    for c in worlds:
        s = st.replace(colliders=c)
        out.append((run(s), run_plain(s, spec, cfg, 1 / 480, n), s))
    return out


def mesh_runs(name, device, run_kernel, run_plain):
    """``lattice_runs`` for a mesh case: ``run_kernel(topo, cfg, dt,
    frames, kin)`` builds a step, ``run_plain(state, topo, cfg, dt,
    frames)`` is the plain engine's ``multi_step_fn``."""
    cfg, kin, move, frames = mesh_collider_cases()[name]
    topo, fields = _mesh_cases.case_inputs("sphere")
    st = state_from_numpy(fields, device=device)
    worlds = [None]
    if kin is not None:
        c = make_colliders(device=device, **kin)
        worlds = [c, moved(c, move)]
    run = run_kernel(topo, cfg, 1 / 60, frames, None if kin is None else (
        worlds[0].n_spheres, worlds[0].n_boxes))
    return [(run(st.replace(colliders=c)),
             run_plain(st.replace(colliders=c), topo, cfg, 1 / 60, frames),
             st.replace(colliders=c)) for c in worlds]


def kin_diff_inputs(device, iterations=4, jacobi_rho=0.9):
    """(topology, config, state, ColliderSet, loss weights (N, 3) tensor)
    of the pose-cotangent set-up on ``device``."""
    pos, topo = _diff_cases.scene()
    cfg = _diff_cases.config(ground_height=123.0, iterations=iterations,
                             jacobi_rho=jacobi_rho)
    st = state_from_topology(topo, pos, device=device)
    coll = make_colliders(device=device, **KIN_DIFF)
    wts = torch.tensor(loss_weights(pos.shape[0]), device=device)
    return topo, cfg, st, coll, wts


def chunk_pose_grads(backward_chunk, topo, cfg, n_sub, st, coll, wts):
    """The pose cotangents of sum(wts * positions) after ``n_sub``
    substeps, from one backward chunk (``backward_chunk_cuda`` or
    ``backward_chunk_plain``) at the start state."""
    z = torch.zeros_like(st.positions)
    out = backward_chunk(topo, cfg, _diff_cases.DT, n_sub, st.inv_mass,
                         st.positions, st.velocities, st.lambda_dist, wts, z,
                         torch.zeros_like(st.lambda_dist), colliders=coll)
    return {k: v.detach().cpu() for k, v in out[-1].items()}


def autograd_pose_grads(topo, cfg, n_sub, st, coll, wts):
    """The same by autograd through the plain engine (on the state's
    device)."""
    from softbodysimulation_tpu_torch.core.colliders import ColliderSet
    from softbodysimulation_tpu_torch.solvers import general

    leaves = {k: getattr(coll, k).clone().requires_grad_()
              for k in ("spheres", "boxes", "ground_height",
                        "sphere_velocities", "box_velocities")}
    out = general.run_substeps_plain(
        st.replace(colliders=ColliderSet(**leaves)), topo, cfg,
        _diff_cases.DT, n_sub)
    keys = ("spheres", "sphere_velocities", "ground_height")
    grads = torch.autograd.grad((wts * out.positions).sum(),
                                [leaves[k] for k in keys])
    return {k: g.detach().cpu() for k, g in zip(keys, grads)}


def pose_error(a, b):
    """max |da - db| over the pose leaves / max |b| over them (one global
    scale), and that scale."""
    scale = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in b) / scale, scale


def test_cases_cover_the_rigid_world():
    """Every lattice and mesh case has a rigid world: config boxes, or a
    ColliderSet whose ground replaces a bogus config ground; both floor
    modes and both solve modes are covered."""
    C = _port_config
    lat = lattice_collider_cases()
    mesh = mesh_collider_cases()
    for cases in (lat, mesh):
        for cfg, kin, move, n in cases.values():
            assert cfg.box_colliders or kin is not None
            if kin is not None:
                assert cfg.ground_height > 1.0 and move is not None
            assert n > 0
    modes = {cfg.floor_mode for cfg, *_ in lat.values()}
    assert modes == {C.FloorMode.XPBD_INEQUALITY,
                     C.FloorMode.VELOCITY_REFLECT}
    assert {cfg.solve_mode for cfg, *_ in mesh.values()} == {
        C.SolveMode.JACOBI, C.SolveMode.COLORED}


def test_kinematic_worlds_move():
    """The kinematic cases' colliders have nonzero velocities, and each
    move changes the pose."""
    for kin in (LATTICE_KIN, MESH_KIN, KIN_DIFF):
        assert np.abs(np.asarray(kin["sphere_velocities"])).max() > 0
    for kin, move in ((LATTICE_KIN, LATTICE_MOVED), (MESH_KIN, MESH_MOVED)):
        assert tuple(kin["spheres"][0][:3]) != move["sphere"]["center"]
        assert kin["ground_height"] != move["ground"]
    assert loss_weights(4).shape == (4, 3)
