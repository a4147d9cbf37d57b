"""The port's scripted rigid world (``interact/animator.py``, the
``sphere_sweep`` scene, ``drag_force`` / ``squeeze_impulse``) and the
kernel runners' collider contract, against the JAX package on the CPU.

``kinematic_rollout`` against a host loop (< 1e-6) and against JAX's; the
gradient of a loss w.r.t. a collider trajectory against ``jax.grad``
(max |dg| / max |g| < 1e-4, the JAX suite's gradient gate);
``sphere_sweep`` pushing its slab; ``scheduled_rollout`` with the three
animations; and the kernel runners' CPU routes with their call-time
refusals (the JAX suite's
``test_streamed_kernel_without_kin_rejects_collider_state``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softbodysimulation_tpu.core import colliders as jcoll
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import scenes as jscenes
from softbodysimulation_tpu.interact import animator as janim
from softbodysimulation_tpu.interact import forces as jforces
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.solvers import lattice as jlat

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core import scenes as pscenes
from softbodysimulation_tpu_torch.interact import animator as panim
from softbodysimulation_tpu_torch.interact import forces as pforces
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.kernels import mesh_diff as md
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_collider_cases as cases
from test_torch_colliders import _pinned_cloth, pcoll
from test_torch_general_engine import jax_case
from test_torch_state import jax_lattice_state, port_config, to_port

torch.set_num_threads(1)

DT = 1 / 60


def _traj(n, y0, y1, radius):
    """(T, 1, 4) poses of a sphere rising along y."""
    traj = np.zeros((n, 1, 4), np.float32)
    traj[:, 0, 1] = np.linspace(y0, y1, n, dtype=np.float32)
    traj[:, 0, 3] = radius
    return traj


def _cloth_config(**kw):
    base = dict(substeps=2, iterations=5, damping=0.05,
                solve_mode=jconfig.SolveMode.JACOBI, ground_height=-2.0,
                friction=0.3)
    base.update(kw)
    return jconfig.SolverConfig(**base)


def test_kinematic_rollout_matches_host_loop():
    """The scripted rollout equals a host loop that installs the same
    poses and forward-difference velocities (< 1e-6), and tracks JAX's
    rollout (< 1e-5)."""
    js, jtopo, ps, ptopo = _pinned_cloth(res=7)
    cfg = _cloth_config()
    n = 30
    traj = _traj(n, 0.2, 1.2, 0.35)
    kin = dict(spheres=[(0.0, 0.2, 0.0, 0.35)], ground_height=-2.0)
    ps = ps.replace(colliders=pcoll(**kin))
    step = pgeneral.make_step(ptopo, port_config(cfg), DT)
    out = panim.kinematic_rollout(ps, step, n_steps=n, dt=DT,
                                  sphere_traj=torch.tensor(traj))
    vel = np.zeros((n, 1, 3), np.float32)
    vel[:-1, 0] = (traj[1:, 0, :3] - traj[:-1, 0, :3]) / np.float32(DT)
    s = ps
    for i in range(n):
        s = step(s.replace(colliders=s.colliders.replace(
            spheres=torch.tensor(traj[i]),
            sphere_velocities=torch.tensor(vel[i]))))
    assert float((out.positions - s.positions).abs().max()) < 1e-6
    jout = janim.kinematic_rollout(
        js.replace(colliders=jcoll.make_colliders(**kin)),
        jgeneral.make_step(jtopo, cfg, DT), n_steps=n, dt=DT,
        sphere_traj=jnp.asarray(traj))
    assert np.abs(out.positions.numpy()
                  - np.asarray(jout.positions)).max() < 1e-5
    # the sphere rose through the cloth and bulged it
    assert float(out.positions[:, 1].max()) > 1.2


def test_kinematic_rollout_scripts_boxes_and_ground():
    """Box and ground trajectories are installed too; a rising ground lifts
    the body, as in JAX."""
    jtopo, js, ptopo, ps = jax_case("sphere")
    cfg = _cloth_config(iterations=3, ground_height=9.0)
    n = 12
    boxes = np.zeros((n, 1, 6), np.float32)
    boxes[:, 0] = (-0.6, 0.3, 0.0, 0.25, 0.25, 0.25)
    boxes[:, 0, 0] += np.linspace(0.0, 0.3, n, dtype=np.float32)
    ground = np.linspace(0.0, 0.3, n, dtype=np.float32)
    kin = dict(boxes=[tuple(boxes[0, 0])], ground_height=0.0)
    out = panim.kinematic_rollout(
        ps.replace(colliders=pcoll(**kin)),
        pgeneral.make_step(ptopo, port_config(cfg), DT), n_steps=n, dt=DT,
        box_traj=torch.tensor(boxes), ground_traj=torch.tensor(ground))
    jout = janim.kinematic_rollout(
        js.replace(colliders=jcoll.make_colliders(**kin)),
        jgeneral.make_step(jtopo, cfg, DT), n_steps=n, dt=DT,
        box_traj=jnp.asarray(boxes), ground_traj=jnp.asarray(ground))
    assert np.abs(out.positions.numpy()
                  - np.asarray(jout.positions)).max() < 2e-5
    assert float(out.positions[:, 1].min()) > 0.2
    with pytest.raises(ValueError, match="colliders"):
        panim.kinematic_rollout(ps, pgeneral.make_step(
            ptopo, port_config(cfg), DT), n_steps=1, dt=DT)


def test_gradient_through_collider_trajectory_matches_jax():
    """d(loss)/d(sphere trajectory) through a kinematic rollout, by
    autograd through the plain engine, against ``jax.grad`` of the JAX
    engine (max |dg| / max |g| < 1e-4); pushing the sphere higher raises
    the cloth, so the height gradient is non-trivial."""
    js, jtopo, ps, ptopo = _pinned_cloth(res=6)
    cfg = _cloth_config(substeps=1, iterations=4)
    n = 12
    traj0 = _traj(n, 0.3, 1.05, 0.3)
    kin = dict(spheres=[(0.0, 0.3, 0.0, 0.3)], ground_height=-2.0)
    jstate = js.replace(colliders=jcoll.make_colliders(**kin))
    jstep = jgeneral.make_step(jtopo, cfg, DT)

    def jloss(traj):
        out = janim.kinematic_rollout(jstate, jstep, n_steps=n, dt=DT,
                                      sphere_traj=traj)
        return out.positions[:, 1].mean()

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(traj0)))
    traj = torch.tensor(traj0, requires_grad=True)
    out = panim.kinematic_rollout(
        ps.replace(colliders=pcoll(**kin)),
        pgeneral.make_step(ptopo, port_config(cfg), DT), n_steps=n, dt=DT,
        sphere_traj=traj)
    (g,) = torch.autograd.grad(out.positions[:, 1].mean(), traj)
    scale = np.abs(g_ref).max()
    assert np.isfinite(g.numpy()).all() and scale > 1e-6
    assert np.abs(g.numpy() - g_ref).max() / scale < 1e-4
    assert np.abs(g.numpy()[:, 0, 1]).max() > 1e-6


def test_sphere_sweep_scene_pushes_slab():
    """The catalogued animated-collider scene: the scripted sphere plows
    through the slab and shoves it along +x; the JAX scene from the same
    start does the same."""
    state, step, info = pscenes.sphere_sweep(device="cpu")
    jstate, jstep, jinfo = jscenes.sphere_sweep()
    assert info["kin_colliders"] == jinfo["kin_colliders"] == (1, 0)
    x0 = float(state.positions[:, 0].mean())
    for i in range(60):
        state = step(info["animate"](i, state))
        jstate = jstep(jinfo["animate"](i, jstate))
    p = state.positions
    assert port.is_finite(state)
    assert float(p[:, 0].mean()) > x0 + 0.05
    assert float(p[:, 1].min()) > -1e-2
    assert abs(float(p[:, 0].mean()) - float(jstate.positions[:, 0].mean())) \
        < 1e-3


def test_scheduled_rollout_matches_jax():
    """``scheduled_rollout`` with a Squeeze, a ForceAnimation and a Pulse on
    the lattice, against JAX's (< 1e-5)."""
    spec, js = jax_lattice_state(4, center=(0.0, 0.6, 0.0), seed=2)
    ps = to_port(js)
    cfg = jconfig.SolverConfig(substeps=2, iterations=2, damping=0.02,
                               solve_mode=jconfig.SolveMode.COLORED,
                               ground_height=0.0, friction=0.3)
    pspec = ptop.lattice_spec(4, braced=True)
    center = (0.1, 0.6, 0.0)

    def anims(mod):
        return [(mod.Squeeze(intensity=0.5, duration=0.1, radius=0.8), 0.0,
                 center),
                (mod.ForceAnimation(direction=(1.0, 1.0, 0.0),
                                    max_force=30.0, duration=0.1,
                                    radius=1.0), 0.02, center),
                (mod.Pulse(frequency=5.0, strength=10.0, radius=1.0), 0.05,
                 center)]

    out = panim.scheduled_rollout(ps, plat.make_step(pspec, port_config(cfg),
                                                     DT),
                                  anims(panim), DT, 10)
    jout = janim.scheduled_rollout(js, jlat.make_step(spec, cfg, DT),
                                   anims(janim), DT, 10)
    d = np.abs(out.positions.numpy() - np.asarray(jout.positions)).max()
    assert d < 1e-5, d
    moved = float((out.positions - ps.positions).abs().max())
    assert moved > 1e-3
    # the curve is JAX's keyframe interpolation, ends clamped
    curve = panim.Curve.ease_in_out()
    jcurve = janim.Curve.ease_in_out()
    for t in (-0.5, 0.0, 0.3, 0.5, 0.97, 1.0, 2.0):
        assert abs(float(curve(torch.tensor(t))) - float(jcurve(t))) < 1e-6


@pytest.mark.parametrize("verb", ["drag_force", "squeeze_impulse"])
def test_drag_and_squeeze_match_jax(verb):
    _, js = jax_lattice_state(4, center=(0.0, 1.0, 0.0), seed=1)
    ps = to_port(js)
    calls = {
        "drag_force": lambda m, s: m.drag_force(s, (1.0, 1.5, -0.5),
                                                strength=4.0, radius=1.5),
        "squeeze_impulse": lambda m, s: m.squeeze_impulse(
            s, (0.1, 1.0, 0.0), intensity=0.7, radius=0.6),
    }
    jout = calls[verb](jforces, js)
    pout = calls[verb](pforces, ps)
    np.testing.assert_allclose(pout.ext_force.numpy(),
                               np.asarray(jout.ext_force), rtol=0, atol=1e-6)
    assert float(pout.ext_force.abs().max()) > 0.1


def test_streamed_kernel_without_kin_rejects_collider_state():
    """A lattice runner built without kin_colliders refuses a state that
    carries a ColliderSet, on any device (the JAX kernel's call-time
    check)."""
    spec = ptop.lattice_spec(3, braced=True)
    state = plat.make_lattice_state(spec, center=(0, 0.8, 0),
                                    device="cpu").replace(
        colliders=pcoll(ground_height=0.0))
    cfg = port_config(jconfig.SolverConfig(
        substeps=2, iterations=2, solve_mode=jconfig.SolveMode.COLORED))
    with pytest.raises(NotImplementedError, match="kin_colliders"):
        lc.make_cuda_substep_runner(spec, cfg, 1 / 480, 2)(state)


@pytest.mark.parametrize("runner", ["lattice", "mesh", "fused"])
def test_kin_runners_cpu_route_and_call_time_checks(runner):
    """A runner built with kin_colliders=(S, B) runs a CPU state through
    the plain engine with the state's poses (equal to it to the bit, and a
    moved pose changes the result), and refuses a state without colliders
    or with other counts (ValueError)."""
    if runner == "lattice":
        spec = ptop.lattice_spec(4, braced=True)
        st = plat.make_lattice_state(spec, center=(0, 0.8, 0), mass=0.01,
                                     device="cpu")
        cfg = port_config(cases.lattice_collider_cases(jconfig)[
            "kin_spheres_boxes"][0])
        kin = cases.LATTICE_KIN
        build = lambda k: lc.make_cuda_substep_runner(  # noqa: E731
            spec, cfg, 1 / 480, 10, kin_colliders=k)
        plain = lambda s: plat.run_substeps_plain(  # noqa: E731
            s, spec, cfg, 1 / 480, 10)
    else:
        _, _, ptopo, st = jax_case("sphere")
        cfg = port_config(cases.mesh_collider_cases(jconfig)[
            "kin_spheres_boxes"][0])
        kin = cases.MESH_KIN
        if runner == "fused":
            kin = cases.KIN_DIFF
            build = lambda k: md.make_fused_differentiable_mesh_runner(  # noqa
                ptopo, cfg, DT / 2, 4, kin_colliders=k)
        else:
            build = lambda k: mc.make_mesh_cuda_substep_runner(  # noqa
                ptopo, cfg, DT / 2, 4, kin_colliders=k)
        plain = lambda s: pgeneral.run_substeps_plain(  # noqa: E731
            s, ptopo, cfg, DT / 2, 4)
    coll = pcoll(**kin)
    counts = (coll.n_spheres, coll.n_boxes)
    run = build(counts)
    s = st.replace(colliders=coll)
    out = run(s)
    assert torch.equal(out.positions, plain(s).positions)
    s2 = st.replace(colliders=cases.moved(coll, cases.MESH_MOVED))
    assert float((run(s2).positions - out.positions).abs().max()) > 1e-5
    with pytest.raises(ValueError, match="needs a state carrying"):
        run(st)
    with pytest.raises(ValueError, match="do not match"):
        run(st.replace(colliders=pcoll(**dict(kin, spheres=[
            (0.0, 0.0, 0.0, 0.1)] * 2, sphere_velocities=None))))
    with pytest.raises(NotImplementedError, match="kin_colliders"):
        build(None)(s)
