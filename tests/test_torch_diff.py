"""The port's differentiable runners (``kernels/diff.py``) against the JAX
package's gradients, on the CPU.

Mirrors ``tests/test_diff_kernels.py`` for what is ported (the lattice
runners are in ``test_torch_diff_lattice.py``, the flat-cloth bending and
hub-row gradients in ``test_torch_diff_repairs.py``): the mesh runner with
each backward, the full-step mesh runner (ext-force gradients, the
self-collision cadence), the material runner with both backwards, chunked
checkpoints and a fit that descends, and the refusals (``approx_math``,
ensembles).  Same inputs go through ``jax.grad`` of the JAX engines and
through the port (on the CPU its kernels' wrappers run the plain engines);
gate max |dg| / max |g| < 1e-4 with max |g| > 1e-3, value within 1e-3
relative, as ``tests/test_mesh_diff_pallas.py:76-87``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.kernels import diff as kdiff
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import lattice as ptop
from softbodysimulation_tpu_torch.topology import mesh as pmesh

from test_torch_state import port_config

torch.set_num_threads(1)

DT_SUB = 1.0 / 240.0
TOL = 1e-4
V0 = np.asarray([0.3, 0.1, -0.2], np.float32)


def assert_grads_match(got, ref, floor=1e-3):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > floor
    np.testing.assert_allclose(got / scale, ref / scale, atol=TOL)


def assert_values_match(got, ref):
    assert abs(float(got) - float(ref)) < 1e-3 * max(1.0, abs(float(ref)))


def jax_state(topo, pos):
    return jstate_mod.state_from_topology(topo, np.asarray(pos))


def port_state(topo, pos):
    return port.state_from_topology(topo, np.asarray(pos),
                                    device="cpu")


def jax_rollout(topo, cfg, n_sub):
    """The JAX general engine's raw-substep rollout (gather backend: its
    windowed VJP rounds cotangents to bf16)."""
    cfg = cfg.replace(distance_backend="gather", bending_backend="gather")

    def roll(s, t=topo):
        out, _ = lax.scan(lambda c, _: (jgeneral._substep(
            c, t, cfg, DT_SUB, apply_ext=False), None), s, None,
            length=n_sub)
        return out

    return roll


def mesh_setup(mesh_mod, build_mod):
    m = mesh_mod.icosphere(1)
    pos, topo = build_mod.topology_from_mesh(m, compliance=1e-4,
                                             windowed=True)
    return pos + np.array([0, 0.5, 0], np.float32), topo


def mesh_cfg(C, **kw):
    base = dict(substeps=2, iterations=2, damping=0.01,
                solve_mode=C.SolveMode.JACOBI, jacobi_rho=0.0,
                ground_height=-2.0)
    base.update(kw)
    return C.SolverConfig(**base)


def scale_grads(jtopo, jroll, ptopo, prun, pos, loss_of):
    """(value, d/d scale) of ``loss_of(rollout(state with positions *
    scale))`` at scale 1.02 in both packages."""
    jst = jax_state(jtopo, pos)

    def jloss(scale):
        return loss_of(jroll(jst.replace(positions=jst.positions * scale)),
                       jnp)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.float32(1.02))
    pst = port_state(ptopo, pos)
    scale = torch.tensor(1.02).requires_grad_()
    loss = loss_of(prun(pst.replace(positions=pst.positions * scale)),
                   torch)
    (grad,) = torch.autograd.grad(loss, scale)
    return (float(loss.detach()), float(grad)), (float(jval), float(jgrad))


def sum_sq(out, xp):
    return xp.sum(out.positions ** 2)


@pytest.mark.parametrize("backward", ["xla", "fused", "auto"])
def test_mesh_runner_grads_match_jax(backward):
    pos, jtopo = mesh_setup(jmesh, jbuild)
    _, ptopo = mesh_setup(pmesh, pbuild)
    jcfg = mesh_cfg(jconfig)
    n_sub = 4
    run = kdiff.make_differentiable_mesh_runner(ptopo, port_config(jcfg),
                                                DT_SUB, n_sub,
                                                backward=backward)
    got, ref = scale_grads(jtopo, jax_rollout(jtopo, jcfg, n_sub), ptopo,
                           run, pos, sum_sq)
    assert_values_match(got[0], ref[0])
    assert_grads_match(got[1], ref[1])


@pytest.mark.parametrize("every", [1, 2])
def test_mesh_step_grads_match_jax(every):
    """Full-step mesh runner: ext-force gradients (every = 1), and a dense
    self-collision cadence (every = 2) whose contact passes the backward
    runs too."""
    pos, jtopo = mesh_setup(jmesh, jbuild)
    _, ptopo = mesh_setup(pmesh, pbuild)
    kw = {}
    if every > 1:
        kw = dict(substeps=4, enable_self_collision=True,
                  self_collision_backend="dense", self_collision_every=every,
                  particle_radius=0.08)
    jcfg = mesh_cfg(jconfig, **kw).replace(distance_backend="gather")
    n_steps, dt = 2, 1 / 120
    jfn = jgeneral.make_step(jtopo, jcfg, dt, n_steps)
    jst = jax_state(jtopo, pos)
    f0 = np.asarray([0.0, 1e-3, 0.0], np.float32)

    def jloss(f):
        s = jst.replace(ext_force=jnp.broadcast_to(f, jst.ext_force.shape))
        return jnp.sum(jfn(s).positions ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(f0))
    run = kdiff.make_differentiable_mesh_step(ptopo, port_config(jcfg), dt,
                                              n_steps=n_steps)
    pst = port_state(ptopo, pos)
    f = torch.as_tensor(f0).requires_grad_()
    loss = (run(pst.replace(ext_force=f.expand(pst.n_particles, 3)))
            .positions ** 2).sum()
    (grad,) = torch.autograd.grad(loss, f)
    assert_values_match(loss.detach(), jval)
    assert_grads_match(grad, jgrad)


def material_setup():
    pos, jtopo = mesh_setup(jmesh, jbuild)
    _, ptopo = mesh_setup(pmesh, pbuild)
    jcfg = mesh_cfg(jconfig)
    return pos, jtopo, ptopo, jcfg, port_config(jcfg)


@pytest.mark.parametrize("backward", ["xla", "fused"])
def test_material_grads_match_jax(backward):
    pos, jtopo, ptopo, jcfg, pcfg = material_setup()
    n_sub = 4
    jroll = jax_rollout(jtopo, jcfg, n_sub)
    jst = jax_state(jtopo, pos)
    mats0 = {"rest_lengths": np.asarray(jtopo.rest_lengths) * 1.05,
             "compliance": np.asarray(jtopo.compliance) * 2.0}

    def jloss(m):
        t = jtopo.replace(rest_lengths=m["rest_lengths"],
                          compliance=m["compliance"])
        return jnp.sum(jroll(jst, t).positions ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in mats0.items()})
    run = kdiff.make_differentiable_material_runner(ptopo, pcfg, DT_SUB,
                                                    n_sub, backward=backward)
    mats = {k: torch.as_tensor(v).requires_grad_() for k, v in mats0.items()}
    loss = (run(port_state(ptopo, pos), mats).positions ** 2).sum()
    grads = torch.autograd.grad(loss, [mats["rest_lengths"],
                                       mats["compliance"]])
    assert_values_match(loss.detach(), jval)
    for k, g in zip(("rest_lengths", "compliance"), grads):
        assert_grads_match(g, jgrad[k])


def test_material_fit_descends():
    """Three gradient steps on perturbed rest lengths move the trajectory
    loss down, through the default (auto: fused) material runner."""
    pos, _, ptopo, _, pcfg = material_setup()
    run = kdiff.make_differentiable_material_runner(ptopo, pcfg, DT_SUB, 4)
    st = port_state(ptopo, pos)
    comp = ptopo.compliance
    target = run(st, {"rest_lengths": ptopo.rest_lengths,
                      "compliance": comp}).positions.detach()

    def loss(rest):
        out = run(st, {"rest_lengths": rest, "compliance": comp})
        return ((out.positions - target) ** 2).sum()

    rest = (ptopo.rest_lengths * 1.1).requires_grad_()
    l0 = cur = float(loss(rest).detach())
    for _ in range(3):
        val = loss(rest)
        (g,) = torch.autograd.grad(val, rest)
        val = val.detach()
        lr = 0.25 * float(val) / float((g * g).sum())
        for _ in range(8):
            trial = (rest - lr * g).detach()
            lt = float(loss(trial))
            if lt < float(val):
                rest, cur = trial.requires_grad_(), lt
                break
            lr *= 0.25
    assert cur < 0.9 * l0, (l0, cur)


def test_config10_material_fit_shrinks_its_losses():
    """The port's example 10 on the CPU: the fused material backward's fit
    shrinks the trajectory loss and the mean rest-length error."""
    from softbodysimulation_tpu_torch.examples import config10_material_fit

    l0, l1, err0, err1 = config10_material_fit.run(device="cpu",
                                                   verbose=False)
    assert l1 < 0.5 * l0 and err1 < err0, (l0, l1, err0, err1)


def test_remat_chunk_grads_match_flat():
    """Checkpointed chunks replay the same arithmetic: the gradients equal
    the flat rollout's, and a chunk that does not divide is refused."""
    pos, _, ptopo, _, pcfg = material_setup()
    grads = {}
    for chunk in (0, 4):
        run = kdiff.make_differentiable_material_runner(
            ptopo, pcfg, DT_SUB, 8, remat_chunk=chunk, backward="xla")
        mats = {"rest_lengths": (ptopo.rest_lengths * 1.03)
                .requires_grad_(), "compliance": ptopo.compliance.clone()
                .requires_grad_()}
        loss = (run(port_state(ptopo, pos), mats).positions ** 2).sum()
        grads[chunk] = torch.autograd.grad(loss, list(mats.values()))
    for a, b in zip(grads[0], grads[4]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert float(grads[0][0].abs().max()) > 1e-3
    with pytest.raises(ValueError, match="divide"):
        kdiff.make_differentiable_material_runner(ptopo, pcfg, DT_SUB, 8,
                                                  remat_chunk=3)


def test_traced_materials_match_static():
    """The topology's own rest lengths and compliances passed as materials
    reproduce the static path bit for bit (same min_alpha_tilde floor,
    same max_dlambda_rel bound)."""
    pos, _, ptopo, _, pcfg = material_setup()
    cfg = pcfg.replace(min_alpha_tilde=0.5, max_dlambda_rel=0.05,
                       lambda_mode=port.LambdaMode.WARM_START)
    st = port_state(ptopo, pos)
    a = pgeneral.run_substeps_plain(st, ptopo, cfg, DT_SUB, 4)
    b = pgeneral.run_substeps_plain(st, ptopo, cfg, DT_SUB, 4, materials={
        "rest_lengths": ptopo.rest_lengths.clone(),
        "compliance": ptopo.compliance.clone()})
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.lambda_dist, b.lambda_dist)
    with pytest.raises(ValueError, match="materials"):
        pgeneral.run_substeps_plain(st, ptopo, cfg, DT_SUB, 1, materials={
            "rest_lengths": ptopo.rest_lengths[:-1],
            "compliance": ptopo.compliance})


def test_backward_auto_chooses_by_the_envelope():
    _, _, ptopo, _, pcfg = material_setup()
    inside = kdiff.make_differentiable_mesh_runner(ptopo, pcfg, DT_SUB, 4,
                                                   backward="auto")
    outside = kdiff.make_differentiable_mesh_runner(
        ptopo, pcfg.replace(solve_mode=port.SolveMode.COLORED), DT_SUB, 4,
        backward="auto")
    assert "fused" in inside.__qualname__
    assert "pair_with_vjp" in outside.__qualname__
    with pytest.raises(NotImplementedError, match="fused mesh backward"):
        kdiff.make_differentiable_mesh_runner(
            ptopo, pcfg.replace(solve_mode=port.SolveMode.COLORED), DT_SUB,
            4, backward="fused")
    with pytest.raises(ValueError, match="backward"):
        kdiff.make_differentiable_mesh_runner(ptopo, pcfg, DT_SUB, 4,
                                              backward="pallas")


def test_paired_runners_refuse_approx_math_and_ensembles():
    _, _, ptopo, _, pcfg = material_setup()
    spec = ptop.lattice_spec(4, braced=True)
    for make, args in ((kdiff.make_differentiable_mesh_runner, (ptopo,)),
                       (kdiff.make_differentiable_lattice_runner, (spec,)),
                       (kdiff.make_differentiable_material_runner,
                        (ptopo,))):
        with pytest.raises(NotImplementedError, match="approx_math"):
            make(*args, pcfg, DT_SUB, 4, approx_math=True)
    for make in (kdiff.make_differentiable_material_ensemble_runner,
                 kdiff.make_differentiable_mesh_ensemble_runner):
        make(ptopo, pcfg, DT_SUB, 4, n_bodies=2)
        with pytest.raises(NotImplementedError, match="approx_math"):
            make(ptopo, pcfg, DT_SUB, 4, n_bodies=2, approx_math=True)
