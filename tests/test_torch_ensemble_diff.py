"""The ensemble differentiable runners (``kernels/diff.py``) and the
differentiable sharded farm (``parallel/batch.py``) against the JAX
package's gradients, on the CPU.

Mirrors ``tests/test_diff_kernels.py:136, 317, 342`` and
``tests/test_parallel.py:338``.  The same inputs go through ``jax.grad``
of JAX's vmapped general engine (its gather sweep, the port's semantics)
and through the port's runners, whose forward is the B-3 ensemble (its
plain twin on the CPU) and whose backward is autograd through the plain
engine body by body.  Gate: max |dg| / max |g| < 1e-4 with max |g| above a
floor, values within 1e-4 relative; bodies with different masses or
materials get different gradients; a shared leaf's gradient is the sum
over the bodies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from softbodysimulation_tpu import LambdaMode, SolveMode, SolverConfig
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.kernels import diff as kdiff
from softbodysimulation_tpu_torch.parallel import batch as pbatch
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import mesh as pmesh

import test_torch_batch as batch_tests
from test_torch_diff import (DT_SUB, assert_grads_match, jax_state,
                             mesh_cfg, mesh_setup)
from test_torch_state import port_config, to_port

torch.set_num_threads(1)

NB, N_SUB = 2, 4


def setup():
    """(JAX topology, port topology, JAX config, port config, JAX state,
    port batched state with a shared inv_mass) of
    ``tests/test_diff_kernels.py:297-306``."""
    pos, jtopo = mesh_setup(jmesh, jbuild)
    _, ptopo = mesh_setup(pmesh, pbuild)
    jcfg = mesh_cfg(jconfig, distance_backend="gather")
    st = jax_state(jtopo, pos)
    one = to_port(st)
    batched = pbatch.replicate_state(one, NB).replace(inv_mass=one.inv_mass)
    return jtopo, ptopo, jcfg, port_config(jcfg), st, batched


def jax_one(jtopo, jcfg):
    def one(state, rest=None, comp=None):
        t = jtopo if rest is None else jtopo.replace(rest_lengths=rest,
                                                     compliance=comp)
        out, _ = lax.scan(lambda c, _: (jgeneral._substep(
            c, t, jcfg, DT_SUB, apply_ext=False), None), state, None,
            length=N_SUB)
        return out
    return one


def full(st):
    return jax.tree.map(lambda x: jnp.broadcast_to(x[None], (NB,) + x.shape),
                        st)


def test_mesh_ensemble_runner_mass_grads_match_jax():
    """``tests/test_diff_kernels.py:136``: gradients w.r.t. per-body masses
    (a ``(B, N)`` inv_mass) equal JAX's, and differ between the bodies."""
    jtopo, ptopo, jcfg, pcfg, st, batched = setup()
    im0 = np.stack([np.asarray(st.inv_mass) * s for s in (1.0, 1.5)])
    one = jax_one(jtopo, jcfg)

    def jloss(im):
        return jnp.sum(jax.vmap(one)(full(st).replace(inv_mass=im))
                       .positions ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(im0))
    run = kdiff.make_differentiable_mesh_ensemble_runner(
        ptopo, pcfg, DT_SUB, N_SUB, n_bodies=NB)
    im = torch.as_tensor(im0).requires_grad_()
    loss = (run(batched.replace(inv_mass=im)).positions ** 2).sum()
    (grad,) = torch.autograd.grad(loss, im)
    assert abs(float(loss.detach()) - float(jval)) / abs(float(jval)) < 1e-4
    assert_grads_match(grad.numpy(), jgrad, floor=1e-4)
    g = np.asarray(jgrad)
    assert np.abs(g[0] - g[1]).max() > 1e-6


def test_material_ensemble_grads_match_jax():
    """``tests/test_diff_kernels.py:342``: per-body (B, E) materials; the
    gradients of both material vectors equal JAX's vmapped engine, differ
    between the bodies, and the shared inv_mass's is their sum."""
    jtopo, ptopo, jcfg, pcfg, st, batched = setup()
    rest0 = np.stack([np.asarray(jtopo.rest_lengths) * s for s in (1.0,
                                                                   1.08)])
    comp0 = np.stack([np.asarray(jtopo.compliance) * s for s in (1.0, 4.0)])
    one = jax_one(jtopo, jcfg)

    def jloss(mats, im):
        s = full(st).replace(inv_mass=jnp.broadcast_to(im, (NB,) + im.shape))
        return jnp.sum(jax.vmap(one)(s, mats["rest_lengths"],
                                     mats["compliance"]).positions ** 2)

    jmats = {"rest_lengths": jnp.asarray(rest0),
             "compliance": jnp.asarray(comp0)}
    jval, (jg, jg_im) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jmats, st.inv_mass)
    run = kdiff.make_differentiable_material_ensemble_runner(
        ptopo, pcfg, DT_SUB, N_SUB, n_bodies=NB)
    mats = {"rest_lengths": torch.as_tensor(rest0).requires_grad_(),
            "compliance": torch.as_tensor(comp0).requires_grad_()}
    im = batched.inv_mass.clone().requires_grad_()
    loss = (run(batched.replace(inv_mass=im), mats).positions ** 2).sum()
    grads = torch.autograd.grad(loss, (mats["rest_lengths"],
                                       mats["compliance"], im))
    assert abs(float(loss.detach()) - float(jval)) / abs(float(jval)) < 1e-4
    assert_grads_match(grads[0].numpy(), jg["rest_lengths"])
    assert_grads_match(grads[1].numpy(), jg["compliance"], floor=1e-12)
    assert_grads_match(grads[2].numpy(), jg_im, floor=1e-4)
    g = np.asarray(jg["rest_lengths"])
    assert np.abs(g[0] - g[1]).max() > 1e-6


def test_per_body_materials_rows_match_shared():
    """``tests/test_diff_kernels.py:317``: equal (B, E) rows give the
    shared (E,) result to the bit through the material ensemble runner,
    and the shared vector's gradient is the sum of the rows'."""
    _, ptopo, _, pcfg, _, batched = setup()
    run = kdiff.make_differentiable_material_ensemble_runner(
        ptopo, pcfg, DT_SUB, N_SUB, n_bodies=NB)
    shared = {"rest_lengths": ptopo.rest_lengths.clone().requires_grad_(),
              "compliance": ptopo.compliance.clone()}
    rows = {"rest_lengths": ptopo.rest_lengths.expand(NB, -1).clone()
            .requires_grad_(),
            "compliance": ptopo.compliance.expand(NB, -1).clone()}
    a, b = run(batched, shared), run(batched, rows)
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.lambda_dist, b.lambda_dist)
    (ga,) = torch.autograd.grad((a.positions ** 2).sum(),
                                shared["rest_lengths"])
    (gb,) = torch.autograd.grad((b.positions ** 2).sum(),
                                rows["rest_lengths"])
    torch.testing.assert_close(ga, gb.sum(0), rtol=1e-5, atol=1e-7)


def test_ensemble_runner_chunked_backward_equals_flat():
    """``remat_chunk`` replays the same arithmetic in checkpointed chunks:
    the gradients equal the flat backward's."""
    _, ptopo, _, pcfg, st, batched = setup()
    im0 = torch.stack([batched.inv_mass, batched.inv_mass * 1.5])
    grads = []
    for chunk in (0, 2):
        run = kdiff.make_differentiable_mesh_ensemble_runner(
            ptopo, pcfg, DT_SUB, N_SUB, n_bodies=NB, remat_chunk=chunk)
        im = im0.clone().requires_grad_()
        loss = (run(batched.replace(inv_mass=im)).positions ** 2).sum()
        grads.append(torch.autograd.grad(loss, im)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-9)
    assert float(grads[0].abs().max()) > 1e-4


def test_differentiable_sharded_mesh_rollout_grads():
    """A loss over 4 shards of a farm: gradients w.r.t. a launch velocity
    and the shared inv_mass (handed to every shard, so its cotangent gathers
    every body's) equal jax.grad of JAX's vmapped engine within 1e-4.  The
    JAX engine runs its gather sweep, the port's semantics: on this
    windowed topology its default spells the sweep as one-hot products,
    which the mass gradient feels at 3e-4."""
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI, jacobi_rho=0.0,
                       lambda_mode=LambdaMode.RESET, ground_height=-2.0,
                       distance_backend="gather")
    jtopo, jb, ptopo, pb = batch_tests._mesh_farm(4, 5)
    n_sub = 4
    mesh = pbatch.make_mesh(4, "cpu")
    run = pbatch.make_differentiable_sharded_mesh_rollout(
        ptopo, port_config(cfg), batch_tests.DT / cfg.substeps, n_sub, mesh, 4)
    v0 = torch.tensor([0.2, 0.0, -0.1], requires_grad=True)
    im = pb.inv_mass.clone().requires_grad_()
    st = pb.replace(velocities=v0.expand(pb.velocities.shape), inv_mass=im)
    out = pbatch.gather_batched_state(run(pbatch.shard_batched_state(st,
                                                                     mesh)))
    loss = (out.positions ** 2).sum()
    g_v0, g_im = torch.autograd.grad(loss, (v0, im))

    def jloss(v, w):
        s = jb.replace(velocities=jnp.broadcast_to(v, jb.velocities.shape),
                       inv_mass=w)
        return jnp.sum(batch_tests._jax_rollout(jtopo, cfg, s, n_sub).positions ** 2)

    val, (jg_v0, jg_im) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray([0.2, 0.0, -0.1]), jb.inv_mass)
    assert abs(float(loss.detach()) - float(val)) / abs(float(val)) < 1e-4
    for got, want in ((g_v0, jg_v0), (g_im, jg_im)):
        want = np.asarray(want)
        assert np.abs(want).max() > 1e-4
        assert (np.abs(got.numpy() - want).max() / np.abs(want).max()
                < 1e-4)
