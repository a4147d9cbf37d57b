"""The fused mesh backward's kinematic pose cotangents
(``kernels/mesh_diff.py``: ``backward_chunk_plain``, the plain version of
TPU kernel B-5's ``gcao`` outputs, and the runners around it) against
``jax.grad`` of the JAX general engine, on the CPU.

Mirrors ``tests/test_mesh_diff_pallas.py:279-407``: the static sphere,
with Chebyshev and without; the kinematic sphere overlapping the shell
from the first substep with a random-weighted loss, at (substeps,
iterations, rho) = (1, 1, 0), (3, 2, 0) and (5, 4, 0.9) and that suite's
bands on one global scale across the pose leaves (1e-4, 5e-3, 5e-2);
pose cotangents summed over chunks (chunked equals flat, rtol 1e-5);
kinematic boxes refused.  The JAX
engine runs its gather backend (``test_torch_mesh_diff.py`` says why).
The paired runner (``backward="xla"``, autograd through the plain engine)
is held against the fused one as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from softbodysimulation_tpu.core import colliders as jcoll
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core.colliders import ColliderSet
from softbodysimulation_tpu_torch.kernels import diff as kdiff
from softbodysimulation_tpu_torch.kernels import mesh_diff as md

import test_torch_collider_cases as ccases
import test_torch_diff_cases as cases

torch.set_num_threads(1)

DT = cases.DT
POSE = ("spheres", "sphere_velocities", "ground_height")


def _scenes():
    jpos, jtopo = cases.scene(jbuild, jmesh)
    ppos, ptopo = cases.scene()
    np.testing.assert_array_equal(jpos, ppos)
    return jpos, jtopo, ptopo


def jax_pose_grads(cfg, n_sub, kin, wts):
    """(loss, {pose leaf: gradient}) of sum(wts * positions) after n_sub
    substeps of the JAX engine, differentiated through the state's
    ColliderSet."""
    pos, topo, _ = _scenes()
    st = jstate_mod.state_from_topology(topo, pos)
    cfg = cfg.replace(distance_backend="gather")

    def loss(c):
        s, _ = lax.scan(lambda cst, _: (jgeneral._substep(
            cst, topo, cfg, DT, apply_ext=False), None),
            st.replace(colliders=c), None, length=n_sub)
        return jnp.sum(jnp.asarray(wts) * s.positions)

    val, g = jax.value_and_grad(loss)(jcoll.make_colliders(**kin))
    return float(val), {k: np.asarray(getattr(g, k)) for k in POSE}


def port_pose_grads(cfg, n_sub, kin, wts, chunk=None, backward="fused"):
    """The same through the port's runner (fused: ``backward_chunk_plain``
    on the CPU; xla: autograd through the plain engine)."""
    pos, _, topo = _scenes()
    st = port.state_from_topology(topo, pos, device="cpu")
    coll = port.make_colliders(device="cpu", **kin)
    leaves = {k: getattr(coll, k).clone().requires_grad_()
              for k in port.core.colliders.FIELDS}
    run = kdiff.make_differentiable_mesh_runner(
        topo, cfg, DT, n_sub, remat_chunk=chunk or 0, backward=backward,
        kin_colliders=(coll.n_spheres, coll.n_boxes))
    out = run(st.replace(colliders=ColliderSet(**leaves)))
    loss = (torch.tensor(wts) * out.positions).sum()
    grads = torch.autograd.grad(loss, [leaves[k] for k in POSE])
    return float(loss.detach()), {k: g.numpy() for k, g in zip(POSE, grads)}


@pytest.mark.parametrize("n_sub,iters,rho,atol", ccases.KIN_DIFF_RUNS)
def test_fused_backward_kinematic_collider_pose_grads(n_sub, iters, rho,
                                                      atol):
    """Gradients w.r.t. the sphere's center, radius and velocity and the
    ground height through the fused backward's plain version against
    ``jax.grad`` through the JAX engine's collider leaf, on one global
    scale across the pose leaves (the JAX suite's bands), the loss value
    within 1e-3; the contact fires, so the pose gradients are non-trivial,
    and the paired (autograd) runner agrees with the fused one (< 1e-4)."""
    pos, _, _ = _scenes()
    wts = ccases.loss_weights(pos.shape[0])
    kw = dict(ground_height=123.0, iterations=iters, jacobi_rho=rho)
    val_r, g_r = jax_pose_grads(cases.config(jconfig, **kw), n_sub,
                                ccases.KIN_DIFF, wts)
    pcfg = cases.config(**kw)
    val_p, g_p = port_pose_grads(pcfg, n_sub, ccases.KIN_DIFF, wts)
    assert abs(val_p - val_r) < 1e-3 * max(1.0, abs(val_r))
    scale = max(max(np.abs(g).max() for g in g_r.values()), 1e-12)
    for k in POSE:
        np.testing.assert_allclose(g_p[k] / scale, g_r[k] / scale,
                                   atol=atol, err_msg=k)
    assert np.abs(g_r["spheres"]).max() > 1e-3
    _, g_x = port_pose_grads(pcfg, n_sub, ccases.KIN_DIFF, wts,
                             backward="xla")
    for k in POSE:
        np.testing.assert_allclose(g_x[k] / scale, g_p[k] / scale,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("rho,cross", [(0.0, 1e-4), (0.9, 5e-3)],
                         ids=["jacobi", "chebyshev"])
def test_fused_backward_static_sphere_collider_grads(rho, cross):
    """The config's static sphere is covered by the fused backward: the
    launch-velocity gradient (the JAX suite's V0 and loss) equals autograd
    through the port's plain engine on the same trajectory (< 1e-4, the
    suite's gate), and tracks ``jax.grad`` of the JAX engine: within that
    gate, the forwards within 1e-6, without Chebyshev (measured 8.4e-8
    and 3.0e-7 at rho 0); with Chebyshev (rho 0.9) within the suite's
    multi-substep contact band, 5e-3 (measured 2.6e-4; the forwards
    1.6e-5 apart after 5 substeps).  There the two packages' forwards
    part after one substep by 1.4e-5: particles
    projected onto the sphere sit on its surface (|d| = r to an ulp), the
    next iteration's gate pen > 0 flips on the ulp by which the packages'
    norms differ, and the Chebyshev step amplifies the flip."""
    pos, jtopo, ptopo = _scenes()
    kw = dict(sphere_colliders=((0.0, 0.1, 0.0, 0.3),), jacobi_rho=rho)
    jcfg = cases.config(jconfig, **kw).replace(distance_backend="gather")
    jst = jstate_mod.state_from_topology(jtopo, pos)
    v0 = np.asarray([0.3, 0.1, -0.2], np.float32)

    def jrun(v):
        s = jst.replace(velocities=jnp.broadcast_to(v, jst.velocities.shape))
        s, _ = lax.scan(lambda c, _: (jgeneral._substep(
            c, jtopo, jcfg, DT, apply_ext=False), None), s, None, length=5)
        return s.positions

    def jloss(v):
        p = jrun(v)
        return jnp.sum(p[:, 0] * p[:, 1])

    g_r = np.asarray(jax.grad(jloss)(jnp.asarray(v0)))
    st = port.state_from_topology(ptopo, pos, device="cpu")
    grads = {}
    for backward in ("fused", "xla"):
        run = kdiff.make_differentiable_mesh_runner(
            ptopo, cases.config(**kw), DT, 5, backward=backward)
        v = torch.tensor(v0, requires_grad=True)
        out = run(st.replace(velocities=v.expand(st.n_particles, 3)))
        (grads[backward],) = torch.autograd.grad(
            (out.positions[:, 0] * out.positions[:, 1]).sum(), v)
    scale = np.abs(g_r).max()
    assert scale > 1e-3
    g = grads["fused"].numpy()
    assert np.abs(g - grads["xla"].numpy()).max() / scale < 1e-4
    assert np.abs(g - g_r).max() / scale < cross
    if rho == 0.0:
        fwd = np.abs(out.positions.detach().numpy()
                     - np.asarray(jrun(jnp.asarray(v0)))).max()
        assert fwd < 1e-6, fwd


def test_fused_backward_kin_multi_chunk_pose_grads_sum():
    """Chunked backward: the pose cotangents SUM over the chunks (the pose
    is constant over the rollout) -- chunked equals flat (rtol 1e-5)."""
    pos, _, _ = _scenes()
    cfg = cases.config(lambda_mode=port.LambdaMode.DECAY, ground_height=55.0)
    kin = dict(spheres=[(0.6, 0.45, 0.0, 0.2)], ground_height=0.0)
    wts = 2.0 * pos       # the gradient of sum(positions^2) at the start
    _, flat = port_pose_grads(cfg, 6, kin, wts)
    _, chunked = port_pose_grads(cfg, 6, kin, wts, chunk=2)
    for k in POSE:
        np.testing.assert_allclose(chunked[k], flat[k], rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    assert np.abs(flat["spheres"]).max() > 1e-3


def test_backward_chunk_plain_pose_outputs():
    """``backward_chunk_plain`` with a ColliderSet appends the pose
    cotangents, shaped as the ColliderSet's leaves; without contact they
    are zero."""
    pos, _, topo = _scenes()
    st = port.state_from_topology(topo, pos, device="cpu")
    z = torch.zeros_like(st.positions)
    g = torch.ones_like(st.positions)
    cfg = cases.config(ground_height=123.0)
    for kin, touching in ((ccases.KIN_DIFF, True),
                          (dict(spheres=[(9.0, 9.0, 9.0, 0.1)],
                                ground_height=-5.0), False)):
        coll = port.make_colliders(device="cpu", **kin)
        out = md.backward_chunk_plain(
            topo, cfg, DT, 3, st.inv_mass, st.positions, st.velocities,
            st.lambda_dist, g, z, torch.zeros_like(st.lambda_dist),
            colliders=coll)
        assert len(out) == 4
        pose = out[-1]
        assert pose["spheres"].shape == (1, 4)
        assert pose["sphere_velocities"].shape == (1, 3)
        assert pose["ground_height"].shape == ()
        big = max(float(v.abs().max()) for v in pose.values())
        assert (big > 1e-3) == touching


def test_fused_backward_kin_box_rejected():
    _, _, topo = _scenes()
    with pytest.raises(NotImplementedError, match="kinematic box"):
        md.make_fused_differentiable_mesh_runner(
            topo, cases.config(), DT, 4, kin_colliders=(1, 1))
    # the config's boxes stay refused; a ColliderSet replaces them
    with pytest.raises(NotImplementedError, match="box colliders"):
        md.make_fused_differentiable_mesh_runner(
            topo, cases.config(box_colliders=(
                (0.0, 0.2, 0.0, 0.1, 0.1, 0.1),)), DT, 4)
    md.make_fused_differentiable_mesh_runner(
        topo, cases.config(box_colliders=((0.0, 0.2, 0.0, 0.1, 0.1, 0.1),)),
        DT, 4, kin_colliders=(1, 0))
