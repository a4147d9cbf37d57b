"""Gradients through the two places where the port's plain engine once
parted from the JAX package's, on the CPU: bending's arccos, whose
derivative is infinite at a flat hinge (``ops/bending.py`` carries the JAX
op's clamped derivative, ``_SafeArccos``), and the column-order sums of
hub rows, incidence rows wider than ``HUB_WIDTH`` (``gather_sum`` sums
them on the tensor's device inside the autograd graph).  Same gates as
``test_torch_diff.py``: max |dg| / max |g| < 1e-4, value within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.ops import bending as jbending
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

from softbodysimulation_tpu_torch.kernels import diff as kdiff
from softbodysimulation_tpu_torch.ops import bending as pbending
from softbodysimulation_tpu_torch.ops import incidence as pincidence
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import mesh as pmesh

import test_torch_contact_cases as contact_cases
from test_torch_diff import (DT_SUB, assert_grads_match, assert_values_match,
                             jax_rollout, jax_state, mesh_cfg, port_state,
                             scale_grads, sum_sq)
from test_torch_state import port_config

torch.set_num_threads(1)


def flat_cloth(mesh_mod, build_mod, res=8):
    """A planar standing cloth (every hinge flat), top row pinned."""
    m = mesh_mod.grid_plane(1.0, res)
    verts = m.vertices[:, [0, 2, 1]].copy()
    verts[:, 2] = 0.0
    pos, topo = build_mod.topology_from_mesh(
        mesh_mod.TriMesh(verts, m.triangles), compliance=1e-5, bending=True,
        bend_compliance=1e-3, windowed="colored")
    return pos + np.array([0.0, 1.2, 0.0], np.float32), topo


def test_mesh_runner_colored_bending_flat_cloth_grads():
    """COLORED bending on a planar cloth through the paired runner
    (backward "xla", autograd through the plain engine): every hinge is
    flat, where arccos' derivative is infinite; the clamped derivative
    keeps the gradient finite and equal to JAX's."""
    pos, jtopo = flat_cloth(jmesh, jbuild)
    _, ptopo = flat_cloth(pmesh, pbuild)
    jcfg = mesh_cfg(jconfig, solve_mode=jconfig.SolveMode.COLORED,
                    enable_bending=True)
    n_sub = 4
    top = np.flatnonzero(pos[:, 1] > pos[:, 1].max() - 1e-4)
    jroll = jax_rollout(jtopo, jcfg, n_sub)

    def pinned(st, xp):
        w = np.ones(pos.shape[0], np.float32)
        w[top] = 0.0
        return st.replace(inv_mass=xp.asarray(w))

    run = kdiff.make_differentiable_mesh_runner(ptopo, port_config(jcfg),
                                                DT_SUB, n_sub)
    got, ref = scale_grads(jtopo, lambda s: jroll(pinned(s, jnp)), ptopo,
                           lambda s: run(pinned(s, torch)), pos, sum_sq)
    assert np.isfinite(got[1])
    assert_values_match(got[0], ref[0])
    assert_grads_match(got[1], ref[1])


def test_safe_arccos_gradient_at_flat_and_bent_hinges():
    """The bending op's gradient through the port's arccos: finite at a
    flat hinge (cos = 1, where torch.acos' derivative is infinite) and
    equal to the JAX op's clamped-JVP gradient at flat and bent hinges."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0], [0.5, -1, 0]],
                   np.float32)
    cfg = jconfig.SolverConfig()
    for lift in (0.0, 0.3):
        p = pts.copy()
        p[3, 2] = lift
        w = jnp.ones(())

        def jfn(x):
            dl, *g = jbending.bending_delta_lambda(
                x[0], x[1], x[2], x[3], w, w, w, w, jnp.float32(0.1),
                jnp.float32(1e-3), jnp.float32(0.0), DT_SUB, cfg)
            return dl + sum(jnp.sum(gi) for gi in g)

        jgrad = np.asarray(jax.grad(jfn)(jnp.asarray(p)))
        x = torch.as_tensor(p).requires_grad_()
        one = torch.tensor(1.0)
        dl, *g = pbending.bending_delta_lambda(
            x[0], x[1], x[2], x[3], one, one, one, one, torch.tensor(0.1),
            torch.tensor(1e-3), torch.tensor(0.0), DT_SUB, port_config(cfg))
        (grad,) = torch.autograd.grad(dl + sum(gi.sum() for gi in g), x)
        assert torch.isfinite(grad).all(), lift
        assert np.isfinite(jgrad).all()
        np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(jgrad).max(), 1.0))
    assert np.abs(jgrad).max() > 1e-2


def test_hub_row_gradients_match_jax():
    """A tet ball whose centre is in all 80 tets and on 42 spoke edges
    (rows wider than ``HUB_WIDTH``): position gradients through the
    paired runner, whose backward sums those rows on the device inside
    the autograd graph, equal JAX's."""
    jmods = contact_cases.modules("softbodysimulation_tpu")
    pmods = contact_cases.modules()
    pos, jtopo = contact_cases.tet_body("ball1", jmods)
    _, ptopo = contact_cases.tet_body("ball1", pmods)
    hub = pincidence.Incidence.of(ptopo.tet_incidence, 4 * ptopo.n_tets)
    assert hub.hub_rows.numel() == 1
    jcfg = jconfig.SolverConfig(
        substeps=4, iterations=4, damping=0.02,
        solve_mode=jconfig.SolveMode.JACOBI, enable_tet_volume=True,
        tet_pressure=1.05, jacobi_rho=0.0, ground_height=0.0, friction=0.3)
    n_sub = 4
    jroll = jax_rollout(jtopo, jcfg, n_sub)
    wts = np.random.default_rng(3).normal(size=pos.shape).astype(np.float32)

    def jloss(x):
        s = jax_state(jtopo, pos).replace(positions=x)
        return jnp.sum(jnp.asarray(wts) * jroll(s).positions)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(pos)))
    run = kdiff.make_differentiable_mesh_runner(ptopo, port_config(jcfg),
                                                DT_SUB, n_sub)
    x = torch.as_tensor(pos).requires_grad_()
    loss = (torch.as_tensor(wts)
            * run(port_state(ptopo, pos).replace(positions=x)).positions
            ).sum()
    (grad,) = torch.autograd.grad(loss, x)
    centre = int(hub.hub_rows[0])
    assert abs(float(grad[centre].abs().max())) > 1e-3
    assert_grads_match(grad, jgrad)
