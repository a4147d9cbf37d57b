"""The port's fused mesh backward (``kernels/mesh_diff.py``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_mesh_diff_pallas.py`` for what is ported: the plain
version of the B-5 kernel, ``backward_chunk_plain`` (and the fused runners
around it, multi-chunk included), against ``jax.vjp`` of the JAX general
engine's rollout on the same inputs, for every case of
``test_torch_diff_cases.py`` (the six (iterations, lambda mode, floor)
cases, multi-chunk, position and multiplier cotangents, pins, WARM_START
with (clamp, fraction) in {(0, 1), (0.5, 0.5)}, a static sphere, the
clamps, traced materials); two runner gradients against the JAX fused
backward in interpret mode; and the envelope guards.  Gate: the JAX
suite's, max |dg| / max |g| < 1e-4 with max |g| > 1e-3, value within 1e-3
relative (``tests/test_mesh_diff_pallas.py:76-87``).  The JAX engine runs
its gather backend: the windowed backend's VJP rounds gather cotangents to
bf16 (``tests/test_mesh_diff_pallas.py:147-156``).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.kernels import mesh_diff_pallas as jmdp
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

from softbodysimulation_tpu_torch.kernels import diff as kdiff
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.kernels import mesh_diff as md

import test_torch_diff_cases as cases

torch.set_num_threads(1)

CASES = cases.diff_cases()
JCASES = cases.diff_cases(jconfig)


def jax_vjp(name):
    """``jax.vjp`` of the JAX engine's rollout of a case (jitted, a scan
    over substeps), at its inputs and cotangents, as numpy
    ``{GRAD_KEYS: array}``."""
    cfg, n_sub, _, kw = JCASES[name]
    cfg = cfg.replace(distance_backend="gather")
    topo, f = cases.case_inputs(kw, jbuild, jmesh)
    state = jstate_mod.SimState(**{k: jnp.asarray(f[k])
                                   for k in cases.STATE_KEYS})
    mats = "rest_lengths" in f

    def roll(x, v, lam, rest, comp):
        s = state.replace(positions=x, velocities=v, lambda_dist=lam)
        t = topo.replace(rest_lengths=rest, compliance=comp)
        s, _ = lax.scan(lambda c, _: (jgeneral._substep(
            c, t, cfg, cases.DT, apply_ext=False), None), s, None,
            length=n_sub)
        return s.positions, s.velocities, s.lambda_dist

    prim = [jnp.asarray(f[k]) for k in ("positions", "velocities",
                                        "lambda_dist")]
    prim += ([jnp.asarray(f["rest_lengths"]), jnp.asarray(f["compliance"])]
             if mats else [topo.rest_lengths, topo.compliance])
    cot = tuple(jnp.asarray(f[k]) for k in ("gx", "gv", "glam"))
    g = jax.jit(lambda p, c: jax.vjp(roll, *p)[1](c))(prim, cot)
    return {k: np.asarray(v) for k, v in zip(cases.GRAD_KEYS,
                                             g if mats else g[:3])}


def port_vjp(name):
    """The port's fused backward of a case on the CPU: one
    ``backward_chunk_plain`` over the rollout, or (a case with a chunk) the
    fused runner's autograd with its backward chunks chained."""
    cfg, n_sub, chunk, kw = CASES[name]
    topo, f = cases.case_inputs(kw)
    state, cot, mats = cases.port_inputs(f)
    if chunk is None:
        g = cases.chunk_vjp(md.backward_chunk_plain, topo, cfg, n_sub, state,
                            cot, mats)
        return {k: v.numpy() for k, v in g.items()}
    leaves = [t.clone().requires_grad_() for t in (
        state.positions, state.velocities, state.lambda_dist)]
    s = state.replace(positions=leaves[0], velocities=leaves[1],
                      lambda_dist=leaves[2])
    if mats is None:
        run = md.make_fused_differentiable_mesh_runner(
            topo, cfg, cases.DT, n_sub, chunk_substeps=chunk)
        out = run(s)
    else:
        mats = {k: v.clone().requires_grad_() for k, v in mats.items()}
        leaves += [mats["rest_lengths"], mats["compliance"]]
        run = md.make_fused_differentiable_material_runner(
            topo, cfg, cases.DT, n_sub, chunk_substeps=chunk)
        out = run(s, mats)
    g = torch.autograd.grad([out.positions, out.velocities, out.lambda_dist],
                            leaves, list(cot))
    return {k: v.numpy() for k, v in zip(cases.GRAD_KEYS, g)}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_backward_matches_jax_engine(name):
    ref = jax_vjp(name)
    got = port_vjp(name)
    err = cases.normalized_errors(got, ref)
    assert max(err.values()) < cases.GRAD_TOL, (name, err)
    assert np.abs(ref["gx"]).max() > 1e-3
    for k in ref:
        assert np.isfinite(got[k]).all(), k


V0 = np.asarray([0.3, 0.1, -0.2], np.float32)


@pytest.mark.parametrize("iters,lam", [(2, "reset"), (4, "warm_start")])
def test_fused_runner_matches_jax_fused_backward(iters, lam):
    """value_and_grad of sum(x * y) w.r.t. a launch velocity through the
    port's fused runner and through the JAX fused backward (interpret
    mode) on the windowed topology."""
    n_sub = 3
    jpos, jtopo = jbuild.topology_from_mesh(
        jmesh.icosphere(2, radius=0.5), compliance=1e-6, windowed=True,
        block_edges=256)
    jpos = jpos + np.array([0, 0.45, 0], np.float32)
    jcfg = cases.config(jconfig, iterations=iters,
                        lambda_mode=jconfig.LambdaMode(lam),
                        distance_backend="windowed")
    jst = jstate_mod.state_from_topology(jtopo, jpos)
    with pltpu.force_tpu_interpret_mode():
        fused = jmdp.make_fused_differentiable_mesh_runner(
            jtopo, jcfg, cases.DT, n_sub)

        def jloss(v0):
            out = fused(jst.replace(velocities=jnp.broadcast_to(
                v0, jst.velocities.shape)))
            return jnp.sum(out.positions[:, 0] * out.positions[:, 1])

        jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(V0))
    pos, topo = cases.scene()
    np.testing.assert_array_equal(pos, jpos)
    cfg = cases.config(iterations=iters,
                       lambda_mode=cases._port_config.LambdaMode(lam))
    from softbodysimulation_tpu_torch import state_from_topology
    st = state_from_topology(topo, pos, device="cpu")
    run = kdiff.make_differentiable_mesh_runner(topo, cfg, cases.DT, n_sub,
                                                backward="fused")
    v0 = torch.as_tensor(V0).requires_grad_()
    out = run(st.replace(velocities=v0.expand(topo.n_particles, 3)))
    loss = (out.positions[:, 0] * out.positions[:, 1]).sum()
    (grad,) = torch.autograd.grad(loss, v0)
    jg = np.asarray(jgrad)
    assert abs(float(loss.detach()) - float(jval)) < 1e-3 * max(1.0, abs(float(jval)))
    np.testing.assert_allclose(grad.numpy() / np.abs(jg).max(),
                               jg / np.abs(jg).max(), atol=cases.GRAD_TOL)
    assert np.abs(jg).max() > 1e-3


def test_fused_backward_envelope_guards():
    _, topo = cases.scene()
    C = cases._port_config
    for kw in (dict(solve_mode=C.SolveMode.COLORED),
               dict(enable_volume=True),
               dict(enable_self_collision=True,
                    self_collision_backend="dense"),
               dict(floor_mode=C.FloorMode.VELOCITY_REFLECT),
               dict(box_colliders=((0.0, 0.2, 0.0, 0.1, 0.1, 0.1),))):
        with pytest.raises(NotImplementedError, match="fused mesh backward"):
            md.make_fused_differentiable_mesh_runner(
                topo, cases.config(**kw), cases.DT, 4)
    with pytest.raises(ValueError, match="divide"):
        md.make_fused_differentiable_mesh_runner(topo, cases.config(),
                                                 cases.DT, 4,
                                                 chunk_substeps=3)
    # kinematic spheres are covered (test_torch_kin_diff.py); kinematic
    # boxes are not, as in JAX
    with pytest.raises(NotImplementedError, match="kinematic box"):
        md.make_fused_differentiable_mesh_runner(
            topo, cases.config(), cases.DT, 4, kin_colliders=(1, 1))
    for kw in (dict(max_dlambda_rel=0.1),
               dict(lambda_mode=C.LambdaMode.WARM_START,
                    warm_start_clamp=0.5)):
        with pytest.raises(NotImplementedError, match="with materials"):
            md.make_fused_differentiable_material_runner(
                topo, cases.config(**kw), cases.DT, 4)


def test_chunk_choice_fits_the_stash_budget():
    """The whole rollout when its stash fits, else the largest divisor
    that does; the 240-substep icosphere(4) rollout of bench_diff.py is
    one chunk of ~0.12 GB."""
    _, topo = cases.scene()
    cfg = cases.config()
    one = md.stash_bytes(topo, cfg, 1)
    assert md.pick_chunk(topo, cfg, 12) == 12
    assert md.pick_chunk(topo, cfg, 12, budget=5 * one) == 4
    with pytest.raises(NotImplementedError, match="budget"):
        md.pick_chunk(topo, cfg, 12, budget=one - 1)
    big = cases._port_build.topology_from_mesh(
        cases._port_mesh.icosphere(4, radius=0.5), compliance=1e-6)[1]
    assert (big.n_particles, big.n_edges) == (2562, 7680)
    assert 0.1e9 < md.stash_bytes(big, cfg, 240) < 0.16e9
    assert md.pick_chunk(big, cfg, 240) == 240


def test_diff_buffers_mirror_the_cuda_source():
    """The ctypes ``DiffBuffers`` lists the pointers of the C struct in
    ``csrc/mesh_diff_xpbd.cu`` in the same order, and the source is built
    into the mesh library, beside the forward it replays."""
    src = (mc._build.CSRC_DIR / "mesh_diff_xpbd.cu").read_text()
    body = re.search(r"struct DiffBuffers \{(.*?)\n\};", src, re.S).group(1)
    names = re.findall(r"^\s*float\* (\w+);", body, re.M)
    assert names == [f[0] for f in mc.DiffBuffers._fields_]
    assert ctypes.sizeof(mc.DiffBuffers) == 8 * len(names)
    assert set(mc.SOURCES) >= {"mesh_diff_xpbd.cu", "mesh_xpbd.cu"}
    assert '#include "mesh_xpbd.cuh"' in src


def test_plain_backward_matches_float64_autograd_through_rest():
    """In float64, ``backward_chunk_plain`` equals autograd through the
    plain engine over a drop that lands on the floor and slides to rest
    under friction: the hand-written VJP is the engine's own derivative
    through the contact phase, not only in flight."""
    from softbodysimulation_tpu_torch import state_from_topology
    from softbodysimulation_tpu_torch.solvers import general

    pos, topo = cases._port_build.topology_from_mesh(
        cases._port_mesh.icosphere(1, radius=0.5), compliance=1e-6)
    pos = pos + np.array([0.0, 0.52, 0.0], np.float32)
    C = cases._port_config
    cfg = C.SolverConfig(substeps=4, iterations=4, damping=0.02,
                         solve_mode=C.SolveMode.JACOBI,
                         gravity_is_acceleration=True, ground_height=0.0,
                         friction=0.3)
    n_sub, n = 96, topo.n_particles
    st = state_from_topology(topo, pos, device="cpu")
    st = st.replace(**{k: getattr(st, k).double() for k in (
        "positions", "velocities", "inv_mass", "ext_force", "lambda_dist",
        "lambda_bend", "lambda_volume")})
    v0 = torch.tensor([0.3, 0.0, 0.1], dtype=torch.float64)
    v = v0.clone().requires_grad_()
    out = general.run_substeps_plain(st.replace(velocities=v.expand(n, 3)),
                                     topo, cfg, cases.DT, n_sub)
    (g_auto,) = torch.autograd.grad((out.positions ** 2).sum(), v)
    start = st.replace(velocities=v0.expand(n, 3).contiguous())
    end = out.positions.detach()
    _, gv, _ = md.backward_chunk_plain(
        topo, cfg, cases.DT, n_sub, start.inv_mass, start.positions,
        start.velocities, start.lambda_dist, 2.0 * end,
        torch.zeros_like(end), torch.zeros_like(start.lambda_dist))
    g_plain = gv.sum(0)
    assert float(end[:, 1].min()) < 1e-3          # the floor was active
    assert float(g_auto.abs().max()) > 1e-3
    err = float((g_plain - g_auto).abs().max() / g_auto.abs().max())
    assert err < 1e-9, (g_plain, g_auto)


def test_backward_dispatch_refuses_other_devices():
    _, topo = cases.scene()
    x = torch.zeros((topo.n_particles, 3), device="meta")
    with pytest.raises(NotImplementedError, match="no path"):
        md.backward_chunk(topo, cases.config(), cases.DT, 1, x[:, 0], x, x,
                          x[:0, 0], x, x, x[:0, 0])
