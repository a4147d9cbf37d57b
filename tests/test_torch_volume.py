"""The global volume (pressure) constraint, ``add_wind`` and the windowed tet
route of the PyTorch port against the JAX package, on the CPU.

Same inputs, made by numpy from a seed (``test_torch_volume_cases.py``),
go through both packages: ``ops/volume`` against JAX's (1e-6 relative);
the plain general engine against JAX's ``general.make_step`` for every
solve mode under every lambda mode, and beside dense contact and the
per-tet volume (positions < 2e-5, 1e-5 COLORED; the
volume multiplier within JAX's own band of 1e-4 between its kernel and
its engine, ``tests/test_mesh_pallas.py:781``, and nonzero); the B-3
runners' plain twins, one body and ensembles with a ``(B,)``
``lambda_volume``, against JAX's engine and its ``vmap``; the one
interpret-mode case, ``tests/test_mesh_pallas.py:799``'s ensemble through
JAX's Pallas kernel; ensemble gradients against ``jax.value_and_grad`` of
the vmapped engine and a float64 witness (1e-4 relative); the windowed
tet backend against JAX's (1e-4, the JAX suite's own windowed-vs-gather gate,
``tests/test_tets.py:803``: JAX sums its one-hot products in another
order); and ``add_wind`` (1e-6 without gusts; with gusts the properties,
since JAX's random stream has no torch counterpart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax import lax
from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.interact import forces as jforces
from softbodysimulation_tpu.kernels import mesh_pallas
from softbodysimulation_tpu.ops import volume as jvolume
from softbodysimulation_tpu.parallel import batch as jbatch
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import edges as jedges
from softbodysimulation_tpu.topology import lattice as jlattice
from softbodysimulation_tpu.topology import mesh as jmesh
from softbodysimulation_tpu.topology import tets as jtets
from softbodysimulation_tpu.topology import windows as jwindows

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core.state import body_of
from softbodysimulation_tpu_torch.interact import forces as pforces
from softbodysimulation_tpu_torch.kernels import diff as pdiff
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.ops import volume as pvolume
from softbodysimulation_tpu_torch.parallel import batch as pbatch
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import edges as pedges
from softbodysimulation_tpu_torch.topology import lattice as plattice
from softbodysimulation_tpu_torch.topology import tets as ptets

import test_torch_volume_cases as V
from test_torch_state import port_config

torch.set_num_threads(1)

CASES = V.volume_cases(jconfig)
ONE = [k for k, (c, nb, _) in CASES.items() if nb == 1 and not V.mixed(c)]
# beside dense contact or the per-tet volume: test_torch_volume_mixed.py
MIXED = [k for k, (c, nb, _) in CASES.items() if nb == 1 and V.mixed(c)]
ENSEMBLES = [k for k, (_, nb, _) in CASES.items() if nb > 1]


def both(name):
    """(JAX config, JAX topology, JAX state, port config, port topology,
    port state, n_bodies, frames) of a case, each package's builders."""
    jcfg, jtopo, fields, nb, frames = V.case_inputs(name, jbuild, jmesh,
                                                    jconfig, jtets)
    pcfg, ptopo, pfields, _, _ = V.case_inputs(name)
    for k in fields:
        np.testing.assert_array_equal(fields[k], pfields[k])
    ps = port.state_from_numpy(fields, device="cpu")
    if nb > 1:
        # JAX's vmap batches every leaf: the shared masses broadcast
        fields = dict(fields, inv_mass=np.broadcast_to(
            fields["inv_mass"], (nb,) + fields["inv_mass"].shape))
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jcfg, jtopo, js, pcfg, ptopo, ps, nb, frames


def dmax(jarr, tensor):
    return float(np.abs(np.asarray(jarr)
                        - tensor.detach().numpy()).max(initial=0.0))


def assert_volume_gates(jout, pout, cfg):
    """Positions, ``lambda_dist`` and ``lambda_volume`` (nonzero) at the
    gates of ``test_torch_volume_cases.py``; with tets ``lambda_tet``
    within 1e-4 of its largest (``test_torch_batch.py``'s gate)."""
    assert port.is_finite(pout)
    assert dmax(jout.positions, pout.positions) < V.dx_gate(cfg)
    assert dmax(jout.lambda_dist, pout.lambda_dist) < 1e-6
    assert dmax(jout.lambda_volume, pout.lambda_volume) < V.DLAM_VOLUME
    assert float(pout.lambda_volume.abs().min()) > 0.0
    if cfg.enable_tet_volume:
        big = float(np.abs(np.asarray(jout.lambda_tet)).max())
        assert dmax(jout.lambda_tet, pout.lambda_tet) < 1e-4 * big


# ---- ops/volume -------------------------------------------------------------

@pytest.mark.parametrize("body", ["ball", "lattice_surface"])
def test_volume_and_gradients_match_jax(body):
    """``enclosed_volume`` and ``volume_gradients`` on a seeded, jittered
    closed surface within 1e-6 of JAX's, relative: the volume to itself, a
    vertex's gradient to the sum of the magnitudes of the corner terms it
    adds (the scale of a float32 sum's rounding: the terms cancel, and JAX
    adds them in another order)."""
    rng = np.random.default_rng(4)
    if body == "ball":
        pos, topo = V.ball(jbuild, jmesh)
        tris = np.asarray(topo.triangles)
    else:
        pos = jlattice.lattice_points(4)
        tris = jlattice.lattice_surface_triangles(4)
    pos = (pos + rng.normal(0.0, 0.01, pos.shape)).astype(np.float32)
    jv = float(jvolume.enclosed_volume(jnp.asarray(pos), jnp.asarray(tris)))
    jg = np.asarray(jvolume.volume_gradients(jnp.asarray(pos),
                                             jnp.asarray(tris)))
    pt, tt = torch.as_tensor(pos), torch.as_tensor(np.array(tris))
    pv = float(pvolume.enclosed_volume(pt, tt))
    pg = pvolume.volume_gradients(pt, tt).numpy()
    corners, _ = pvolume.corner_terms(pt, tt)
    scale = np.zeros_like(pos)
    np.add.at(scale, tris.T.reshape(-1), np.abs(corners.numpy()))
    assert abs(pv - jv) <= 1e-6 * abs(jv)
    assert (np.abs(pg - jg) <= 1e-6 * scale.max(axis=1, keepdims=True)).all()
    assert jv > 0.1


# ---- the plain engine and the runners' twins --------------------------------

@pytest.mark.parametrize("name", ONE)
def test_plain_engine_volume_matches_jax(name):
    check_plain_engine(name)


def check_plain_engine(name):
    """A one-body case through the plain engine against JAX's engine, and
    the substep runner's plain twin against the engine to the bit; where
    the volume meets dense contact or the per-tet volume, that family
    moves the result more than 10x the gate (it is exercised, not
    idle)."""
    jcfg, jtopo, js, pcfg, ptopo, ps, _, frames = both(name)
    jout = jgeneral.make_step(jtopo, jcfg, V.DT, n_steps=frames)(js)
    pout = pgeneral.make_step(ptopo, pcfg, V.DT, n_steps=frames)(ps)
    assert_volume_gates(jout, pout, pcfg)
    if pcfg.enable_bending:
        assert dmax(jout.lambda_bend, pout.lambda_bend) < 5e-6
    if pcfg.enable_self_collision or pcfg.enable_tet_volume:
        off = pgeneral.make_step(ptopo, pcfg.replace(
            enable_self_collision=False, enable_tet_volume=False), V.DT,
            n_steps=frames)(ps)
        moved = float((off.positions - pout.positions).abs().max())
        assert moved > 10 * V.dx_gate(pcfg), moved
    # the substep runner's plain twin is the step's to the bit
    run = mc.make_mesh_cuda_substep_runner(ptopo, pcfg,
                                           V.DT / pcfg.substeps,
                                           frames * pcfg.substeps,
                                           with_ext=True)(ps)
    for k in ("positions", "lambda_dist", "lambda_volume", "lambda_tet"):
        if getattr(pout, k) is not None:
            assert torch.equal(getattr(run, k), getattr(pout, k)), k


@pytest.mark.parametrize("name", ENSEMBLES)
def test_ensemble_twin_volume_matches_vmapped_jax(name):
    """The B-3 ensemble's twin (``general.make_batched_step``) with a
    ``(B,)`` lambda_volume against JAX's vmapped engine
    (``make_batched_general_step``), every row the one-body engine's to the
    bit, and a shared scalar refused by both runners with the name of the
    leaf."""
    jcfg, jtopo, js, pcfg, ptopo, ps, nb, frames = both(name)
    jout = jbatch.make_batched_general_step(jtopo, jcfg, V.DT,
                                            n_steps=frames)(js)
    pout = pgeneral.make_batched_step(ptopo, pcfg, V.DT, frames)(ps)
    assert_volume_gates(jout, pout, pcfg)
    one = pgeneral.make_step(ptopo, pcfg, V.DT, n_steps=frames)
    for b in range(nb):
        row = one(body_of(ps, b))
        for k in ("positions", "lambda_volume"):
            assert torch.equal(getattr(pout, k)[b], getattr(row, k)), (b, k)
    shared = ps.replace(lambda_volume=ps.lambda_volume[0])
    with pytest.raises(ValueError, match="lambda_volume"):
        pgeneral.make_batched_step(ptopo, pcfg, V.DT, 1)(shared)
    with pytest.raises(ValueError, match="lambda_volume"):
        mc.make_mesh_cuda_substep_runner(ptopo, pcfg, V.DT, 1,
                                         n_bodies=nb)(shared)
    with pytest.raises(ValueError, match="lambda_volume"):
        pbatch.make_sharded_mesh_pallas_rollout(
            ptopo, pcfg, V.DT, 1, pbatch.make_mesh(1, device="cpu"), nb)


def test_mesh_ensemble_volume_matches_jax_kernel():
    """``tests/test_mesh_pallas.py:799``: two bodies with per-body volume
    multipliers through JAX's fused mesh kernel (interpret mode) and the
    port's runner, body by body within JAX's own gates (5e-5, 1e-4)."""
    cfg = jconfig.SolverConfig(
        substeps=2, iterations=2, damping=0.02,
        solve_mode=jconfig.SolveMode.JACOBI, jacobi_rho=0.9,
        lambda_mode=jconfig.LambdaMode.DECAY, lambda_decay=0.97,
        distance_backend="windowed", enable_volume=True, pressure=1.5,
        volume_compliance=1e-4, ground_height=0.0, friction=0.3)
    pos, jtopo = V.ball(jbuild, jmesh)
    _, ptopo = V.ball()
    fields = V.inputs(pos, jtopo, 2)
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    with pltpu.force_tpu_interpret_mode():
        jout = mesh_pallas.make_mesh_substep_runner(
            jtopo, cfg, V.DT / 2, 4, block_edges=128, with_ext=True,
            n_bodies=2)(js)
    pout = mc.make_mesh_cuda_substep_runner(
        ptopo, port_config(cfg), V.DT / 2, 4, with_ext=True, n_bodies=2)(
            port.state_from_numpy(fields, device="cpu"))
    assert dmax(jout.positions, pout.positions) < 5e-5
    assert dmax(jout.lambda_volume, pout.lambda_volume) < 1e-4
    assert float(pout.lambda_volume.abs().min()) > 0.0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_ensemble_gradient_matches_jax():
    """``tests/test_diff_kernels.py:560``'s scene: the gradient of sum(x^2)
    w.r.t. per-body masses through ``make_differentiable_mesh_ensemble_
    runner`` (B-3's forward, autograd through the plain engine body by
    body) with a ``(2,)`` lambda_volume, against ``jax.value_and_grad`` of
    the vmapped engine.  The value agrees within 1e-4 relative.  The
    float32 gradients are held to a float64 witness (the plain engine in
    float64, itself checked against a central difference along a seeded
    direction, 1e-6): the port's within 1e-4 relative, and the port's
    distance from JAX's within JAX's own distance from the witness plus
    1e-4 (JAX's float32 gradient is about 1e-3 from it here, the port's
    about 1e-5)."""
    jcfg = jconfig.SolverConfig(
        substeps=2, iterations=2, damping=0.01,
        solve_mode=jconfig.SolveMode.JACOBI, jacobi_rho=0.0,
        enable_volume=True, pressure=1.1, ground_height=-2.0)
    cfg = port_config(jcfg)
    dt_sub, nb, n_sub = 1 / 240, 2, 4
    m = jmesh.icosphere(1)
    pos, jtopo = jbuild.build_windowed_topology(
        m.vertices, jedges.unique_edges(m.triangles), 1e-4,
        triangles=m.triangles)
    _, ptopo = pbuild.build_windowed_topology(
        m.vertices, pedges.unique_edges(m.triangles), 1e-4,
        triangles=m.triangles)
    pos = pos + np.array([0, 0.5, 0], np.float32)
    st = jstate_mod.state_from_topology(jtopo, pos)
    im0 = np.stack([np.asarray(st.inv_mass) * s for s in (1.0, 1.3)])

    def one(state):
        out, _ = lax.scan(lambda c, _: (jgeneral._substep(
            c, jtopo, jcfg, dt_sub, apply_ext=False), None), state, None,
            length=n_sub)
        return out

    full = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (nb,) + x.shape),
                        st)

    def jloss(im):
        out = jax.vmap(one)(full.replace(
            inv_mass=im, lambda_volume=jnp.zeros((nb,), jnp.float32)))
        return jnp.sum(out.positions ** 2)

    val_j, grad_j = jax.value_and_grad(jloss)(jnp.asarray(im0))

    batched = pbatch.replicate_state(
        port.state_from_topology(ptopo, pos, device="cpu"), nb)
    run = pdiff.make_differentiable_mesh_ensemble_runner(
        ptopo, cfg, dt_sub, n_sub, n_bodies=nb)
    im = torch.as_tensor(im0).requires_grad_()
    val = (run(batched.replace(inv_mass=im)).positions ** 2).sum()
    (grad,) = torch.autograd.grad(val, im)
    assert abs(float(val.detach()) - float(val_j)) <= 1e-4 * float(val_j)

    # the float64 witness
    t64 = ptopo.replace(rest_lengths=ptopo.rest_lengths.double(),
                        compliance=ptopo.compliance.double(),
                        rest_volume=ptopo.rest_volume.double())
    b64 = batched.replace(**{k: getattr(batched, k).double() for k in (
        "positions", "velocities", "ext_force", "lambda_dist",
        "lambda_bend", "lambda_volume")})

    def loss64(im64):
        out = pgeneral.run_substeps_plain_batched(
            b64.replace(inv_mass=im64), t64, cfg, dt_sub, n_sub)
        return (out.positions ** 2).sum()

    im64 = torch.as_tensor(im0, dtype=torch.float64).requires_grad_()
    (g64,) = torch.autograd.grad(loss64(im64), im64)
    d = torch.as_tensor(np.random.default_rng(0).normal(size=im0.shape))
    with torch.no_grad():
        h = 1e-5
        fd = (loss64(im64 + h * d) - loss64(im64 - h * d)) / (2 * h)
    assert abs(float(fd) - float((g64 * d).sum())) <= 1e-6 * abs(float(fd))
    w = g64.numpy()
    assert _rel(grad.numpy(), w) < 1e-4
    assert _rel(grad.numpy(), grad_j) < _rel(grad_j, w) + 1e-4
    assert np.abs(w).max() > 1e-3


def test_fully_pinned_body_keeps_a_finite_gradient():
    """Every particle pinned and no compliance: the volume's denominator is
    0, its safe divisor gives dlambda 0, and the gradient through the
    paired runner stays finite (JAX ``ops/volume.py:51-56``)."""
    cfg = port_config(jconfig.SolverConfig(
        substeps=2, iterations=2, enable_volume=True, pressure=1.3,
        volume_compliance=0.0, ground_height=-2.0))
    pos, ptopo = V.ball()
    st = port.state_from_numpy(V.inputs(pos, ptopo), device="cpu")
    st = st.replace(inv_mass=torch.zeros_like(st.inv_mass))
    run = pdiff.make_differentiable_mesh_runner(ptopo, cfg, V.DT / 2, 4)
    x0 = st.positions.clone().requires_grad_()
    out = run(st.replace(positions=x0))
    (g,) = torch.autograd.grad((out.positions ** 2).sum(), x0)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    assert torch.equal(out.positions, st.positions)
    assert float(out.lambda_volume.detach()) == 0.0


def test_fused_backward_refuses_volume_and_the_pairing_carries_it():
    """B-5 refuses the volume, as JAX's fused backward does
    (``mesh_diff_pallas.py:114``); ``backward="auto"`` then pairs B-3's
    forward with autograd through the plain engine, the ``"xla"``
    runner's gradient to the bit."""
    cfg = port_config(jconfig.SolverConfig(
        substeps=2, iterations=2, solve_mode=jconfig.SolveMode.JACOBI,
        enable_volume=True, pressure=1.2, ground_height=-2.0))
    pos, ptopo = V.ball()
    st = port.state_from_numpy(V.inputs(pos, ptopo), device="cpu")
    with pytest.raises(NotImplementedError, match="global volume"):
        pdiff.make_differentiable_mesh_runner(ptopo, cfg, V.DT / 2, 4,
                                              backward="fused")
    grads = []
    for backward in ("auto", "xla"):
        run = pdiff.make_differentiable_mesh_runner(ptopo, cfg, V.DT / 2, 4,
                                                    backward=backward)
        v0 = st.velocities.clone().requires_grad_()
        out = run(st.replace(velocities=v0))
        grads.append(torch.autograd.grad((out.positions ** 2).sum()
                                         + out.lambda_volume, v0)[0])
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0


# ---- the windowed tet route -------------------------------------------------

def _tet_cube(build, tets, lattice, res, windowed=True):
    pos0 = lattice.lattice_points(res) + np.array([0, 1.0, 0])
    tt = tets.fix_orientation(pos0, tets.cube_lattice_tets(res))
    args = (pos0, tets.tet_edges(tt), 1e-4)
    kw = dict(tets=tt, tet_compliance=0.0, triangles=tets.boundary_faces(tt))
    if windowed:
        return build.build_windowed_topology(*args, **kw)
    return np.asarray(pos0, np.float32), build.build_topology(*args, **kw)


def test_windowed_tets_match_jax():
    """``tests/test_tets.py:770-808``'s scene (an inflating res-5 Kuhn
    cube, JACOBI x 4), cut to 6 frames: the port's windowed route (the
    gather sweep) against JAX's windowed one-hot backend within 1e-4 and
    its multipliers within 1e-3, the JAX suite's own windowed-vs-gather
    gates; the slot permutations equal."""
    jpos, jtopo = _tet_cube(jbuild, jtets, jlattice, 5)
    ppos, ptopo = _tet_cube(pbuild, ptets, plattice, 5)
    np.testing.assert_array_equal(jpos, ppos)
    np.testing.assert_array_equal(np.asarray(jtopo.tet_window_perm),
                                  ptopo.tet_window_perm.numpy())
    jcfg = jconfig.SolverConfig(
        substeps=4, iterations=4, solve_mode=jconfig.SolveMode.JACOBI,
        distance_backend="windowed", ground_height=0.0, tet_pressure=1.3,
        enable_tet_volume=True, tet_backend="windowed")
    js = jstate_mod.state_from_topology(jtopo, jpos)
    ps = port.state_from_topology(ptopo, ppos, device="cpu")
    jout = jgeneral.make_step(jtopo, jcfg, V.DT, n_steps=6)(js)
    pout = pgeneral.make_step(ptopo, port_config(jcfg), V.DT, n_steps=6)(ps)
    assert port.is_finite(pout)
    assert dmax(jout.positions, pout.positions) < 1e-4
    assert dmax(jout.lambda_tet, pout.lambda_tet) < 1e-3
    assert float((pout.positions - ps.positions).abs().max()) > 1e-2


def test_windowed_tets_raise_where_jax_raises():
    """Without tet windows (a plain build) both engines raise ValueError
    when the step runs; the window test is JAX's: a centroid fan's hub
    fits a small mesh's window and not a wide one."""
    jpos, jtopo = _tet_cube(jbuild, jtets, jlattice, 3, windowed=False)
    ppos, ptopo = _tet_cube(pbuild, ptets, plattice, 3, windowed=False)
    jcfg = jconfig.SolverConfig(substeps=2, iterations=2,
                                solve_mode=jconfig.SolveMode.JACOBI,
                                enable_tet_volume=True,
                                tet_backend="windowed")
    with pytest.raises(ValueError, match="tet windows"):
        jgeneral.make_step(jtopo, jcfg, V.DT)(
            jstate_mod.state_from_topology(jtopo, jpos))
    with pytest.raises(ValueError, match="tet windows"):
        pgeneral.make_step(ptopo, port_config(jcfg), V.DT)(
            port.state_from_topology(ptopo, ppos, device="cpu"))
    for n_rim in (40, 3000):
        rim = np.arange(1, n_rim + 1)
        fan = np.stack([np.zeros_like(rim), rim, np.roll(rim, 1),
                        np.roll(rim, 2)], axis=1).astype(np.int32)
        perm = pbuild.tet_window_perm(fan, 128, 1024, 128)
        try:
            jwindows.build_hinge_windows(
                fan[jwindows.sort_hinges_by_window(fan)], n_rim + 1,
                np.ones(n_rim + 1, np.float32))
            fits = True
        except ValueError:
            fits = False
        assert (perm is not None) == fits == (n_rim == 40)


# ---- add_wind ---------------------------------------------------------------

def test_add_wind_matches_jax():
    """Without gusts, JAX's force within 1e-6 (a cloth-like open sheet and
    the ball, an unnormalised direction); with gusts, the same seed gives
    the same forces, another seed others, and every magnitude stays within
    strength * catch * (1 +- gustiness)."""
    pos, jtopo = V.ball(jbuild, jmesh)
    _, ptopo = V.ball()
    fields = V.inputs(pos, jtopo)
    fields["ext_force"] = np.random.default_rng(2).normal(
        0.0, 1.0, pos.shape).astype(np.float32)
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ps = port.state_from_numpy(fields, device="cpu")
    wind = ((3.0, 0.5, -1.0), 2.5)
    jf = jforces.add_wind(js, jtopo, *wind).ext_force
    pf = pforces.add_wind(ps, ptopo, *wind).ext_force
    assert dmax(jf, pf) < 1e-6
    calm = pf - ps.ext_force
    catch = calm.norm(dim=1)
    a = pforces.add_wind(ps, ptopo, *wind, gustiness=0.4, seed=7).ext_force
    b = pforces.add_wind(ps, ptopo, *wind, gustiness=0.4, seed=7).ext_force
    c = pforces.add_wind(ps, ptopo, *wind, gustiness=0.4, seed=8).ext_force
    assert torch.equal(a, b) and not torch.equal(a, c)
    gust = (a - ps.ext_force).norm(dim=1)
    assert bool((gust <= catch * 1.4 + 1e-5).all())
    assert bool((gust >= catch * 0.6 - 1e-5).all())
    assert float((gust - catch).abs().max()) > 1e-3
