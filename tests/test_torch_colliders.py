"""The port's kinematic rigid world (``core/colliders.py``, box SDFs,
traced poses in the stencil, general and sharded engines) against the JAX
package, on the CPU.

Mirrors the ops and engine cases of ``tests/test_collision.py:232-297``
and ``tests/test_kinematic_colliders.py:57-274``: box push-out (ties to
the first axis, ``sign(0) = +1``), traced poses equal to the config's
constants, a ColliderSet overriding the config, the animated ground
against the frozen NumPy oracle, the stencil engine with poses against the
general engine, the sharded engine with a sweeping sphere
(``tests/test_spatial_sharding.py:127-160``) and ``state_from_numpy``
with colliders.  Inputs are made by numpy from a seed; gates are the JAX
suite's (engines < 1e-5, traced vs config < 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbodysimulation_tpu.core import colliders as jcoll
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.ops import collision as jcol_ops
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.solvers import reference_cpu
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import lattice as jtop
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.interact import forces as pforces
from softbodysimulation_tpu_torch.ops import collision as pcol_ops
from softbodysimulation_tpu_torch.parallel import spatial as psp
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import lattice as ptop
from softbodysimulation_tpu_torch.topology import mesh as pmesh

import test_torch_cases as lattice_cases
import test_torch_collider_cases as cases
from test_torch_general_engine import diffs, jax_case
from test_torch_state import FIELDS, port_config

torch.set_num_threads(1)

DT = 1 / 60
LAT_CASES = cases.lattice_collider_cases(jconfig)
MESH_CASES = cases.mesh_collider_cases(jconfig)


def pcoll(**kw):
    return port.make_colliders(device="cpu", **kw)


def both_colliders(kw):
    return jcoll.make_colliders(**kw), pcoll(**kw)


def _pinned_cloth(res=8, y=1.0, size=1.2):
    """(JAX state, JAX topology, port state, port topology) of a
    horizontal cloth at height y, rim pinned (the JAX suite's
    ``_pinned_cloth``)."""
    out = []
    for build, mesh, make, forces in (
            (jbuild, jmesh, jstate_mod.state_from_topology, None),
            (pbuild, pmesh, port.state_from_topology, pforces)):
        pos, topo = build.topology_from_mesh(mesh.grid_plane(size, res),
                                             compliance=1e-4)
        pos = pos + np.array([0, y, 0], np.float32)
        ii, jj = np.divmod(np.arange(res * res), res)
        rim = np.flatnonzero((ii % (res - 1) == 0) | (jj % (res - 1) == 0))
        if forces is None:
            from softbodysimulation_tpu.interact import forces as jforces
            st = jforces.pin_indices(make(topo, pos), rim, pinned=True)
        else:
            st = forces.pin_indices(make(topo, pos, device="cpu"), rim,
                                    pinned=True)
        out += [st, topo]
    return out


def _run(state, step, n):
    for _ in range(n):
        state = step(state)
    return state


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---- ops --------------------------------------------------------------------

def test_box_sdf_pushes_out_nearest_face():
    """Points inside a box leave through the nearest face, ties go to the
    first axis and a point on the centre plane (sign 0) to the + side,
    points outside stay; the same numbers as JAX's ``box_sdf_project``,
    with the config's box, a traced one and a moving one."""
    pred = np.array([[0.2, 0.4, 0.0],     # nearest face +y
                     [-0.9, 0.0, 0.0],    # nearest face -x
                     [2.0, 0.0, 0.0],     # outside
                     [0.75, 0.25, 0.75],  # x and z tie: first axis (x)
                     [0.0, 0.25, 0.0],    # y face, local y = 0.25
                     [0.5, 0.0, 0.5],     # x and z tie, all equal faces
                     [0.0, 0.0, 0.9]],    # local x = y = 0, z face
                    np.float32)
    prev = pred - np.float32(0.01)
    w = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
    box = (0.0, 0.0, 0.0, 1.0, 0.5, 1.0)
    cfg = jconfig.SolverConfig(friction=0.3, box_colliders=(box,))
    vel = np.array([[0.3, -0.2, 0.1]], np.float32)
    runs = {"config": ({}, {}),
            "traced": (dict(boxes=jnp.asarray([box])),
                       dict(boxes=torch.tensor([box]))),
            "moving": (dict(boxes=jnp.asarray([box]),
                            box_velocities=jnp.asarray(vel)),
                       dict(boxes=torch.tensor([box]),
                            box_velocities=torch.tensor(vel)))}
    for name, (jkw, pkw) in runs.items():
        j = np.asarray(jcol_ops.box_sdf_project(
            jnp.asarray(pred), jnp.asarray(prev), jnp.asarray(w), DT, cfg,
            **jkw))
        p = pcol_ops.box_sdf_project(
            torch.tensor(pred), torch.tensor(prev), torch.tensor(w), DT,
            port_config(cfg), **pkw).numpy()
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-7, err_msg=name)
    out = pcol_ops.box_sdf_project(
        torch.tensor(pred), torch.tensor(pred), torch.tensor(w), DT,
        port_config(cfg.replace(friction=0.0))).numpy()
    assert np.isclose(out[0, 1], 0.5) and np.isclose(out[0, 0], 0.2)
    assert np.isclose(out[1, 0], -1.0)
    np.testing.assert_array_equal(out[2], pred[2])
    assert np.isclose(out[3, 0], 1.0) and np.isclose(out[3, 2], 0.75)
    np.testing.assert_array_equal(out[4], pred[4])      # pinned
    assert np.isclose(out[5, 0], 1.0)                    # first axis
    assert np.isclose(out[6, 2], 1.0)


def test_collider_helpers_match_jax():
    """make_colliders, colliders_from_config and the with_* helpers give
    the JAX package's arrays, and the helpers keep a pose's gradient."""
    kw = cases.LATTICE_KIN
    j, p = both_colliders(kw)
    j = j.with_sphere(0, center=(0.1, 0.2, 0.3), radius=0.4,
                      velocity=(1.0, 2.0, 3.0)).with_box(
        0, center=(0.5, 0.6, 0.7), half_extents=(0.1, 0.2, 0.3),
        velocity=(-1.0, 0.0, 1.0)).with_ground(0.25)
    center = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    p = p.with_sphere(0, center=center, radius=0.4,
                      velocity=(1.0, 2.0, 3.0)).with_box(
        0, center=(0.5, 0.6, 0.7), half_extents=(0.1, 0.2, 0.3),
        velocity=(-1.0, 0.0, 1.0)).with_ground(0.25)
    for k in port.core.colliders.FIELDS:
        np.testing.assert_array_equal(_np(getattr(p, k)),
                                      np.asarray(getattr(j, k)), err_msg=k)
    (g,) = torch.autograd.grad(p.spheres.sum(), center)
    np.testing.assert_array_equal(g.numpy(), [1.0, 1.0, 1.0])
    cfg = LAT_CASES["config_box"][0].replace(
        sphere_colliders=((0.0, 1.0, 0.0, 0.5),), ground_height=-0.5)
    jc = jcoll.colliders_from_config(cfg)
    pc = port.colliders_from_config(port_config(cfg), device="cpu")
    for k in port.core.colliders.FIELDS:
        np.testing.assert_array_equal(_np(getattr(pc, k)),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    with pytest.raises(ValueError, match="row counts"):
        pcoll(spheres=[(0, 0, 0, 1)], sphere_velocities=[(0, 0, 0)] * 2)


def test_state_from_numpy_with_colliders():
    """A JAX state carrying a ColliderSet crosses into the port as numpy
    (the five fields as a mapping), and back, bit for bit; the collider
    tensors lie on the state's device, and ``snapshot`` / ``restore`` /
    ``SimState.to`` carry them."""
    spec = jtop.lattice_spec(3)
    js = jlat.make_lattice_state(spec, center=(0, 1.0, 0)).replace(
        colliders=jcoll.make_colliders(**cases.LATTICE_KIN))
    fields = {k: (None if getattr(js, k) is None
                  else np.asarray(getattr(js, k))) for k in FIELDS}
    fields["colliders"] = {k: np.asarray(getattr(js.colliders, k))
                           for k in port.core.colliders.FIELDS}
    ps = port.state_from_numpy(fields, device="cpu")
    assert ps.colliders.device.type == "cpu"
    assert (ps.colliders.n_spheres, ps.colliders.n_boxes) == (1, 1)
    back = port.state_to_numpy(ps)
    for k, v in back["colliders"].items():
        np.testing.assert_array_equal(v, fields["colliders"][k])
    rec = port.restore(port.snapshot(ps), device="cpu")
    np.testing.assert_array_equal(rec.colliders.spheres.numpy(),
                                  fields["colliders"]["spheres"])
    assert rec.colliders.spheres is not ps.colliders.spheres
    with pytest.raises(ValueError, match="unknown collider fields"):
        port.state_from_numpy(dict(fields, colliders={"planes": [0.0]}),
                              device="cpu")


# ---- engines ------------------------------------------------------------

@pytest.mark.parametrize("name", list(LAT_CASES))
def test_lattice_colliders_match_jax(name):
    """The stencil engine with config boxes or a ColliderSet (spheres and
    boxes with velocities, an animated ground, both floor modes) against
    the JAX engine, before and after the poses move, at the lattice gates
    (|dx| < 1e-5, |dlambda| < 1e-6)."""
    cfg, kin, move, n_sub = LAT_CASES[name]
    fields = lattice_cases.seeded_inputs(6)
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ps = port.state_from_numpy(fields, device="cpu")
    spec = jtop.lattice_spec(6, braced=True)
    pspec = ptop.lattice_spec(6, braced=True)
    jrun = jlat.make_substep_runner(spec, cfg, 1 / 480, n_sub)
    pcfg = port_config(cfg)
    worlds = [(None, None)]
    if kin is not None:
        jc, pc = both_colliders(kin)
        worlds = [(jc, pc), (cases.moved(jc, move), cases.moved(pc, move))]
    outs = []
    for jc, pc in worlds:
        jout = jrun(js.replace(colliders=jc))
        pout = plat.make_substep_runner(pspec, pcfg, 1 / 480, n_sub)(
            ps.replace(colliders=pc))
        d = diffs(jout, pout)
        assert d["positions"] < 1e-5 and d["lambda_dist"] < 1e-6, (name, d)
        assert port.is_finite(pout)
        outs.append(pout)
    if len(outs) == 2:
        assert float((outs[1].positions - outs[0].positions).abs().max()) \
            > 1e-4


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_general_colliders_match_jax(name):
    """The general engine with config boxes or a ColliderSet against the
    JAX engine, before and after the poses move, at the mesh gates."""
    cfg, kin, move, frames = MESH_CASES[name]
    jtopo, js, ptopo, ps = jax_case("sphere")
    jstep = jgeneral.make_step(jtopo, cfg, DT, n_steps=frames)
    pstep = pgeneral.make_step(ptopo, port_config(cfg), DT, n_steps=frames)
    worlds = [(None, None)]
    if kin is not None:
        jc, pc = both_colliders(kin)
        worlds = [(jc, pc), (cases.moved(jc, move), cases.moved(pc, move))]
    for jc, pc in worlds:
        d = diffs(jstep(js.replace(colliders=jc)),
                  pstep(ps.replace(colliders=pc)))
        gate = 1e-5 if cfg.solve_mode == jconfig.SolveMode.COLORED else 2e-5
        assert d["positions"] < gate and d["lambda_dist"] < 1e-6, (name, d)


@pytest.mark.parametrize("engine", ["general", "lattice"])
def test_traced_colliders_match_config_constants(engine):
    """colliders_from_config(cfg) reproduces the config-constant rigid
    world (< 1e-6; the same formulas with zero collider velocities), and
    both track the JAX engine.  The cloth runs without Chebyshev: its
    momentum step amplifies the ulps by which the two packages' sphere
    normals part (``jnp.linalg.norm`` against x^2 + y^2 + z^2) to 1e-4
    over 30 frames of contact, the chaos the JAX suite's mesh kinematic
    test avoids the same way."""
    if engine == "general":
        js, jtopo, ps, ptopo = _pinned_cloth()
        cfg = jconfig.SolverConfig(
            substeps=2, iterations=6, damping=0.02, jacobi_rho=0.0,
            solve_mode=jconfig.SolveMode.JACOBI, ground_height=0.0,
            friction=0.3, sphere_colliders=((0.0, 0.72, 0.0, 0.3),),
            box_colliders=((0.45, 0.8, 0.0, 0.15, 0.15, 0.15),))
        pstep = pgeneral.make_step(ptopo, port_config(cfg), DT)
        jstep = jgeneral.make_step(jtopo, cfg, DT)
        n = 30
    else:
        spec, pspec = jtop.lattice_spec(4), ptop.lattice_spec(4)
        js = jlat.make_lattice_state(spec, center=(0, 0.8, 0), mass=0.01)
        ps = plat.make_lattice_state(pspec, center=(0, 0.8, 0), mass=0.01,
                                     device="cpu")
        cfg = jconfig.SolverConfig(
            substeps=4, iterations=2, damping=0.02,
            solve_mode=jconfig.SolveMode.COLORED, ground_height=0.0,
            friction=0.3, sphere_colliders=((0.0, 0.25, 0.0, 0.3),),
            box_colliders=((0.5, 0.3, 0.0, 0.2, 0.2, 0.2),))
        pstep = plat.make_step(pspec, port_config(cfg), DT)
        jstep = jlat.make_step(spec, cfg, DT)
        n = 20
    p_const = _run(ps, pstep, n).positions
    p_traced = _run(ps.replace(colliders=port.colliders_from_config(
        port_config(cfg), device="cpu")), pstep, n).positions
    assert float((p_const - p_traced).abs().max()) < 1e-6
    j_const = np.asarray(_run(js, jstep, n).positions)
    assert np.abs(p_const.numpy() - j_const).max() < 1e-5
    assert float((p_const - ps.positions).abs().max()) > 1e-2


def test_state_colliders_override_config():
    """A present ColliderSet replaces the config's rigid world entirely: a
    sphere parked far away acts as no sphere at all."""
    _, _, ps, ptopo = _pinned_cloth()
    base = dict(substeps=2, iterations=6, damping=0.02,
                solve_mode=jconfig.SolveMode.JACOBI, ground_height=0.0,
                friction=0.3)
    cfg_with = port_config(jconfig.SolverConfig(
        sphere_colliders=((0.0, 0.72, 0.0, 0.3),), **base))
    cfg_without = port_config(jconfig.SolverConfig(**base))
    parked = ps.replace(colliders=pcoll(spheres=[(50.0, 50.0, 50.0, 0.3)],
                                        ground_height=0.0))
    p_parked = _run(parked, pgeneral.make_step(ptopo, cfg_with, DT), 40)
    p_none = _run(ps, pgeneral.make_step(ptopo, cfg_without, DT), 40)
    assert float((p_parked.positions - p_none.positions).abs().max()) < 1e-6
    # and with the config's sphere the cloth is held up
    p_with = _run(ps, pgeneral.make_step(ptopo, cfg_with, DT), 40)
    assert float((p_with.positions - p_none.positions).abs().max()) > 1e-2


def test_animated_ground_matches_oracle():
    """Animated floor: the engine reads the ground height from the
    ColliderSet; the frozen NumPy oracle re-folds the constant per frame.
    COLORED mode tracks it (the JAX suite's gate, 5e-5)."""
    pos = pmesh.cube_corners(1.0) + np.array([0, 1.0, 0], np.float32)
    edges = ptop.cube8_edges()
    topo = pbuild.build_topology(pos, edges, compliance=0.01)
    cfg = jconfig.SolverConfig(substeps=1, iterations=10, damping=0.01,
                               solve_mode=jconfig.SolveMode.COLORED,
                               ground_height=0.0, friction=0.3)
    state = port.state_from_topology(topo, pos, device="cpu").replace(
        colliders=pcoll(ground_height=0.0))
    step = pgeneral.make_step(topo, port_config(cfg), DT)
    oracle = reference_cpu.ReferenceSolver(
        pos, topo.edges.numpy(), topo.rest_lengths.numpy(),
        topo.compliance.numpy(), np.ones(len(pos), np.float32), cfg,
        colors=topo.colors.numpy())
    heights = np.concatenate([np.linspace(0.0, 0.6, 25),
                              np.full(25, 0.6)]).astype(np.float32)
    for h in heights:
        state = step(state.replace(colliders=state.colliders.with_ground(h)))
        oracle.cfg = cfg.replace(ground_height=float(h))
        oracle.step(DT)
    drift = np.abs(state.positions.numpy() - oracle.x).max()
    assert drift < 5e-5, drift
    assert float(state.positions[:, 1].min()) > 0.55


def test_velocity_reflect_floor_animates():
    """The velocity-reflect floor follows an animated ground, as the JAX
    engine does."""
    pos = pmesh.cube_corners(0.5) + np.array([0, 1.0, 0], np.float32)
    edges = ptop.cube8_edges()
    ptopo = pbuild.build_topology(pos, edges, compliance=0.01)
    jtopo = jbuild.build_topology(pos, edges, compliance=0.01)
    cfg = jconfig.SolverConfig(substeps=2, iterations=6, damping=0.02,
                               floor_mode=jconfig.FloorMode.VELOCITY_REFLECT,
                               ground_height=0.0)
    ps = port.state_from_topology(ptopo, pos, device="cpu").replace(
        colliders=pcoll(ground_height=0.0))
    js = jstate_mod.state_from_topology(jtopo, pos).replace(
        colliders=jcoll.make_colliders(ground_height=0.0))
    pstep = pgeneral.make_step(ptopo, port_config(cfg), DT)
    jstep = jgeneral.make_step(jtopo, cfg, DT)
    for i in range(80):
        h = min(0.4, i * 0.01)
        ps = pstep(ps.replace(colliders=ps.colliders.with_ground(h)))
        js = jstep(js.replace(colliders=js.colliders.with_ground(h)))
    p = ps.positions.numpy()
    assert np.isfinite(p).all() and p[:, 1].min() > 0.38, p[:, 1].min()
    assert np.abs(p - np.asarray(js.positions)).max() < 1e-5


def test_stencil_engine_kinematic_matches_general():
    """The stencil engine honours the ColliderSet contract: with family-
    parity colours (COLORED) an animated sphere sweep tracks the general
    engine (< 1e-5), and it moves the body."""
    res = 3
    pspec = ptop.lattice_spec(res)
    state_s = plat.make_lattice_state(pspec, center=(0, 1.5, 0),
                                      device="cpu")
    pos = ptop.lattice_points(res, center=(0, 1.5, 0))
    edges, comp = ptop.lattice_edges(res)
    topo = pbuild.build_topology(pos, edges, comp,
                                 colors=ptop.lattice_family_colors(res))
    state_g = port.state_from_topology(topo, pos, device="cpu")
    cfg = port_config(jconfig.SolverConfig(
        substeps=2, iterations=6, damping=0.05,
        solve_mode=jconfig.SolveMode.COLORED, ground_height=-2.0,
        friction=0.3))
    coll = pcoll(spheres=[(0.0, 0.2, 0.0, 0.4)], ground_height=-2.0)
    step_s = plat.make_step(pspec, cfg, DT)
    step_g = pgeneral.make_step(topo, cfg, DT)
    n = 30
    ys = np.linspace(0.2, 1.3, n, dtype=np.float32)
    for i in range(n):
        vel = (0.0, float((ys[min(i + 1, n - 1)] - ys[i]) / DT), 0.0)
        cs = coll.with_sphere(0, center=(0.0, float(ys[i]), 0.0),
                              velocity=vel)
        state_s = step_s(state_s.replace(colliders=cs))
        state_g = step_g(state_g.replace(colliders=cs))
    drift = float((state_s.positions - state_g.positions).abs().max())
    assert drift < 1e-5, drift
    assert float(state_s.positions[:, 1].max()) > 1.8


def test_sharded_kinematic_collider_sweeps_across_slabs():
    """The sharded engine reads the state's ColliderSet, replicated on
    every slab: a sphere sweeping along x crosses the slab boundaries over
    all 24 frames of ``tests/test_spatial_sharding.py:143-190`` (dt 0.02,
    the config's ground 123 bogus on purpose), and tracks JAX's sharded
    engine in float32 and the port's single-device stencil engine in
    float64, each within 1e-4 (that test's gate) at every frame.

    The port's float32 pair is not held at 1e-4: the sweep's contact
    switching amplifies a difference of one ulp past it.  JAX's own
    stencil engine, started from positions one ulp up, parts from itself
    by more than 1e-4 (asserted here; 3.2e-4 at frame 22), so a pair of
    engines whose sums round differently meets the gate at frame 24 by
    chance: JAX's pair reads 9.6e-5, the port's 3.4e-4.  In float64 the
    port's pair stays within 4.4e-6.  ``-s`` prints every frame (all but
    the float32 pairs held at the gate; the pairs only printed).  A step
    built with kin_colliders refuses a state without colliders; the slab
    kernel route refuses kin_colliders."""
    from softbodysimulation_tpu.parallel import batch as jbatch
    from softbodysimulation_tpu.parallel import spatial as jsp

    dt = 0.02
    jcfg = jconfig.SolverConfig(
        substeps=2, iterations=2, damping=0.02,
        solve_mode=jconfig.SolveMode.COLORED, ground_height=123.0,
        friction=0.3)
    cfg = port_config(jcfg)
    spec = ptop.lattice_spec(8, braced=True)
    kin = dict(spheres=[(-1.2, 0.9, 0.0, 0.45)], ground_height=0.0)
    jc, pc = both_colliders(kin)
    state0 = plat.make_lattice_state(spec, center=(0, 1.0, 0),
                                     device="cpu").replace(colliders=pc)
    jspec = jtop.lattice_spec(8, braced=True)
    mesh = jbatch.make_mesh(4, axis="x")
    jstep = jsp.make_spatial_lattice_step(jspec, jcfg, dt, mesh,
                                          kin_colliders=(1, 0))
    jstep_1 = jlat.make_step(jspec, jcfg, dt)
    j0 = jlat.make_lattice_state(jspec, center=(0, 1.0, 0)).replace(
        colliders=jc)
    jst = jsp.shard_lattice_state(j0, jspec, mesh)
    # the witness: the same engine from positions one ulp up
    jw = [j0, j0.replace(positions=jnp.asarray(np.nextafter(
        np.asarray(j0.positions), np.float32(np.inf))))]
    step_sh = psp.make_spatial_lattice_step(spec, cfg, dt, ["cpu"] * 4,
                                            kin_colliders=(1, 0))
    step_1 = plat.make_step(spec, cfg, dt)

    def f64(s):
        return s.replace(colliders=s.colliders.map(torch.Tensor.double),
                         **{k: getattr(s, k).double() for k in FIELDS
                            if getattr(s, k) is not None})

    st_sh = psp.shard_lattice_state(state0, spec, ["cpu"] * 4)
    st_1 = state0
    st64_sh = psp.shard_lattice_state(f64(state0), spec, ["cpu"] * 4)
    st64_1 = f64(state0)
    n = 24
    xs = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    ulp = 0.0
    print("\nframe  port-JAX sharded  port sharded-single (f64)  JAX "
          "one-ulp drift  port sharded-single  JAX sharded-single")
    for i in range(n):
        vel = (float((xs[min(i + 1, n - 1)] - xs[i]) / dt), 0.0, 0.0)
        center = (float(xs[i]), 0.9, 0.0)
        cs = pc.with_sphere(0, center=center, velocity=vel)
        st_sh = step_sh(st_sh.replace(colliders=(cs,) * 4))
        st_1 = step_1(st_1.replace(colliders=cs))
        jcs = jc.with_sphere(0, center=center, velocity=vel)
        jst = jstep(jst.replace(colliders=jcs))
        jw = [jstep_1(s.replace(colliders=jcs)) for s in jw]
        c64 = cs.map(torch.Tensor.double)
        st64_sh = step_sh(st64_sh.replace(colliders=(c64,) * 4))
        st64_1 = step_1(st64_1.replace(colliders=c64))
        out = psp.gather_lattice_state(st_sh)
        dj = np.abs(out.positions.numpy() - np.asarray(jst.positions)).max()
        d64 = float((psp.gather_lattice_state(st64_sh).positions
                     - st64_1.positions).abs().max())
        dw = np.abs(np.asarray(jw[0].positions)
                    - np.asarray(jw[1].positions)).max()
        d1 = float((out.positions - st_1.positions).abs().max())
        dJ = np.abs(np.asarray(jst.positions)
                    - np.asarray(jw[0].positions)).max()
        print(f"{i:5d}  {dj:.3e}  {d64:.3e}  {dw:.3e}  {d1:.3e}  {dJ:.3e}")
        assert port.is_finite(out) and dj < 1e-4 and d64 < 1e-4, (i, dj,
                                                                  d64)
        ulp = max(ulp, float(dw))
    assert ulp > 1e-4, ulp
    assert abs(float(out.positions[:, 0].mean())) > 0.02
    with pytest.raises(ValueError):
        step_sh(st_sh.replace(colliders=None))
    with pytest.raises(NotImplementedError):
        psp.make_spatial_lattice_step(spec, cfg, dt, ["cpu"] * 4,
                                      backend="pallas", kin_colliders=(1, 0))
