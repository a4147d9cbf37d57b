"""The port's ensembles and their shards (``parallel/batch.py``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_parallel.py``.  The same ensembles, made by the JAX
builders from numpy seeds, go through the JAX functions and through the
port (on the CPU the kernels' wrappers run their plain twins: the
lane-folded stencil engine for B-1, the general engine body by body for
B-3).  Gates: the JAX suite's, |dx| < 1e-5 for lattices (|dlambda| <
1e-6 for the lane-folded engine), 2e-5 for meshes, gradients max |dg| /
max |g| < 1e-4; sharded equal to unsharded to the bit, since each shard
runs the same arithmetic on its bodies.  The port's shards are 8 entries
of ``make_mesh(8, "cpu")``; JAX's the 8-device CPU mesh of
``tests/conftest.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu import LambdaMode, SolveMode, SolverConfig
from softbodysimulation_tpu import state_from_topology as jstate_from_topology
from softbodysimulation_tpu.core.colliders import make_colliders as jcolliders
from softbodysimulation_tpu.parallel import batch as jbatch
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import lattice as jtop
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core import state as pstate
from softbodysimulation_tpu_torch.parallel import batch as pbatch
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import lattice as ptop
from softbodysimulation_tpu_torch.topology import mesh as pmesh

from test_torch_state import port_config, to_port

torch.set_num_threads(1)

DT = 0.02


def cfg_default(**kw):
    base = dict(substeps=2, iterations=2, damping=0.02,
                solve_mode=SolveMode.JACOBI, ground_height=0.0, friction=0.3,
                lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0)
    base.update(kw)
    return SolverConfig(**base)


def make_ensemble(n_bodies, res=3, braced=True):
    """(JAX spec, JAX batched state, port spec, port batched state) of
    ``tests/test_parallel.py:24-32``'s ensemble."""
    spec = jtop.lattice_spec(res, braced=braced)
    rng = np.random.RandomState(0)
    states = [jlat.make_lattice_state(spec, center=(
        rng.uniform(-1, 1), 1.0 + 0.5 * i, rng.uniform(-1, 1)))
        for i in range(n_bodies)]
    batched = jbatch.stack_states(states)
    return (spec, batched, ptop.lattice_spec(res, braced=braced),
            to_port(batched))


def dmax(jarr, tensor):
    return float(np.abs(np.asarray(jarr) - tensor.detach().numpy()).max())


def test_vmap_matches_loop():
    """``make_batched_lattice_step`` equals the one-body step on every body
    to the bit, and JAX's vmapped step within 1e-5."""
    jspec, jb, spec, pb = make_ensemble(4)
    cfg = cfg_default()
    out = pbatch.make_batched_lattice_step(spec, port_config(cfg), DT,
                                           n_steps=8)(pb)
    step1 = plat.make_step(spec, port_config(cfg), DT, n_steps=8)
    for i in range(4):
        torch.testing.assert_close(
            out.positions[i], step1(pbatch.body_slice(pb, i)).positions,
            rtol=0, atol=0)
    ref = jbatch.make_batched_lattice_step(jspec, cfg, DT, n_steps=8)(jb)
    assert dmax(ref.positions, out.positions) < 1e-5


def test_replicate_state():
    _, _, spec, _ = make_ensemble(1)
    s = plat.make_lattice_state(spec, center=(0, 1, 0), device="cpu")
    b = pbatch.replicate_state(s, 5)
    assert b.positions.shape == (5,) + s.positions.shape
    assert b.inv_mass.shape == (5,) + s.inv_mass.shape
    assert torch.equal(pbatch.body_slice(b, 3).positions, s.positions)


def test_stack_states_shares_one_collider_set():
    _, _, spec, _ = make_ensemble(1)
    s = plat.make_lattice_state(spec, device="cpu")
    coll = port.make_colliders(spheres=[(0, 0, 0, 0.2)], device="cpu")
    b = pbatch.stack_states([s.replace(colliders=coll)] * 3)
    assert b.colliders is coll and b.positions.shape[0] == 3
    with pytest.raises(ValueError, match="ColliderSet"):
        pbatch.stack_states([s.replace(colliders=coll), s])


def _icosphere_farm(n, sub=1, **topo_kw):
    """(JAX topology, JAX states, port topology, port states) of ``n``
    icospheres, body i lifted by (0.3 i, 1 + 0.4 i, 0)."""
    m = jmesh.icosphere(sub, radius=0.4)
    pos, jtopo = jbuild.topology_from_mesh(m, **topo_kw)
    ppos, ptopo = pbuild.topology_from_mesh(pmesh.icosphere(sub, radius=0.4),
                                            **topo_kw)
    np.testing.assert_array_equal(np.asarray(pos), ppos)
    js = [jstate_from_topology(jtopo, pos + np.array(
        [0.3 * i, 1.0 + 0.4 * i, 0.0], np.float32)) for i in range(n)]
    return jtopo, js, ptopo, [to_port(s) for s in js]


def test_batched_general_engine_matches_loop():
    """The batched general step equals the one-body step on every body to
    the bit and JAX's vmapped engine within 1e-5."""
    jtopo, js, ptopo, ps = _icosphere_farm(3, compliance=1e-4, bending=True,
                                           bend_compliance=1e-2)
    cfg = cfg_default(substeps=2, iterations=3, enable_bending=True)
    out = pbatch.make_batched_general_step(ptopo, port_config(cfg), DT,
                                           n_steps=15)(
        pbatch.stack_states(ps))
    step1 = pgeneral.make_step(ptopo, port_config(cfg), DT, n_steps=15)
    for i in range(3):
        assert torch.equal(out.positions[i], step1(ps[i]).positions)
    ref = jbatch.make_batched_general_step(jtopo, cfg, DT, n_steps=15)(
        jbatch.stack_states(js))
    assert dmax(ref.positions, out.positions) < 1e-5


def test_lane_batched_lattice_matches_vmap():
    """The lane-folded engine equals the one-body engine on every body to
    the bit and JAX's lane-folded engine within 1e-5 (dx) and 1e-6
    (dlambda), with a pending ext force on one body."""
    jspec, jb, spec, _ = make_ensemble(5, res=4)
    jb = jb.replace(ext_force=jb.ext_force.at[2, :, 1].set(30.0))
    pb = to_port(jb)
    cfg = cfg_default(substeps=3, iterations=2)
    out = plat.make_batched_step(spec, port_config(cfg), DT, n_bodies=5,
                                 n_steps=10)(pb)
    step1 = plat.make_step(spec, port_config(cfg), DT, n_steps=10)
    for i in range(5):
        one = step1(pbatch.body_slice(pb, i))
        assert torch.equal(out.positions[i], one.positions)
        assert torch.equal(out.lambda_dist[i], one.lambda_dist)
    ref = jlat.make_batched_step(jspec, cfg, DT, n_bodies=5, n_steps=10)(jb)
    assert dmax(ref.positions, out.positions) < 1e-5
    assert dmax(ref.lambda_dist, out.lambda_dist) < 1e-6
    assert float(out.ext_force.abs().max()) == 0.0
    # the poked body went elsewhere
    assert float((out.positions[2] - out.positions[1]).abs().max()) > 0.1


class TestSharded:
    """Eight shards on the CPU against the unsharded ensemble and JAX's
    8-device mesh."""

    def test_sharded_matches_single_device(self):
        jspec, jb, spec, pb = make_ensemble(16)
        cfg = cfg_default()
        mesh = pbatch.make_mesh(8, "cpu")
        out = pbatch.gather_batched_state(pbatch.make_sharded_lattice_step(
            spec, port_config(cfg), DT, mesh, n_steps=5)(
                pbatch.shard_batched_state(pb, mesh)))
        local = pbatch.make_batched_lattice_step(spec, port_config(cfg), DT,
                                                 n_steps=5)(pb)
        assert torch.equal(out.positions, local.positions)
        jmesh_ = jbatch.make_mesh(8)
        ref = jbatch.make_sharded_lattice_step(jspec, cfg, DT, jmesh_,
                                               n_steps=5)(
            jbatch.shard_batched_state(jb, jmesh_))
        assert dmax(ref.positions, out.positions) < 1e-5

    def test_sharded_pallas_rollout_matches_xla(self):
        """Raw substeps per shard, through the B-1 ensemble runner (its
        plain twin, the lane-folded engine, on the CPU), equal JAX's
        lane-folded engine within 1e-5."""
        jspec, jb, spec, pb = make_ensemble(16, res=4)
        cfg = cfg_default(lambda_mode=LambdaMode.RESET)
        mesh = pbatch.make_mesh(8, "cpu")
        n_sub = 3 * cfg.substeps
        step = pbatch.make_sharded_pallas_rollout(
            spec, port_config(cfg), DT / cfg.substeps, n_sub, mesh, 16)
        assert step.ensemble_backend == "xla"
        out = pbatch.gather_batched_state(
            step(pbatch.shard_batched_state(pb, mesh)))
        ref = jlat.make_batched_step(jspec, cfg, DT, 16, n_steps=3)(jb)
        assert dmax(ref.positions, out.positions) < 1e-5

    def test_ensemble_backend_auto_routing(self):
        """The report takes the B-1 ensemble on a CUDA device and the plain
        engine on the CPU, whatever the lattice (the JAX lane-tile rule is
        a TPU measurement); the CPU route equals JAX's within 1e-5."""
        spec4 = ptop.lattice_spec(4)
        assert pbatch.pick_lattice_ensemble_backend(spec4, "cpu") == "xla"
        assert pbatch.pick_lattice_ensemble_backend(spec4, "cuda") == "cuda"
        assert pbatch.pick_lattice_ensemble_backend(
            ptop.lattice_spec(12), "cuda") == "cuda"
        jspec, jb, spec, pb = make_ensemble(16, res=4)
        cfg = cfg_default(lambda_mode=LambdaMode.RESET)
        mesh = pbatch.make_mesh(8, "cpu")
        step = pbatch.make_sharded_pallas_rollout(
            spec, port_config(cfg), DT / cfg.substeps, 2 * cfg.substeps,
            mesh, 16)
        assert step.ensemble_backend == "xla"
        out = pbatch.gather_batched_state(
            step(pbatch.shard_batched_state(pb, mesh)))
        ref = jlat.make_batched_step(jspec, cfg, DT, 16, n_steps=2)(jb)
        assert dmax(ref.positions, out.positions) < 1e-5

    def test_one_body_a_shard_bridges_the_body_axis(self):
        """Eight bodies on eight shards run the one-body runner through
        ``_drop_body_axis`` / ``_add_body_axis`` and equal two shards of
        four and the unsharded ensemble to the bit."""
        _, _, spec, pb = make_ensemble(8, res=4)
        cfg = port_config(cfg_default(lambda_mode=LambdaMode.DECAY))
        outs = []
        for n in (8, 2, 1):
            mesh = pbatch.make_mesh(n, "cpu")
            step = pbatch.make_sharded_pallas_rollout(
                spec, cfg, DT / cfg.substeps, 4, mesh, 8)
            outs.append(pbatch.gather_batched_state(
                step(pbatch.shard_batched_state(pb, mesh))))
        for o in outs[1:]:
            assert torch.equal(o.positions, outs[0].positions)
            assert torch.equal(o.lambda_dist, outs[0].lambda_dist)
        one = pbatch._drop_body_axis(pbatch.shard_batched_state(
            pb, pbatch.make_mesh(8, "cpu"))[3])
        assert one.positions.shape == (64, 3)
        assert pbatch._add_body_axis(one).positions.shape == (1, 64, 3)

    def test_sharded_ensemble_diagnostics(self):
        """Equal to JAX's cross-device reduction, at rest and moving."""
        jspec, jb, spec, pb = make_ensemble(16)
        jb = jb.replace(velocities=jb.velocities.at[5, 3, 0].set(-2.5))
        pb = to_port(jb)
        mesh = pbatch.make_mesh(8, "cpu")
        got = pbatch.make_sharded_ensemble_diagnostics(mesh)(
            pbatch.shard_batched_state(pb, mesh))
        jmesh_ = jbatch.make_mesh(8)
        want = jbatch.make_sharded_ensemble_diagnostics(jmesh_)(
            jbatch.shard_batched_state(jb, jmesh_))
        assert float(got[0]) == float(want[0]) == 2.5
        assert int(got[1]) == int(want[1]) == 0
        assert abs(float(got[2]) - float(want[2])) < 1e-6
        assert int(got[3]) == int(want[3])
        for t in got:
            assert t.device == mesh[0] and t.ndim == 0

    def test_sharded_detects_nan_on_any_chip(self):
        _, _, spec, pb = make_ensemble(16)
        pb = pb.replace(positions=pb.positions.clone())
        pb.positions[15, 0, 0] = float("nan")
        mesh = pbatch.make_mesh(8, "cpu")
        _, bad, _, _ = pbatch.make_sharded_ensemble_diagnostics(mesh)(
            pbatch.shard_batched_state(pb, mesh))
        assert int(bad) == 1


def test_shards_refuse_what_does_not_divide():
    _, _, spec, pb = make_ensemble(6)
    mesh = pbatch.make_mesh(4, "cpu")
    with pytest.raises(ValueError, match="divide"):
        pbatch.shard_batched_state(pb, mesh)
    with pytest.raises(ValueError, match="divide"):
        pbatch.make_sharded_pallas_rollout(
            spec, port_config(cfg_default()), DT, 2, mesh, 6)
    shards = pbatch.shard_batched_state(pb, pbatch.make_mesh(3, "cpu"))
    assert [s.positions.shape[0] for s in shards] == [2, 2, 2]
    back = pbatch.gather_batched_state(shards)
    assert torch.equal(back.positions, pb.positions)


def test_sharded_general_mesh_ensemble_matches_vmap():
    """Mesh bodies over 8 shards: equal to the unsharded batched step to
    the bit and to JAX's 8-device step within 1e-5."""
    m = jmesh.icosphere(2)
    pos, jtopo = jbuild.topology_from_mesh(m, compliance=1e-5, windowed=True)
    _, ptopo = pbuild.topology_from_mesh(pmesh.icosphere(2), compliance=1e-5,
                                         windowed=True)
    cfg = SolverConfig(substeps=2, iterations=3, damping=0.02,
                       solve_mode=SolveMode.JACOBI, ground_height=0.0,
                       friction=0.3)
    js = [jstate_from_topology(jtopo, pos + np.array([0, 1.0 + 0.1 * i, 0],
                                                     np.float32))
          for i in range(16)]
    jb = jbatch.stack_states(js)
    pb = to_port(jb)
    mesh = pbatch.make_mesh(8, "cpu")
    out = pbatch.gather_batched_state(pbatch.make_sharded_general_step(
        ptopo, port_config(cfg), 1 / 60, mesh, n_steps=4)(
            pbatch.shard_batched_state(pb, mesh)))
    local = pbatch.make_batched_general_step(ptopo, port_config(cfg), 1 / 60,
                                             n_steps=4)(pb)
    assert torch.equal(out.positions, local.positions)
    jmesh_ = jbatch.make_mesh(8)
    ref = jbatch.make_sharded_general_step(jtopo, cfg, 1 / 60, jmesh_,
                                           n_steps=4)(
        jbatch.shard_batched_state(jb, jmesh_))
    assert dmax(ref.positions, out.positions) < 1e-5
    assert port.is_finite(out)


def _mesh_farm(nb, seed, tets=False):
    """(JAX topology, JAX batched state with a shared inv_mass, port
    topology, port state) of ``tests/test_parallel.py:248-264``'s farm."""
    from softbodysimulation_tpu.topology import tets as jtets
    from softbodysimulation_tpu_torch.topology import tets as ptets

    m = jmesh.icosphere(1, radius=0.4)
    pm = pmesh.icosphere(1, radius=0.4)
    if tets:
        verts, tt = jtets.tets_from_surface_centroid(m.vertices, m.triangles)
        pos, jtopo = jbuild.build_windowed_topology(
            verts, jtets.tet_edges(tt), 1e-4, tets=tt, tet_compliance=0.0,
            triangles=jtets.boundary_faces(tt), block_edges=64)
        pv, ptt = ptets.tets_from_surface_centroid(pm.vertices, pm.triangles)
        _, ptopo = pbuild.build_windowed_topology(
            pv, ptets.tet_edges(ptt), 1e-4, tets=ptt, tet_compliance=0.0,
            triangles=ptets.boundary_faces(ptt))
    else:
        pos, jtopo = jbuild.topology_from_mesh(
            m, compliance=1e-4, windowed=True, block_edges=64)
        _, ptopo = pbuild.topology_from_mesh(pm, compliance=1e-4,
                                             windowed=True)
    st = jstate_from_topology(jtopo, pos + np.array([0, 1.0, 0], np.float32))
    offs = np.random.RandomState(seed).uniform(-1, 1, (nb, 3)).astype(
        np.float32)
    z = np.zeros((nb,) + tuple(st.positions.shape), np.float32)
    jb = st.replace(
        positions=jnp.asarray(np.asarray(st.positions)[None]
                              + offs[:, None, :]),
        velocities=jnp.asarray(z), ext_force=jnp.asarray(z),
        lambda_dist=jnp.zeros((nb, jtopo.n_edges), jnp.float32),
        lambda_bend=jnp.zeros((nb, jtopo.n_hinges), jnp.float32),
        lambda_tet=(jnp.zeros((nb, jtopo.n_tets), jnp.float32) if tets
                    else None))
    return jtopo, jb, ptopo, to_port(jb)


def _jax_rollout(jtopo, cfg, jb, n_sub):
    """JAX's vmapped general engine over raw substeps with the rollout's
    ext lifecycle (the reference the JAX suite holds its kernel to)."""
    full = jb.replace(inv_mass=jnp.broadcast_to(
        jb.inv_mass, jb.positions.shape[:2]))

    def one(s):
        s = jgeneral._substep(s, jtopo, cfg, DT / cfg.substeps,
                              apply_ext=True)
        for _ in range(n_sub - 1):
            s = jgeneral._substep(s, jtopo, cfg, DT / cfg.substeps,
                                  apply_ext=False)
        return s

    return jax.vmap(one)(full.replace(lambda_volume=jnp.zeros(
        (jb.positions.shape[0],), jnp.float32)))


@pytest.mark.parametrize("tets", [False, True])
def test_sharded_mesh_pallas_rollout_matches_single_kernel(tets):
    """The B-3 ensemble per shard (8 bodies on 4 shards, a shared
    inv_mass) equals the one-shard ensemble runner to the bit and JAX's
    vmapped engine within 2e-5; with tets, lambda_tet splits with the
    bodies."""
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI, jacobi_rho=0.9,
                       lambda_mode=LambdaMode.RESET,
                       enable_tet_volume=tets, ground_height=0.0,
                       friction=0.3)
    jtopo, jb, ptopo, pb = _mesh_farm(8, 3 if tets else 2, tets)
    pcfg = port_config(cfg)
    n_sub = 2 * cfg.substeps
    mesh = pbatch.make_mesh(4, "cpu")
    out = pbatch.gather_batched_state(pbatch.make_sharded_mesh_pallas_rollout(
        ptopo, pcfg, DT / cfg.substeps, n_sub, mesh, 8)(
            pbatch.shard_batched_state(pb, mesh)))
    from softbodysimulation_tpu_torch.kernels import mesh_cuda
    one = mesh_cuda.make_mesh_cuda_substep_runner(
        ptopo, pcfg, DT / cfg.substeps, n_sub, with_ext=True, n_bodies=8)(pb)
    assert torch.equal(out.positions, one.positions)
    assert out.lambda_dist.shape == (8, ptopo.n_edges)
    ref = _jax_rollout(jtopo, cfg, jb, n_sub)
    assert dmax(ref.positions, out.positions) < 2e-5
    if tets:
        assert torch.equal(out.lambda_tet, one.lambda_tet)
        assert out.lambda_tet.shape == (8, ptopo.n_tets)
        # the centroid fan's thin tets turn an ulp of position into ~1e-5
        # of their multiplier's size (test_torch_contact_cases.py:109):
        # held relative to the largest multiplier
        big = float(np.abs(np.asarray(ref.lambda_tet)).max())
        assert dmax(ref.lambda_tet, out.lambda_tet) < 1e-4 * big


def test_sharded_rollout_shared_kinematic_colliders():
    """One shared ColliderSet on every shard, through the sharded rollout
    and the unsharded lane-folded engine: equal to each other to the bit,
    to the one-body runner with the same poses, and to JAX's sharded
    rollout within 1e-5; the sharded step takes the same set."""
    jspec, jb, spec, pb = make_ensemble(8, res=4)
    cfg = cfg_default(lambda_mode=LambdaMode.RESET, ground_height=77.0)
    pcfg = port_config(cfg)
    coll = port.make_colliders(spheres=[(0.0, 0.6, 0.0, 0.45)],
                               ground_height=0.0, device="cpu")
    mesh = pbatch.make_mesh(8, "cpu")
    shards = pbatch.shard_batched_state(pb, mesh)
    n_sub = 2 * cfg.substeps
    step = pbatch.make_sharded_pallas_rollout(
        spec, pcfg, DT / cfg.substeps, n_sub, mesh, 8, kin_colliders=(1, 0))
    out = pbatch.gather_batched_state(step(shards, coll))
    whole = plat.run_substeps_plain_batched(
        pb.replace(colliders=coll), spec, pcfg, DT / cfg.substeps, n_sub)
    assert torch.equal(out.positions, whole.positions)
    runner = plat.make_substep_runner(spec, pcfg, DT / cfg.substeps, n_sub)
    for i in (0, 3, 7):
        want = runner(pbatch.body_slice(pb, i).replace(colliders=coll))
        assert torch.equal(out.positions[i], want.positions)
    jcoll = jcolliders(spheres=[(0.0, 0.6, 0.0, 0.45)], ground_height=0.0)
    jmesh_ = jbatch.make_mesh(8)
    ref = jbatch.make_sharded_pallas_rollout(
        jspec, cfg, DT / cfg.substeps, n_sub, jmesh_, 8,
        kin_colliders=(1, 0))(jbatch.shard_batched_state(jb, jmesh_), jcoll)
    assert dmax(ref.positions, out.positions) < 1e-5
    stepx = pbatch.make_sharded_lattice_step(spec, pcfg, DT, mesh,
                                             n_steps=2, kin_colliders=True)
    outx = pbatch.gather_batched_state(stepx(shards, coll))
    wantx = plat.make_step(spec, pcfg, DT, n_steps=2)(
        pbatch.body_slice(pb, 5).replace(colliders=coll))
    assert torch.equal(outx.positions[5], wantx.positions)
    assert outx.colliders is None


def test_batched_states_cross_from_jax_and_back():
    """A JAX ensemble (leaves with a body axis, a shared or a per-body
    inv_mass) crosses into the port and back bit for bit; ``snapshot`` and
    ``restore`` keep the body axis; ``body_of`` / ``stack_bodies`` invert
    each other and keep a shared leaf shared."""
    _, jb, _, pb = make_ensemble(3)
    back = port.state_to_numpy(pb)
    for k in ("positions", "inv_mass", "lambda_dist", "lambda_volume"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jb, k)))
    shared = pb.replace(inv_mass=pb.inv_mass[0])
    assert pstate.shared_leaves(shared) == ("inv_mass",)
    rows = [pstate.body_of(shared, i) for i in range(3)]
    again = pstate.stack_bodies(shared, rows)
    assert again.inv_mass is shared.inv_mass
    assert torch.equal(again.positions, shared.positions)
    snap = port.snapshot(shared)
    rest = port.restore(snap, device="cpu")
    assert rest.positions.shape == (3, 27, 3)
    assert rest.inv_mass.shape == (27,)
    assert float(rest.lambda_dist.abs().max()) == 0.0
    with pytest.raises(ValueError, match="batched"):
        pstate.body_count(rows[0])
