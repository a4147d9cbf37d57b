"""The plain twins of the B-1 and B-3 ensembles against the JAX package, on
the CPU, and the ensembles' refusals, normals and example 5.

On the CPU the ensemble runners (``lattice_cuda.make_cuda_step(...,
n_bodies=B)``, ``mesh_cuda.make_mesh_cuda_step(..., n_bodies=B)``) run
their plain twins: the lane-folded stencil engine and the general engine
body by body.  Every case of ``test_torch_ensemble_cases.py`` goes through
them and, body by body, through the JAX engines (the vmapped XLA engine
the JAX suite holds its ensemble kernels to), and the JAX ensemble kernel
B-1 runs in interpret mode as ``tests/test_pallas_kernel.py:251`` runs
it.  Gates: lattices |dx| < 1e-5 and |dlambda| < 1e-6; meshes |dx| < 2e-5
(JACOBI), 1e-5 (COLORED), 2e-4 with contact, |dlambda_dist| < 1e-6; every
row equal to the one-body plain engine to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu import LambdaMode, SolveMode, SolverConfig
from softbodysimulation_tpu.core import colliders as jcolliders
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.examples import config5_batch_1024 as jconfig5
from softbodysimulation_tpu.kernels import lattice_pallas as jlp
from softbodysimulation_tpu.ops import normals as jnormals
from softbodysimulation_tpu.parallel import batch as jbatch
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import lattice as jtop

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core.state import body_of
from softbodysimulation_tpu_torch.examples import config5_batch_1024 as config5
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.ops import normals as pnormals
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_contact_cases as contact_cases
import test_torch_ensemble_cases as cases
import test_torch_mesh_cases as mesh_cases
from test_torch_state import port_config, to_port

torch.set_num_threads(1)

# the cases with the JAX package's configs (port_config carries them over)
LATTICE = cases.lattice_ensemble_cases(jconfig)
MESH = cases.mesh_ensemble_cases(jconfig)
JAX_MODS = contact_cases.modules("softbodysimulation_tpu")
RES = 4


def jax_body(fields, i, shared=()):
    """Body ``i`` of batched numpy fields as a JAX one-body state."""
    return jstate_mod.SimState(**{
        k: jnp.asarray(v if k in shared or k == "lambda_volume" else v[i])
        for k, v in fields.items()})


def dmax(jarr, tensor):
    return float(np.abs(np.asarray(jarr) - tensor.numpy()).max(initial=0.0))


@pytest.mark.parametrize("name", list(LATTICE))
def test_lattice_ensemble_twin_matches_jax(name):
    """The B-1 ensemble's plain twin: every row the one-body plain engine's
    to the bit, and JAX's ``make_step`` on that body within 1e-5 / 1e-6."""
    cfg, kw, nb, frames, kin, batched = LATTICE[name]
    fields = cases.lattice_inputs(RES, nb, **kw)
    spec = ptop.lattice_spec(RES, braced=True)
    st = port.state_from_numpy(fields, device="cpu")
    jcoll = None
    if kin:
        st = st.replace(colliders=port.make_colliders(**cases.KIN_SPHERE,
                                                      device="cpu"))
        jcoll = jcolliders.make_colliders(**cases.KIN_SPHERE)
    pcfg = port_config(cfg)
    out = lc.make_cuda_step(spec, pcfg, cases.DT, frames, kin_colliders=kin,
                            n_bodies=nb, batched=batched)(st)
    assert out.positions.shape == (nb, RES ** 3, 3)
    one = plat.make_step(spec, pcfg, cases.DT, frames)
    jstep = jlat.make_step(jtop.lattice_spec(RES, braced=True), cfg,
                           cases.DT, frames)
    for i in range(nb):
        mine = one(body_of(st, i))
        assert torch.equal(out.positions[i], mine.positions)
        assert torch.equal(out.lambda_dist[i], mine.lambda_dist)
        if cfg.enable_tet_volume:
            assert torch.equal(out.lambda_tet[i], mine.lambda_tet)
        ref = jstep(jax_body(fields, i).replace(colliders=jcoll))
        assert dmax(ref.positions, out.positions[i]) < 1e-5, (name, i)
        assert dmax(ref.lambda_dist, out.lambda_dist[i]) < 1e-6, (name, i)
    assert float(out.ext_force.abs().max()) == 0.0
    assert float((out.positions - st.positions).abs().max()) > 1e-3


def test_lattice_ensemble_twin_matches_jax_kernel():
    """``tests/test_pallas_kernel.py:251``: 5 bodies x res 4, RESET; the
    port's ensemble runner (its plain twin here) against JAX's streamed
    ensemble kernel in interpret mode and JAX's lane-folded engine."""
    cfg = SolverConfig(substeps=4, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.RESET,
                       ground_height=0.0, friction=0.3)
    spec = jtop.lattice_spec(4, braced=True)
    base = jlat.make_lattice_state(spec, center=(0, 0.8, 0), mass=0.01)
    nb = 5
    batched = jbatch.replicate_state(base, nb)
    rng = np.random.default_rng(2)
    offs = jnp.asarray(rng.uniform(-1, 1, (nb, 1, 3)) * 0.3
                       + np.array([0, 0.5, 0]), jnp.float32)
    batched = batched.replace(positions=batched.positions + offs)
    n_steps = 3
    dt_sub = (1 / 120) / cfg.substeps
    out = lc.make_cuda_substep_runner(
        ptop.lattice_spec(4, braced=True), port_config(cfg), dt_sub,
        n_steps * cfg.substeps, n_bodies=nb)(to_port(batched))
    ref = jlat.make_batched_step(spec, cfg, 1 / 120, nb,
                                 n_steps=n_steps)(batched)
    with pltpu.force_tpu_interpret_mode():
        kern = jlp.make_pallas_substep_runner_streamed(
            spec, cfg, dt_sub, n_steps * cfg.substeps, n_bodies=nb)(batched)
    for jout in (ref, kern):
        assert dmax(jout.positions, out.positions) < 1e-5
        assert dmax(jout.lambda_dist, out.lambda_dist) < 1e-6


def _jax_mesh(name):
    """(port topology, port state, port materials, JAX topology, fields,
    JAX materials) of a mesh case, each package's own builders."""
    cfg, kind, nb, frames, opts = MESH[name]
    jtopo, fields, mats = cases.mesh_case_inputs(kind, nb, JAX_MODS, opts)
    ptopo, pfields, _ = cases.mesh_case_inputs(kind, nb,
                                               contact_cases.modules(), opts)
    for k in fields:
        np.testing.assert_array_equal(fields[k], pfields[k])
    st = port.state_from_numpy(fields, device="cpu")
    pm = None if mats is None else {k: torch.as_tensor(v)
                                    for k, v in mats.items()}
    return ptopo, st, pm, jtopo, fields, mats


@pytest.mark.parametrize("name", list(MESH))
def test_mesh_ensemble_twin_matches_jax(name):
    """The B-3 ensemble's plain twin: every row the one-body plain engine's
    to the bit, and JAX's ``general.make_step`` on that body (with its own
    materials and masses) within the case's gate; dense contact stays
    body-local, so it fires within each body and the bodies differ."""
    cfg, kind, nb, frames, opts = MESH[name]
    ptopo, st, pm, jtopo, fields, mats = _jax_mesh(name)
    pcfg = port_config(cfg)
    kin = opts.get("kin")
    jcoll = None
    if kin:
        st = st.replace(colliders=port.make_colliders(**cases.KIN_SPHERE,
                                                      device="cpu"))
        jcoll = jcolliders.make_colliders(**cases.KIN_SPHERE)
    per_body = bool(opts.get("per_body_mass"))
    out = mc.make_mesh_cuda_step(ptopo, pcfg, cases.DT, frames,
                                 kin_colliders=kin, n_bodies=nb,
                                 per_body_mass=per_body)(st, pm)
    one = mc.make_mesh_cuda_step(ptopo, pcfg, cases.DT, frames,
                                 kin_colliders=kin)
    shared = () if per_body else ("inv_mass",)
    for i in range(nb):
        mat_i = None if pm is None else {k: v[i] for k, v in pm.items()}
        mine = one(body_of(st, i), mat_i)
        for k in ("positions", "velocities", "lambda_dist", "lambda_bend",
                  "lambda_tet"):
            if getattr(mine, k) is not None:
                assert torch.equal(getattr(out, k)[i], getattr(mine, k)), k
        jt = jtopo if mats is None else jtopo.replace(
            rest_lengths=jnp.asarray(mats["rest_lengths"][i]),
            compliance=jnp.asarray(mats["compliance"][i]))
        ref = jgeneral.make_step(jt, cfg, cases.DT, n_steps=frames)(
            jax_body(fields, i, shared).replace(colliders=jcoll))
        assert dmax(ref.positions, out.positions[i]) < cases.dx_gate(cfg), (
            name, i)
        if not cfg.enable_self_collision:
            assert dmax(ref.lambda_dist, out.lambda_dist[i]) < (
                mesh_cases.DLAM_DIST), (name, i)
        if cfg.enable_bending:
            assert dmax(ref.lambda_bend, out.lambda_bend[i]) < (
                mesh_cases.DLAM_BEND), (name, i)
    assert float(out.ext_force.abs().max()) == 0.0
    if cfg.enable_self_collision:
        off = pgeneral.make_step(ptopo, pcfg.replace(
            enable_self_collision=False), cases.DT, frames)(body_of(st, 0))
        assert float((off.positions - out.positions[0]).abs().max()) > 1e-4


def test_per_body_mass_needs_the_batched_contract():
    """``tests/test_mesh_pallas.py:684``: ValueError, as in JAX; a shared
    mass leaf handed to a per-body runner (and the reverse) is refused at
    call time."""
    ptopo, st, _, _, _, _ = _jax_mesh("shared_mass")
    cfg = port_config(SolverConfig())
    with pytest.raises(ValueError, match="per_body_mass"):
        mc.make_mesh_cuda_substep_runner(ptopo, cfg, cases.DT, 2,
                                         per_body_mass=True)
    with pytest.raises(ValueError, match="batched"):
        mc.make_mesh_cuda_substep_runner(ptopo, cfg, cases.DT, 2,
                                         n_bodies=2, batched=False)
    run = mc.make_mesh_cuda_substep_runner(ptopo, cfg, cases.DT, 2,
                                           n_bodies=3, per_body_mass=True)
    with pytest.raises(ValueError, match="inv_mass"):
        run(st)
    with pytest.raises(ValueError, match="3 bodies"):
        mc.make_mesh_cuda_substep_runner(ptopo, cfg, cases.DT, 2,
                                         n_bodies=3)(body_of(st, 0))


def test_per_body_materials_rows_match_shared():
    """``tests/test_diff_kernels.py:317``: a (B, E) materials batch whose
    rows are equal gives the shared (E,) result to the bit."""
    ptopo, st, _, _, _, _ = _jax_mesh("shared_mass")
    cfg = port_config(MESH["shared_mass"][0])
    run = mc.make_mesh_cuda_substep_runner(ptopo, cfg, cases.DT / 2, 4,
                                           n_bodies=3)
    shared = {"rest_lengths": ptopo.rest_lengths,
              "compliance": ptopo.compliance}
    rows = {k: v.expand(3, -1).contiguous() for k, v in shared.items()}
    a, b = run(st, shared), run(st, rows)
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.lambda_dist, b.lambda_dist)


REFUSED = ["blocked", "blocked_pallas", "hash", "sorted", "volume",
           "approx_math_mesh", "approx_math_lattice"]


@pytest.mark.parametrize("what", REFUSED)
def test_ensemble_refusals_at_build(what):
    """What ensembles do not carry raises NotImplementedError when the
    runner is built, naming its ROADMAP item: self-collision backends other
    than dense (B-4 carries one body; JAX's ensemble kernel refuses them
    too).  ``approx_math`` is carried in both ensembles, as JAX's runners
    take it: there the runner builds, and on the CPU every row of its
    result is the one-body approx twin's to the bit.  The global volume
    constraint is carried with a ``(B,)`` ``lambda_volume``
    (``_volume_ensemble_matches_vmapped_jax``)."""
    ptopo, st2, _, _, _, _ = _jax_mesh("shared_mass")
    cfg = port_config(MESH["dense_contact"][0])
    assert cfg.enable_self_collision
    spec = ptop.lattice_spec(3, braced=True)
    if what == "approx_math_lattice":
        lcfg = port_config(SolverConfig(substeps=2, iterations=2,
                                        ground_height=0.0))
        st = port.state_from_numpy(cases.lattice_inputs(3, 2),
                                   device="cpu")
        out = lc.make_cuda_substep_runner(spec, lcfg, cases.DT, 2,
                                          n_bodies=2, approx_math=True)(st)
        for b in range(2):
            one = plat.run_substeps_plain(body_of(st, b), spec, lcfg,
                                          cases.DT, 2, approx_math=True)
            assert torch.equal(out.positions[b], one.positions)
            assert torch.equal(out.lambda_dist[b], one.lambda_dist)
        return
    if what == "approx_math_mesh":
        out = mc.make_mesh_cuda_substep_runner(
            ptopo, cfg, cases.DT, 2, n_bodies=st2.positions.shape[0],
            approx_math=True)(st2)
        for b in range(st2.positions.shape[0]):
            one = pgeneral.run_substeps_plain(body_of(st2, b), ptopo, cfg,
                                              cases.DT, 2, approx_math=True)
            assert torch.equal(out.positions[b], one.positions)
            assert torch.equal(out.lambda_dist[b], one.lambda_dist)
        return
    if what == "volume":
        _volume_ensemble_matches_vmapped_jax()
        return
    kw = dict(n_bodies=2)
    match = "B-3 item 5"
    cfg = cfg.replace(self_collision_backend=what)
    with pytest.raises(NotImplementedError, match=match):
        mc.make_mesh_cuda_substep_runner(ptopo, cfg, cases.DT, 2, **kw)
    with pytest.raises(NotImplementedError, match=match):
        pgeneral.make_batched_step(ptopo, cfg, cases.DT)


def _volume_ensemble_matches_vmapped_jax():
    """``tests/test_parallel.py:163``'s configuration (``icosphere(1,
    0.4)``, pressure 1.2) for two bodies through the port's batched step
    with a ``(2,)`` lambda_volume: each row the one-body engine's to the
    bit, JAX's vmapped engine (``make_batched_general_step``) within 2e-5
    and its multipliers within 1e-4 (``tests/test_mesh_pallas.py:781``),
    both bodies inflating; a shared scalar ``lambda_volume`` raises
    ``ValueError`` naming it, as JAX's ensemble kernel does
    (``mesh_pallas.py:1977-1986``)."""
    from softbodysimulation_tpu.topology import build as jb
    from softbodysimulation_tpu.topology import mesh as jm
    from softbodysimulation_tpu_torch.ops.volume import enclosed_volume
    from softbodysimulation_tpu_torch.topology import build as pb
    from softbodysimulation_tpu_torch.topology import mesh as pm

    jcfg = SolverConfig(substeps=2, iterations=4, damping=0.05,
                        enable_volume=True, pressure=1.2,
                        lambda_mode=LambdaMode.DECAY, lambda_decay=0.97,
                        ground_height=-10.0)
    cfg = port_config(jcfg)
    pos, jtopo = jb.topology_from_mesh(jm.icosphere(1, radius=0.4),
                                       compliance=5e-4)
    ppos, ptopo = pb.topology_from_mesh(pm.icosphere(1, radius=0.4),
                                        compliance=5e-4)
    np.testing.assert_array_equal(pos, ppos)
    bodies = np.stack([pos + np.array([0, 2 + i, 0], np.float32)
                       for i in range(2)])
    n, e = pos.shape[0], ptopo.n_edges
    fields = {"positions": bodies, "velocities": np.zeros_like(bodies),
              "inv_mass": np.ones((2, n), np.float32),
              "ext_force": np.zeros_like(bodies),
              "lambda_dist": np.zeros((2, e), np.float32),
              "lambda_bend": np.zeros((2, 0), np.float32),
              "lambda_volume": np.zeros((2,), np.float32)}
    jout = jbatch.make_batched_general_step(jtopo, jcfg, cases.DT,
                                            n_steps=12)(
        jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in
                               fields.items()}))
    st = port.state_from_numpy(fields, device="cpu")
    step = pgeneral.make_batched_step(ptopo, cfg, cases.DT, 12)
    out = step(st)
    one = pgeneral.make_step(ptopo, cfg, cases.DT, 12)
    v0 = float(ptopo.rest_volume)
    for b in range(2):
        row = one(body_of(st, b))
        assert torch.equal(out.positions[b], row.positions)
        assert torch.equal(out.lambda_volume[b], row.lambda_volume)
        assert float(enclosed_volume(out.positions[b],
                                     ptopo.triangles)) > 1.05 * v0
    assert dmax(jout.positions, out.positions) < 2e-5
    assert dmax(jout.lambda_volume, out.lambda_volume) < 1e-4
    assert float(out.lambda_volume.abs().min()) > 0
    with pytest.raises(ValueError, match="lambda_volume"):
        step(st.replace(lambda_volume=st.lambda_volume[0]))


def test_normals_bounds_and_com_match_jax():
    """``ops/normals`` against JAX's within 1e-6, one body and a batch."""
    res = 4
    tris = jtop.lattice_surface_triangles(res)
    pos = np.random.default_rng(5).normal(0.0, 0.01, (3, res ** 3, 3)) + (
        jtop.lattice_points(res)[None])
    pos = pos.astype(np.float32)
    im = np.random.default_rng(6).uniform(0.0, 2.0, res ** 3).astype(
        np.float32)
    im[:5] = 0.0
    pt = torch.as_tensor(pos)
    got = pnormals.vertex_normals(pt, torch.as_tensor(tris))
    assert got.shape == pt.shape
    for b in range(3):
        want = jnormals.vertex_normals(jnp.asarray(pos[b]),
                                       jnp.asarray(tris))
        assert dmax(want, got[b]) < 1e-6
        one = pnormals.vertex_normals(pt[b], torch.as_tensor(tris))
        assert dmax(want, one) < 1e-6
        lo, hi = pnormals.bounds(pt[b])
        jlo, jhi = jnormals.bounds(jnp.asarray(pos[b]))
        assert dmax(jlo, lo) == 0.0 and dmax(jhi, hi) == 0.0
        for w in (None, im):
            c = pnormals.center_of_mass(pt[b], None if w is None
                                        else torch.as_tensor(w))
            jc = jnormals.center_of_mass(jnp.asarray(pos[b]),
                                         None if w is None
                                         else jnp.asarray(w))
            assert dmax(jc, c) < 1e-6
    # a vertex of no triangle points up
    lone = torch.zeros((4, 3))
    n = pnormals.vertex_normals(lone, torch.as_tensor([[0, 1, 2]]))
    assert torch.equal(n[3], torch.tensor([0.0, 1.0, 0.0]))


def _jax_config5_lane_folded(n_bodies, res, steps):
    """JAX example 5's initial ensemble through JAX's lane-folded engine,
    the spelling its example takes on one device."""
    cfg = SolverConfig(substeps=4, iterations=1, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
                       ground_height=0.0, friction=0.3)
    spec = jtop.lattice_spec(res, braced=True)
    rng = np.random.RandomState(42)
    batched = jbatch.replicate_state(jlat.make_lattice_state(spec), n_bodies)
    offsets = np.stack([rng.uniform(-8, 8, n_bodies),
                        rng.uniform(1.0, 4.0, n_bodies),
                        rng.uniform(-8, 8, n_bodies)], axis=1).astype(
                            np.float32)
    batched = batched.replace(positions=batched.positions
                              + offsets[:, None, :])
    return jlat.make_batched_step(spec, cfg, 1 / 60, n_bodies,
                                  n_steps=steps)(batched)


@pytest.mark.parametrize("steps", [30, 60])
def test_config5_batch_matches_jax(steps):
    """``tests/test_examples.py:58``'s cut (16 bodies x res 3, 60 frames):
    finite, unit normals, and JAX's lane-folded engine (the port's own
    spelling on one shard) within 1e-5 at 30 frames, as JAX's example (on
    its 8-device mesh, sharded) is.  At 60 frames float32 rounding has
    grown past that: the two engines first part by one ulp at frame 12,
    on a body in free fall, and floor contact amplifies it to 3.4e-5 from
    the lane-folded engine; the sharded example is then held within 3x
    the spread between JAX's own two spellings of it (2.5e-5 apart).  The
    port's run on 4 CPU shards equals its one-shard run to the bit."""
    batched, normals = config5.run(n_bodies=16, res=3, steps=steps,
                                   verbose=False, device="cpu")
    assert batched.positions.shape == (16, 27, 3)
    assert port.is_finite(batched)
    assert torch.allclose(torch.linalg.norm(normals, dim=-1),
                          torch.ones(16, 27), atol=1e-3)
    jb, jn = jconfig5.run(n_bodies=16, res=3, steps=steps, verbose=False)
    folded = _jax_config5_lane_folded(16, 3, steps).positions
    gate = 1e-5
    if steps == 60:
        spread = float(np.abs(np.asarray(jb.positions)
                              - np.asarray(folded)).max())
        gate = max(gate, 3.0 * spread)
    else:
        assert dmax(folded, batched.positions) < 1e-5
    assert dmax(jb.positions, batched.positions) < gate
    assert dmax(jn, normals) < 1e-4
    if steps == 60:
        sharded, _ = config5.run(n_bodies=16, res=3, steps=steps,
                                 verbose=False, device="cpu", n_devices=4)
        assert torch.equal(sharded.positions, batched.positions)


def test_config5_exports_the_frame(tmp_path):
    batched, normals = config5.run(n_bodies=4, res=3, steps=5,
                                   verbose=False, device="cpu",
                                   export_dir=str(tmp_path))
    data = np.load(tmp_path / "ensemble_frame.npz")
    np.testing.assert_array_equal(data["positions"],
                                  batched.positions.numpy())
    np.testing.assert_array_equal(data["normals"], normals.numpy())
    assert data["triangles"].shape[1] == 3
