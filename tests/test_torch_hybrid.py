"""The lattice's hybrid contact step and runner
(``kernels/lattice_cuda.make_hybrid_contact_step`` / ``_runner``: the
contact-free substeps of each cadence group as one kernel launch sequence,
the contact substep in the plain stencil engine), the routes the lattice
and mesh steps take, the ``hash`` / ``sorted`` hybrid of the mesh step,
and the host-sync-free hash and sorted passes, on the CPU.

On the CPU the kernel's launch sequence is its plain version, so the
hybrid is held against the JAX stencil engine's own cadence (which
``tests/test_contact_cadence.py:169-321`` holds the JAX hybrid to) at
1e-5, in the scenes of that file: the runner (with a tail shorter than a
group), the step (with a poke: the ext-force lifecycle), a solid lattice
with tets, and a kinematic sphere; and its validation errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu import SolveMode, SolverConfig
from softbodysimulation_tpu import make_colliders as jmake_colliders
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.examples import config4_interactive_poke as jex4
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import lattice as jtop

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.examples import config4_interactive_poke as ex4
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.ops import spatial_hash as psh
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

from test_torch_state import port_config, to_port

torch.set_num_threads(1)

DT = 1 / 60
TOL = 1e-5


def hybrid_config(**kw) -> SolverConfig:
    """``tests/test_contact_cadence.py:196-206``: res 6, blocked contact
    every 3rd of 6 substeps."""
    base = dict(substeps=6, iterations=1, damping=0.02,
                solve_mode=SolveMode.JACOBI, fast_math=True,
                gravity_is_acceleration=True, enable_self_collision=True,
                particle_radius=0.45 / 5, self_collision_backend="blocked",
                collision_block_size=128, block_neighbors=2,
                self_collision_every=3, ground_height=0.0, friction=0.3)
    base.update(kw)
    return SolverConfig(**base)


def scene(tets=False):
    spec = jtop.lattice_spec(6, braced=True)
    js = jlat.make_lattice_state(spec, center=(0.0, 0.55, 0.0), mass=0.001,
                                 tet_volume=tets)
    return spec, js, ptop.lattice_spec(6, braced=True), to_port(js)


def dx(jout, pout):
    return float(np.abs(np.asarray(jout.positions)
                        - pout.positions.numpy()).max())


def test_hybrid_runner_matches_stencil_cadence():
    """8 raw substeps (two groups of 3 and a tail of 2: a contact substep
    and a contact-free stencil substep) against JAX's stencil runner;
    approx_math in the kernel chunks stays within 1e-4 of exact."""
    cfg = hybrid_config()
    spec, js, pspec, ps = scene()
    ref = jlat.make_substep_runner(spec, cfg, DT / 6, 8)(js)
    run = lc.make_hybrid_contact_runner(pspec, port_config(cfg), DT / 6, 8)
    out = run(ps)
    assert run.route == "hybrid" and port.is_finite(out)
    assert dx(ref, out) < TOL, dx(ref, out)
    assert float(out.ext_force.abs().max()) == 0.0
    approx = lc.make_hybrid_contact_runner(pspec, port_config(cfg), DT / 6,
                                           8, approx_math=True)(ps)
    assert float((approx.positions - out.positions).abs().max()) < 1e-4
    with pytest.raises(ValueError):
        lc.make_hybrid_contact_runner(
            pspec, port_config(cfg.replace(self_collision_every=1)), DT / 6,
            8)
    with pytest.raises(ValueError):
        lc.make_hybrid_contact_runner(
            pspec, port_config(cfg.replace(enable_self_collision=False)),
            DT / 6, 8)


def test_hybrid_step_matches_stencil_step():
    """Two frames with a poke (consumed on the first substep, zeroed
    after) against JAX's stencil ``make_step``; ``make_cuda_step`` and the
    solver's ``make_step`` route here; a cadence that does not divide the
    frame is refused by the hybrid and runs in the stencil engine."""
    cfg = hybrid_config()
    spec, js, pspec, _ = scene()
    f = np.zeros(np.asarray(js.ext_force).shape, np.float32)
    f[10] = (0.05, 0.2, -0.03)
    js = js.replace(ext_force=jnp.asarray(f))
    ps = to_port(js)
    ref = jlat.make_step(spec, cfg, DT, n_steps=2)(js)
    pcfg = port_config(cfg)
    for step in (lc.make_cuda_step(pspec, pcfg, DT, n_steps=2),
                 plat.make_step(pspec, pcfg, DT, n_steps=2)):
        assert step.route == "hybrid"
        out = step(ps)
        assert dx(ref, out) < TOL, dx(ref, out)
        assert float(out.ext_force.abs().max()) == 0.0
    with pytest.raises(NotImplementedError):
        lc.make_hybrid_contact_step(
            pspec, pcfg.replace(self_collision_every=4), DT)
    with pytest.raises(ValueError):
        lc.make_hybrid_contact_step(
            pspec, pcfg.replace(self_collision_every=1), DT)
    assert plat.make_step(pspec, pcfg.replace(self_collision_every=4),
                          DT).route == "plain"


def test_hybrid_runner_with_tets():
    """A solid self-colliding lattice: the kernel chunks run the tet sweep,
    the contact substeps thread the tet multipliers through the stencil
    engine (``tests/test_contact_cadence.py:248-281``)."""
    cfg = hybrid_config(enable_tet_volume=True)
    spec, js, pspec, ps = scene(tets=True)
    ref = jlat.make_substep_runner(spec, cfg, DT / 6, 6)(js)
    out = lc.make_hybrid_contact_runner(pspec, port_config(cfg), DT / 6,
                                        6)(ps)
    assert out.lambda_tet is not None
    assert dx(ref, out) < TOL, dx(ref, out)
    assert float(np.abs(np.asarray(ref.lambda_tet)
                        - out.lambda_tet.numpy()).max()) < 1e-6


def test_hybrid_with_kinematic_colliders():
    """A traced sphere on both halves (``tests/test_contact_cadence.py:
    284-321``): the config's ground is bogus (123), so only the state's
    ColliderSet can explain agreement; runner and step against the JAX
    stencil engine, and a moved pose changes the result on the same
    step."""
    cfg = hybrid_config(ground_height=123.0)
    spec, js, pspec, ps = scene()
    js = js.replace(colliders=jmake_colliders(
        spheres=[(0.0, 0.2, 0.0, 0.3)], ground_height=0.0))
    coll = port.make_colliders(spheres=[(0.0, 0.2, 0.0, 0.3)],
                               ground_height=0.0, device="cpu")
    ps = ps.replace(colliders=coll)
    pcfg = port_config(cfg)
    out = lc.make_hybrid_contact_runner(pspec, pcfg, DT / 6, 6,
                                        kin_colliders=(1, 0))(ps)
    ref = jlat.make_substep_runner(spec, cfg, DT / 6, 6)(js)
    assert dx(ref, out) < TOL, dx(ref, out)
    step = plat.make_step(pspec, pcfg, DT)
    out_s = step(ps)
    assert dx(jlat.make_step(spec, cfg, DT)(js), out_s) < TOL
    moved = step(ps.replace(colliders=coll.with_sphere(
        0, center=(0.0, 0.45, 0.0), velocity=(0.0, 1.5, 0.0))))
    assert float((moved.positions - out_s.positions).abs().max()) > 1e-6
    with pytest.raises(NotImplementedError):
        # a runner built without kin_colliders refuses a collider state
        lc.make_hybrid_contact_runner(pspec, pcfg, DT / 6, 6)(ps)


# ---- routes ----------------------------------------------------------------

LATTICE_ROUTES = {
    "no_contact": (dict(enable_self_collision=False), "kernel"),
    "every_substep": (dict(self_collision_every=1), "plain"),
    "cadence_divides": (dict(self_collision_every=3), "hybrid"),
    "cadence_does_not_divide": (dict(self_collision_every=4), "plain"),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", list(LATTICE_ROUTES))
def test_lattice_routes(name, device):
    """The route is read from the config when the step is built, for
    either device (nothing is built on the card until a CUDA state
    arrives); the kernel's own runner refuses self-collision."""
    kw, want = LATTICE_ROUTES[name]
    cfg = port_config(hybrid_config(**kw))
    spec = ptop.lattice_spec(6, braced=True)
    assert lc.route(cfg) == want
    step = plat.make_step(spec, cfg, DT)
    assert step.route == want
    assert plat.make_substep_runner(spec, cfg, DT / 6, 6).route == want
    if device == "cpu":
        st = plat.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                     mass=0.001, device="cpu")
        assert port.is_finite(step(st))
    elif want != "kernel":
        with pytest.raises(NotImplementedError):
            lc.make_cuda_substep_runner(spec, cfg, DT / 6, 6)


MESH_ROUTES = {
    "no_contact": (dict(enable_self_collision=False), "kernel"),
    "dense": (dict(self_collision_backend="dense"), "kernel"),
    "blocked_cadence": (dict(self_collision_backend="blocked_pallas",
                             self_collision_every=2), "kernel"),
    "hash": (dict(), "plain"),
    "hash_cadence": (dict(self_collision_every=2), "hybrid"),
    "sorted": (dict(self_collision_backend="sorted"), "plain"),
    "sorted_cadence": (dict(self_collision_backend="sorted",
                            self_collision_every=4), "hybrid"),
    "sorted_cadence_does_not_divide": (dict(
        self_collision_backend="sorted", self_collision_every=3), "plain"),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", list(MESH_ROUTES))
def test_mesh_routes(name, device):
    """``general.make_step``'s route for example 4's configuration and its
    variants.  For a CUDA device the library refuses ``hash`` and
    ``sorted`` (as JAX's mesh kernel does), so their ``"plain"`` route is
    the plain engine on the card and their ``"hybrid"`` one builds only
    contact-free library runners; a CPU state runs every route."""
    kw, want = MESH_ROUTES[name]
    topo, cfg, st = ex4.scene(device="cpu")
    cfg = cfg.replace(**kw)
    assert mc.route(cfg) == want
    step = pgeneral.make_step(topo, cfg, DT)
    assert step.route == want
    if device == "cpu":
        assert port.is_finite(step(st))
    elif want == "hybrid":
        assert mc.make_mesh_hybrid_contact_step(
            topo, cfg, DT, device=device).route == "hybrid"
    elif want == "kernel":
        mc.make_mesh_cuda_step(topo, cfg, DT, device=device)
    else:
        with pytest.raises(NotImplementedError):
            mc.make_mesh_cuda_step(topo, cfg, DT, device=device)


@pytest.mark.parametrize("backend,every", [("hash", 2), ("sorted", 4)])
def test_mesh_hybrid_matches_jax_general_step(backend, every):
    """Example 4's scene through ``general.make_step``'s ``"hybrid"`` route
    (contact substeps in the plain engine, the others in the mesh kernel's
    plain version) against JAX's ``general.make_step``, 3 frames with a
    poke (gate 2e-5, the mesh cases' Jacobi gate)."""
    jtopo, jcfg, jstate = _jax_example4()
    jcfg = jcfg.replace(self_collision_backend=backend,
                        self_collision_every=every)
    topo, cfg, st = ex4.scene(device="cpu")
    cfg = cfg.replace(self_collision_backend=backend,
                      self_collision_every=every)
    poke = ((80.0, 60.0, 0.0), (0.0, 0.3, 0.0), 0.6)
    from softbodysimulation_tpu.interact import forces as jforces
    from softbodysimulation_tpu_torch.interact import forces as pforces
    js = jforces.add_force(jstate, poke[0], poke[1], radius=poke[2])
    ps = pforces.add_force(st, poke[0], poke[1], radius=poke[2])
    ref = jgeneral.make_step(jtopo, jcfg, DT, n_steps=3)(js)
    step = pgeneral.make_step(topo, cfg, DT, n_steps=3)
    out = step(ps)
    assert step.route == "hybrid"
    assert dx(ref, out) < 2e-5, dx(ref, out)
    assert float(out.ext_force.abs().max()) == 0.0


def _jax_example4():
    """(topology, config, state) of JAX's example 4 at res 4, from its own
    builders (the scene its ``run`` builds)."""
    from softbodysimulation_tpu.core.state import make_state
    from softbodysimulation_tpu.topology import build as jbuild

    res = 4
    spacing = 1.0 / (res - 1)
    pos = np.concatenate([jtop.lattice_points(res, center=(0.0, 0.8, 0.0)),
                          jtop.lattice_points(res,
                                              center=(0.15, 2.1, 0.1))])
    e, comp = jtop.lattice_edges(res, braced=True)
    topo = jbuild.build_topology(pos, np.concatenate([e, e + res ** 3]),
                                 np.concatenate([comp, comp]), color=False)
    cfg = jconfig.SolverConfig(
        substeps=4, iterations=2, damping=0.03,
        solve_mode=jconfig.SolveMode.JACOBI,
        lambda_mode=jconfig.LambdaMode.WARM_START, lambda_decay=1.0,
        enable_self_collision=True, particle_radius=0.45 * spacing,
        hash_grid_dim=32, ground_height=0.0, friction=0.3)
    assert jex4.run.__defaults__[0] == res
    return topo, cfg, make_state(pos, n_edges=topo.n_edges)


# ---- host syncs --------------------------------------------------------------

def test_hash_and_sorted_passes_make_no_host_sync(monkeypatch):
    """The hash and sorted passes and the curve order read nothing back to
    the host and copy nothing to the device once their constants are
    there: every way a tensor reaches the host (``item``, ``tolist``,
    ``numpy``, truth and number conversions) and every host-to-device
    constructor raises while they run.  (On the card
    ``torch.cuda.set_sync_debug_mode`` checks the same, in
    ``chip_smoke.py``.)"""
    topo, cfg, st = ex4.scene(device="cpu")
    pred, w = st.positions + 0.01, st.inv_mass
    sorted_cfg = cfg.replace(self_collision_backend="sorted")

    def run():
        order = psh.morton_order(pred, sorted_cfg)
        return (psh.self_collision_project(pred, w, cfg),
                psh.self_collision_project_sorted(pred, w, order,
                                                  sorted_cfg))

    want = run()                       # caches the constants

    def forbidden(*_a, **_k):
        raise AssertionError("host round trip in a contact pass")

    for name in ("item", "tolist", "numpy", "__bool__", "__float__",
                 "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    monkeypatch.setattr(torch, "tensor", forbidden)
    monkeypatch.setattr(torch, "as_tensor", forbidden)
    got = run()
    monkeypatch.undo()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
