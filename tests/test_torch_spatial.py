"""The port's spatial (x-slab sharded) lattice path against the JAX
package's, on the CPU.

The sharded torch engine (``parallel/spatial.py``) runs the cases of
``test_torch_spatial_cases.py`` against JAX's ``make_spatial_lattice_step``
(XLA backend, on the 8 virtual CPU devices of ``conftest.py``) with the
same op order on both sides: max |dx| < 1e-5 and max |dlambda| < 1e-6
(tets: 2e-5 and |dlambda_tet| < 1e-5); the distance-only cases here, the
rest in ``test_torch_spatial_solids.py``.  The exchange alone, the shard /
gather round trip, resident sharded states, the routing and the refusals
are checked here too; the other engines the sharded one must track are in
``test_torch_spatial_engine.py``.  The slab kernel B-6 runs only on the
card (``test_torch_kernel_on_card.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.parallel import batch as pbatch
from softbodysimulation_tpu.parallel import spatial as jspatial
from softbodysimulation_tpu.topology import lattice as jtop

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.kernels import spatial_cuda as sc
from softbodysimulation_tpu_torch.parallel import spatial as psp
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_spatial_cases as cases
from test_torch_state import FIELDS, port_config

torch.set_num_threads(1)

DT = cases.DT
CASES = cases.spatial_cases(jconfig)
DX_TOL, DLAM_TOL = 1e-5, 1e-6
DX_TET, DLAM_TET = 2e-5, 1e-5


def _jax_state(fields):
    return jstate_mod.SimState(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})


def _port_state(fields):
    return port.state_from_numpy(fields, device="cpu")


def _diff(a, b, name):
    a = getattr(a, name)
    b = getattr(b, name)
    return float(np.abs(np.asarray(a) - (b.numpy() if isinstance(
        b, torch.Tensor) else np.asarray(b))).max())


def _run_port(name, n_slabs=None, **kw):
    cfg, inputs, d, res, frames = CASES[name]
    spec = ptop.lattice_spec(res, braced=True)
    st = _port_state(cases.case_inputs(res, **inputs))
    step = psp.make_spatial_lattice_step(
        spec, port_config(cfg), DT, ["cpu"] * (n_slabs or d),
        n_steps=frames, **kw)
    return st, step(st)


def check_against_jax_spatial(name):
    """A case: the port's sharded engine vs JAX's XLA spatial engine on a
    D-device mesh, positions, velocities and multipliers; the ext force is
    consumed."""
    cfg, inputs, d, res, frames = CASES[name]
    fields = cases.case_inputs(res, **inputs)
    mesh = pbatch.make_mesh(d, axis="x")
    jout = jspatial.make_spatial_lattice_step(
        jtop.lattice_spec(res, braced=True), cfg, DT, mesh,
        n_steps=frames)(_jax_state(fields))
    start, pout = _run_port(name)
    tets = cfg.enable_tet_volume
    dx, dlam = _diff(jout, pout, "positions"), _diff(jout, pout,
                                                     "lambda_dist")
    dv = _diff(jout, pout, "velocities")
    moved = float((pout.positions - start.positions).abs().max())
    assert moved > 1e-3 and port.is_finite(pout)
    assert dx < (DX_TET if tets else DX_TOL), (dx, dlam)
    assert dlam < DLAM_TOL and dv < 1e-5 / (DT / cfg.substeps), (dlam, dv)
    if tets:
        assert _diff(jout, pout, "lambda_tet") < DLAM_TET
        assert float(pout.lambda_tet.abs().max()) > 0.0
    assert float(pout.ext_force.abs().max()) == 0.0


# the distance-only cases; the rest are in test_torch_spatial_solids.py
# (one file would outlast a test worker's share of the suite)
JAX_CASES_HERE = ("colored_reset", "jacobi_decay", "jacobi_warm_start",
                  "colored_warm_start", "velocity_reflect", "pinned")


@pytest.mark.parametrize("name", JAX_CASES_HERE)
def test_sharded_engine_matches_jax_spatial(name):
    check_against_jax_spatial(name)


@pytest.mark.parametrize("source", [1, -1])
def test_exchange_is_the_global_roll(source):
    """Slabs -> exchange -> each slab holds its neighbour's edge plane: the
    global lattice rolled by one plane, zeros where there is no
    neighbour."""
    rng = np.random.default_rng(5)
    glob = torch.as_tensor(rng.normal(size=(8, 4, 6)).astype(np.float32))
    slabs = list(glob.chunk(4, dim=0))
    edge = 0 if source == 1 else -1
    got = psp.exchange([s[edge] for s in slabs], ["cpu"] * 4, source)
    rolled = torch.roll(glob, -source, dims=0)
    for i, g in enumerate(got):
        j = i + source
        want = (rolled[2 * i + (1 if source == 1 else 0)]
                if 0 <= j < 4 else torch.zeros_like(g))
        assert torch.equal(g, want)
        assert g.data_ptr() != slabs[min(max(j, 0), 3)][edge].data_ptr()


@pytest.mark.parametrize("tets", [False, True])
def test_shard_gather_round_trip(tets):
    """``shard_lattice_state`` -> ``gather_lattice_state`` gives back the
    same state bit for bit; every slab is a copy on its device."""
    fields = cases.case_inputs(8, tets=tets, pins=(3, 300),
                               ext_patch=(20, (1.0, 2.0, 3.0)))
    st = _port_state(fields)
    spec = ptop.lattice_spec(8, braced=True)
    sh = psp.shard_lattice_state(st, spec, ["cpu"] * 4)
    assert len(sh.slabs) == 4 and sh.slabs[1].positions.shape == (3, 128)
    assert sh.slabs[0].lambda_dist.shape == (13, 128)
    back = psp.gather_lattice_state(sh)
    for k in FIELDS:
        a, b = getattr(st, k), getattr(back, k)
        assert (a is None) == (b is None) == (k == "lambda_tet" and not tets)
        if a is not None:
            assert torch.equal(a, b), k
    sh.slabs[0].positions.add_(1.0)
    assert torch.equal(st.positions, back.positions)


def test_sharded_state_stays_resident():
    """A sharded state goes in and comes out sharded: two calls of one
    frame equal one call of two frames (the ext force consumed by the
    first), and a step built for other slabs refuses it."""
    cfg, inputs, d, res, _ = CASES["ext_force"]
    spec, pcfg = ptop.lattice_spec(res, braced=True), port_config(cfg)
    st = _port_state(cases.case_inputs(res, **inputs))
    one = psp.make_spatial_lattice_step(spec, pcfg, DT, ["cpu"] * d)
    sh = psp.shard_lattice_state(st, spec, ["cpu"] * d)
    out = one(one(sh))
    assert isinstance(out, psp.ShardedLatticeState)
    two = psp.make_spatial_lattice_step(spec, pcfg, DT, ["cpu"] * d,
                                        n_steps=2)(st)
    assert torch.equal(psp.gather_lattice_state(out).positions,
                       two.positions)
    with pytest.raises(ValueError, match="step built for"):
        psp.make_spatial_lattice_step(spec, pcfg, DT, ["cpu"] * 4)(sh)


def test_routing_on_cpu_slabs():
    """Slabs on the CPU run the sharded engine whatever the backend names:
    ``"auto"`` and ``"xla"`` directly, ``"pallas"`` through the kernel's
    wrapper (its plain version); nothing launches.  Unknown backends
    raise."""
    cfg, inputs, d, res, frames = CASES["colored_reset"]
    spec, pcfg = ptop.lattice_spec(res, braced=True), port_config(cfg)
    st = _port_state(cases.case_inputs(res, **inputs))
    before = sc.launches
    outs = [psp.make_spatial_lattice_step(spec, pcfg, DT, ["cpu"] * d,
                                          backend=b)(st)
            for b in ("auto", "xla", "pallas")]
    assert sc.launches == before
    for o in outs[1:]:
        assert torch.equal(o.positions, outs[0].positions)
    with pytest.raises(ValueError, match="backend"):
        psp.make_spatial_lattice_step(spec, pcfg, DT, ["cpu"] * d,
                                      backend="cuda")


@pytest.mark.parametrize("what", ["res_not_divisible", "box_colliders",
                                  "kin_colliders", "state_colliders",
                                  "self_collision", "kernel_one_plane",
                                  "kernel_tets", "kernel_sphere",
                                  "kernel_x_offset"])
def test_refusals(what):
    """What the spatial path refuses: a lattice that does not split into
    the slabs (ValueError, as JAX), self-collision, a state carrying
    colliders on a step built without ``kin_colliders``; and on the kernel
    route fewer than 2 planes a slab, tets, spheres and boxes (naming
    ``backend="xla"``), kinematic colliders (as JAX's slab kernel) and
    family x-offsets other than 0 and 1."""
    spec = ptop.lattice_spec(8, braced=True)
    cfg = port.SolverConfig(substeps=2, iterations=1)
    build = psp.make_spatial_lattice_step
    cpu4 = ["cpu"] * 4
    if what == "res_not_divisible":
        with pytest.raises(ValueError, match="divisible"):
            build(ptop.lattice_spec(6, braced=True), cfg, DT, cpu4)
        return
    if what == "state_colliders":
        st = plat.make_lattice_state(spec, device="cpu").replace(
            colliders=port.make_colliders(device="cpu"))
        with pytest.raises(NotImplementedError, match="kin_colliders"):
            build(spec, cfg, DT, cpu4)(st)
        return
    kw, match = {}, None
    if what == "box_colliders":
        build = sc.make_spatial_cuda_substep
        match = 'backend="xla"'
        cfg = cfg.replace(box_colliders=((0.0, 0.0, 0.0, 0.5, 0.5, 0.5),))
    elif what == "kin_colliders":
        kw = dict(kin_colliders=(1, 0), backend="pallas")
    elif what == "self_collision":
        cfg = cfg.replace(enable_self_collision=True)
    else:
        build = sc.make_spatial_cuda_substep
        match = 'backend="xla"'
        if what == "kernel_one_plane":
            cpu4 = ["cpu"] * 8
        elif what == "kernel_tets":
            cfg = cfg.replace(enable_tet_volume=True)
        elif what == "kernel_sphere":
            cfg = cfg.replace(sphere_colliders=((0.0, 0.0, 0.0, 0.3),))
        else:
            spec = dataclasses.replace(spec, families=(
                (-1, 0, 0, 0),) + spec.families[1:])
            match = "x-offsets"
    with pytest.raises(NotImplementedError, match=match):
        build(spec, cfg, DT, cpu4, **kw)
