"""The port's tetrahedra against the JAX package's, on the CPU: the copied
builders (``topology/tets.py``), the tet constraint (``ops/tet_volume.py``),
the topologies that carry tets, and the plain general engine's tet sweep
(COLORED and mass-splitting JACOBI) over the tet cases of
``test_torch_contact_cases.py``, at the JAX suite's gates (|dx| < 2e-5,
|dlambda_tet| < 1e-5, ``tests/test_tets.py:382-383``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.ops import tet_volume as jtv
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh
from softbodysimulation_tpu.topology import tets as jtets

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.ops import tet_volume as ptv
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import mesh as pmesh
from softbodysimulation_tpu_torch.topology import tets as ptets

import test_torch_contact_cases as cases
from test_torch_mesh_topology import assert_same_topology
from test_torch_state import port_config

torch.set_num_threads(1)

DT = 1 / 60
TET_CASES = cases.tet_cases(jconfig)


def _fan(mesh_mod, tets_mod):
    m = mesh_mod.icosphere(1, radius=0.5)
    return tets_mod.tets_from_surface_centroid(m.vertices, m.triangles)


@pytest.mark.parametrize("fn", ["kuhn_offset_paths", "cube_lattice_tets",
                                "tets_from_surface_centroid", "tet_volumes6",
                                "fix_orientation", "tet_edges",
                                "boundary_faces"])
def test_tet_builders_match_jax(fn):
    """The copied builders give the JAX package's arrays exactly, on the
    Kuhn lattice of res 3 and on an icosphere's centroid fan."""
    cube = jtets.cube_lattice_tets(3)
    verts, fan = _fan(jmesh, jtets)
    pos = np.random.default_rng(0).normal(size=(27, 3))
    args = {
        "kuhn_offset_paths": [()],
        "cube_lattice_tets": [(2,), (3,)],
        "tets_from_surface_centroid": [],
        "tet_volumes6": [(pos, cube), (verts, fan)],
        "fix_orientation": [(pos, cube), (verts, fan[:, [0, 1, 3, 2]])],
        "tet_edges": [(cube,), (fan,)],
        "boundary_faces": [(jtets.fix_orientation(pos, cube),), (fan,)],
    }[fn]
    if fn == "tets_from_surface_centroid":
        for a, b in zip(_fan(jmesh, jtets), _fan(pmesh, ptets)):
            np.testing.assert_array_equal(a, b)
        return
    for a in args:
        j, p = getattr(jtets, fn)(*a), getattr(ptets, fn)(*a)
        if fn == "kuhn_offset_paths":
            assert j == p
            continue
        assert j.dtype == p.dtype and j.shape == p.shape
        np.testing.assert_array_equal(j, p)


def test_tet_delta_lambda_matches_jax():
    """``tet_delta_lambda`` (and the 6V helpers) on seeded tets: one
    all-pinned and one collapsed tet of compliance 0 (both skipped), the
    rest random, compliance 0 and 1e-6, pressure 1.05."""
    rng = np.random.default_rng(4)
    t = 64
    p = rng.normal(size=(4, t, 3)).astype(np.float32)
    p[:, 4] = p[0, 4]                                  # collapsed
    w = rng.uniform(0.0, 2.0, size=(4, t)).astype(np.float32)
    w[:, 2] = 0.0                                      # all pinned
    rest = np.abs(rng.normal(size=t)).astype(np.float32)
    comp = np.where(np.arange(t) % 2, 1e-6, 0.0).astype(np.float32)
    lam = rng.normal(scale=1e-3, size=t).astype(np.float32)
    cfg = jconfig.SolverConfig(tet_pressure=1.05)
    jout = jtv.tet_delta_lambda(*map(jnp.asarray, (*p, *w, rest, comp, lam)),
                                DT / 4, cfg)
    pout = ptv.tet_delta_lambda(*map(torch.as_tensor, (*p, *w, rest, comp,
                                                       lam)),
                                DT / 4, port_config(cfg))
    # XLA may contract the cross and dot products' multiply-adds on the CPU
    for j, q in zip(jout, pout):
        np.testing.assert_allclose(q.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    assert float(pout[0][4]) == 0.0 and float(pout[0][2]) == 0.0
    assert float(pout[0].abs().max()) > 0
    np.testing.assert_allclose(
        ptv.tet_volume6(*map(torch.as_tensor, p)).numpy(),
        np.asarray(jtv.tet_volume6(*map(jnp.asarray, p))), rtol=1e-6)
    pos = p.reshape(-1, 3)
    tets = np.arange(4 * t).reshape(4, t).T.astype(np.int32)
    np.testing.assert_allclose(
        ptv.tet_volumes6(torch.as_tensor(pos), torch.as_tensor(tets)).numpy(),
        np.asarray(jtv.tet_volumes6(jnp.asarray(pos), jnp.asarray(tets))),
        rtol=1e-6)


@pytest.mark.parametrize("kind", ["cube3", "ball1"])
def test_topologies_with_tets_match_jax(kind):
    """``build_topology`` (the Kuhn cube) and ``build_windowed_topology``
    (the centroid fan, RCM-renumbered) with tets give every field of the
    JAX builders, and ``validate_topology`` the same report."""
    _, jtopo = cases.tet_body(kind, cases.modules("softbodysimulation_tpu"))
    _, ptopo = cases.tet_body(kind, cases.modules())
    assert_same_topology(ptopo, jtopo)
    assert ptopo.n_tets == jtopo.n_tets > 0
    assert pbuild.validate_topology(ptopo) == jbuild.validate_topology(jtopo)


def test_bad_tets_are_refused():
    """Inverted tets without rest volumes, and a tet colouring with a
    conflict, are refused as the JAX builders refuse them."""
    lat = np.random.default_rng(1).normal(size=(27, 3))
    tt = jtets.fix_orientation(lat, jtets.cube_lattice_tets(3))
    bad = tt[:, [0, 1, 3, 2]]
    for b in (jbuild, pbuild):
        with pytest.raises(ValueError, match="non-positive"):
            b.build_topology(lat, jtets.tet_edges(bad), 1e-4, tets=bad)
    topo = pbuild.build_topology(lat, jtets.tet_edges(tt), 1e-4, tets=tt)
    clash = topo.tcol_tet_ids.clone()
    clash[0, 1] = clash[0, 0]
    with pytest.raises(ValueError, match="tet coloring"):
        pbuild.validate_topology(topo.replace(tcol_tet_ids=clash))


@pytest.mark.parametrize("name", list(TET_CASES))
def test_plain_engine_tets_match_jax(name):
    """The plain engine's tet sweep, lifecycle and pins against JAX
    ``general.make_step``."""
    cfg, kind, kw, frames = TET_CASES[name]
    jtopo, fields = cases.tet_inputs(
        kind, cases.modules("softbodysimulation_tpu"), **kw)
    ptopo, pfields = cases.tet_inputs(kind, cases.modules(), **kw)
    for k in fields:
        np.testing.assert_array_equal(fields[k], pfields[k])
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ps = port.state_from_numpy(pfields, device="cpu")
    jout = jgeneral.make_step(jtopo, cfg, DT, n_steps=frames)(js)
    pout = pgeneral.make_step(ptopo, port_config(cfg), DT, n_steps=frames)(ps)
    assert port.is_finite(pout)
    dx = np.abs(np.asarray(jout.positions) - pout.positions.numpy()).max()
    dlt = np.abs(np.asarray(jout.lambda_tet) - pout.lambda_tet.numpy()).max()
    assert dx < cases.DX_TET and dlt < cases.DLAM_TET, (name, dx, dlt)
    # the tets loaded, and the bodies moved
    assert float(pout.lambda_tet.abs().max()) > 0
    assert float((pout.positions - ps.positions).abs().max()) > 1e-3
    pins = np.flatnonzero(pfields["inv_mass"] == 0)
    np.testing.assert_array_equal(pout.positions[pins].numpy(),
                                  pfields["positions"][pins])
