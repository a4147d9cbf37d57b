"""The port's mesh topology builders against the JAX package's, on the CPU.

``build_topology``, ``build_windowed_topology`` (plain and colour-major)
and ``topology_from_mesh`` must give every field the JAX builder gives:
integer tables exactly, float32 arrays to the bit, and the same static
counts; the window matrices the JAX topology also carries have no
counterpart.  ``topology_from_numpy`` carries a JAX topology across.
"""

import dataclasses

import numpy as np
import pytest
import torch

from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import coloring as jcoloring
from softbodysimulation_tpu.topology import edges as jedges
from softbodysimulation_tpu.topology import mesh as jmesh
from softbodysimulation_tpu.topology import windows as jwindows

from softbodysimulation_tpu_torch.core.state import (Topology,
                                                     topology_from_numpy)
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import coloring as pcoloring
from softbodysimulation_tpu_torch.topology import edges as pedges
from softbodysimulation_tpu_torch.topology import mesh as pmesh
from softbodysimulation_tpu_torch.topology import native as pnative
from softbodysimulation_tpu_torch.topology import tets as ptets
from softbodysimulation_tpu_torch.topology import windows as pwindows

import test_torch_mesh_cases as mesh_cases

WINDOW_FIELDS = {"windows", "bend_windows", "tet_windows"}


def jax_fields(jtopo):
    return {f.name: getattr(jtopo, f.name) for f in dataclasses.fields(jtopo)}


def port_fields(ptopo):
    """Field name -> numpy array, int, or None (an absent tet field)."""
    return {f.name: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(ptopo)
            for v in (getattr(ptopo, f.name),)}


def assert_same_topology(ptopo, jtopo):
    """Every field of the port's topology equals the JAX topology's, bit
    for bit and with the same dtype."""
    jf = jax_fields(jtopo)
    assert set(jf) - WINDOW_FIELDS == {f.name for f in
                                       dataclasses.fields(ptopo)}
    for name, p in port_fields(ptopo).items():
        j = jf[name]
        if j is None or isinstance(j, int):
            assert p == j, name
            continue
        j = np.asarray(j)
        assert p.dtype == j.dtype and p.shape == j.shape, (name, p.dtype,
                                                           j.dtype)
        np.testing.assert_array_equal(p.reshape(-1).view(np.uint8),
                                      j.reshape(-1).view(np.uint8),
                                      err_msg=name)


def bodies(mesh):
    """(name, TriMesh) of the bodies held: an icosphere and a cloth bent
    out of its plane."""
    return [("icosphere", mesh.icosphere(2)),
            ("bent_cloth", mesh_cases._cloth_mesh(mesh, res=10))]


@pytest.mark.parametrize("body", ["icosphere", "bent_cloth"])
@pytest.mark.parametrize("how", ["plain", "windowed", "colored"])
def test_topology_from_mesh_matches_jax(body, how):
    windowed = {"plain": False, "windowed": True, "colored": "colored"}[how]
    jm = dict(bodies(jmesh))[body]
    pm = dict(bodies(pmesh))[body]
    kw = dict(compliance=1e-4, bending=True, bend_compliance=2e-3,
              windowed=windowed)
    jpos, jtopo = jbuild.topology_from_mesh(jm, **kw)
    ppos, ptopo = pbuild.topology_from_mesh(pm, **kw)
    np.testing.assert_array_equal(ppos, jpos)
    assert ppos.dtype == np.float32
    assert_same_topology(ptopo, jtopo)
    assert pbuild.validate_topology(ptopo)["ok"]
    if how == "colored":
        colors = ptopo.colors.numpy()
        assert (np.diff(colors) >= 0).all()      # colour-major edge order


def test_build_topology_with_given_rest_data_matches_jax():
    """``build_topology`` with explicit rest lengths and angles, the
    cluster colourer and no colouring at all."""
    m = jmesh.icosphere(1)
    e = jedges.unique_edges(m.triangles)
    h = jedges.hinges(m.triangles)
    rest = np.linspace(0.5, 1.0, len(e)).astype(np.float32)
    ang = np.linspace(0.0, 0.3, len(h)).astype(np.float32)
    for kw in (dict(rest_lengths=rest, rest_angles=ang),
               dict(color_strategy="cluster"), dict(color=False)):
        assert_same_topology(
            pbuild.build_topology(m.vertices, e, 1e-3, hinges=h,
                                  triangles=m.triangles, **kw),
            jbuild.build_topology(m.vertices, e, 1e-3, hinges=h,
                                  triangles=m.triangles, **kw))


def test_orderings_and_numpy_helpers_match_jax():
    """The copied NumPy modules give the JAX package's answers: RCM order,
    window sorts, edges, hinges, welding, colouring; and the native colorer
    (``native/topology.cpp``) equals its NumPy fallback."""
    m = mesh_cases._cloth_mesh(pmesh, res=9)
    e = pedges.unique_edges(m.triangles)
    h = pedges.hinges(m.triangles)
    np.testing.assert_array_equal(e, jedges.unique_edges(m.triangles))
    np.testing.assert_array_equal(h, jedges.hinges(m.triangles))
    np.testing.assert_array_equal(pwindows.rcm_order(e, 81),
                                  jwindows.rcm_order(e, 81))
    np.testing.assert_array_equal(pwindows.sort_edges_by_window(e),
                                  jwindows.sort_edges_by_window(e))
    np.testing.assert_array_equal(pwindows.sort_hinges_by_window(h),
                                  jwindows.sort_hinges_by_window(h))
    for p, j in zip(pedges.weld(m.vertices, m.triangles, 0.2),
                    jedges.weld(m.vertices, m.triangles, 0.2)):
        np.testing.assert_array_equal(p, j)
    for cons in (e, h):
        ref = pcoloring.greedy_color(cons, 81)
        np.testing.assert_array_equal(ref, jcoloring.greedy_color(cons, 81))
        np.testing.assert_array_equal(pnative.greedy_color(cons, 81), ref)
        assert pcoloring.validate_coloring(cons, ref)


def test_topology_numpy_round_trip_and_to():
    """A JAX topology crosses into the port (window matrices dropped) and
    equals the port's own build; a round trip through numpy and ``to``
    keep every field."""
    m = jmesh.icosphere(2)
    _, jtopo = jbuild.topology_from_mesh(m, compliance=1e-3, bending=True,
                                         windowed=True)
    assert jtopo.windows is not None
    carried = topology_from_numpy(jax_fields(jtopo), device="cpu")
    assert_same_topology(carried, jtopo)
    _, own = pbuild.topology_from_mesh(pmesh.icosphere(2), compliance=1e-3,
                                       bending=True, windowed=True)
    assert_same_topology(own, jtopo)
    back = topology_from_numpy(port_fields(carried), device="cpu")
    assert_same_topology(back, jtopo)
    moved = carried.to("cpu")
    assert isinstance(moved, Topology) and moved.n_edges == jtopo.n_edges
    assert moved.edges.dtype == torch.int32
    assert moved.n_hinges == jtopo.n_hinges and moved.n_tets == 0
    fields = jax_fields(jtopo)
    del fields["degree"]
    with pytest.raises(ValueError):
        topology_from_numpy(fields, device="cpu")
    with pytest.raises(ValueError):
        topology_from_numpy(dict(jax_fields(jtopo), bogus=1),
                            device="cpu")


def test_tets_and_bad_topologies_are_refused():
    """An inverted tet (non-positive rest volume) and a degenerate edge are
    refused, as the JAX builders refuse them."""
    m = pmesh.icosphere(1)
    e = pedges.unique_edges(m.triangles)
    verts = np.concatenate([m.vertices, m.vertices.mean(0, keepdims=True)])
    tet = ptets.fix_orientation(verts, [[len(m.vertices), *m.triangles[0]]])
    inverted = tet[:, [0, 1, 3, 2]]
    for b in (jbuild, pbuild):
        with pytest.raises(ValueError, match="non-positive rest tet"):
            b.build_topology(verts, e, 1e-3, tets=inverted)
    bad = pbuild.build_topology(m.vertices, e, 1e-3)
    bad = bad.replace(edges=bad.edges.clone())
    bad.edges[0, 1] = bad.edges[0, 0]
    with pytest.raises(ValueError, match="degenerate"):
        pbuild.validate_topology(bad)
