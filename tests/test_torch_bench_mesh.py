"""The benchmark's mesh cell on the CPU: the plain mesh reference
(``portbench/reference/mesh.py``) builds the port's mesh and topology, the
port's normal ensemble path equals it under the ``farm32_pressurized``
limits while the bfloat16 control fails them, and the cell's readers
(``mesh_roofline_pct``, and the accepted idle shares on the mesh runner's
spans) read what they should.

The reference imports nothing of the program; here both sides are built
and compared.  Bodies of ``icosphere(1)`` and ``icosphere(2)``, two a
farm, two frames a call: a few seconds in all.
"""

import copy
import json

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.control import Control
from portbench.reference import mesh as ref
from portbench.systems import mesh as system
from portbench.trace import Trace
from softbodysimulation_tpu_torch.ops import volume as pvolume
from softbodysimulation_tpu_torch.topology import build, edges as pedges
from softbodysimulation_tpu_torch.topology import mesh as pmesh
from softbodysimulation_tpu_torch.topology import windows

CELL = "farm32_pressurized.rollout"
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SEEDS = (1, 2 ** 31 + 99, 2 ** 40 + 7)


def cut(subdivisions, frames=2):
    """(configuration, traffic, limits) of the farm cell: two bodies of
    ``icosphere(subdivisions)``, ``frames`` frames a call."""
    _, conf, traffic, limits = harness.cell_files(BENCH, CELL)
    conf = copy.deepcopy(conf)
    conf["body"]["subdivisions"], conf["bodies"] = subdivisions, 2
    return conf, dict(traffic, frames_per_call=frames), limits


def real_rows(table, pad):
    """The entries of each incidence row short of the pad, as lists."""
    t = np.asarray(table)
    return [list(r[r < pad]) for r in t]


@pytest.mark.parametrize("subdivisions", [1, 2])
def test_the_reference_builds_the_ports_mesh(subdivisions):
    """The icosphere, its edges and its triangles equal the port's; the
    windowed numbering (the reverse Cuthill-McKee order, the edges sorted
    by lower endpoint), the rest lengths and volume equal the port's
    ``topology_from_mesh(..., windowed=True)``; the edge and
    triangle-corner incidence rows list what the port's tables list, in
    its order."""
    verts, tris = ref.icosphere(subdivisions, 0.5)
    port = pmesh.icosphere(subdivisions, radius=0.5)
    assert np.array_equal(verts, port.vertices)
    assert np.array_equal(tris, port.triangles)
    raw = ref.unique_edges(tris)
    assert np.array_equal(raw, pedges.unique_edges(port.triangles))
    assert np.array_equal(ref.rcm_order(raw, len(verts)),
                          windows.rcm_order(raw.astype(np.int32),
                                            len(verts)))
    conf = cut(subdivisions)[0]
    m = ref.Mesh.of(conf)
    pos, topo = build.topology_from_mesh(port, compliance=1e-6,
                                         windowed=True)
    # the stated permutation: new particle i is raw vertex order[i]
    assert np.array_equal(m.positions, verts[m.order])
    assert np.array_equal(m.positions, pos)
    assert np.array_equal(m.edges, topo.edges.numpy())
    assert np.array_equal(m.triangles, topo.triangles.numpy())
    assert np.array_equal(m.rest_lengths, topo.rest_lengths.numpy())
    assert np.array_equal(m.compliance, topo.compliance.numpy())
    assert m.rest_volume == np.float32(topo.rest_volume)
    assert np.array_equal(m.degree, topo.degree.numpy())
    e = topo.n_edges
    assert (real_rows(ref.incidence(m.edges, m.n), 2 * e)
            == real_rows(topo.incidence, 2 * e))
    corners, pad = pvolume.corner_table(topo.triangles, topo.n_particles)
    assert (real_rows(ref.incidence(m.triangles, m.n), pad)
            == real_rows(corners, pad))


def seeded_start(conf, traffic, seed):
    """The program built on the seed's offsets, its state given seeded
    random velocities."""
    pos = system.initial_positions(conf, seed)
    prog = system.Program(conf, traffic, pos, "cpu")
    vel = np.random.default_rng(seed).normal(0.0, 0.5, pos.shape)
    return prog, prog.state.replace(
        velocities=torch.as_tensor(vel.astype(np.float32)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("subdivisions", [1, 2])
def test_the_normal_path_equals_the_reference(subdivisions, seed):
    """``general.make_batched_step`` on a CPU state (the plain engine body
    by body) against the reference, batched: within the cell's limits,
    and in fact to the bit."""
    conf, traffic, limits = cut(subdivisions)
    prog, state = seeded_start(conf, traffic, seed)
    out = prog.leaves(prog.step(state))
    want = system.Reference(conf, traffic, "cpu").call(prog.leaves(state))
    numbers = check.compare(limits, [(out, want)])
    assert check.passes(numbers), numbers
    assert all(n["value"] == 0.0 for n in numbers.values()), numbers
    # the call moved the bodies and inflated each
    assert float((out["positions"] - state.positions).abs().max()) > 1e-2
    assert float(out["lambda_volume"].abs().min()) > 0.0
    assert int(system.unhealthy(out)) == 0


@pytest.mark.parametrize("subdivisions", [1, 2])
def test_the_bfloat16_control_fails_the_limits(subdivisions):
    """The reference computed in bfloat16 in the program's place, at the
    same cut, fails at least one limit."""
    conf, traffic, limits = cut(subdivisions)
    prog, state = seeded_start(conf, traffic, SEEDS[0])
    ctl = Control(conf, traffic, system.initial_positions(conf, SEEDS[0]),
                  "cpu")
    leaves = prog.leaves(state)
    got = ctl.step(leaves)
    want = system.Reference(conf, traffic, "cpu").call(leaves)
    numbers = check.compare(limits, [(got, want)])
    assert not check.passes(numbers), numbers


def test_the_health_gate():
    """Finite leaves of a body at rest or inflated pass; a body flattened,
    inverted or not finite fails."""
    conf, traffic, _ = cut(2)
    prog, state = seeded_start(conf, traffic, 5)
    leaves = prog.leaves(state)
    assert int(system.unhealthy(leaves)) == 0
    x = leaves["positions"]
    centre = x.mean(dim=1, keepdim=True)
    for bad in (centre + (x - centre) * torch.tensor([1.0, 0.05, 1.0]),
                centre + (x - centre) * torch.tensor([1.0, -1.0, 1.0])):
        assert int(system.unhealthy(dict(leaves, positions=bad))) == 1
    assert int(system.unhealthy(dict(
        leaves, positions=centre + (x - centre) * 1.1))) == 0
    lam = leaves["lambda_volume"].clone()
    lam[1] = float("nan")
    assert int(system.unhealthy(dict(leaves, lambda_volume=lam))) == 1


def test_mesh_roofline_count_by_hand():
    """One substep of two icosphere(1) bodies (42 particles, 120 edges, 80
    triangles) with the volume, the floor and Chebyshev weights, counted
    here from the kernel's passes."""
    reader = harness.load_reader("mesh_roofline_pct")
    work = reader.__globals__
    conf = cut(1)[0]
    nbytes, ops = work["work"](conf, 1, True)
    n, e, t = 42, 120, 80
    # every body: x, v, w, ext read; x, v, 120 + 1 multipliers written
    # (RESET reads none); the tables once: edges 8, rest, compliance,
    # relaxation 4 each, CSR pointers and columns of both incidences,
    # triangles 12
    tables = (e * 20 + 4 * (n + 1) + 4 * 2 * e + 12 * t + 4 * (n + 1)
              + 4 * 3 * t)
    assert nbytes == 2 * (n * (24 + 4 + 12) + n * 24 + 4 * (e + 1)) + tables
    # an iteration: edges 35 each, their rows 3 an entry, the correction 3 a
    # particle, the floor 6; triangles 41, corner rows 3 an entry, w|g|^2
    # 6, the reduction t + n + 510 + 8, the apply 7; the momentum step 18
    # and the floor again
    it = (e * 35 + 3 * 2 * e + 3 * n + 6 * n + t * 41 + 3 * 3 * t + 6 * n
          + t + n + 510 + 8 + 7 * n + (18 + 6) * n)
    assert ops == 2 * (4 * it + n * (21 + 6))
    # this small a call is bound by its bytes
    bound = max(nbytes / 3.35e12, ops / 67e12)
    assert bound == nbytes / 3.35e12
    assert work["bound_s"](conf, 1, True) == pytest.approx(bound)
    # the kernel's time a call over the least time
    tr = Trace(window=(0.0, 1.0), calls=2, device_ops=[
        ("void mesh_persistent_kernel<1>(MeshParams, ...)", 0.1, 0.3),
        ("void mesh_persistent_kernel<1>(MeshParams, ...)", 0.5, 0.7),
        ("elementwise", 0.3, 0.4)], spans=[])
    run = harness.Run(conf, 2 * n, 1, True, trace=tr)
    assert reader(run) == pytest.approx(100.0 * bound * 2 / 0.4)
    assert reader(harness.Run(conf, 2 * n, 1, True, trace=Trace(
        (0.0, 1.0), 2, [("elementwise", 0.0, 1.0)], []))) is None


def test_farm_idle_readers_read_the_mesh_runners_spans():
    """The farm cell's idle shares are the benchmark's own readers: the
    device's (``device_idle_pct.rollout``) and the runner's
    (``runner_idle_pct``, the union of ``mesh.call`` spans as of
    ``lattice.call``); the mesh runner's phases alone and idle time outside
    the calls do not count; a slice without a runner call reads nothing
    for the runner."""
    listed = {m["name"] for m in BENCH["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert {"device_idle_pct.rollout", "runner_idle_pct",
            "mesh_roofline_pct"} <= listed
    runner = harness.load_reader("runner_idle_pct")
    device = harness.load_reader("device_idle_pct.rollout")
    conf = cut(1)[0]
    ops = [("k", 1.0, 3.0), ("k", 5.0, 6.0)]
    program = [("mesh.call", 0.5, 2.0),       # idle 0.5-1
               ("mesh.layout", 0.5, 0.8),     # inside the call
               ("mesh.call", 3.0, 4.5),       # idle 3-4.5
               ("mesh.launch", 9.0, 9.5)]     # no call around it
    tr = Trace(window=(0.0, 10.0), calls=2, device_ops=ops,
               spans=[("dispatch", 0.0, 9.5)], program_spans=program)
    run = harness.Run(conf, 84, 8, True, trace=tr)
    assert runner(run) == pytest.approx(100.0 * (0.5 + 1.5) / 10.0)
    assert device(run) == pytest.approx(70.0)
    bare = Trace(window=(0.0, 10.0), calls=2, device_ops=ops, spans=[],
                 program_spans=program[1:2] + program[3:])
    assert runner(harness.Run(conf, 84, 8, True, trace=bare)) is None
    assert runner(harness.Run(conf, 84, 8, True)) is None