"""The persistent mesh kernel's plan and hub tables (``kernels/mesh_cuda.py``
``plan_schedule``, ``hub_rows``), on the CPU.

The kernel itself runs only on the card (``test_torch_kernel_on_card.py``);
what it is told to do -- which block owns which particles, edges, hinges,
tets, triangles, colour slots and dense rows, which barrier separates the
passes, how large the grid is, which rows a warp sums -- is plain Python,
held here at the main paths' shapes (cloth_xl, the 20k ball-on-cloth, the
farm, the inflated ball, the catalogued ball_on_cloth and its farm): every
item lies in exactly one tile, a block-barrier plan never splits a body, a
grid larger than the card holds at once raises, the hub table lists
exactly the rows longer than ``HUB_WIDTH``, and a NumPy mirror of the hub
warp's staged sum equals ``ops/incidence.ordered_sum`` to the bit.  The
constants, the tile kinds and the ctypes mirrors match the CUDA sources.
"""

import ctypes
import functools
import re

import numpy as np
import pytest
import torch

from softbodysimulation_tpu_torch.core import config as C
from softbodysimulation_tpu_torch.core import scenes
from softbodysimulation_tpu_torch.kernels import _build
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.ops import incidence
from softbodysimulation_tpu_torch.topology import build, mesh

import test_torch_contact_cases as contact_cases

# an H100's 132 SMs at one and two blocks of the kernel each, and a
# smaller card
CARDS = [(132, 2), (132, 1), (16, 3)]


def _icosphere(subdiv, radius, **kw):
    return build.topology_from_mesh(mesh.icosphere(subdiv, radius=radius),
                                    **kw)[1]


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(topology, config, bodies) of a main path's shape."""
    if name == "cloth_xl":
        _, _, info = scenes.cloth_xl(device="cpu")
        return info["topology"], info["config"], 1
    if name == "ball_on_cloth_20k":
        topo, _, cfg, _ = contact_cases.scaled_ball_on_cloth(
            contact_cases.modules())
        return topo, cfg, 1
    if name in ("farm", "pressurized_farm"):
        cfg = C.SolverConfig(substeps=4, iterations=4, damping=0.02,
                             solve_mode=C.SolveMode.JACOBI,
                             gravity_is_acceleration=True,
                             enable_volume=name == "pressurized_farm",
                             volume_compliance=0.0, pressure=1.15)
        return _icosphere(4, 0.5, compliance=1e-6), cfg, 32
    if name == "inflated_ball":
        cfg = C.SolverConfig(substeps=4, iterations=4,
                             solve_mode=C.SolveMode.JACOBI,
                             enable_volume=True, pressure=1.15)
        return _icosphere(5, 0.4, compliance=5e-4, bending=False), cfg, 1
    if name in ("catalogued", "contact_farm"):
        _, _, info = scenes.ball_on_cloth(device="cpu")
        return (info["topology"], info["config"],
                8 if name == "contact_farm" else 1)
    # small bodies a block holds whole, one and an ensemble, COLORED
    cfg = C.SolverConfig(substeps=2, iterations=2, enable_bending=True,
                         solve_mode=C.SolveMode.COLORED)
    topo = _icosphere(1, 0.3, bending=True)
    return topo, cfg, 5 if name == "small_ensemble" else 1


SHAPES = ["cloth_xl", "ball_on_cloth_20k", "farm", "pressurized_farm",
          "inflated_ball", "catalogued", "contact_farm", "small_body",
          "small_ensemble"]


def _counts(name):
    topo, cfg, bodies = _scene(name)
    return mc.tile_counts(mc.make_params(topo, cfg, 1 / 240)), bodies


def _plans(name):
    counts, bodies = _counts(name)
    for sms, per_sm in CARDS:
        for barrier in (None, *mc.BARRIERS):
            if barrier == "block" and max(counts) > mc.BLOCK_BODY_MAX:
                continue   # a whole large body in one block: valid, slow
            yield counts, bodies, mc.plan_schedule(counts, bodies, sms,
                                                   per_sm, barrier=barrier)


@pytest.mark.parametrize("name", SHAPES)
def test_every_item_in_exactly_one_tile(name):
    for counts, bodies, s in _plans(name):
        assert s.counts == counts and s.n_bodies == bodies
        for kind, count in enumerate(counts):
            total = count * bodies
            covered = np.zeros(total, np.int32)
            tiles = s.tiles(kind)
            assert len(tiles) == s.grid
            for lo, hi in tiles:
                assert 0 <= lo <= hi <= total
                covered[lo:hi] += 1
            assert (covered == 1).all(), (name, mc.TILE_KINDS[kind], s)
            # the kernel's own rule: block j owns [j * chunk, + chunk)
            if total:
                assert s.grid * s.chunks[kind] >= total


def test_the_main_paths_tile_what_they_run():
    """The counts follow the launch's families: hinges and tets always
    (their multipliers' lifecycle), triangles with the volume, colour slots
    only under COLORED, dense rows only with dense self-collision."""
    k = {name: i for i, name in enumerate(mc.TILE_KINDS)}
    counts, _ = _counts("ball_on_cloth_20k")
    assert counts[:4] == (20243, 60803, 57685, 1280)
    assert counts[k["dense_rows"]] == counts[k["triangles"]] == 0
    counts, _ = _counts("inflated_ball")
    assert counts[k["triangles"]] == 20480 and counts[k["particles"]] == 10242
    counts, _ = _counts("catalogued")
    assert counts[k["dense_rows"]] == counts[k["particles"]] == 619
    counts, _ = _counts("small_body")
    assert counts[k["edge_colour_slots"]] > 0
    assert counts[k["hinge_colour_slots"]] > 0


@pytest.mark.parametrize("name", SHAPES)
def test_block_plan_never_splits_a_body(name):
    for counts, bodies, s in _plans(name):
        if s.kind != "block":
            continue
        for kind, count in enumerate(counts):
            assert s.chunks[kind] % max(count, 1) == 0 or count == 0
            for lo, hi in s.tiles(kind):
                assert lo % max(count, 1) == 0
                assert hi % max(count, 1) == 0 or hi == count * bodies


def test_the_shape_chooses_the_barrier():
    """Bodies of at most BLOCK_BODY_MAX items of every kind step in blocks
    of whole bodies; larger ones across the grid with GRID_BARRIER: every
    main path across the grid."""
    for name in SHAPES:
        counts, _ = _counts(name)
        want = "block" if name.startswith("small") else mc.GRID_BARRIER
        assert mc.choose_barrier(counts) == want, name
        assert mc.plan_schedule(counts, 1, 132, 2).barrier == want


def test_grid_plans_fill_the_card_and_leave_the_hubs_room():
    """At the 20k shape the grid takes one block for every THREADS edges
    and the particles end before the last blocks, whose warps take the hub
    rows first; the dense paths give every row a warp where the card holds
    that many blocks."""
    counts, _ = _counts("ball_on_cloth_20k")
    s = mc.plan_schedule(counts, 1, 132, 2)
    assert s.grid == -(-counts[1] // mc.THREADS)
    last = s.tiles(0)[-1]
    assert last[0] == last[1] == counts[0]
    counts, _ = _counts("catalogued")
    s = mc.plan_schedule(counts, 1, 132, 2)
    assert s.grid == -(-619 // mc.WARPS)
    assert s.chunks[mc.TILE_KINDS.index("dense_rows")] == mc.WARPS


def test_grid_beyond_the_card_raises():
    counts, _ = _counts("cloth_xl")
    with pytest.raises(ValueError, match="co-resident"):
        mc.plan_schedule(counts, 1, 16, 3, barrier="counter", grid=49)
    with pytest.raises(ValueError, match="no barrier"):
        mc.plan_schedule(counts, 1, 16, 3, barrier="grid.sync")
    with pytest.raises(ValueError):
        mc.plan_schedule(counts, 0, 16, 3)


@pytest.mark.parametrize("table,pad", [("incidence", 2), ("tet_incidence", 4),
                                       ("bend_incidence", 4)])
def test_hub_table_lists_exactly_the_long_rows(table, pad):
    """At the 20k ball-on-cloth: the rows longer than HUB_WIDTH (the tet
    fan's centroid: 642 edges, 1,280 tets; no hinge row), as
    ``incidence.Incidence`` splits them for the plain engine."""
    topo, _, _ = _scene("ball_on_cloth_20k")
    width = {"incidence": topo.n_edges, "tet_incidence": topo.n_tets,
             "bend_incidence": topo.n_hinges}[table] * pad
    inc = getattr(topo, table)
    ptr, cols = mc.incidence_csr(inc, width)
    hubs = mc.hub_rows(ptr)
    lengths = np.diff(ptr)
    assert (np.flatnonzero(lengths > incidence.HUB_WIDTH) == hubs).all()
    assert (lengths[hubs] > incidence.HUB_WIDTH).all()
    assert np.array_equal(hubs, incidence.Incidence.of(inc, width)
                          .hub_rows.numpy())
    want = {"incidence": [642], "tet_incidence": [1280],
            "bend_incidence": []}[table]
    assert sorted(lengths[hubs].tolist()) == want


def _warp_row_sum_mirror(contrib, cols, k0, k1):
    """``csrc/mesh_xpbd.cu`` ``warp_row_sum`` in NumPy: rounds of 128
    columns, lane l holding columns 32 g + l; the stage read in position
    order by three lanes, one float32 sum a coordinate from 0."""
    acc = np.zeros(3, np.float32)
    for base in range(k0, k1, 128):
        stage = np.zeros((3, 129), np.float32)
        for g in range(4):
            for lane in range(32):
                k = base + 32 * g + lane
                if k < k1:
                    stage[:, 32 * g + lane] = contrib[cols[k]]
        for j in range(min(128, k1 - base)):
            acc = (acc + stage[:, j]).astype(np.float32)
    return acc


@pytest.mark.parametrize("width", [33, 127, 128, 129, 642, 1280])
def test_hub_warp_mirror_is_the_column_order_sum(width):
    """The hub warp's staged sum equals ``ordered_sum`` (the plain engine's
    hub rows) and the one-thread fold to the bit, with contributions of
    wildly different scales."""
    rng = np.random.default_rng(width)
    n = 3 * width
    contrib = (rng.normal(size=(n, 3)) * np.exp(
        3.0 * rng.normal(size=(n, 1)))).astype(np.float32)
    cols = np.sort(rng.choice(n, size=width, replace=False)).astype(np.int32)
    got = _warp_row_sum_mirror(contrib, cols, 0, width)
    fold = np.zeros(3, np.float32)
    for k in range(width):
        fold = (fold + contrib[cols[k]]).astype(np.float32)
    stack = torch.from_numpy(np.concatenate(
        [np.zeros((1, 1, 3), np.float32), contrib[cols][None]], axis=1))
    ref = incidence.ordered_sum(stack)[0].numpy()
    assert np.array_equal(got.view(np.int32), fold.view(np.int32))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def _struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    return re.findall(r"^\s+(?:const )?\w+\*?\s+\*?(\w+)(?:\[\d+\])?;", body,
                      re.M)


def test_constants_and_mirrors_match_the_sources():
    src = (_build.CSRC_DIR / "mesh_xpbd.cuh").read_text()
    assert mc.hub_width() == incidence.HUB_WIDTH
    assert mc.reduction_threads() == mc.THREADS
    tiles = re.search(r"enum \{\s*(MX_TILE_PART.*?)MX_TILES", src,
                      re.S).group(1)
    assert len(re.findall(r"MX_TILE_\w+", tiles)) == len(mc.TILE_KINDS)
    assert _struct_fields(src, "MeshParams") == [
        f for f, _ in mc.MeshParams._fields_]
    assert _struct_fields(src, "MeshBuffers") == list(mc._BUFFERS)
    assert ctypes.sizeof(mc.MeshBuffers) == 8 * len(mc._BUFFERS)
    barrier = (_build.CSRC_DIR / "grid_barrier.cuh").read_text()
    for name, value in (("BARRIER_BLOCK", mc.BARRIERS["block"]),
                        ("BARRIER_GRID_CTR", mc.BARRIERS["counter"])):
        assert re.search(rf"#define {name} {value}\b", barrier)
