"""The persistent lattice kernel's plan (``kernels/lattice_cuda.py``
``plan_schedule``), on the CPU.

The kernel itself runs only on the card (``test_torch_kernel_on_card.py``);
what it is told to do -- which block owns which particles, which barrier
separates the passes, how large the grid is -- is plain Python, held here:
every particle lies in exactly one tile, a block-barrier plan never splits
a body, no pass reads outside a particle's body (the family offsets and
the Kuhn tet corners, as ``csrc/lattice_xpbd.cuh``'s FastNbr reads them),
so a block of whole bodies reads only its own tile, a grid larger than the
card holds at once raises, and the constants and the ctypes
``LatticeParams`` mirror the CUDA sources.
"""

import ctypes
import re

import numpy as np
import pytest

from softbodysimulation_tpu_torch.kernels import _build
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

# an H100's 132 SMs at two blocks of the kernel each, and smaller cards
CARDS = [(132, 2), (132, 1), (16, 3)]
# (res, bodies, braced): the main path's shapes (bench res 40, entry res
# 16, example 5's 1,024 res-4 bodies), the largest body a block holds, and
# odd sizes
SHAPES = [(40, 1, True), (16, 1, True), (4, 1024, True), (8, 64, True),
          (6, 3, True), (9, 5, False), (10, 1, True), (128, 1, True)]


def _plans(res, bodies, braced):
    spec = ptop.lattice_spec(res, braced=braced)
    for sms, per_sm in CARDS:
        for barrier in (None, "block", *lc.BARRIERS):
            if barrier == "block" and res > 16:
                continue   # a whole res-40 body in one block: valid, slow
            yield spec, lc.plan_schedule(spec, bodies, sms, per_sm,
                                         barrier=barrier)


@pytest.mark.parametrize("res,bodies,braced", SHAPES)
def test_every_particle_in_exactly_one_tile(res, bodies, braced):
    for spec, s in _plans(res, bodies, braced):
        n = spec.n_particles * bodies
        assert s.n == n and s.barrier in lc.BARRIERS
        tiles = s.tiles()
        assert len(tiles) == s.grid
        covered = np.zeros(n, np.int32)
        for lo, hi in tiles:
            assert 0 <= lo <= hi <= n
            covered[lo:hi] += 1
        assert (covered == 1).all(), (res, bodies, s)
        # the kernel's own rule: block j owns [j * chunk, + chunk)
        assert s.grid * s.chunk >= n and (s.grid - 1) * s.chunk < n


@pytest.mark.parametrize("res,bodies,braced", SHAPES)
def test_block_plan_never_splits_a_body(res, bodies, braced):
    for spec, s in _plans(res, bodies, braced):
        if s.kind != "block":
            continue
        body_n = spec.n_particles
        assert s.chunk % body_n == 0
        for lo, hi in s.tiles():
            assert lo % body_n == 0 and (hi % body_n == 0 or hi == s.n)


def test_the_shape_chooses_the_barrier():
    """Bodies up to BLOCK_BODY_MAX particles step in blocks of whole
    bodies; larger ones across the grid with GRID_BARRIER.  The main path:
    bench res 40 and entry res 16 across the grid, example 5 in blocks."""
    for res in range(2, 20):
        spec = ptop.lattice_spec(res, braced=True)
        want = ("block" if res ** 3 <= lc.BLOCK_BODY_MAX
                else lc.GRID_BARRIER)
        assert lc.choose_barrier(spec) == want
    assert lc.plan_schedule(ptop.lattice_spec(40, braced=True), 1, 132,
                            2).kind == "grid"
    assert lc.plan_schedule(ptop.lattice_spec(16, braced=True), 1, 132,
                            2).kind == "grid"
    ex5 = lc.plan_schedule(ptop.lattice_spec(4, braced=True), 1024, 132, 2)
    assert ex5.kind == "block" and ex5.grid >= 132
    # a grid plan gives each thread at most one particle where it can
    bench = lc.plan_schedule(ptop.lattice_spec(40, braced=True), 1, 132, 2)
    assert bench.chunk <= lc.THREADS and bench.grid <= 264


def _reads(spec, a):
    """Every particle whose positions, multipliers or tet terms a pass of
    the persistent kernel reads for particle a (FastNbr): the family
    partners a+d of valid anchors and the anchors a-d of kept backward
    constraints, the Kuhn corners of the cell at a (clamped into the body
    for an invalid cell) and the cells at -o_k inside the body whose terms
    the apply sums.  Returns body-local indices.  (The inverse masses are
    constant through a call: WARM_START reads an invalid anchor's wrapped
    partner's, which need no barrier.)"""
    res = spec.res
    l = a % spec.n_particles
    x, y, z = l // (res * res), (l // res) % res, l % res
    masks = plat._family_masks(spec)

    def idx(cx, cy, cz):
        return (cx * res + cy) * res + cz

    def inside(cx, cy, cz):
        return 0 <= cx < res and 0 <= cy < res and 0 <= cz < res

    out = []
    for fi, (dx, dy, dz, _) in enumerate(spec.families):
        valid = masks[fi][0].reshape(res, res, res)
        if valid[x, y, z]:
            out.append(idx(x + dx, y + dy, z + dz))
        bx, by, bz = x - dx, y - dy, z - dz
        if inside(bx, by, bz) and valid[bx, by, bz]:
            out.append(idx(bx, by, bz))
    for path in plat._tet_fields(spec)[0]:
        for ox, oy, oz in path[1:]:
            out.append(idx(min(max(x + ox, 0), res - 1),
                           min(max(y + oy, 0), res - 1),
                           min(max(z + oz, 0), res - 1)))
            if inside(x - ox, y - oy, z - oz):
                out.append(idx(x - ox, y - oy, z - oz))
    return out


@pytest.mark.parametrize("res,bodies,braced",
                         [(6, 3, True), (4, 5, True), (9, 2, False),
                          (12, 1, True)])
def test_no_read_leaves_its_body(res, bodies, braced):
    """Every particle whose state a cell's passes read lies in the cell's
    body, so a block-barrier tile (whole bodies) reads only itself and
    needs no other block between passes."""
    spec = ptop.lattice_spec(res, braced=braced)
    body_n = spec.n_particles
    reads = [np.asarray(_reads(spec, l)) for l in range(body_n)]
    for sms, per_sm in ((4, 1), (2, 1), (132, 2)):
        for barrier in lc.BARRIERS:
            s = lc.plan_schedule(spec, bodies, sms, per_sm, barrier=barrier)
            for lo, hi in s.tiles():
                for a in range(lo, hi):
                    base = a // body_n * body_n
                    got = base + reads[a - base]
                    assert ((got >= base) & (got < base + body_n)).all()
                    if s.kind == "block":
                        assert ((got >= lo) & (got < hi)).all(), (a, s)


def test_example5_tile_fills_33792_bytes_of_shared_memory():
    """Example 5's tiles (four res-4 bodies, 256 particles, 13 families)
    hold w, two iterate and two multiplier buffers in shared memory:
    4 x 256 x (6 + 1 + 2 x 13) bytes."""
    spec = ptop.lattice_spec(4, braced=True)
    ex5 = lc.plan_schedule(spec, 1024, 132, 2)
    assert (ex5.kind, ex5.chunk, spec.n_families) == ("block", 256, 13)
    assert lc.tile_bytes(ex5, spec.n_families) == 33792


@pytest.mark.parametrize("res,bodies,braced", SHAPES)
def test_default_block_tiles_fit_without_raising_the_limit(res, bodies,
                                                           braced):
    """Every block plan the planner chooses holds its tile within the 48 KB
    a block gets without raising its shared-memory limit (a body of at
    most BLOCK_BODY_MAX particles, at most a block's threads of them); the
    grid kind holds none."""
    spec = ptop.lattice_spec(res, braced=braced)
    for sms, per_sm in CARDS:
        s = lc.plan_schedule(spec, bodies, sms, per_sm)
        need = lc.tile_bytes(s, spec.n_families)
        if s.kind == "block":
            assert 0 < need <= 48 * 1024, (res, bodies, s)
        else:
            assert need == 0


def test_grid_beyond_coresidency_raises():
    spec = ptop.lattice_spec(40, braced=True)
    ok = lc.plan_schedule(spec, 1, 132, 2, barrier="counter", grid=264)
    assert ok.grid <= 264 and ok.chunk % 32 == 0
    with pytest.raises(ValueError, match="co-resident"):
        lc.plan_schedule(spec, 1, 132, 2, barrier="counter", grid=265)
    with pytest.raises(ValueError, match="co-resident"):
        lc.plan_schedule(spec, 1, 132, 0, barrier="counter")
    # a block barrier needs no co-residency: any grid of whole bodies
    small = ptop.lattice_spec(4, braced=True)
    s = lc.plan_schedule(small, 1024, 132, 0, barrier="block", grid=1024)
    assert s.grid == 1024 and s.chunk == small.n_particles
    with pytest.raises(ValueError, match="no barrier"):
        lc.plan_schedule(spec, 1, 132, 2, barrier="spin")


def _walk(res, bodies, start, stride):
    """The kernel's Walker in Python: the first particle's coordinates by
    division, each next one's by carried additions."""
    body_n, r2 = res ** 3, res * res
    sb, l = divmod(stride, body_n)
    sx, l = divmod(l, r2)
    sy, sz = divmod(l, res)
    b, l = divmod(start, body_n)
    x, l = divmod(l, r2)
    y, z = divmod(l, res)
    a = start
    while a < bodies * body_n:
        yield a, b, x, y, z
        a += stride
        z, y, x, bb = z + sz, y + sy, x + sx, sb
        if z >= res:
            z, y = z - res, y + 1
        if y >= res:
            y, x = y - res, x + 1
        if x >= res:
            x, bb = x - res, bb + 1
        b += bb


@pytest.mark.parametrize("res,bodies", [(4, 9), (6, 2), (7, 3), (40, 1)])
def test_carried_coordinates_equal_division(res, bodies):
    """Stepping a thread's particles by the block size with carries gives
    each particle's coordinates as division does."""
    body_n = res ** 3
    for start in (0, 1, 37, 255):
        for a, b, x, y, z in _walk(res, bodies, start, lc.THREADS):
            assert (b, x, y, z) == (a // body_n, a % body_n // (res * res),
                                    a % (res * res) // res, a % res)


def test_constants_mirror_the_cuda_source():
    src = (_build.CSRC_DIR / "lattice_xpbd.cu").read_text()
    defines = dict(re.findall(r"#define (LX_\w+) (\d+)", src))
    assert int(defines["LX_THREADS"]) == lc.THREADS
    assert {k: int(defines[d]) for k, d in (("block", "LX_BLOCK"),
                                             ("counter", "LX_GRID_CTR"))
            } == lc.BARRIERS
    assert "grid.sync" not in re.sub(r"//[^\n]*", "", src)
    head = (_build.CSRC_DIR / "lattice_xpbd.cuh").read_text()
    assert f"#define TET_PLANES {lc.TET_PLANES}" in head
    assert lc.GRID_BARRIER in lc.BARRIERS and lc.GRID_BARRIER != "block"


def test_params_mirror_matches_the_struct():
    """``LatticeParams`` in ctypes: the C struct's fields, in order, each
    of its type and element count, and no padding."""
    src = (_build.CSRC_DIR / "lattice_xpbd.cuh").read_text()
    body = re.search(r"struct LatticeParams \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    consts = dict((k, int(v)) for k, v in
                  re.findall(r"#define (LX_MAX_\w+) (\d+)", src))
    c_fields = []
    for decl in body.split(";"):
        m = re.match(r"\s*(int|float)\s+(\w+)((?:\[\w+\])*)\s*$", decl)
        if m:
            dims = [consts.get(d) or int(d) for d in
                    re.findall(r"\[(\w+)\]", m.group(3))]
            c_fields.append((m.group(2), m.group(1), int(np.prod(dims))))
    py = []
    for name, ct in lc.LatticeParams._fields_:
        count, base = 1, ct
        while hasattr(base, "_length_"):
            count, base = count * base._length_, base._type_
        kind = "int" if base is ctypes.c_int else "float"
        py.append((name, kind, count))
    assert c_fields == py
    assert ctypes.sizeof(lc.LatticeParams) == 4 * sum(c for *_, c in py)
