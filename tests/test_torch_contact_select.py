"""The culled design of TPU kernel B-4 (``csrc/contact_xpbd.cu``), on the
CPU: plain mirrors of the two things it decides that the serial design did
not, held against the plain pass they must reproduce.

* The selection in ``cx_select_pair_kernel``'s prologue: compact the
  touching blocks in index order, rank only those by (key, index), fill
  the rest in index order.  It must equal ``select_candidates`` (the
  stable descending sort, ``lax.top_k``'s tie order) row for row: ties of
  equal keys, rows with fewer than M touching blocks, M = 1 and M = nb.
* The warp cull (``kernels.contact_cuda.warp_cull_plain``, the float32
  mirror of ``cx_cull_bound`` and the sub-block AABBs): it must never skip
  a pair that ``_blocked_pairs`` marks touching, at pairs placed at the
  contact diameter within a few ulp and at coordinates from 1e-2 to 1e2;
  without its margin it would.
* The constants and the ctypes mirrors match the CUDA source.

The kernel itself runs only on the card (``test_torch_kernel_on_card.py``).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from softbodysimulation_tpu_torch.core.config import SolverConfig
from softbodysimulation_tpu_torch.kernels import _build
from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
from softbodysimulation_tpu_torch.ops import spatial_hash as psh

import test_torch_contact_cases as cases

torch.set_num_threads(1)


def select_mirror(touch, d2ab, m_nbr):
    """``cx_select_pair_kernel``'s selection, plainly: per row the touching
    blocks in index order, each ranked by the touching keys below it and
    the equal keys before it; then the first non-touching blocks in index
    order.  Returns (nbr (nb, M), ok (nb, M)) as numpy arrays."""
    touch, d2ab = touch.numpy(), d2ab.numpy()
    nb = touch.shape[0]
    nbr = np.full((nb, m_nbr), -1, np.int64)
    ok = np.zeros((nb, m_nbr), bool)
    for i in range(nb):
        clist = np.flatnonzero(touch[i])
        ckey = d2ab[i, clist]
        fill = np.flatnonzero(~touch[i])
        k = min(len(clist), m_nbr)
        for a in range(len(clist)):
            rank = int(np.sum((ckey < ckey[a]) | ((ckey == ckey[a])
                                                  & (np.arange(len(clist))
                                                     < a))))
            if rank < m_nbr:
                nbr[i, rank], ok[i, rank] = clist[a], True
        nbr[i, k:] = fill[:m_nbr - k]
    return nbr, ok


def _grid():
    """800 particles on the points of a 0.1-spaced 6^3 grid: blocks of 16
    whose AABBs touch at equal gaps, so keys tie."""
    pts = np.random.default_rng(11).integers(0, 6, (800, 3)) * 0.1
    return pts.astype(np.float32), np.ones(800, np.float32)


def _clusters():
    """12 tight clusters of 40 particles far apart: most rows touch only
    their own blocks, fewer than M."""
    rng = np.random.default_rng(12)
    c = rng.uniform(-5.0, 5.0, (12, 1, 3))
    x = (c + rng.normal(0.0, 0.02, (12, 40, 3))).reshape(-1, 3)
    return x.astype(np.float32), np.ones(480, np.float32)


def _uniform():
    return cases.cloud("cloud777")


SELECT_CLOUDS = {"grid": _grid, "clusters": _clusters, "uniform": _uniform}


def _select_inputs(cloud, block):
    x, w = SELECT_CLOUDS[cloud]()
    cfg = SolverConfig(enable_self_collision=True,
                       self_collision_backend="blocked",
                       particle_radius=0.05, collision_block_size=block)
    pred, inv = torch.as_tensor(x), torch.as_tensor(w)
    order = psh.morton_order(pred, cfg)
    *_, touch, d2ab, _, _, nb = psh._blocked_layout(pred, inv, order, cfg)
    return touch, d2ab, nb


@pytest.mark.parametrize("m_nbr", ["1", "4", "nb"])
@pytest.mark.parametrize("cloud", list(SELECT_CLOUDS))
def test_select_mirror_equals_select_candidates(cloud, m_nbr):
    touch, d2ab, nb = _select_inputs(cloud, 16)
    m = nb if m_nbr == "nb" else int(m_nbr)
    nbr, ok = psh.select_candidates(touch, d2ab, m)
    mnbr, mok = select_mirror(touch, d2ab, m)
    np.testing.assert_array_equal(mnbr, nbr.numpy())
    np.testing.assert_array_equal(mok, ok.numpy())
    # the touching candidates are a prefix of every row
    assert np.all(mok[:, 1:] <= mok[:, :-1])


def test_select_clouds_cover_ties_and_short_rows():
    """The grid has rows whose touching keys tie; the clusters have rows
    with fewer touching blocks than M = 4 (and the grid rows with more)."""
    touch, d2ab, _ = _select_inputs("grid", 16)
    ties = [len(k) - len(np.unique(k)) for k in
            (d2ab[i][touch[i]].numpy() for i in range(touch.shape[0]))]
    assert max(ties) > 0
    assert int(touch.sum(dim=1).max()) > 4
    touch, _, _ = _select_inputs("clusters", 16)
    assert int(touch.sum(dim=1).min()) < 4


def _pairs_at_diameter(spread, diam, n_pairs=60, seed=0):
    """Clusters of 32 coincident particles (one sub-block each along the
    curve) in pairs whose centres lie ``diam * (1 + k 2^-23)``, k in -4..4,
    apart, at centres uniform in [-spread, spread]^3: the sub-blocks'
    AABBs are points, as tight as a warp's can be."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n_pairs, 3))
    u = rng.normal(size=(n_pairs, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sep = diam * (1.0 + rng.integers(-4, 5, n_pairs) * 2.0 ** -23)
    a, b = c - 0.5 * sep[:, None] * u, c + 0.5 * sep[:, None] * u
    x = np.repeat(np.stack([a, b], 1), 32, axis=1)             # (P, 2, 32, 3)
    return x.reshape(-1, 3).astype(np.float32)


def _cull_case(x, diam):
    n = x.shape[0]
    cfg = SolverConfig(enable_self_collision=True,
                       self_collision_backend="blocked",
                       particle_radius=0.5 * diam, collision_block_size=128,
                       block_neighbors=-(-n // 128))
    pred = torch.as_tensor(x)
    inv = torch.ones(n)
    order = psh.morton_order(pred, cfg)
    touch = psh.blocked_touching_pairs(pred, inv, order, cfg)
    return pred, inv, order, cfg, touch


# (spread of the centres, contact diameter)
CULL_CASES = {"1e-2": (1e-2, 5e-4), "1": (1.0, 0.05), "1e2": (1e2, 0.05),
              "1e2_wide": (1e2, 2.0)}


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_warp_cull_never_skips_a_touching_pair(case):
    spread, diam = CULL_CASES[case]
    pred, inv, order, cfg, touch = _cull_case(
        _pairs_at_diameter(spread, diam), diam)
    skip, tests, candidates = cc.warp_cull_plain(pred, inv, order, cfg)
    assert int(touch.sum()) > 0
    assert not bool((skip & touch).any())
    # and it culls: most candidate sub-blocks lie far apart
    assert tests < candidates


@pytest.mark.parametrize("name", list(cases.CLOUDS))
def test_warp_cull_keeps_every_touching_pair_of_the_clouds(name):
    x, w = cases.cloud(name)
    cfg = cases.cloud_config(name, "blocked")
    pred, inv = torch.as_tensor(x), torch.as_tensor(w)
    order = psh.morton_order(pred, cfg)
    skip, tests, candidates = cc.warp_cull_plain(pred, inv, order, cfg)
    touch = psh.blocked_touching_pairs(pred, inv, order, cfg)
    assert int(touch.sum()) > 0 and not bool((skip & touch).any())
    assert 0 < tests <= candidates


def test_warp_cull_needs_its_margin(monkeypatch):
    """At coordinates of 1e2 the Gram d2 errs by far more than the pairs'
    distance from the diameter: without the margin (the bound = t_touch)
    the cull skips pairs the pass classifies as touching."""
    spread, diam = CULL_CASES["1e2"]
    pred, inv, order, cfg, touch = _cull_case(
        _pairs_at_diameter(spread, diam), diam)
    monkeypatch.setattr(cc, "GRAM_ERR", 0.0)
    monkeypatch.setattr(cc, "CULL_SLACK", 1.0)
    skip = cc.warp_cull_plain(pred, inv, order, cfg)[0]
    assert bool((skip & touch).any())


def test_touch_bound_is_the_rounded_up_square():
    for d in (0.1, 0.05, 0.0141, 1e-3, 2.0, 3.0):
        t = cc.touch_bound(d)
        df = float(np.float32(d))
        assert float(t) >= df * df
        assert float(np.nextafter(t, np.float32(0))) < df * df


def test_constants_mirror_the_cuda_source():
    src = (_build.CSRC_DIR / "contact_xpbd.cu").read_text()
    floats = dict(re.findall(r"#define (CX_\w+) ([0-9.e+-]+)f", src))
    assert float(floats["CX_SMAX_SLACK"]) == cc.SMAX_SLACK
    assert float(floats["CX_GRAM_ERR"]) == cc.GRAM_ERR
    assert float(floats["CX_CULL_SLACK"]) == cc.CULL_SLACK
    assert "__fmul_ru(p.diam, p.diam)" in src
    head = (_build.CSRC_DIR / "contact_xpbd.cuh").read_text()
    assert re.search(r"int design;\s*// 0 culled .*, 1 serial", head)
    assert cc.DESIGNS == {"culled": 0, "serial": 1}


def _struct_fields(name):
    head = (_build.CSRC_DIR / "contact_xpbd.cuh").read_text()
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", head, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"(\w+)\s*;", body)


@pytest.mark.parametrize("struct", [cc.ContactParams, cc.ContactBuffers])
def test_ctypes_mirrors_the_structs(struct):
    assert [f for f, _ in struct._fields_] == _struct_fields(struct.__name__)
    size = sum(ctypes.sizeof(t) for _, t in struct._fields_)
    assert ctypes.sizeof(struct) == size
