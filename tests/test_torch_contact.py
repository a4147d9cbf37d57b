"""The port's self-collision against the JAX package's, on the CPU: the
Hilbert curve order, one pass of each of the four backends, the blocked
backend's exactness diagnostics, and the B-4 wrapper
(``kernels/contact_cuda.py``) on a CPU tensor against the JAX B-4 kernel in
interpret mode, on the seeded clouds of ``test_torch_contact_cases.py``.
Gate of one pass: max |dx| < 1e-5 (``tests/test_contact_pallas.py:45,60``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.kernels import contact_pallas
from softbodysimulation_tpu.ops import spatial_hash as jsh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.diag import diagnostics as pdiag
from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
from softbodysimulation_tpu_torch.ops import spatial_hash as psh

import test_torch_contact_cases as cases
from test_torch_state import port_config

torch.set_num_threads(1)

# the JAX package's diag/__init__ re-exports the function under the module's
# name
jdiag = importlib.import_module("softbodysimulation_tpu.diag.diagnostics")


def _ties():
    """600 particles on the 64 points of a 0.2-spaced grid: many per cell,
    so the order of equal codes decides the permutation."""
    pts = np.random.default_rng(5).integers(0, 4, (600, 3)) * 0.2
    return pts.astype(np.float32)


def _sheet():
    """A flat 40 x 40 sheet: the extent, not the diameter, sets the cell."""
    u = np.linspace(-1.75, 1.75, 40, dtype=np.float32)
    gx, gz = np.meshgrid(u, u, indexing="ij")
    return np.stack([gx.ravel(), np.ones(1600, np.float32), gz.ravel()], 1)


@pytest.mark.parametrize("cloud", ["cloud1000", "cloud777", "ties", "sheet"])
def test_morton_order_matches_jax(cloud):
    x = {"ties": _ties, "sheet": _sheet}.get(
        cloud, lambda: cases.cloud(cloud)[0])()
    cfg = cases.cloud_config("cloud1000", "blocked", jconfig)
    j = np.asarray(jsh.morton_order(jnp.asarray(x), cfg))
    p = psh.morton_order(torch.as_tensor(x), port_config(cfg)).numpy()
    np.testing.assert_array_equal(p, j)


def _both(name, backend, **kw):
    x, w = cases.cloud(name)
    jcfg = cases.cloud_config(name, backend, jconfig, **kw)
    order = np.asarray(jsh.morton_order(jnp.asarray(x), jcfg))
    return x, w, order, jcfg, port_config(jcfg)


@pytest.mark.parametrize("backend", cases.BACKENDS)
@pytest.mark.parametrize("name", list(cases.CLOUDS))
def test_backend_pass_matches_jax(name, backend):
    """One separation pass of each backend; the pass did real work and
    pinned particles do not move."""
    x, w, order, jcfg, pcfg = _both(name, backend)
    j = np.asarray(jsh.project_self_collision(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(order), jcfg))
    p = psh.project_self_collision(torch.as_tensor(x), torch.as_tensor(w),
                                   torch.tensor(order), pcfg).numpy()
    assert np.abs(p - j).max() < cases.DX_PASS, np.abs(p - j).max()
    assert np.abs(p - x).max() > 1e-4
    pins = w == 0
    np.testing.assert_array_equal(p[pins], x[pins])


@pytest.mark.parametrize("name,neighbors", [("cloud1000", None),
                                            ("cloud777", None),
                                            ("cloud1000", 1)])
def test_blocked_diagnostics_match_jax(name, neighbors):
    """``blocked_overflow`` and ``blocked_dropped_pairs`` equal JAX's,
    through the ops and through ``diag.diagnostics``; with one candidate
    block per block the selection overflows, so its tie order decides
    which pairs drop."""
    kw = {} if neighbors is None else dict(block_neighbors=neighbors)
    x, w, order, jcfg, pcfg = _both(name, "blocked", **kw)
    args_j = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(order), jcfg)
    args_p = (torch.as_tensor(x), torch.as_tensor(w), torch.tensor(order),
              pcfg)
    jo = int(jsh.self_collision_blocked_overflow(*args_j))
    jd = int(jsh.self_collision_blocked_dropped_pairs(*args_j))
    assert int(psh.self_collision_blocked_overflow(*args_p)) == jo
    assert int(psh.self_collision_blocked_dropped_pairs(*args_p)) == jd
    assert jo > 0 and jd > 0
    if neighbors == 1:
        assert jd > 1000
    fields = dict(positions=x, velocities=np.zeros_like(x), inv_mass=w,
                  ext_force=np.zeros_like(x), lambda_dist=np.zeros(1),
                  lambda_bend=np.zeros(0), lambda_volume=np.zeros(()))
    js = jstate_mod.SimState(**{k: jnp.asarray(v, jnp.float32)
                                for k, v in fields.items()})
    ps = port.state_from_numpy(fields, device="cpu")
    assert pdiag.blocked_overflow(ps, pcfg) == jdiag.blocked_overflow(js,
                                                                      jcfg)
    assert pdiag.blocked_dropped_pairs(ps, pcfg) == \
        jdiag.blocked_dropped_pairs(js, jcfg)


def test_touching_pairs_cover_every_contact():
    """With enough candidate blocks to drop nothing, the plain pass's
    touching-pair mask holds exactly the directed pairs within the contact
    diameter (the layout ``touching_pairs_cuda`` reports on the card)."""
    x, w, order, _, pcfg = _both("cloud1000", "blocked", block_neighbors=8)
    args = (torch.as_tensor(x), torch.as_tensor(w), torch.tensor(order),
            pcfg)
    assert int(psh.self_collision_blocked_dropped_pairs(*args)) == 0
    mask = psh.blocked_touching_pairs(*args)
    block, nb, npad, m_nbr = cc.layout(1000, pcfg)
    assert tuple(mask.shape) == (npad, m_nbr * block)
    d = np.linalg.norm(x[:, None, :].astype(np.float64) - x[None], axis=-1)
    brute = (d < 2 * pcfg.particle_radius) & ~np.eye(1000, dtype=bool)
    assert int(mask.sum()) == int(brute.sum())


@pytest.mark.parametrize("name", list(cases.CLOUDS))
def test_b4_wrapper_on_cpu_matches_pallas_interpret(name):
    """``self_collision_project_blocked_cuda`` on a CPU tensor (its plain
    version) against the JAX B-4 kernel, run in interpret mode as
    ``tests/test_contact_pallas.py`` runs it; the plain version launches
    nothing."""
    x, w, order, jcfg, pcfg = _both(name, "blocked_pallas")
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(contact_pallas.self_collision_project_blocked_pallas(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(order), jcfg))
    before = cc.launches
    p = cc.self_collision_project_blocked_cuda(
        torch.as_tensor(x), torch.as_tensor(w), torch.tensor(order), pcfg)
    assert cc.launches == before
    assert np.abs(p.numpy() - j).max() < cases.DX_PASS
    assert np.abs(p.numpy() - x).max() > 1e-4


def test_b4_wrapper_refuses_what_it_does_not_take():
    x, w, order, _, pcfg = _both("cloud777", "blocked_pallas")
    t = [torch.tensor(a) for a in (x, w, order)]
    with pytest.raises(NotImplementedError):
        cc.self_collision_project_blocked_cuda(*[a.to("meta") for a in t],
                                               pcfg)
    with pytest.raises(NotImplementedError):
        cc.check_layout(5000, pcfg.replace(collision_block_size=2048))
    with pytest.raises(NotImplementedError):
        cc.check_layout(10 ** 7, pcfg.replace(collision_block_size=8))
    assert cc.layout(777, pcfg) == (128, 7, 896, 3)


def test_diagnostics_match_jax():
    """The diagnostics reductions on a moving, partly pinned body."""
    cfg, kind, kw, _ = cases.tet_cases(jconfig)["ball_pinned"]
    jtopo, fields = cases.tet_inputs(
        kind, cases.modules("softbodysimulation_tpu"), **kw)
    ptopo, _ = cases.tet_inputs(kind, cases.modules(), **kw)
    fields["lambda_dist"] = np.linspace(-1, 1, int(jtopo.n_edges),
                                        dtype=np.float32)
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    j = jdiag.diagnostics(js, jtopo)
    p = pdiag.diagnostics(port.state_from_numpy(fields, device="cpu"),
                          ptopo)
    assert set(p) == set(j)
    # sums in another order: the centre of mass's zero components differ
    # by rounding
    for k in j:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert pdiag.format_diagnostics(p) == jdiag.format_diagnostics(j)
