"""The per-cell tet family of the port's stencil lattice engine (6 Kuhn tets
per cell, ``solvers/lattice._tet_sweep``) against the JAX package's, on the
CPU: the static fields, one sweep, ``make_step`` in every lambda mode, the
JAX volume test's checks, and the ``solid_lattice`` scene.  The CUDA
kernel's tet sweep is held against this plain version on the card
(``test_torch_kernel_on_card.py``, ``chip_smoke.py`` phase 22)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import scenes as jscenes
from softbodysimulation_tpu.ops import tet_volume as jtv
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import lattice as jtop
from softbodysimulation_tpu.topology import tets as jtets

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core import scenes as pscenes
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

from test_torch_state import jax_lattice_state, port_config, to_port

torch.set_num_threads(1)

DT = 1 / 60
# tets sum 4 endpoint terms per path in another order than JAX's XLA
# reductions, and their multipliers are ~1e-3 of the distance ones
DX_TOL = 2e-5
DLAM_TET_TOL = 1e-5


def _tet_cfg(mode, **kw):
    base = dict(substeps=2, iterations=3, damping=0.02,
                solve_mode=jconfig.SolveMode.JACOBI, lambda_mode=mode,
                lambda_decay=0.97, enable_tet_volume=True,
                ground_height=0.0, friction=0.3)
    base.update(kw)
    return jconfig.SolverConfig(**base)


def test_tet_fields_match_jax():
    """The Kuhn paths, the valid-cell mask, the per-particle tet degree and
    the rest volume equal the JAX engine's."""
    for res in (3, 5):
        jf = jlat._tet_fields(jtop.lattice_spec(res, braced=True))
        pf = plat._tet_fields(ptop.lattice_spec(res, braced=True))
        assert pf[0] == jf[0]
        np.testing.assert_array_equal(pf[1], np.asarray(jf[1]))
        np.testing.assert_array_equal(pf[2], np.asarray(jf[2]))
        assert pf[3] == jf[3]


def test_tet_sweep_matches_jax():
    """One sweep at res 5 from a jittered pred with carried multipliers."""
    res = 5
    jspec = jtop.lattice_spec(res, braced=True)
    pspec = ptop.lattice_spec(res, braced=True)
    rng = np.random.default_rng(11)
    r2 = res * res
    pos = jtop.lattice_points(res, jspec.size, (0.0, 0.5, 0.0))
    pred = (pos.T.reshape(3, res, r2)
            + rng.normal(0, 0.02, (3, res, r2))).astype(np.float32)
    w = rng.uniform(50.0, 150.0, (res, r2)).astype(np.float32)
    w[0, :3] = 0.0
    lam = rng.normal(0, 1e-4, (6, res, r2)).astype(np.float32)
    jcfg = _tet_cfg(jconfig.LambdaMode.DECAY, omega=1.3,
                    tet_compliance=1e-7, tet_pressure=1.02)
    dt = DT / jcfg.substeps
    paths, valid, tdeg, rest6 = jlat._tet_fields(jspec)
    jp, jl = jlat._tet_sweep(
        jnp.asarray(pred), jnp.asarray(w), jnp.asarray(lam), jspec, jcfg, dt,
        (paths, jnp.asarray(valid), jnp.asarray(tdeg), rest6), 1.3)
    pp, pl = plat._tet_sweep(
        torch.as_tensor(pred), torch.as_tensor(w), torch.as_tensor(lam),
        pspec, port_config(jcfg), dt, plat._tet_dev(pspec, "cpu"))
    assert float(np.abs(pp.numpy() - np.asarray(pred)).max()) > 1e-4
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("mode", ["RESET", "DECAY", "WARM_START"])
def test_make_step_with_tets_matches_jax(mode):
    """``make_step`` with the tet family, on a jittered res-5 body resting
    in the floor with pinned particles, over 4 frames: positions, distance
    and tet multipliers (the tet lifecycle: fresh every substep except in
    DECAY)."""
    jcfg = _tet_cfg(getattr(jconfig.LambdaMode, mode))
    spec, js = jax_lattice_state(5, pins=(0, 24), jitter=0.1)
    js = js.replace(lambda_tet=jnp.zeros((6 * 125,), jnp.float32))
    ps = to_port(js)
    jout = jlat.make_step(spec, jcfg, DT, n_steps=4)(js)
    pout = plat.make_step(ptop.lattice_spec(5, braced=True),
                          port_config(jcfg), DT, n_steps=4)(ps)
    dx = float(np.abs(np.asarray(jout.positions)
                      - pout.positions.numpy()).max())
    dlam = float(np.abs(np.asarray(jout.lambda_dist)
                        - pout.lambda_dist.numpy()).max())
    dtet = float(np.abs(np.asarray(jout.lambda_tet)
                        - pout.lambda_tet.numpy()).max())
    assert float(np.abs(pout.lambda_tet.numpy()).max()) > 1e-7
    assert dx < DX_TOL and dlam < 1e-6 and dtet < DLAM_TET_TOL, (
        dx, dlam, dtet)
    assert float(pout.ext_force.abs().max()) == 0.0


def test_tets_change_the_trajectory_and_need_multipliers():
    """Tets on and off give clearly different bodies (the gates above
    cannot hide a dropped sweep); a tet config without ``lambda_tet``
    raises; a state carrying ``lambda_tet`` with tets off keeps the JAX
    lifecycle (zeroed outside DECAY)."""
    cfg = port_config(_tet_cfg(jconfig.LambdaMode.RESET))
    spec = ptop.lattice_spec(4, braced=True)
    st = plat.make_lattice_state(spec, center=(0, 0.6, 0), mass=0.01,
                                 device="cpu", tet_volume=True)
    on = plat.make_step(spec, cfg, DT, n_steps=6)(st)
    off = plat.make_step(spec, cfg.replace(enable_tet_volume=False), DT,
                         n_steps=6)(st.replace(
                             lambda_tet=torch.ones_like(st.lambda_tet)))
    assert float((on.positions - off.positions).abs().max()) > 1e-4
    assert float(off.lambda_tet.abs().max()) == 0.0
    with pytest.raises(ValueError, match="tet_volume=True"):
        plat.make_step(spec, cfg, DT)(st.replace(lambda_tet=None))
    assert plat.make_lattice_state(spec, device="cpu").lambda_tet is None
    assert st.lambda_tet.shape == (6 * 64,)


def test_solid_lattice_drop_conserves_volume():
    """The checks of the JAX suite's stencil solid drop
    (``tests/test_tets.py:596-619``) on the port: volume within 1 %, on
    the floor, resting, not pancaked."""
    res = 5
    spec = ptop.lattice_spec(res, braced=True)
    st = plat.make_lattice_state(spec, center=(0, 1.0, 0), tet_volume=True,
                                 device="cpu")
    cfg = port.SolverConfig(substeps=4, iterations=6, damping=0.02,
                            solve_mode=port.SolveMode.JACOBI,
                            enable_tet_volume=True, ground_height=0.0,
                            friction=0.3)
    out = plat.make_step(spec, cfg, 1 / 60., n_steps=60)(st)
    assert port.is_finite(out)
    assert out.lambda_tet.shape == (6 * res ** 3,)
    tt = jtets.cube_lattice_tets(res)
    p0 = jtop.lattice_points(res, center=(0, 1.0, 0))
    v0 = jtets.tet_volumes6(p0, tt).sum()
    v = float(np.asarray(jtv.tet_volumes6(
        jnp.asarray(out.positions.numpy()), jnp.asarray(tt))).sum())
    y = out.positions[:, 1].numpy()
    assert abs(v / v0 - 1.0) < 0.01
    assert -0.01 < y.min() < 0.05
    assert y.max() - y.min() > 0.9


def test_solid_lattice_scene_matches_jax_and_runs_healthy():
    """The port's ``solid_lattice`` is the JAX scene (config, state,
    ``make_cuda_step``) on the device it is given; at res 5 a few frames
    of it track the JAX scene and stay healthy."""
    jst, jstep, jinfo = jscenes.solid_lattice(res=5)
    pst, pstep, pinfo = pscenes.solid_lattice(res=5, device="cpu")
    assert pinfo["config"] == port_config(jinfo["config"])
    assert pinfo["dt"] == jinfo["dt"] and pinfo["spec"].res == 5
    assert pst.device.type == "cpu" and pst.lambda_tet.shape == (6 * 125,)
    np.testing.assert_array_equal(pst.positions.numpy(),
                                  np.asarray(jst.positions))
    np.testing.assert_array_equal(pst.inv_mass.numpy(),
                                  np.asarray(jst.inv_mass))
    before = lc.launches
    for _ in range(20):
        jst, pst = jstep(jst), pstep(pst)
    assert lc.launches == before     # a CPU state runs the plain engine
    assert port.is_finite(pst)
    y = pst.positions[:, 1]
    assert float(y.min()) > -1e-2 and float(y.max() - y.min()) > 0.5
    assert float(np.abs(np.asarray(jst.positions)
                        - pst.positions.numpy()).max()) < DX_TOL
