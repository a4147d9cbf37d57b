"""The PyTorch port's plain lattice engine (``solvers/lattice.py``) against
the JAX stencil engine, on the CPU.

Same inputs, made by numpy from a seed, go through both packages'
``make_substep_runner`` / ``make_step``.  Tolerances are those the JAX
suite holds its own engines to (``tests/test_pallas_kernel.py``):
max |dx| < 1e-5 and max |dlambda| < 1e-6; velocities are (pred - x)/dt, so
their tolerance is the position tolerance over dt_sub.
"""

import jax
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import scenes as jscenes
from softbodysimulation_tpu.solvers import lattice as jlat

from softbodysimulation_tpu_torch.core import scenes as pscenes
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_cases as lattice_cases
from test_torch_state import (jax_lattice_state, max_diffs, port_config,
                              to_port)

torch.set_num_threads(1)

DX_TOL = 1e-5
DLAM_TOL = 1e-6

# name -> (JAX config, input kwargs, substeps or "step"): bench.py's and
# __graft_entry__.py's configs, the flagship scene's, and one case per knob
CASES = lattice_cases.parity_cases(jconfig)


def _run_both(cfg, state_kw, substeps, res=6):
    spec, js = jax_lattice_state(res, **state_kw)
    pspec = ptop.lattice_spec(res, braced=state_kw.get("braced", True))
    assert pspec == type(pspec)(**spec.__dict__)
    ps = to_port(js)
    pcfg = port_config(cfg)
    dt_sub, n_sub, with_ext = lattice_cases.run_length(cfg, substeps)
    if with_ext:
        jout = jlat.make_step(spec, cfg, 1 / 60, n_steps=3)(js)
        pout = plat.make_step(pspec, pcfg, 1 / 60, n_steps=3)(ps)
    else:
        jout = jlat.make_substep_runner(spec, cfg, dt_sub, n_sub)(js)
        pout = plat.make_substep_runner(pspec, pcfg, dt_sub, n_sub)(ps)
    return js, ps, jout, pout, dt_sub


@pytest.mark.parametrize("name", list(CASES))
def test_plain_engine_matches_jax(name):
    cfg, state_kw, substeps = CASES[name]
    js, ps, jout, pout, dt_sub = _run_both(cfg, state_kw, substeps)
    d = max_diffs(jout, pout)
    assert np.isfinite(pout.positions.numpy()).all()
    assert d["dx"] < DX_TOL, f"{name}: {d}"
    assert d["dlam"] < DLAM_TOL, f"{name}: {d}"
    assert d["dv"] < DX_TOL / dt_sub, f"{name}: {d}"
    assert d["dext"] == 0.0, f"{name}: {d}"
    assert float(pout.ext_force.abs().max()) == 0.0
    # the scene did move, so the comparison says something
    assert float((pout.positions - ps.positions).abs().max()) > 1e-4
    pins = state_kw.get("pins", ())
    if pins:
        np.testing.assert_array_equal(pout.positions[list(pins)].numpy(),
                                      ps.positions[list(pins)].numpy())


def test_step_fn_matches_make_step_and_jax():
    """``step_fn`` (the plain engine on any device) chained = ``make_step``
    with n_steps, and one frame agrees with the JAX ``step_fn``
    (``__graft_entry__.entry``'s call)."""
    cfg, state_kw, _ = CASES["entry"]
    spec, js = jax_lattice_state(6, ext_patch=(20, (5.0, 0.0, 0.0)),
                                 **state_kw)
    pspec = ptop.lattice_spec(6, braced=True)
    pcfg = port_config(cfg)
    ps = to_port(js)
    chained = plat.multi_step_fn(ps, pspec, pcfg, 1 / 60, 2)
    fused = plat.make_step(pspec, pcfg, 1 / 60, n_steps=2)(ps)
    np.testing.assert_array_equal(chained.positions.numpy(),
                                  fused.positions.numpy())
    jstep = jax.jit(lambda s: jlat.step_fn(s, spec, cfg, 1 / 60))
    d = max_diffs(jstep(js), plat.step_fn(ps, pspec, pcfg, 1 / 60))
    assert d["dx"] < DX_TOL and d["dlam"] < DLAM_TOL, d


@pytest.mark.parametrize("scene,kw", [("flagship", dict(res=4,
                                                         gravity_on=True)),
                                      ("flagship_perf", dict(res=6))])
def test_scenes_match_jax(scene, kw):
    """The two lattice scenes build the same body and config as the JAX
    package's, and their steppers agree over 3 frames."""
    jstate, jstep, jinfo = getattr(jscenes, scene)(**kw)
    pstate, pstep, pinfo = getattr(pscenes, scene)(device="cpu", **kw)
    assert pinfo["config"] == port_config(jinfo["config"])
    assert pinfo["spec"] == type(pinfo["spec"])(**jinfo["spec"].__dict__)
    np.testing.assert_array_equal(pstate.positions.numpy(),
                                  np.asarray(jstate.positions))
    np.testing.assert_array_equal(pstate.inv_mass.numpy(),
                                  np.asarray(jstate.inv_mass))
    for _ in range(3):
        jstate, pstate = jstep(jstate), pstep(pstate)
    d = max_diffs(jstate, pstate)
    assert d["dx"] < DX_TOL and d["dlam"] < DLAM_TOL, d
