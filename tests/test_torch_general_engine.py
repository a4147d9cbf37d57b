"""The PyTorch port's plain general engine (``solvers/general.py``) and
mesh scenes against the JAX package's, on the CPU.

Same inputs, made by numpy from a seed (``test_torch_mesh_cases.py``), go
through both packages' ``general.make_step``.  Gates are those the JAX
suite holds its own mesh kernel to (``tests/test_mesh_pallas.py``):
max |dx| < 2e-5 (JACOBI) or 1e-5 (COLORED), max |dlambda_dist| < 1e-6,
max |dlambda_bend| < 5e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import scenes as jscenes
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.solvers import general as jgeneral
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core import scenes as pscenes
from softbodysimulation_tpu_torch.interact import forces as pforces
from softbodysimulation_tpu_torch.solvers import general as pgeneral

import test_torch_mesh_cases as mesh_cases
from test_torch_state import FIELDS, port_config

torch.set_num_threads(1)

CASES = mesh_cases.mesh_cases(jconfig)
DT = 1 / 60


def jax_case(kind, **kw):
    """(JAX topology, JAX state, port topology, port state) of a case; each
    package builds the body with its own builders."""
    jtopo, fields = mesh_cases.case_inputs(kind, jbuild, jmesh, **kw)
    ptopo, pfields = mesh_cases.case_inputs(kind, **kw)
    for k in fields:
        np.testing.assert_array_equal(fields[k], pfields[k])
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jtopo, js, ptopo, port.state_from_numpy(pfields,
                                                   device="cpu")


def diffs(jstate, pstate):
    return {k: float(np.abs(np.asarray(getattr(jstate, k))
                            - getattr(pstate, k).numpy()).max(initial=0.0))
            for k in ("positions", "velocities", "lambda_dist",
                      "lambda_bend", "ext_force")}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_engine_matches_jax(name):
    cfg, kind, kw, frames = CASES[name]
    jtopo, js, ptopo, ps = jax_case(kind, **kw)
    jout = jgeneral.make_step(jtopo, cfg, DT, n_steps=frames)(js)
    pout = pgeneral.make_step(ptopo, port_config(cfg), DT, n_steps=frames)(
        ps)
    d = diffs(jout, pout)
    assert port.is_finite(pout)
    assert d["positions"] < mesh_cases.dx_gate(cfg), (name, d)
    assert d["lambda_dist"] < mesh_cases.DLAM_DIST, (name, d)
    assert d["lambda_bend"] < mesh_cases.DLAM_BEND, (name, d)
    assert d["velocities"] < mesh_cases.dx_gate(cfg) * cfg.substeps / DT, (
        name, d)
    assert float(pout.ext_force.abs().max()) == 0.0
    # the body moved and its constraints loaded, so the comparison says
    # something
    assert float((pout.positions - ps.positions).abs().max()) > 1e-3
    assert float(pout.lambda_dist.abs().max()) > 0
    if cfg.enable_bending and cfg.lambda_mode.value == "decay":
        assert float(pout.lambda_bend.abs().max()) > 0
    pins = np.flatnonzero(ps.inv_mass.numpy() == 0)
    if len(pins):
        np.testing.assert_array_equal(pout.positions[pins].numpy(),
                                      ps.positions[pins].numpy())


def test_step_fn_chains_like_make_step():
    """``multi_step_fn`` (the plain loop on any device) equals
    ``make_step`` bit for bit, and ``step_fn`` matches the JAX
    ``step_fn`` for one frame with the ext force."""
    cfg, kind, kw, _ = CASES["ext_accel"]
    jtopo, js, ptopo, ps = jax_case(kind, **kw)
    pcfg = port_config(cfg)
    chained = pgeneral.multi_step_fn(ps, ptopo, pcfg, DT, 2)
    fused = pgeneral.make_step(ptopo, pcfg, DT, n_steps=2)(ps)
    np.testing.assert_array_equal(chained.positions.numpy(),
                                  fused.positions.numpy())
    d = diffs(jgeneral.step(js, jtopo, cfg, DT),
              pgeneral.step_fn(ps, ptopo, pcfg, DT))
    assert d["positions"] < mesh_cases.DX_JACOBI, d
    assert d["lambda_dist"] < mesh_cases.DLAM_DIST, d


def test_raw_substeps_keep_the_accumulator():
    """``run_substeps_plain(with_ext=False)`` neither applies nor clears
    ``ext_force`` (the fused runners' rollout semantics)."""
    cfg, kind, kw, _ = CASES["ext_accel"]
    _, _, ptopo, ps = jax_case(kind, **kw)
    pcfg = port_config(cfg)
    raw = pgeneral.run_substeps_plain(ps, ptopo, pcfg, DT / 4, 4)
    np.testing.assert_array_equal(raw.ext_force.numpy(),
                                  ps.ext_force.numpy())
    ref = pgeneral.run_substeps_plain(
        ps.replace(ext_force=torch.zeros_like(ps.ext_force)), ptopo, pcfg,
        DT / 4, 4)
    np.testing.assert_array_equal(raw.positions.numpy(),
                                  ref.positions.numpy())


def _poke(mod, state):
    com = np.asarray(state.positions).mean(0)
    return mod.add_force(state, (0.0, 5.0, 40.0), com.tolist(), radius=0.6)


@pytest.mark.parametrize("scene,kw", [("cloth", dict(res=8)),
                                      ("cpu_mesh", dict(fallback_subdiv=1))])
def test_mesh_scenes_match_jax(scene, kw):
    """The mesh scenes build the same body, pins and config as the JAX
    package's, and their steppers agree over 3 frames (the cloth with a
    poke that bends it out of its plane)."""
    from softbodysimulation_tpu.interact import forces as jforces

    jstate, jstep, jinfo = getattr(jscenes, scene)(**kw)
    pstate, pstep, pinfo = getattr(pscenes, scene)(device="cpu", **kw)
    assert pinfo["config"] == port_config(jinfo["config"])
    for k in FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(pstate, k).numpy(),
                                      np.asarray(getattr(jstate, k)))
    if scene == "cloth":
        jstate = _poke(jforces, jstate)
        pstate = _poke(pforces, pstate)
    for _ in range(3):
        jstate, pstate = jstep(jstate), pstep(pstate)
    d = diffs(jstate, pstate)
    assert d["positions"] < mesh_cases.dx_gate(pinfo["config"]), d
    assert d["lambda_dist"] < mesh_cases.DLAM_DIST, d
    assert d["lambda_bend"] < mesh_cases.DLAM_BEND, d
    assert float(pstate.ext_force.abs().max()) == 0.0


def test_refused_features_raise_at_build():
    """The plain engine refuses, at build time, what the slice does not
    carry; a state whose ColliderSet lies on another device than its
    positions is refused at call time."""
    _, _, ptopo, ps = jax_case("sphere")
    base = port_config(jconfig.SolverConfig(substeps=2, iterations=1))
    for kw in (dict(enable_volume=True),
               dict(enable_tet_volume=True, tet_backend="windowed"),
               # a dense contact cadence that does not divide the frame
               dict(enable_self_collision=True,
                    self_collision_backend="dense",
                    self_collision_every=3)):
        with pytest.raises(NotImplementedError):
            pgeneral.make_step(ptopo, base.replace(**kw), DT)
    with pytest.raises(ValueError, match="colliders on meta"):
        pgeneral.make_step(ptopo, base, DT)(ps.replace(
            colliders=port.make_colliders(device="cpu").to("meta")))
