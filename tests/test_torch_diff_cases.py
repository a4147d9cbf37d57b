"""Differentiable-path scenarios that hold two backward constructions
against each other, and tests of the scenarios themselves.

Each case is a solver configuration in the fused backward's envelope, the
icosphere body of the JAX suite's fused-backward tests
(``tests/test_mesh_diff_pallas.py``: subdivision 2, radius 0.5, compliance
1e-6, lifted 0.45 so that it starts in the floor), a rollout length and a
backward chunk, and seeded inputs made by numpy: the chunk-entry state
(velocity jitter, pinned particles, carried multipliers) and the output
cotangents (positions, velocities, multipliers) a loss would send back,
optionally with traced materials.  ``test_torch_mesh_diff.py`` holds the
port's ``backward_chunk_plain`` against ``jax.vjp`` of the JAX engine with
them on the CPU; ``test_torch_kernel_on_card.py`` and ``chip_smoke.py``
hold the B-5 kernel against ``backward_chunk_plain`` and against autograd
through the plain engine with them on the card.  This module imports
neither jax nor pytest.
"""

from typing import Dict

import numpy as np
import torch

from softbodysimulation_tpu_torch import state_from_numpy
from softbodysimulation_tpu_torch.core import config as _port_config
from softbodysimulation_tpu_torch.solvers import general as _general
from softbodysimulation_tpu_torch.topology import build as _port_build
from softbodysimulation_tpu_torch.topology import mesh as _port_mesh

DT = 1.0 / 240.0
# the JAX suite's gate on gradients, max |dg| / max |g|, with max |g| > 1e-3
# (tests/test_mesh_diff_pallas.py:76-87)
GRAD_TOL = 1e-4
# the B-5 kernel against its plain version (one arithmetic, one order)
KERNEL_TOL = 1e-5


def scene(build=_port_build, mesh=_port_mesh):
    """(positions (N, 3) f32, topology) of the body, with either package's
    builders: 162 particles, 480 edges."""
    m = mesh.icosphere(2, radius=0.5)
    pos, topo = build.topology_from_mesh(m, compliance=1e-6, windowed=True)
    return pos + np.array([0.0, 0.45, 0.0], np.float32), topo


def config(C=_port_config, **kw):
    """The JAX suite's fused-backward configuration, with overrides."""
    base = dict(substeps=2, iterations=4, damping=0.02,
                solve_mode=C.SolveMode.JACOBI,
                lambda_mode=C.LambdaMode.RESET,
                gravity_is_acceleration=True, ground_height=0.0,
                friction=0.3)
    base.update(kw)
    return C.SolverConfig(**base)


def diff_cases(C=_port_config):
    """``{name: (config, substeps, chunk, input kwargs)}``; input kwargs go
    to ``seeded_inputs``.  The six (iterations, lambda mode, floor) cases
    of ``test_fused_backward_grads_match_engine``, a multi-chunk rollout,
    the WARM_START chain with (clamp, fraction) in {(0, 1), (0.5, 0.5)}, a
    static sphere, pinned particles, the clamps and traced materials."""
    floor, none = C.FloorMode.XPBD_INEQUALITY, C.FloorMode.NONE
    L = C.LambdaMode
    cases = {}
    for iters, lmode, fmode in ((2, L.RESET, floor), (4, L.RESET, floor),
                                (4, L.DECAY, floor), (3, L.RESET, none),
                                (4, L.WARM_START, floor),
                                (2, L.WARM_START, none)):
        name = (f"it{iters}_{lmode.value}_"
                f"{'floor' if fmode == floor else 'nofloor'}")
        cases[name] = (config(C, iterations=iters, lambda_mode=lmode,
                              floor_mode=fmode), 5, None, {})
    cases["multi_chunk"] = (config(C, lambda_mode=L.DECAY), 6, 2, {})
    for clamp, frac in ((0.0, 1.0), (0.5, 0.5)):
        cases[f"warm_clamp{clamp:g}_frac{frac:g}"] = (config(
            C, lambda_mode=L.WARM_START, iterations=3,
            warm_start_clamp=clamp, warm_start_fraction=frac), 4, None,
            dict(carried=True))
    cases["sphere"] = (config(C, sphere_colliders=((0.0, 0.1, 0.0, 0.3),)),
                       5, None, {})
    cases["pinned"] = (config(C), 3, None, dict(pins=(0, 1, 2, 3, 4)))
    cases["clamps"] = (config(
        C, lambda_mode=L.DECAY, max_dlambda=5e-4, lambda_clamp=1e-3,
        max_velocity=0.6, world_bounds=0.8), 4, None, dict(carried=True))
    # alpha = compliance / dt^2 ~ 0.0576 here: the floor takes about half
    cases["materials"] = (config(C, lambda_mode=L.DECAY,
                                 min_alpha_tilde=0.0576), 4, 2,
                          dict(materials=True))
    return cases


def seeded_inputs(positions: np.ndarray, rest: np.ndarray,
                  compliance: np.ndarray, seed: int = 0,
                  jitter: float = 0.1, pins=(), carried: bool = False,
                  materials: bool = False) -> Dict[str, np.ndarray]:
    """Float32 arrays from ``seed``: the state fields (velocities ~ N(0,
    jitter) around (0.3, 0.1, -0.2); ``pins`` pinned; ``carried`` gives
    nonzero entry multipliers), the output cotangents ``gx``, ``gv``,
    ``glam`` ~ N(0, 1), and with ``materials`` the traced rest lengths and
    compliances (the topology's, each scaled by a seeded factor in
    [0.95, 1.05] and [0.5, 2])."""
    rng = np.random.default_rng(seed)
    n, e = positions.shape[0], rest.shape[0]
    vel = (np.array([0.3, 0.1, -0.2]) + rng.normal(0.0, jitter, (n, 3)))
    w = np.ones((n,))
    w[list(pins)] = 0.0
    vel[list(pins)] = 0.0
    out = {
        "positions": positions, "velocities": vel, "inv_mass": w,
        "ext_force": np.zeros((n, 3)),
        "lambda_dist": (rng.normal(0.0, 1e-5, (e,)) if carried
                        else np.zeros((e,))),
        "lambda_bend": np.zeros((0,)), "lambda_volume": np.zeros(()),
        "gx": rng.normal(size=(n, 3)), "gv": rng.normal(size=(n, 3)),
        "glam": rng.normal(size=(e,)),
    }
    if materials:
        out["rest_lengths"] = rest * rng.uniform(0.95, 1.05, (e,))
        out["compliance"] = compliance * rng.uniform(0.5, 2.0, (e,))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def case_inputs(kw, build=_port_build, mesh=_port_mesh):
    """(topology, seeded inputs) of a case's input kwargs."""
    pos, topo = scene(build, mesh)
    return topo, seeded_inputs(pos, np.asarray(topo.rest_lengths),
                               np.asarray(topo.compliance), **kw)


STATE_KEYS = ("positions", "velocities", "inv_mass", "ext_force",
              "lambda_dist", "lambda_bend", "lambda_volume")
GRAD_KEYS = ("gx", "gv", "glam", "g_rest", "g_comp")


def normalized_errors(got, ref) -> Dict[str, float]:
    """max |got - ref| / max |ref| per named output."""
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max()
                     / max(float(np.abs(np.asarray(ref[k])).max()), 1e-30))
            for k in ref}


def port_inputs(fields, device="cpu"):
    """(state, cotangents (gx, gv, glam), materials or None) as tensors on
    ``device``."""
    state = state_from_numpy({k: fields[k] for k in STATE_KEYS},
                             device=device)
    cot = tuple(torch.as_tensor(fields[k], device=device)
                for k in ("gx", "gv", "glam"))
    mats = None
    if "rest_lengths" in fields:
        mats = {k: torch.as_tensor(fields[k], device=device)
                for k in ("rest_lengths", "compliance")}
    return state, cot, mats


def chunk_vjp(backward_chunk, topo, cfg, n_sub, state, cot, mats=None):
    """A backward-chunk function (``backward_chunk_plain`` or ``_cuda``)
    over the whole rollout as one chunk, as ``{GRAD_KEYS: tensor}``."""
    out = backward_chunk(topo, cfg, DT, n_sub, state.inv_mass,
                         state.positions, state.velocities,
                         state.lambda_dist, *cot, mats)
    return dict(zip(GRAD_KEYS, out))


def autograd_vjp(topo, cfg, n_sub, state, cot, mats=None):
    """The same VJP by autograd through the plain engine's rollout."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (state.positions, state.velocities,
                        state.lambda_dist)]
    m = None
    if mats is not None:
        m = {k: v.detach().clone().requires_grad_() for k, v in mats.items()}
        leaves += [m["rest_lengths"], m["compliance"]]
    s = state.replace(positions=leaves[0], velocities=leaves[1],
                      lambda_dist=leaves[2])
    out = _general.run_substeps_plain(s, topo, cfg, DT, n_sub, materials=m)
    grads = torch.autograd.grad(
        [out.positions, out.velocities, out.lambda_dist], leaves, list(cot),
        allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g
            for k, g, x in zip(GRAD_KEYS, grads, leaves)}


# ---- the scenarios cover what the slice promises --------------------------

def test_diff_cases_cover_the_envelope():
    """Every mode and knob of the fused backward's envelope is switched on
    by at least one case."""
    C = _port_config
    cases = diff_cases()
    cfgs = [c for c, _, _, _ in cases.values()]
    assert {c.lambda_mode for c in cfgs} == set(C.LambdaMode)
    assert {c.floor_mode for c in cfgs} == {C.FloorMode.NONE,
                                             C.FloorMode.XPBD_INEQUALITY}
    assert {c.jacobi_rho > 0 and c.iterations > c.jacobi_cheby_delay
            for c in cfgs} == {True, False}
    for knob in ("sphere_colliders", "max_dlambda", "lambda_clamp",
                 "max_velocity", "world_bounds", "min_alpha_tilde"):
        assert any(getattr(c, knob) for c in cfgs), knob
    warm = {(c.warm_start_clamp, c.warm_start_fraction) for c in cfgs
            if c.lambda_mode == C.LambdaMode.WARM_START}
    assert {(0.0, 1.0), (0.5, 0.5)} <= warm
    assert any(chunk and chunk < n for _, n, chunk, _ in cases.values())
    kws = [kw for _, _, _, kw in cases.values()]
    assert any(kw.get("pins") for kw in kws)
    assert any(kw.get("materials") for kw in kws)
    assert all(c.solve_mode == C.SolveMode.JACOBI and not c.enable_bending
               for c in cfgs)


def test_diff_inputs_are_seeded_and_shaped():
    """Same seed, same arrays; the scene starts in the floor; pins are
    still; materials stay near the topology's."""
    topo, a = case_inputs(dict(pins=(0, 3), materials=True, carried=True))
    _, b = case_inputs(dict(pins=(0, 3), materials=True, carried=True))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32, k
    n, e = topo.n_particles, topo.n_edges
    assert (n, e) == (162, 480)
    assert a["positions"][:, 1].min() < 0.0 < a["positions"][:, 1].max()
    assert a["gx"].shape == (n, 3) and a["glam"].shape == (e,)
    np.testing.assert_array_equal(a["inv_mass"][[0, 3]], [0.0, 0.0])
    np.testing.assert_array_equal(a["velocities"][[0, 3]], 0.0)
    assert np.abs(a["lambda_dist"]).max() > 0
    ratio = a["rest_lengths"] / np.asarray(topo.rest_lengths)
    assert 0.95 <= ratio.min() and ratio.max() <= 1.05
