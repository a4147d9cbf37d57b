"""The port's CUDA lattice kernel wrapper (``kernels/lattice_cuda.py``).

On the CPU the wrapper runs the kernel's plain version, so its runner and
step are held against the JAX package's fused streamed Pallas kernel, run
in interpret mode as ``tests/test_pallas_kernel.py`` runs it (res 6, 12
substeps; tolerances max |dx| < 1e-5, max |dlambda| < 1e-6).  The build-time
refusals are checked here too.  The kernel itself runs only on the card:
``tests/test_torch_kernel_on_card.py`` (marked ``gpu``, no jax) holds it
against the plain version there and skips on a host without CUDA.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu import SolverConfig
from softbodysimulation_tpu.kernels import lattice_pallas as lp

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.kernels import _build
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

from test_torch_lattice_engine import CASES
from test_torch_state import (jax_lattice_state, max_diffs, port_config,
                              to_port)

torch.set_num_threads(1)

DX_TOL = 1e-5
DLAM_TOL = 1e-6
DT_SUB = 1 / 480


def test_cuda_runner_on_cpu_matches_streamed_pallas():
    """``make_cuda_substep_runner`` on a CPU state (the bench config) vs
    ``make_pallas_substep_runner_streamed`` — the kernel this port's CUDA
    kernel replaces — in interpret mode."""
    cfg, state_kw, n = CASES["bench"]
    spec, js = jax_lattice_state(6, **state_kw)
    with pltpu.force_tpu_interpret_mode():
        jfn = lp.make_pallas_substep_runner_streamed(spec, cfg, DT_SUB, n)
        jout = jfn(js)
    before = lc.launches
    pout = lc.make_cuda_substep_runner(ptop.lattice_spec(6, braced=True),
                                       port_config(cfg), DT_SUB, n)(
        to_port(js))
    assert lc.launches == before     # the plain version launches nothing
    d = max_diffs(jout, pout)
    assert d["dx"] < DX_TOL and d["dlam"] < DLAM_TOL, d


def test_cuda_step_on_cpu_matches_pallas_step():
    """``make_cuda_step`` (ext force consumed on the first substep, zeroed
    after) vs ``make_pallas_step`` on the entry config (WARM_START)."""
    cfg, state_kw, _ = CASES["entry"]
    spec, js = jax_lattice_state(6, ext_patch=(30, (40.0, 25.0, 0.0)),
                                 **state_kw)
    with pltpu.force_tpu_interpret_mode():
        jout = lp.make_pallas_step(spec, cfg, 1 / 60, n_steps=3)(js)
    pout = lc.make_cuda_step(ptop.lattice_spec(6, braced=True),
                             port_config(cfg), 1 / 60, n_steps=3)(to_port(js))
    d = max_diffs(jout, pout)
    assert d["dx"] < DX_TOL and d["dlam"] < DLAM_TOL, d
    assert float(pout.ext_force.abs().max()) == 0.0


def test_runner_without_ext_keeps_the_accumulator():
    """``with_ext=False`` neither applies nor clears ``ext_force``, as the
    fused Pallas runners do; the solver-level runner clears it, as the
    stencil engine's does."""
    cfg, state_kw, _ = CASES["entry"]
    _, js = jax_lattice_state(4, ext_patch=(5, (1.0, 0.0, 0.0)), **state_kw)
    spec, pcfg, ps = ptop.lattice_spec(4, braced=True), port_config(cfg), \
        to_port(js)
    raw = lc.make_cuda_substep_runner(spec, pcfg, DT_SUB, 4)(ps)
    np.testing.assert_array_equal(raw.ext_force.numpy(), ps.ext_force.numpy())
    ref = plat.run_substeps_plain(ps.replace(ext_force=0 * ps.ext_force),
                                  spec, pcfg, DT_SUB, 4)
    np.testing.assert_array_equal(raw.positions.numpy(),
                                  ref.positions.numpy())
    solver = plat.make_substep_runner(spec, pcfg, DT_SUB, 4)(ps)
    assert float(solver.ext_force.abs().max()) == 0.0


@pytest.mark.parametrize("what", ["self_collision", "tet_volume",
                                  "box_colliders", "approx_math",
                                  "ensemble_runner", "batched_step",
                                  "solver_step", "too_many_spheres"])
def test_unsupported_features_refused_at_build(what):
    """What the slice does not carry raises ``NotImplementedError`` when the
    runner is built.  The per-cell tets are carried: a tet config builds,
    and only a state without tet multipliers is refused, when it arrives.
    Box colliders are carried up to the kernel's table size: more are
    refused, config or kinematic.  Ensembles are carried: their runner
    refuses what the single-body runner refuses (self-collision, which the
    kernel's runner refuses as JAX's streamed runner does), and the
    lane-folded step refuses a ColliderSet, as JAX's does.  ``approx_math``
    is carried: the runner builds, on the CPU its result is the approx
    twin's to the bit, and it tracks the exact runner within 1e-4
    (``tests/test_pallas_kernel.py:230-244``).  The solver's step takes
    self-collision: at every substep through the stencil engine (route
    ``"plain"``)."""
    spec = ptop.lattice_spec(4, braced=True)
    cfg = port_config(SolverConfig(substeps=2, iterations=1))
    kw = {}
    build = lc.make_cuda_substep_runner
    if what == "approx_math":
        st = plat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                     mass=0.001, device="cpu")
        out = build(spec, cfg, DT_SUB, 8, approx_math=True)(st)
        twin = plat.run_substeps_plain(st, spec, cfg, DT_SUB, 8,
                                       approx_math=True)
        exact = build(spec, cfg, DT_SUB, 8)(st)
        assert torch.equal(out.positions, twin.positions)
        assert torch.equal(out.lambda_dist, twin.lambda_dist)
        assert float((out.positions - exact.positions).abs().max()) < 1e-4
        assert not torch.equal(out.lambda_dist, exact.lambda_dist)
        return
    if what == "solver_step":
        sc = cfg.replace(enable_self_collision=True)
        step = plat.make_step(spec, sc, 1 / 60)
        st = plat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                     device="cpu")
        assert step.route == "plain"
        assert torch.equal(step(st).positions,
                           plat.step_fn(st, spec, sc, 1 / 60).positions)
        return
    if what == "tet_volume":
        run = build(spec, cfg.replace(enable_tet_volume=True), DT_SUB, 4)
        with pytest.raises(ValueError, match="tet_volume=True"):
            run(plat.make_lattice_state(spec, device="cpu"))
        return
    if what == "self_collision":
        cfg = cfg.replace(enable_self_collision=True,
                          self_collision_every=2)
    elif what == "box_colliders":
        cfg = cfg.replace(box_colliders=((0.0, 0.3, 0.0, 0.5, 0.3, 0.5),)
                          * (lc.MAX_BOXES + 1))
        with pytest.raises(NotImplementedError):
            build(spec, cfg.replace(box_colliders=()), DT_SUB, 4,
                  kin_colliders=(0, lc.MAX_BOXES + 1))
    elif what == "ensemble_runner":
        build(spec, cfg, DT_SUB, 4, n_bodies=2)
        cfg = cfg.replace(enable_self_collision=True)
        kw = dict(n_bodies=2)
    elif what == "too_many_spheres":
        cfg = cfg.replace(sphere_colliders=((0.0, 0.0, 0.0, 0.1),)
                          * (lc.MAX_SPHERES + 1))
    with pytest.raises(NotImplementedError):
        if what == "batched_step":
            from softbodysimulation_tpu_torch.parallel import batch
            st = batch.replicate_state(
                plat.make_lattice_state(spec, device="cpu"), 2)
            plat.make_batched_step(spec, cfg, 1 / 60, n_bodies=2)(
                st.replace(colliders=port.make_colliders(device="cpu")))
        else:
            build(spec, cfg, DT_SUB, 4, **kw)


def test_state_with_colliders_refused_at_call():
    """Runners built without ``kin_colliders`` refuse a state carrying a
    ColliderSet; the engine's step builds one per collider count, and
    refuses colliders on another device than the state."""
    spec = ptop.lattice_spec(3, braced=True)
    cfg = port_config(SolverConfig(substeps=2, iterations=1))
    coll = port.make_colliders(ground_height=0.0, device="cpu")
    state = plat.make_lattice_state(spec, device="cpu").replace(
        colliders=coll)
    for fn in (lc.make_cuda_substep_runner(spec, cfg, DT_SUB, 2),
               lc.make_cuda_step(spec, cfg, 1 / 60)):
        with pytest.raises(NotImplementedError):
            fn(state)
    with pytest.raises(ValueError, match="colliders on meta"):
        plat.make_step(spec, cfg, 1 / 60)(state.replace(
            colliders=coll.to("meta")))


def test_params_mirror_the_cuda_struct():
    """The ctypes ``LatticeParams`` lists the fields of the C struct in
    ``csrc/lattice_xpbd.cuh`` (shared by the lattice and slab kernels) in
    the same order with the same widths, and ``make_params`` rounds each
    constant from the config's double."""
    src = (_build.CSRC_DIR / "lattice_xpbd.cuh").read_text()
    body = re.search(r"struct LatticeParams \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    consts = {"LX_MAX_FAM": lc.MAX_FAM, "LX_MAX_SPHERES": lc.MAX_SPHERES}
    c_fields = []
    for decl in body.split(";"):
        m = re.match(r"\s*(int|float)\s+(\w+)((?:\[\w+\])*)\s*$", decl)
        if m:
            dims = [int(consts.get(d, d)) for d in
                    re.findall(r"\[(\w+)\]", m.group(3))]
            c_fields.append((m.group(2), m.group(1), dims))
    assert [f[0] for f in c_fields] == [f[0] for f in lc.LatticeParams._fields_]
    size = sum(4 * int(np.prod(dims)) for _, _, dims in c_fields)
    assert ctypes.sizeof(lc.LatticeParams) == size

    cfg, _, _ = CASES["flagship"]
    spec = ptop.lattice_spec(6)
    p = lc.make_params(spec, port_config(cfg), 1 / 240)
    assert p.n == 216 and p.nfam == 7 and p.colored == 1
    assert p.lambda_mode == 1 and p.floor_mode == 2 and p.reference_bounds
    assert p.alpha[0] == np.float32(1e-4 * 240 * 240)
    assert p.dl_rel[3] == np.float32(0.1 * spec.rest_lengths[3])
    assert p.damp_factor == np.float32(1.0 - 0.01 / 240)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
