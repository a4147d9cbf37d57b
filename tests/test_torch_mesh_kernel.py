"""The port's CUDA mesh kernel wrapper (``kernels/mesh_cuda.py``).

On the CPU the wrapper runs the kernel's plain version, so its runner and
step are held against the JAX package's fused mesh kernel (TPU kernel
B-3, ``kernels/mesh_pallas.make_mesh_substep_runner``), run in interpret
mode as ``tests/test_mesh_pallas.py`` runs it (icosphere 2,
``block_edges=128``, 12 substeps), at the gates of
``test_torch_mesh_cases.py``.  The build-time refusals and the ctypes
mirrors of the kernel's structs are checked here too.  The kernel itself
runs only on the card: ``tests/test_torch_kernel_on_card.py`` (marked
``gpu``, no jax) holds it against the plain version there.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.kernels import mesh_pallas
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import mesh as jmesh

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.kernels import _build
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.solvers import general as pgeneral

import test_torch_mesh_cases as mesh_cases
from test_torch_state import port_config

torch.set_num_threads(1)

DT = 1 / 60
C = jconfig


def both(kind, **kw):
    jtopo, fields = mesh_cases.case_inputs(kind, jbuild, jmesh, **kw)
    ptopo, _ = mesh_cases.case_inputs(kind, **kw)
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jtopo, js, ptopo, port.state_from_numpy(fields, device="cpu")


def assert_gates(jout, pout, cfg):
    d = {k: float(np.abs(np.asarray(getattr(jout, k))
                         - getattr(pout, k).numpy()).max(initial=0.0))
         for k in ("positions", "lambda_dist", "lambda_bend")}
    assert port.is_finite(pout)
    assert d["positions"] < mesh_cases.dx_gate(cfg), d
    assert d["lambda_dist"] < mesh_cases.DLAM_DIST, d
    assert d["lambda_bend"] < mesh_cases.DLAM_BEND, d
    assert float(pout.ext_force.abs().max()) == 0.0


def test_cuda_runner_on_cpu_matches_pallas_jacobi_bending_warm():
    """``make_mesh_cuda_substep_runner`` on a CPU state vs
    ``make_mesh_substep_runner`` — the kernel this port's CUDA kernel
    replaces — JACOBI with Chebyshev, WARM_START, bending, a poke."""
    cfg = C.SolverConfig(substeps=4, iterations=4, damping=0.02,
                         solve_mode=C.SolveMode.JACOBI,
                         lambda_mode=C.LambdaMode.WARM_START,
                         lambda_decay=0.98, jacobi_rho=0.9,
                         enable_bending=True, ground_height=0.0,
                         friction=0.3)
    jtopo, js, ptopo, ps = both("sphere_bend_high",
                                ext_patch=(10, (4.0, 8.0, 2.0)))
    with pltpu.force_tpu_interpret_mode():
        jout = mesh_pallas.make_mesh_substep_runner(
            jtopo, cfg, DT / 4, 12, block_edges=128, with_ext=True)(js)
    before = mc.launches
    pout = mc.make_mesh_cuda_substep_runner(ptopo, port_config(cfg), DT / 4,
                                            12, with_ext=True)(ps)
    assert mc.launches == before     # the plain version launches nothing
    assert_gates(jout, pout, cfg)
    assert float(pout.lambda_bend.abs().max()) > 0


def test_cuda_step_on_cpu_matches_pallas_step_colored():
    """``make_mesh_cuda_step`` vs ``make_mesh_pallas_step`` on a COLORED
    configuration (exact Gauss-Seidel per colour) with clamps, 3 frames."""
    cfg = C.SolverConfig(substeps=4, iterations=3, damping=0.02,
                         solve_mode=C.SolveMode.COLORED,
                         lambda_mode=C.LambdaMode.DECAY, lambda_decay=0.98,
                         max_dlambda=1e-3, lambda_clamp=0.05,
                         ground_height=0.0, friction=0.3)
    jtopo, js, ptopo, ps = both("sphere_colored_bend")
    with pltpu.force_tpu_interpret_mode():
        jout = mesh_pallas.make_mesh_pallas_step(jtopo, cfg, DT, n_steps=3)(
            js)
    pout = mc.make_mesh_cuda_step(ptopo, port_config(cfg), DT, n_steps=3)(ps)
    assert_gates(jout, pout, cfg)


def test_runner_without_ext_keeps_the_accumulator():
    cfg, kind, kw, _ = mesh_cases.mesh_cases()["ext_accel"]
    _, _, ptopo, ps = both(kind, **kw)
    raw = mc.make_mesh_cuda_substep_runner(ptopo, cfg, DT / 4, 4)(ps)
    np.testing.assert_array_equal(raw.ext_force.numpy(),
                                  ps.ext_force.numpy())
    ref = pgeneral.run_substeps_plain(
        ps.replace(ext_force=torch.zeros_like(ps.ext_force)), ptopo, cfg,
        DT / 4, 4)
    np.testing.assert_array_equal(raw.positions.numpy(),
                                  ref.positions.numpy())


REFUSED = ["volume", "tet_volume", "box_colliders", "kin_colliders",
           "self_collision", "ensembles", "approx_math", "too_many_spheres"]


@pytest.mark.parametrize("what", REFUSED)
def test_unsupported_features_refused_at_build(what):
    """B-3's features the port does not carry raise at build time, in both
    the kernel's runners and the plain engine's step.  Box and kinematic
    colliders are carried up to the kernel's table size: more are
    refused.  Ensembles are carried with dense contact only.
    ``approx_math`` is carried: the runner builds, on the CPU its result
    is the approx twin's to the bit, and it stays within JAX's own band of
    the exact result (5e-3, 5e-4: ``tests/test_mesh_pallas.py:111-118``)."""
    _, _, ptopo, ps = both("sphere")
    cfg = port_config(C.SolverConfig(substeps=2, iterations=1))
    kw = {}
    if what == "approx_math":
        run = mc.make_mesh_cuda_substep_runner(ptopo, cfg, DT / 2, 4,
                                               approx_math=True)
        out = run(ps)
        twin = pgeneral.run_substeps_plain(ps, ptopo, cfg, DT / 2, 4,
                                           approx_math=True)
        exact = pgeneral.run_substeps_plain(ps, ptopo, cfg, DT / 2, 4)
        assert torch.equal(out.positions, twin.positions)
        assert torch.equal(out.lambda_dist, twin.lambda_dist)
        assert float((out.positions - exact.positions).abs().max()) < 5e-3
        assert float((out.lambda_dist - exact.lambda_dist).abs().max()) < 5e-4
        return
    if what == "volume":
        cfg = cfg.replace(enable_volume=True)
    elif what == "tet_volume":
        # tets run; their windowed (one-hot) backend is not ported
        cfg = cfg.replace(enable_tet_volume=True, tet_backend="windowed")
    elif what == "box_colliders":
        cfg = cfg.replace(box_colliders=((0.0, 0.3, 0.0, 0.5, 0.3, 0.5),)
                          * (mc.MAX_BOXES + 1))
    elif what == "kin_colliders":
        kw = dict(kin_colliders=(mc.MAX_SPHERES + 1, 0))
    elif what == "self_collision":
        # self-collision runs; the hash backend only in the plain engine,
        # so a runner built for the card refuses it
        cfg = cfg.replace(enable_self_collision=True,
                          self_collision_backend="hash")
        kw = dict(device="cuda")
    elif what == "ensembles":
        # ensembles run; with a self-collision backend other than dense
        # they are refused
        mc.make_mesh_cuda_substep_runner(ptopo, cfg, DT / 2, 2, n_bodies=2)
        cfg = cfg.replace(enable_self_collision=True,
                          self_collision_backend="blocked")
        kw = dict(n_bodies=2)
    elif what == "too_many_spheres":
        cfg = cfg.replace(sphere_colliders=((0.0, 0.0, 0.0, 0.1),)
                          * (mc.MAX_SPHERES + 1))
    with pytest.raises(NotImplementedError):
        mc.make_mesh_cuda_substep_runner(ptopo, cfg, DT / 2, 2, **kw)
    if not kw and what != "too_many_spheres":
        with pytest.raises(NotImplementedError):
            mc.make_mesh_cuda_step(ptopo, cfg, DT)
        with pytest.raises(NotImplementedError):
            pgeneral.make_step(ptopo, cfg, DT)


def test_state_with_colliders_or_other_device_refused_at_call():
    _, _, ptopo, ps = both("sphere")
    cfg = port_config(C.SolverConfig(substeps=2, iterations=1))
    run = mc.make_mesh_cuda_substep_runner(ptopo, cfg, DT / 2, 2)
    # a runner built without kin_colliders refuses a collider state
    with pytest.raises(NotImplementedError):
        run(ps.replace(colliders=port.make_colliders(device="cpu")))
    with pytest.raises(NotImplementedError):
        run(ps.to("meta"))


def _c_struct_fields(src, name):
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        m = re.match(r"\s*(?:const\s+)?(int|float)(\*?)\s+(\w+)((?:\[\w+\])*)"
                     r"\s*$", decl)
        if m:
            dims = [int({"MX_MAX_SPHERES": mc.MAX_SPHERES}.get(d, d))
                    for d in re.findall(r"\[(\w+)\]", m.group(4))]
            width = 8 if m.group(2) else 4
            out.append((m.group(3), width * int(np.prod(dims))))
    return out


def test_structs_mirror_the_cuda_source():
    """The ctypes ``MeshParams`` / ``MeshBuffers`` list the fields of the C
    structs in ``csrc/mesh_xpbd.cuh`` (the header the mesh kernel and the
    fused backward share) in the same order with the same widths, and the
    constants are rounded as the plain engine rounds them."""
    src = (_build.CSRC_DIR / "mesh_xpbd.cuh").read_text()
    for struct, cls in (("MeshParams", mc.MeshParams),
                        ("MeshBuffers", mc.MeshBuffers)):
        fields = _c_struct_fields(src, struct)
        assert [f[0] for f in fields] == [f[0] for f in cls._fields_]
        assert ctypes.sizeof(cls) == sum(w for _, w in fields)

    cfg, kind, kw, _ = mesh_cases.mesh_cases()["sphere_collider_clamps"]
    _, _, ptopo, _ = both(kind, **kw)
    dt = DT / cfg.substeps
    p = mc.make_params(ptopo, cfg, dt)
    assert (p.n, p.n_edges, p.n_hinges) == (162, 480, 0)
    assert p.colored == 0 and p.lambda_mode == 1 and p.accelerate == 1
    # the incidence rows go to the card as CSR: pads dropped, order kept
    ptr, cols = mc.incidence_csr(ptopo.incidence, 2 * ptopo.n_edges)
    inc = ptopo.incidence.numpy()
    assert ptr[-1] == len(cols) == 2 * ptopo.n_edges
    for i in (0, 5, 161):
        np.testing.assert_array_equal(cols[ptr[i]:ptr[i + 1]],
                                      inc[i][inc[i] < 2 * ptopo.n_edges])
    assert p.damp_factor == np.float32(1.0) - np.float32(0.02)
    assert p.friction_dt == np.float32(dt) * np.float32(0.3)
    consts = mc.constraint_constants(ptopo, cfg, dt)
    plain_alpha = torch.clamp(ptopo.compliance * (1.0 / (dt * dt)),
                              min=cfg.min_alpha_tilde)
    np.testing.assert_array_equal(consts["alpha"], plain_alpha.numpy())
    deg = ptopo.degree.numpy()
    e = ptopo.edges.numpy()
    np.testing.assert_array_equal(
        consts["relax"], np.float32(0.8) / np.maximum(
            np.maximum(deg[e[:, 0]], deg[e[:, 1]]), np.float32(1.0)))
    oms = pgeneral.chebyshev_omegas(cfg)
    assert oms[:3] == [1.0, 1.0, float(np.float32(2.0 / (2.0 - 0.81)))]


def test_library_builds_with_its_own_flags():
    """The mesh library is hashed with its extra flag (no FMA
    contraction), so it never shares a file with a build without it."""
    plain = _build.library_path(mc.LIB_NAME, mc.SOURCES)
    own = _build.library_path(mc.LIB_NAME, mc.SOURCES, mc.NVCC_EXTRA)
    assert plain != own and "-fmad=false" in mc.NVCC_EXTRA
