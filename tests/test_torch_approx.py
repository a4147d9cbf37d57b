"""``approx_math``: the plain twins of the CUDA kernels' rsqrt /
approximate-reciprocal variant (B-1 and B-2 in ``csrc/lattice_xpbd.cu``,
B-3 in ``csrc/mesh_xpbd.cu``) against the JAX package's ``approx_math``
kernels, run in interpret mode as its own tests run them, on the CPU.

On the CPU a runner built with ``approx_math=True`` runs the twin:
``torch.rsqrt`` and ``torch.reciprocal``, where the JAX kernels take
``lax.rsqrt`` and ``pl.reciprocal(approx=True)``; on the CPU both are
close to exact, so the twin and JAX's kernel agree to a few float32 ulps
of the state, as the exact twins do.  Gates: lattices max |dx| < 1e-6 and
max |dlambda| < 1e-6; the mesh at the port's mesh gates, |dx| < 2e-5 and
|dlambda| < 1e-6 (JAX holds its own approx mesh kernel to 5e-3 and 5e-4
of its engine, ``tests/test_mesh_pallas.py:111-118``).  On the
card the kernels are held to these twins in ``chip_smoke.py`` and
``tests/test_torch_kernel_on_card.py``, to a tolerance: ``rcp.approx`` is
not IEEE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from softbodysimulation_tpu import (LambdaMode, SolveMode, SolverConfig,
                                    state_from_topology)
from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.kernels import lattice_pallas as jlp
from softbodysimulation_tpu.kernels import mesh_pallas
from softbodysimulation_tpu.parallel import batch as jbatch
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import build as jbuild
from softbodysimulation_tpu.topology import lattice as jtop
from softbodysimulation_tpu.topology import mesh as jmesh
from softbodysimulation_tpu.topology import edges as jedges

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.kernels import diff as pdiff
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import build as pbuild
from softbodysimulation_tpu_torch.topology import lattice as ptop
from softbodysimulation_tpu_torch.topology import mesh as pmesh
from softbodysimulation_tpu_torch.topology import edges as pedges

from test_torch_state import port_config, to_port

torch.set_num_threads(1)

DT_SUB = 1 / 480
LAT_DX, LAT_DLAM = 1e-6, 1e-6
MESH_DX, MESH_DLAM = 2e-5, 1e-6


def dmax(jarr, tensor):
    return float(np.abs(np.asarray(jarr) - tensor.numpy()).max(initial=0.0))


def bench_config(**kw):
    """``tests/test_pallas_kernel.py:230-244``: RESET, JACOBI x 2,
    ``fast_math``, gravity as an acceleration, floor."""
    return SolverConfig(substeps=4, iterations=2, damping=0.02,
                        solve_mode=SolveMode.JACOBI,
                        lambda_mode=LambdaMode.RESET, fast_math=True,
                        gravity_is_acceleration=True, ground_height=0.0,
                        friction=0.3, **kw)


@pytest.mark.parametrize("res,n_sub,tets", [(5, 16, False), (4, 6, True)])
def test_lattice_twin_matches_jax_approx_kernel(res, n_sub, tets):
    """The lattice (res 5, 16 substeps, as JAX's approx test) and a solid
    lattice (the tet sweep's reciprocal; res 4, 6 substeps): the runner's
    twin against JAX's streamed kernel with ``approx_math``; the twin
    tracks the exact runner within 1e-4, JAX's gate for its kernel."""
    cfg = bench_config(enable_tet_volume=tets)
    spec = jtop.lattice_spec(res, braced=True)
    js = jlat.make_lattice_state(spec, center=(0, 0.6, 0), mass=0.001,
                                 tet_volume=tets)
    with pltpu.force_tpu_interpret_mode():
        jout = jlp.make_pallas_substep_runner_streamed(
            spec, cfg, DT_SUB, n_sub, approx_math=True)(js)
    pspec, pcfg, ps = ptop.lattice_spec(res, braced=True), \
        port_config(cfg), to_port(js)
    out = lc.make_cuda_substep_runner(pspec, pcfg, DT_SUB, n_sub,
                                      approx_math=True)(ps)
    assert port.is_finite(out)
    assert dmax(jout.positions, out.positions) < LAT_DX
    assert dmax(jout.lambda_dist, out.lambda_dist) < LAT_DLAM
    if tets:
        assert dmax(jout.lambda_tet, out.lambda_tet) < LAT_DLAM
    exact = lc.make_cuda_substep_runner(pspec, pcfg, DT_SUB, n_sub)(ps)
    assert float((out.positions - exact.positions).abs().max()) < 1e-4


def test_lattice_ensemble_twin_matches_jax_approx_kernel():
    """Two bodies in one runner (``n_bodies=2``) against JAX's streamed
    ensemble kernel with ``approx_math``."""
    cfg = bench_config()
    spec = jtop.lattice_spec(4, braced=True)
    base = jlat.make_lattice_state(spec, center=(0, 0.6, 0), mass=0.001)
    batched = jbatch.replicate_state(base, 2)
    offs = np.array([[[0.0, 0.0, 0.0]], [[0.2, 0.15, -0.1]]], np.float32)
    batched = batched.replace(positions=batched.positions + offs)
    with pltpu.force_tpu_interpret_mode():
        jout = jlp.make_pallas_substep_runner_streamed(
            spec, cfg, DT_SUB, 8, n_bodies=2, approx_math=True)(batched)
    out = lc.make_cuda_substep_runner(
        ptop.lattice_spec(4, braced=True), port_config(cfg), DT_SUB, 8,
        n_bodies=2, approx_math=True)(to_port(batched))
    assert dmax(jout.positions, out.positions) < LAT_DX
    assert dmax(jout.lambda_dist, out.lambda_dist) < LAT_DLAM


def _sphere(build_mod, mesh_mod, edges_mod, bending):
    m = mesh_mod.icosphere(2)
    pos, topo = build_mod.build_windowed_topology(
        m.vertices, edges_mod.unique_edges(m.triangles), 1e-3,
        hinges=edges_mod.hinges(m.triangles) if bending else None,
        triangles=m.triangles)
    return pos + np.array([0, 0.8, 0], np.float32), topo


@pytest.mark.parametrize("bending", [False, True])
def test_mesh_twin_matches_jax_approx_kernel(bending):
    """``tests/test_mesh_pallas.py:111-118`` (icosphere 2, JACOBI x 2,
    RESET, 4 substeps x 5 frames, ``block_edges=128``), and with dihedral
    bending (the normals' rsqrt), against JAX's mesh kernel with
    ``approx_math``.  The JAX kernel's switch to single-pass one-hot dots
    under ``approx_math`` is not carried; in interpret mode on the CPU
    those dots are float32 anyway."""
    cfg = jconfig.SolverConfig(substeps=4, iterations=2,
                               solve_mode=SolveMode.JACOBI, jacobi_rho=0.0,
                               lambda_mode=LambdaMode.RESET,
                               distance_backend="windowed",
                               enable_bending=bending,
                               ground_height=0.0, friction=0.3)
    pos, jtopo = _sphere(jbuild, jmesh, jedges, bending)
    ppos, ptopo = _sphere(pbuild, pmesh, pedges, bending)
    assert (ptopo.n_hinges > 0) == bending
    np.testing.assert_array_equal(pos, ppos)
    js = state_from_topology(jtopo, pos)
    f = np.zeros_like(pos)
    f[:10] = (4.0, 8.0, 2.0)
    js = js.replace(ext_force=jnp.asarray(f))
    with pltpu.force_tpu_interpret_mode():
        jout = mesh_pallas.make_mesh_substep_runner(
            jtopo, cfg, (1 / 60) / 4, 20, block_edges=128, with_ext=True,
            approx_math=True)(js)
    out = mc.make_mesh_cuda_substep_runner(
        ptopo, port_config(cfg), (1 / 60) / 4, 20, with_ext=True,
        approx_math=True)(to_port(js))
    assert port.is_finite(out)
    assert dmax(jout.positions, out.positions) < MESH_DX
    assert dmax(jout.lambda_dist, out.lambda_dist) < MESH_DLAM
    assert dmax(jout.lambda_bend, out.lambda_bend) < MESH_DLAM
    if bending:
        assert float(out.lambda_bend.abs().max()) > 0


def test_gradient_runners_refuse_approx_math():
    """The paired gradient runners take the exact forward only, as JAX's
    (``kernels/diff.py:90-95``)."""
    spec = ptop.lattice_spec(3, braced=True)
    cfg = port_config(bench_config())
    with pytest.raises(NotImplementedError, match="approx_math"):
        pdiff.make_differentiable_lattice_runner(spec, cfg, DT_SUB, 4,
                                                 approx_math=True)
    st = plat.make_lattice_state(spec, device="cpu")
    assert port.is_finite(lc.make_cuda_substep_runner(
        spec, cfg, DT_SUB, 4, approx_math=True)(st))
