"""The port's differentiable lattice runners (``kernels/diff.py``) against
the JAX package's gradients, on the CPU.

Mirrors the lattice tests of ``tests/test_diff_kernels.py``: the paired
lattice runner (CUDA lattice kernel forward, the plain stencil engine's
autograd backward; on the CPU both are the plain engine) with and without
``remat_chunk``, and the full-step runner's ext-force gradients.  Gate as
``test_torch_diff.py``: max |dg| / max |g| < 1e-4, value within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import lattice as jtop

from softbodysimulation_tpu_torch.kernels import diff as kdiff
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

from test_torch_diff import DT_SUB, V0, assert_grads_match, assert_values_match
from test_torch_state import port_config

torch.set_num_threads(1)


def lattice_case():
    cfg = dict(substeps=2, iterations=2, damping=0.01,
               lambda_mode="reset", gravity_is_acceleration=True,
               ground_height=0.0, friction=0.3)
    jcfg = jconfig.SolverConfig(**{**cfg, "lambda_mode":
                                   jconfig.LambdaMode.RESET,
                                   "solve_mode": jconfig.SolveMode.JACOBI})
    return (jtop.lattice_spec(4, braced=True), ptop.lattice_spec(4,
                                                                  braced=True),
            jcfg, port_config(jcfg))


@functools.lru_cache(maxsize=None)
def jax_lattice_grad(n_sub):
    """(value, d/d v0) of sum(x) after ``n_sub`` substeps of the JAX
    stencil engine from a launch velocity v0 (computed once per test
    session: its compile is the slow part)."""
    jspec, _, jcfg, _ = lattice_case()
    jst = jlat.make_lattice_state(jspec, center=(0, 0.7, 0))
    ref_fn = jlat.make_substep_runner(jspec, jcfg, DT_SUB, n_sub)

    def jloss(v0):
        s = jst.replace(velocities=jnp.broadcast_to(v0, jst.velocities.shape))
        return jnp.sum(ref_fn(s).positions[:, 0])

    val, grad = jax.value_and_grad(jloss)(jnp.asarray(V0))
    return float(val), np.asarray(grad)


@pytest.mark.parametrize("remat_chunk", [0, 4])
def test_lattice_runner_grads_match_jax(remat_chunk):
    _, pspec, _, pcfg = lattice_case()
    n_sub = 8
    jval, jgrad = jax_lattice_grad(n_sub)
    pst = plat.make_lattice_state(pspec, center=(0, 0.7, 0),
                                  device="cpu")
    run = kdiff.make_differentiable_lattice_runner(pspec, pcfg, DT_SUB, n_sub,
                                                   remat_chunk=remat_chunk)
    v0 = torch.as_tensor(V0).requires_grad_()
    loss = run(pst.replace(velocities=v0.expand(pst.n_particles, 3))
               ).positions[:, 0].sum()
    (grad,) = torch.autograd.grad(loss, v0)
    assert_values_match(loss.detach(), jval)
    assert_grads_match(grad, jgrad)


def test_lattice_step_ext_force_grads_match_jax():
    """Control workload: gradients w.r.t. a force written into the state,
    through the full-step runner (the force consumed on the first
    substep)."""
    jspec, pspec, jcfg, pcfg = lattice_case()
    n_steps, dt = 1, 1 / 60
    jst = jlat.make_lattice_state(jspec, center=(0, 0.7, 0))
    ref_fn = jlat.make_step(jspec, jcfg, dt, n_steps)
    f0 = np.asarray([0.0, 2e-3, 0.0], np.float32)

    def jloss(f):
        s = jst.replace(ext_force=jnp.broadcast_to(f, jst.ext_force.shape))
        return jnp.sum(ref_fn(s).positions[:, 1])

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(f0))
    pst = plat.make_lattice_state(pspec, center=(0, 0.7, 0),
                                  device="cpu")
    run = kdiff.make_differentiable_lattice_step(pspec, pcfg, dt,
                                                 n_steps=n_steps)
    f = torch.as_tensor(f0).requires_grad_()
    loss = run(pst.replace(ext_force=f.expand(pst.n_particles, 3))
               ).positions[:, 1].sum()
    (grad,) = torch.autograd.grad(loss, f)
    assert_values_match(loss.detach(), jval)
    assert_grads_match(grad, jgrad)


def test_config6_diffsim_loss_drops():
    """The port's example 6 on the CPU, cut to 10 frames: gradient descent
    on the launch velocity through the paired lattice runner brings the
    centre of mass toward the target."""
    from softbodysimulation_tpu_torch.examples import config6_diffsim

    v0, hist = config6_diffsim.run(steps=10, opt_iters=3, verbose=False,
                                   device="cpu")
    assert all(np.isfinite(hist)) and hist[-1] < 0.5 * hist[0], hist
    assert v0[0] > 0
