"""Self-collision in the port's stencil engine (``solvers/lattice.py``)
against the JAX package's, on the CPU.

The scene of ``tests/test_contact_cadence.py:113-165``: a braced res-4
lattice with a contact radius of 0.55 x its spacing (neighbours overlap, so
the pass fires from the first substep), 3 substeps x 1 Jacobi iteration, a
floor.  For each self-collision backend and cadence 1, 2 and 3, the step
(``make_step``, two frames: the cadence counts substeps within a frame)
and the substep runner (``make_substep_runner``, 4 raw substeps: the
cadence counts the raw index) go through both packages from the same
state.  The JAX side is its ``make_step`` and ``make_substep_runner`` for
the default ``hash`` backend, and for the others the replay of its
``_substep`` with the contact pattern of those two functions, which
``tests/test_contact_cadence.py`` holds equal to them (one compiled
substep a backend, not one program a case, keeps this file cheap).  Gates:
max |dx| < 2e-5 (the JAX suite's own for its cadence replay) and max
|dlambda| < 1e-6.  The route each took is
checked too: ``"plain"`` at every substep, ``"hybrid"`` at a cadence that
divides the frame, ``"plain"`` otherwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu import SolveMode, SolverConfig
from softbodysimulation_tpu.solvers import lattice as jlat
from softbodysimulation_tpu.topology import lattice as jtop

from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

from test_torch_state import port_config, to_port

torch.set_num_threads(1)

DT = 1 / 60
SUBSTEPS = 3
FRAMES = 2
RUNNER_SUBSTEPS = 4
DX_TOL = 2e-5
DLAM_TOL = 1e-6
SPEC = jtop.lattice_spec(4, braced=True)


def contact_config(backend: str, every: int) -> SolverConfig:
    return SolverConfig(substeps=SUBSTEPS, iterations=1,
                        solve_mode=SolveMode.JACOBI,
                        enable_self_collision=True,
                        particle_radius=0.55 / 3,
                        self_collision_backend=backend,
                        collision_block_size=128, block_neighbors=2,
                        self_collision_every=every, ground_height=0.0,
                        friction=0.3, damping=0.05)


@functools.lru_cache(maxsize=None)
def jax_substep(backend: str):
    """JAX's ``_substep`` of the backend's config, compiled once, its
    ``apply_ext`` and ``contact_on`` static (the cadence reaches
    ``_substep`` only through ``contact_on``)."""
    cfg = contact_config(backend, 1)
    masks = jlat._masks_dev(SPEC)

    def sub(x, v, w, f, lam, apply_ext, contact_on):
        return jlat._substep(x, v, w, f, lam, SPEC, cfg, DT / SUBSTEPS,
                             apply_ext, masks, contact_on=contact_on)

    return jax.jit(sub, static_argnums=(5, 6))


def jax_replay(backend: str, every: int, js, step: bool):
    """JAX's step (``FRAMES`` frames: contact on substep j of a frame iff
    j % every == 0, ext force on the first frame's first substep) or
    runner (``RUNNER_SUBSTEPS`` raw substeps: iff i % every == 0), from
    its ``_substep``."""
    sub = jax_substep(backend)
    x, v, w, f, lam = jlat._to_grid(js, SPEC)
    if step:
        for frame in range(FRAMES):
            fr = f if frame == 0 else jnp.zeros_like(f)
            for j in range(SUBSTEPS):
                x, v, lam = sub(x, v, w, fr, lam, j == 0, j % every == 0)
    else:
        for i in range(RUNNER_SUBSTEPS):
            x, v, lam = sub(x, v, w, f, lam, False, i % every == 0)
    return jlat._from_grid(js, x, v, lam)


def jax_reference(backend: str, every: int, js, step: bool):
    if backend != "hash":
        return jax_replay(backend, every, js, step)
    cfg = contact_config(backend, every)
    if step:
        return jlat.make_step(SPEC, cfg, DT, n_steps=FRAMES)(js)
    return jlat.make_substep_runner(SPEC, cfg, DT / SUBSTEPS,
                                    RUNNER_SUBSTEPS)(js)


def gaps(jout, pout):
    return (float(np.abs(np.asarray(jout.positions)
                         - pout.positions.numpy()).max()),
            float(np.abs(np.asarray(jout.lambda_dist)
                         - pout.lambda_dist.numpy()).max()))


@pytest.mark.parametrize("every", [1, 2, 3])
@pytest.mark.parametrize("backend", ["hash", "dense", "blocked",
                                     "blocked_pallas", "sorted"])
def test_stencil_self_collision_matches_jax(backend, every):
    """Step and runner of both packages from the same state, and the
    routes the port took."""
    js = jlat.make_lattice_state(SPEC, center=(0.0, 0.6, 0.0))
    pspec, pcfg, ps = ptop.lattice_spec(4, braced=True), port_config(
        contact_config(backend, every)), to_port(js)
    step = plat.make_step(pspec, pcfg, DT, n_steps=FRAMES)
    runner = plat.make_substep_runner(pspec, pcfg, DT / SUBSTEPS,
                                      RUNNER_SUBSTEPS)
    want = ("plain" if every == 1 else
            "hybrid" if SUBSTEPS % every == 0 else "plain")
    assert step.route == runner.route == want
    for is_step, fn in ((True, step), (False, runner)):
        dx, dlam = gaps(jax_reference(backend, every, js, is_step), fn(ps))
        assert dx < DX_TOL and dlam < DLAM_TOL, (is_step, dx, dlam)


def test_cadence_changes_the_trajectory():
    """The discriminator of ``tests/test_contact_cadence.py``: every
    second substep is far from every substep, so the gates above cannot
    hide a wrong contact pattern; and the contact pass acts at all."""
    pspec = ptop.lattice_spec(4, braced=True)
    st = plat.make_lattice_state(pspec, center=(0.0, 0.6, 0.0),
                                 device="cpu")

    def run(cfg):
        return plat.make_step(pspec, port_config(cfg), DT,
                              n_steps=FRAMES)(st).positions

    one, two = (run(contact_config("dense", e)) for e in (1, 2))
    off = run(contact_config("dense", 1).replace(
        enable_self_collision=False))
    assert float((one - two).abs().max()) > 1e-4
    assert float((one - off).abs().max()) > 1e-3
