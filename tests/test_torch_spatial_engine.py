"""The port's sharded lattice engine (``parallel/spatial.py``) against the
other engines it must track, on the CPU: the port's single-device stencil
engine at the JAX suite's own gates (1e-4, lambda 1e-3;
``tests/test_spatial_sharding.py``), itself at other slab counts (bit for
bit without tets), and JAX's fused ``make_spatial_pallas_substep`` in
interpret mode at that suite's shape (res 16 over 8 devices).  Its
comparison with JAX's XLA spatial engine is in ``test_torch_spatial.py``
and ``test_torch_spatial_solids.py``."""

import jax
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.kernels import spatial_pallas as jsp_pallas
from softbodysimulation_tpu.topology import lattice as jtop

from softbodysimulation_tpu_torch.parallel import spatial as psp
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_spatial_cases as cases
from test_torch_spatial import (CASES, DT, _diff, _jax_state, _port_state,
                                _run_port)
from test_torch_state import port_config

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_engine_tracks_single_device(name):
    """Every case against the port's single-device stencil engine at the JAX
    suite's gates (1e-4, lambda 1e-3).  Not bit for bit, not even at D = 1:
    the sharded engine takes dp = dl * (d / length) and the general
    engine's floor and sphere formulas, the stencil engine
    d * (dl / length) and its own, as the two JAX engines do.  The
    distance passes are bit for bit across D (the exchange moves values,
    it adds nothing: ``test_slab_count_does_not_change_the_bits``)."""
    cfg, inputs, d, res, frames = CASES[name]
    start, pout = _run_port(name)
    ref = plat.make_step(ptop.lattice_spec(res, braced=True),
                         port_config(cfg), DT, n_steps=frames)(start)
    dx = float((pout.positions - ref.positions).abs().max())
    dlam = float((pout.lambda_dist - ref.lambda_dist).abs().max())
    assert dx < 1e-4 and dlam < 1e-3, (dx, dlam)
    if cfg.enable_tet_volume:
        assert float((pout.lambda_tet - ref.lambda_tet).abs().max()) < 1e-3


@pytest.mark.parametrize("name", ["colored_reset", "jacobi_warm_start",
                                  "pinned", "velocity_reflect", "sphere",
                                  "tets"])
def test_slab_count_does_not_change_the_bits(name):
    """Without tets, D slabs give the one-slab result bit for bit: the
    exchange only moves planes.  The sharded tet sweep adds a slab's spill
    after its own terms, so tets agree to rounding (2e-6)."""
    cfg, inputs, d, res, frames = CASES[name]
    _, one = _run_port(name, n_slabs=1)
    for n in (2, 4):
        _, many = _run_port(name, n_slabs=n)
        dx = float((many.positions - one.positions).abs().max())
        if cfg.enable_tet_volume:
            assert 0.0 < dx < 2e-6, dx
        else:
            assert dx == 0.0 and torch.equal(many.lambda_dist,
                                             one.lambda_dist), (n, dx)


def test_sharded_engine_tracks_jax_spatial_pallas_interpret():
    """The JAX suite's fused-kernel shape (res 16 over the 8 devices,
    ``tests/test_spatial_pallas.py:23-34``), 2 frames: the port's sharded
    engine vs ``make_spatial_pallas_substep`` in interpret mode, at that
    suite's gates (1e-4, lambda 1e-3)."""
    from jax.sharding import Mesh

    cfg, inputs, _, res, _ = CASES["res16_over_8"]
    fields = cases.case_inputs(res, **inputs)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    jout = jsp_pallas.make_spatial_pallas_substep(
        jtop.lattice_spec(res, braced=True), cfg, DT, mesh, n_steps=2)(
        _jax_state(fields))
    pout = psp.make_spatial_lattice_step(
        ptop.lattice_spec(res, braced=True), port_config(cfg), DT,
        ["cpu"] * 8, n_steps=2)(_port_state(fields))
    assert _diff(jout, pout, "positions") < 1e-4
    assert _diff(jout, pout, "lambda_dist") < 1e-3
