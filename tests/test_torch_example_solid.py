"""The port's example 9 (a Kuhn-tet jelly cube, COLORED, per-tet volumes)
against the JAX package's, on the CPU, at the JAX test's cut and gates
(``tests/test_examples.py:99-108``), in a file of its own: its 120 frames
of Gauss-Seidel colour sweeps take the plain engine about 40 s here.

The band against JAX is ``test_torch_examples.py``'s: within 1e-5, or 3x
JAX's own spread under a one-ulp nudge before every frame where the stiff
tets and the floor contact amplify rounding.
"""

import numpy as np
import torch

from softbodysimulation_tpu.examples import config9_tet_solid as j9

from softbodysimulation_tpu_torch.examples import config9_tet_solid as p9
from softbodysimulation_tpu_torch.ops.tet_volume import tet_volumes6

from test_torch_examples import hold_to_jax

torch.set_num_threads(1)


def test_config9_tet_solid(monkeypatch):
    state, topo = p9.run(res=4, steps=120, verbose=False, device="cpu")
    p = state.positions.numpy()
    assert np.isfinite(p).all()
    assert p[:, 1].min() > -5e-3          # resting on the floor
    v0 = float(topo.rest_tet_volumes.sum())
    v = float(tet_volumes6(state.positions, topo.tets).sum())
    assert abs(v / v0 - 1.0) < 0.02       # solid volume preserved
    hold_to_jax(monkeypatch, j9.run, j9.general, p, res=4, steps=120)
