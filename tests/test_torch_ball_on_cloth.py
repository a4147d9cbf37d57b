"""The catalogued ``ball_on_cloth`` scene's contact physics with the port's
plain engine on the CPU (``tests/test_multibody.py:36-61`` of the JAX
package): a pressurized solid ball dropped onto a rim-pinned cloth comes to
rest on it, 120 frames of 6 substeps with dense contact on every substep.
The rollout without contact is in ``test_torch_multibody.py``.
"""

import numpy as np
import torch

from softbodysimulation_tpu_torch.core import scenes as pscenes

torch.set_num_threads(1)


def test_ball_rests_on_cloth():
    state, step, info = pscenes.ball_on_cloth(device="cpu")
    nc = info["n_cloth"]
    for _ in range(120):
        state = step(state)
    p = state.positions.numpy()
    assert np.isfinite(p).all()
    # on the sagging cloth: far above the floor (y = 0), no lower than a
    # trampoline's sag below the cloth's rest plane (y = 1)
    assert p[nc:, 1].min() > 0.55, p[nc:, 1].min()
    # the cloth deflected under the ball (contact is two-sided)
    assert p[:nc, 1].min() < 0.99, p[:nc, 1].min()
    # the rim held
    assert abs(p[:nc, 1].max() - 1.0) < 1e-4, p[:nc, 1].max()
