"""Example 8 -- the fused lattice kernel end to end: a braced lattice
settles on the floor with the whole interactive step (gravity, solve,
contacts, the external-force lifecycle) in the hand-written CUDA kernel
(``kernels.lattice_cuda.make_cuda_step``, the counterpart of
``make_pallas_step``), then gets poked.

Counterpart of ``softbodysimulation_tpu/examples/config8_fused_kernel.py``.
On the card the kernel runs; on the CPU its plain version does.

    python -m softbodysimulation_tpu_torch.examples.config8_fused_kernel
"""

from __future__ import annotations

import torch

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..kernels import lattice_cuda
from ..solvers import lattice as lat
from ..topology import lattice


def run(res: int = 6, steps: int = 40, dt: float = 1 / 60,
        poke_at: int = 20, verbose: bool = True, device="cuda"):
    """Returns the state after ``steps`` frames, a sideways impulse of
    2e-3 on every particle at frame ``poke_at``."""
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=4, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        ground_height=0.0, friction=0.3)
    state = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                   mass=0.001, device=device)
    step = lattice_cuda.make_cuda_step(spec, cfg, dt)
    for i in range(steps):
        if i == poke_at:
            # sideways impulse through the fused force lifecycle
            f = torch.zeros_like(state.ext_force)
            f[:, 0] = 2e-3
            state = state.replace(ext_force=f)
        state = step(state)

    if verbose:
        p = state.positions
        print(f"fused kernel: {spec.n_particles} particles x {steps} "
              f"frames  finite={bool(torch.isfinite(p).all())} "
              f"ymin={float(p[:, 1].min()):.4f} "
              f"com_x={float(p[:, 0].mean()):.4f}")
    return state


if __name__ == "__main__":
    run()
