"""Example 6 -- differentiable simulation (beyond the reference).

Counterpart of ``softbodysimulation_tpu/examples/config6_diffsim.py``:
finds, by gradient descent through the physics, the launch velocity that
lands a soft cube's centre of mass on a target after one second of
flight, bounce and all.  The rollout runs through
``make_differentiable_lattice_runner``: the CUDA lattice kernel carries
the forward, and the gradient is autograd through the plain stencil
engine at the same input (``kernels/diff.py``).

    python -m softbodysimulation_tpu_torch.examples.config6_diffsim
"""

from __future__ import annotations

import torch

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..kernels.diff import make_differentiable_lattice_runner
from ..solvers import lattice as lat
from ..topology import lattice


def run(res: int = 3, steps: int = 60, dt: float = 1 / 60,
        target=(1.5, 0.4, 0.0), lr: float = 4.0, opt_iters: int = 40,
        verbose: bool = True, device="cuda"):
    """Returns ``(learned v0 (3,) numpy, loss history)``; the loss must
    drop."""
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=2, iterations=2, damping=0.01,
        solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True, ground_height=0.0, friction=0.3)
    state0 = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    device=device)
    goal = torch.tensor(target, dtype=torch.float32, device=device)
    rollout = make_differentiable_lattice_runner(
        spec, cfg, dt / cfg.substeps, steps * cfg.substeps)

    def loss(v0):
        s = state0.replace(velocities=v0.expand(spec.n_particles, 3))
        com = rollout(s).positions.mean(dim=0)
        return ((com - goal) ** 2).sum()

    v0 = torch.zeros(3, device=device)
    history = []
    for _ in range(opt_iters):
        v = v0.clone().requires_grad_()
        value = loss(v)
        (grad,) = torch.autograd.grad(value, v)
        history.append(float(value.detach()))
        v0 = v0 - lr * grad
    final = float(loss(v0))
    if verbose:
        print(f"loss: {history[0]:.4f} -> {final:.6f} over "
              f"{opt_iters} gradient steps")
        print(f"learned launch velocity: {v0.cpu().numpy().round(3)}")
    return v0.cpu().numpy(), history + [final]


if __name__ == "__main__":
    run()
