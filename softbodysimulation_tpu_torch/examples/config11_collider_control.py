"""Example 11 -- contact-rich control through a kinematic collider.

Counterpart of the JAX package's
``examples/config11_collider_control.py``: optimises a RIGID collider's
trajectory by gradient descent through the contact physics.  A kinematic
sphere sweeps through a soft cube resting on the floor and must shove it
so that its centre of mass lands on a target.
The loss differentiates through the whole rollout -- the sphere's SDF
projection, friction against the moving collider's velocity frame, floor
contact, constraint projection -- back to the sweep parameters, through
``interact.animator.kinematic_rollout`` and the state's ColliderSet.

``engine="fused"`` runs the forward in the CUDA mesh kernel (TPU kernel
B-3) with the sphere's pose in its collider table, and the gradient in the
hand-written fused backward (B-5) with its in-kernel pose cotangents;
``"xla"`` keeps the forward in the mesh kernel and takes the gradient by
autograd through the plain general engine (``kernels/diff.py``).

    python -m softbodysimulation_tpu_torch.examples.config11_collider_control
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.colliders import make_colliders
from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..interact import animator
from ..kernels.diff import make_differentiable_mesh_runner
from ..topology import build, lattice


def _sweep_traj(params, n_steps: int, start_x: float, radius: float):
    """(push, height, lateral) -> (T, 1, 4) sphere poses: a straight sweep
    from ``start_x`` along +x, at learned height and z-offset."""
    push, height, lateral = params[0], params[1], params[2]
    xs = start_x + torch.linspace(0.0, 1.0, n_steps, dtype=params.dtype,
                                  device=params.device) * push
    traj = torch.stack([xs, height.expand(n_steps), lateral.expand(n_steps),
                        torch.full_like(xs, radius)], dim=-1)
    return traj[:, None, :]


def run(res: int = 4, steps: int = 50, dt: float = 1 / 60,
        target=(0.55, 0.25), lr: float = 0.8, opt_iters: int = 30,
        radius: float = 0.28, verbose: bool = True, engine: str = "auto",
        device="cuda"):
    """Returns (learned params (3,) numpy, loss history).  ``target`` is
    the goal (x, z) for the soft cube's final centre of mass.  ``engine``:
    ``"fused"``, ``"xla"`` (module docstring) or ``"auto"`` (fused on the
    card, xla on the CPU, where the fused backward's plain version would
    only repeat the plain engine's work)."""
    if engine not in ("auto", "xla", "fused"):
        raise ValueError(f"engine must be auto|xla|fused, got {engine!r}")
    device = torch.device(device)
    if engine == "auto":
        engine = "fused" if device.type == "cuda" else "xla"
    pos = np.asarray(lattice.lattice_points(res, center=(0.0, 0.5, 0.0)),
                     np.float32)
    edges, comp = lattice.lattice_edges(res)
    cfg = SolverConfig(
        substeps=2, iterations=3, damping=0.02,
        solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True, ground_height=0.0, friction=0.4,
        **({"distance_backend": "windowed"} if engine == "fused" else {}))
    if engine == "fused":
        # the JAX example's fused path takes the windowed (RCM + sorted
        # edge) topology; kept, so both packages number the particles alike
        pos, topo = build.build_windowed_topology(pos, edges, comp)
    else:
        topo = build.build_topology(pos, edges, comp)
    start_x = -1.2
    state0 = state_from_topology(topo, pos, device=device).replace(
        colliders=make_colliders(spheres=[(start_x, 0.5, 0.0, radius)],
                                 ground_height=0.0, device=device))
    # one frame = substeps raw substeps (ext stays zero in this workload)
    step = make_differentiable_mesh_runner(
        topo, cfg, dt / cfg.substeps, cfg.substeps, backward=engine,
        kin_colliders=(1, 0))
    goal = torch.tensor(target, dtype=torch.float32, device=device)

    def loss(params):
        traj = _sweep_traj(params, steps, start_x, radius)
        out = animator.kinematic_rollout(state0, step, n_steps=steps, dt=dt,
                                         sphere_traj=traj)
        com = out.positions.mean(dim=0)
        return ((com[[0, 2]] - goal) ** 2).sum()

    def value_and_grad(params):
        p = params.clone().requires_grad_()
        value = loss(p)
        (grad,) = torch.autograd.grad(value, p)
        return float(value.detach()), grad

    # initial guess: a shallow straight poke that barely reaches the cube
    params = torch.tensor([0.9, 0.5, 0.0], dtype=torch.float32,
                          device=device)
    lo = torch.tensor([0.2, radius * 0.7, -0.8], device=device)
    hi = torch.tensor([3.0, 1.2, 0.8], device=device)
    history = []
    for _ in range(opt_iters):
        value, grad = value_and_grad(params)
        history.append(value)
        # keep the sweep physical: push forward, sphere above the floor
        params = torch.minimum(torch.maximum(params - lr * grad, lo), hi)
    final = value_and_grad(params)[0]
    history.append(final)
    if verbose:
        print(f"loss: {history[0]:.4f} -> {final:.5f} over {opt_iters} "
              f"gradient steps")
        print("learned sweep (push, height, lateral): "
              f"{params.cpu().numpy().round(3)}")
    return params.cpu().numpy(), history


if __name__ == "__main__":
    run()
