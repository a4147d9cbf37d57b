"""Example 10 -- material system identification (beyond the reference).

Counterpart of ``softbodysimulation_tpu/examples/config10_material_fit.py``:
recovers a soft body's rest lengths from an observed trajectory.  A
"ground-truth" icosphere is rolled out, the rest lengths are perturbed,
and gradient descent through the simulator fits them back.  The rollouts
run in the CUDA mesh kernel with traced materials, and the gradient is
the hand-written fused backward (TPU kernel B-5, ``csrc/mesh_diff_xpbd.cu``)
with its in-kernel rest-length and compliance cotangents
(``make_differentiable_material_runner``, ``backward="fused"``).

    python -m softbodysimulation_tpu_torch.examples.config10_material_fit
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..kernels.diff import make_differentiable_material_runner
from ..topology import build, mesh
from ..topology.edges import unique_edges


def run(subdiv: int = 1, n_substeps: int = 6, dt_sub: float = 1 / 240,
        perturb: float = 0.08, opt_iters: int = 8, seed: int = 0,
        verbose: bool = True, backward: str = "fused", device="cuda"):
    """Returns ``(initial_loss, final_loss, err0, err1)``: the fit must
    shrink both the trajectory loss and the mean rest-length error."""
    m = mesh.icosphere(subdiv)
    pos, topo = build.build_windowed_topology(
        m.vertices, unique_edges(m.triangles), 1e-4, triangles=m.triangles)
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.01,
                       solve_mode=SolveMode.JACOBI, jacobi_rho=0.0,
                       ground_height=-2.0)
    st = state_from_topology(topo, pos + np.array([0, 0.5, 0], np.float32),
                             device=device)
    rollout = make_differentiable_material_runner(
        topo, cfg, dt_sub, n_substeps, backward=backward)
    truth = topo.rest_lengths.to(device)
    comp = topo.compliance.to(device)
    target = rollout(st, {"rest_lengths": truth,
                          "compliance": comp}).positions.detach()

    def loss(rest):
        out = rollout(st, {"rest_lengths": rest, "compliance": comp})
        return ((out.positions - target) ** 2).sum()

    rng = np.random.default_rng(seed)
    rest = truth * torch.as_tensor(
        1.0 + perturb * rng.standard_normal(truth.shape[0]),
        dtype=torch.float32, device=device)
    err0 = float((rest - truth).abs().mean())
    l0 = float(loss(rest))
    for _ in range(opt_iters):
        r = rest.clone().requires_grad_()
        val = loss(r)
        (g,) = torch.autograd.grad(val, r)
        val = float(val.detach())
        lr = 0.25 * val / max(float((g * g).sum()), 1e-30)
        for _ in range(8):                       # backtracking line search
            trial = rest - lr * g
            if float(loss(trial)) < val:
                rest = trial
                break
            lr *= 0.25
    l1 = float(loss(rest))
    err1 = float((rest - truth).abs().mean())
    if verbose:
        print(f"trajectory loss: {l0:.3e} -> {l1:.3e} "
              f"({opt_iters} gradient steps)")
        print(f"mean |rest-length error|: {err0:.4f} -> {err1:.4f}")
    return l0, l1, err0, err1


if __name__ == "__main__":
    run()
