"""Example 5 -- an ensemble of 1,024 independent bodies, their vertex
normals on the device and a headless frame export (BASELINE config 5).

Counterpart of ``softbodysimulation_tpu/examples/config5_batch_1024.py``:
1,024 res-4 lattices dropped from random heights advance together through
``solvers.lattice.make_batched_step`` (on the card the B-1 ensemble kernel:
every body in one launch a pass), then the normals of every body are
computed on the device (``ops.normals``) and, if asked, written to an npz
with the positions.  With several entries in the shard mesh
(``parallel.batch.make_mesh``), the bodies split into shards that step
apart (``make_sharded_lattice_step``).

    python -m softbodysimulation_tpu_torch.examples.config5_batch_1024
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..ops.normals import vertex_normals
from ..parallel import batch as pbatch
from ..solvers import lattice as lat
from ..topology import lattice


def make_ensemble(n_bodies: int = 1024, res: int = 4, device="cuda"):
    """(spec, config, batched state) of the example: ``n_bodies`` braced
    res^3 lattices at rest, scattered by seeded offsets (x, z in [-8, 8),
    y in [1, 4))."""
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=4, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
        ground_height=0.0, friction=0.3)
    rng = np.random.RandomState(42)
    base = lat.make_lattice_state(spec, device=device)
    batched = pbatch.replicate_state(base, n_bodies)
    offsets = np.stack([
        rng.uniform(-8, 8, n_bodies),
        rng.uniform(1.0, 4.0, n_bodies),
        rng.uniform(-8, 8, n_bodies),
    ], axis=1).astype(np.float32)
    return spec, cfg, batched.replace(
        positions=batched.positions + torch.as_tensor(
            offsets, device=batched.device)[:, None, :])


def run(n_bodies: int = 1024, res: int = 4, steps: int = 120,
        dt: float = 1 / 60, export_dir: str | None = None,
        verbose: bool = True, device="cuda", n_devices=None):
    """Returns ``(batched state, normals (B, N, 3))``.  ``n_devices``: the
    shard count of ``make_mesh`` (default one per card, one on the
    CPU)."""
    spec, cfg, batched = make_ensemble(n_bodies, res, device)
    mesh = pbatch.make_mesh(n_devices, device)
    if len(mesh) > 1 and n_bodies % len(mesh) == 0:
        step = pbatch.make_sharded_lattice_step(spec, cfg, dt, mesh,
                                                n_steps=steps)
        batched = pbatch.gather_batched_state(
            step(pbatch.shard_batched_state(batched, mesh)),
            batched.device)
    else:
        batched = lat.make_batched_step(spec, cfg, dt, n_bodies,
                                        n_steps=steps)(batched)

    # normals of the whole ensemble on the device; the host sees them only
    # at the export
    tris = lattice.lattice_surface_triangles(res)
    normals = vertex_normals(batched.positions, torch.as_tensor(tris))

    if export_dir:
        os.makedirs(export_dir, exist_ok=True)
        np.savez(os.path.join(export_dir, "ensemble_frame.npz"),
                 positions=batched.positions.cpu().numpy(),
                 normals=normals.cpu().numpy(), triangles=tris)

    if verbose:
        p = batched.positions
        unit = bool(torch.allclose(torch.linalg.norm(normals, dim=-1),
                                   torch.ones_like(normals[..., 0]),
                                   atol=1e-3))
        print(f"{n_bodies} bodies x {spec.n_particles} particles on "
              f"{len(mesh)} shard(s): "
              f"finite={bool(torch.isfinite(p).all())} "
              f"ymin={float(p[..., 1].min()):.4f} normals unit={unit}")
    return batched, normals


if __name__ == "__main__":
    run()
