"""Integration: predict and finalize phases, on (N, 3) tensors.

Counterpart of ``softbodysimulation_tpu/ops/integrate.py``:

predict  — semi-implicit Euler + damping + position prediction
           (``SoftBodyCPU.cs:294-301``; flagship ``XPBDSoftBody.compute:76-104``;
           optional velocity/force/world clamps from
           ``XPBDSimulatorCS.compute:55-92``).
finalize — v = (pred - x)/dt, x = pred, pinned particles frozen
           (``SoftBodyCPU.cs:314-324``).

Divisions by ``dt`` go through ``over_dt``: a Python-float divisor is
turned into a multiply by its reciprocal on CUDA, which rounds
differently from the true division the JAX version and the CUDA kernel do.
Constants reach the device without a copy from the host (``scalar``: a
fill; ``gravity``: one copy per device, cached), so a substep on the card
makes no host sync.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import DampingMode, SolverConfig


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype as a 0-dim tensor on its
    device, filled there (no copy from the host, so no sync)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=16)
def gravity(g: tuple, dtype, device) -> torch.Tensor:
    """The config's gravity as a (3,) tensor on ``device``, copied there
    once."""
    return torch.tensor(g, dtype=dtype, device=device)


def over_dt(a: torch.Tensor, dt: float) -> torch.Tensor:
    """``a / dt`` as a true float32 division on every device."""
    return a / scalar(dt, a)


def damping_factor(cfg: SolverConfig, dt: float) -> float:
    """The per-substep velocity multiplier, rounded as the JAX version
    rounds it (PER_STEP: 1 - clip(damping) in float32; PER_DT:
    1 - damping * dt in double, then float32)."""
    if cfg.damping_mode == DampingMode.PER_STEP:
        return float(np.float32(1.0)
                     - np.float32(min(max(cfg.damping, 0.0), 1.0)))
    return float(np.float32(1.0 - cfg.damping * dt))


def predict(positions, velocities, inv_mass, ext_force, dt,
            cfg: SolverConfig, apply_ext: bool = True):
    """Returns (pred_positions, new_velocities)."""
    g = gravity(tuple(cfg.gravity), positions.dtype, positions.device)
    ext = ext_force if apply_ext else torch.zeros_like(ext_force)
    if cfg.gravity_is_acceleration:
        if cfg.max_force > 0:
            ext = torch.clamp(ext, -cfg.max_force, cfg.max_force)
        active = (inv_mass > 0)[:, None]
        dv = dt * (torch.where(active, g[None, :], 0.0)
                   + inv_mass[:, None] * ext)
    else:
        force = g[None, :] + ext
        if cfg.max_force > 0:
            force = torch.clamp(force, -cfg.max_force, cfg.max_force)
        dv = dt * inv_mass[:, None] * force
    v = (velocities + dv) * damping_factor(cfg, dt)
    if cfg.max_velocity > 0:
        v = torch.clamp(v, -cfg.max_velocity, cfg.max_velocity)
    pred = positions + dt * v
    if cfg.world_bounds > 0:
        pred = torch.clamp(pred, -cfg.world_bounds, cfg.world_bounds)
    return pred, v


def finalize(positions, pred, inv_mass, dt):
    """Returns (new_positions, new_velocities)."""
    pinned = (inv_mass == 0.0)[:, None]
    v = torch.where(pinned, 0.0, over_dt(pred - positions, dt))
    x = torch.where(pinned, positions, pred)
    return x, v
