"""Collision projections on (N, 3) tensors: the ground plane (two
semantics) and static sphere SDFs.

Counterpart of ``floor_project_xpbd``, ``floor_velocity_reflect`` and
``sphere_sdf_project`` of ``softbodysimulation_tpu/ops/collision.py`` with
the config's constant rigid world.  Traced kinematic collider poses
(``ColliderSet``) and box SDFs are not ported: the solvers refuse them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SolverConfig
from .distance import dot3
from .integrate import over_dt


def friction_step(cfg: SolverConfig, dt: float) -> float:
    """dt * clip(friction, 0, 1), multiplied in float32 as JAX does."""
    return float(np.float32(dt)
                 * np.float32(min(max(cfg.friction, 0.0), 1.0)))


def floor_project_xpbd(pred, prev_pos, inv_mass, dt, cfg: SolverConfig):
    """Position-level inequality ground constraint + positional friction
    (``SoftBodyCPU.cs:352-400``), applied to predicted positions during
    the solver iterations."""
    pen = cfg.ground_height - pred[:, 1]            # >0 when below ground
    denom = inv_mass + cfg.collision_compliance / (dt * dt)
    active = ((pen > 0) & (inv_mass >= cfg.static_inv_mass_eps)
              & (torch.abs(denom) >= cfg.eps_denominator))
    dl = pen / torch.where(active, denom, 1.0)
    dy = torch.where(active, inv_mass * dl, 0.0)
    pred = torch.stack([pred[:, 0], pred[:, 1] + dy, pred[:, 2]], dim=1)

    # positional friction on the tangential motion since step start
    vel = over_dt(pred - prev_pos, dt)
    vt = torch.stack([vel[:, 0], torch.zeros_like(vel[:, 1]), vel[:, 2]],
                     dim=1)
    return pred - torch.where(active[:, None], vt * friction_step(cfg, dt),
                              0.0)


def floor_velocity_reflect(pos, vel, inv_mass, dt, cfg: SolverConfig):
    """Velocity-level floor response of the flagship kernel
    ``ApplyFloorConstraint`` (``XPBDSoftBody.compute:272-316``): project to
    floor + offset, restitution plus penetration-proportional kick, and
    velocity-level friction scaled by a pseudo normal force."""
    gh = cfg.ground_height
    pen = gh - pos[:, 1]
    hit = (pen > 0) & (inv_mass > 0)
    new_y = torch.where(hit, gh + cfg.floor_offset, pos[:, 1])
    pos = torch.stack([pos[:, 0], new_y, pos[:, 2]], dim=1)

    falling = hit & (vel[:, 1] < 0)
    vy = torch.abs(vel[:, 1]) * cfg.restitution + pen * cfg.penetration_kick
    vel_y = torch.where(falling, vy, vel[:, 1])

    normal_force = torch.abs(vel_y) + pen * cfg.normal_force_scale
    h_speed = torch.sqrt(vel[:, 0] * vel[:, 0] + vel[:, 2] * vel[:, 2])
    moving = h_speed > 1e-3
    hs = torch.clamp(h_speed, min=1e-12)
    fmag = torch.minimum(h_speed,
                         normal_force * cfg.floor_friction_coeff * dt)
    slide = falling & moving
    dv0 = torch.where(slide, vel[:, 0] / hs * fmag, 0.0)
    dv2 = torch.where(slide, vel[:, 2] / hs * fmag, 0.0)
    vel = torch.stack([vel[:, 0] - dv0, vel_y, vel[:, 2] - dv2], dim=1)
    return pos, vel


def sphere_sdf_project(pred, prev_pos, inv_mass, dt, cfg: SolverConfig):
    """Project predicted positions out of ``cfg.sphere_colliders`` with
    positional friction in the contact tangent plane."""
    fr_dt = friction_step(cfg, dt)
    for cx, cy, cz, radius in cfg.sphere_colliders:
        center = torch.tensor([cx, cy, cz], dtype=pred.dtype,
                              device=pred.device)
        d = pred - center
        dist = torch.sqrt(dot3(d, d))
        n = d / torch.clamp(dist, min=1e-12)[:, None]
        pen = radius - dist
        active = (pen > 0) & (inv_mass >= cfg.static_inv_mass_eps)
        pred = pred + torch.where(active[:, None], n * pen[:, None], 0.0)
        vel = over_dt(pred - prev_pos, dt)
        vt = vel - dot3(vel, n)[:, None] * n
        pred = pred - torch.where(active[:, None], vt * fr_dt, 0.0)
    return pred
