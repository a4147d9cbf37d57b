"""Diagnostics reductions, on the state's device.

Counterpart of ``softbodysimulation_tpu/diag/diagnostics.py`` (the
``ComputeDiagnostics`` kernel, ``XPBDSoftBody.compute:234-270``: max
velocity, constraint error, mean |lambda|, ground contacts, kinetic energy,
finiteness) and of the blocked self-collision backend's exactness checks,
``blocked_overflow`` and ``blocked_dropped_pairs``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import SolverConfig
from ..core.state import SimState, Topology
from ..ops import spatial_hash as _sh
from ..ops.distance import constraint_error, dot3


def diagnostics(state: SimState, topo: Topology,
                ground_height: float = 0.0) -> Dict[str, torch.Tensor]:
    """The reductions as 0-d tensors (``com`` a 3-vector) on the state's
    device; nothing leaves the device unless the caller reads it."""
    t = topo.to(state.device)
    speed = torch.linalg.norm(state.velocities, dim=1)
    err = constraint_error(state.positions, t.edges, t.rest_lengths)
    ground = torch.abs(state.positions[:, 1] - ground_height) < 0.01
    mass = torch.where(state.inv_mass > 0,
                       1.0 / torch.clamp(state.inv_mass, min=1e-12), 0.0)
    ke = 0.5 * torch.sum(mass * dot3(state.velocities, state.velocities))
    finite = (torch.isfinite(state.positions).all()
              & torch.isfinite(state.velocities).all()
              & torch.isfinite(state.lambda_dist).all())
    return {
        "max_velocity": speed.max(),
        "max_constraint_error": err.max(),
        "mean_constraint_error": err.mean(),
        "mean_abs_lambda": torch.abs(state.lambda_dist).mean(),
        "ground_contacts": ground.sum(),
        "kinetic_energy": ke,
        "is_finite": finite,
        "com": state.positions.mean(dim=0),
    }


def blocked_overflow(state: SimState, cfg: SolverConfig) -> int:
    """Worst-case AABB-touching neighbour blocks the blocked backend drops at
    the current positions (0 => the pass is exact here; conservative, see
    ``blocked_dropped_pairs``)."""
    order = _sh.morton_order(state.positions, cfg)
    return int(_sh.self_collision_blocked_overflow(
        state.positions, state.inv_mass, order, cfg))


def blocked_dropped_pairs(state: SimState, cfg: SolverConfig) -> int:
    """Pair-accurate exactness check of the blocked backend at the current
    positions: the directed contact pairs its top-M candidate selection
    misses (0 => its coverage equals the dense backend's here)."""
    order = _sh.morton_order(state.positions, cfg)
    return int(_sh.self_collision_blocked_dropped_pairs(
        state.positions, state.inv_mass, order, cfg))


def format_diagnostics(d: Dict[str, torch.Tensor]) -> str:
    """Human-readable one-liner (the Debug.Log analog,
    ``SoftBodySimulator.cs:629-630``)."""
    g = {k: v.detach().cpu() for k, v in d.items()}
    return (f"maxVel={float(g['max_velocity']):.3f} "
            f"maxErr={float(g['max_constraint_error']):.4f} "
            f"avgLambda={float(g['mean_abs_lambda']):.4f} "
            f"ground={int(g['ground_contacts'])} "
            f"KE={float(g['kinetic_energy']):.3f} "
            f"finite={bool(g['is_finite'])}")
