"""Interaction verbs: poke / pin, as ``SimState -> SimState`` updates.

Counterpart of ``softbodysimulation_tpu/interact/forces.py`` (``add_force``,
``add_uniform_force``, ``set_pinned``, ``pin_indices``).  Each verb
computes against the live positions on the state's device and returns a
new state; a poke lands in ``ext_force`` and is consumed by the next
step's first substep.
"""

from __future__ import annotations

import torch

from ..core.state import SimState


def _vec(state: SimState, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=state.positions.dtype,
                           device=state.device)


def add_force(state: SimState, force, position, radius=1.0) -> SimState:
    """Accumulate a radial linear-falloff force: falloff = 1 - d/radius for
    d < radius (``SoftBodySimulator.cs:930-937``)."""
    force = _vec(state, force)
    d = torch.linalg.norm(state.positions - _vec(state, position), dim=1)
    fall = torch.where(d < radius, 1.0 - d / radius, 0.0)
    return state.replace(ext_force=state.ext_force + fall[:, None] * force)


def add_uniform_force(state: SimState, force) -> SimState:
    return state.replace(
        ext_force=state.ext_force + _vec(state, force)[None, :])


def set_pinned(state: SimState, position, radius=0.5, pinned=True,
               mass: float = 1.0) -> SimState:
    """Pin/unpin particles within radius: inv_mass = 0 or 1/mass
    (``SoftBodySimulator.cs:944-959``)."""
    d = torch.linalg.norm(state.positions - _vec(state, position), dim=1)
    sel = d < radius
    new_w = 0.0 if pinned else 1.0 / mass
    inv_mass = torch.where(sel, new_w, state.inv_mass)
    vel = state.velocities
    if pinned:
        vel = torch.where(sel[:, None], 0.0, vel)
    return state.replace(inv_mass=inv_mass, velocities=vel)


def pin_indices(state: SimState, indices, pinned=True,
                mass: float = 1.0) -> SimState:
    """Pin/unpin explicit particle indices (``SoftBodyGPU.cs:284-285``)."""
    idx = torch.as_tensor(indices, dtype=torch.long, device=state.device)
    inv_mass = state.inv_mass.clone()
    inv_mass[idx] = 0.0 if pinned else 1.0 / mass
    vel = state.velocities
    if pinned:
        vel = vel.clone()
        vel[idx] = 0.0
    return state.replace(inv_mass=inv_mass, velocities=vel)
