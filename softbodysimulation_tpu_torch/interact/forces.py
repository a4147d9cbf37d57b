"""Interaction verbs: poke / drag / squeeze / pin, as ``SimState ->
SimState`` updates.

Counterpart of ``softbodysimulation_tpu/interact/forces.py`` (``add_force``,
``add_uniform_force``, ``drag_force``, ``squeeze_impulse``, ``set_pinned``,
``pin_indices``, ``add_wind``).  Each verb computes against the live
positions on the state's device and returns a new state; a poke lands in
``ext_force`` and is consumed by the next step's first substep.

Divisions by a radius or a norm divide by a tensor: a Python-float divisor
is turned into a multiply by its reciprocal on CUDA, which rounds
differently from the true division the JAX package does (its verbs are
jitted with the radius traced), so a poke on the card would part from one
on the CPU by an ulp.  Distances are ``sqrt(x^2 + y^2 + z^2)`` in that
order on every device.
"""

from __future__ import annotations

import torch

from ..core.state import SimState
from ..ops.distance import dot3
from ..ops.normals import vertex_normals


def _vec(state: SimState, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=state.positions.dtype,
                           device=state.device)


def _falloff(dist: torch.Tensor, radius, state: SimState) -> torch.Tensor:
    """1 - dist / radius inside the radius, else 0 (a true division)."""
    r = _vec(state, radius)
    return torch.where(dist < r, 1.0 - dist / r, 0.0)


def add_force(state: SimState, force, position, radius=1.0) -> SimState:
    """Accumulate a radial linear-falloff force: falloff = 1 - d/radius for
    d < radius (``SoftBodySimulator.cs:930-937``)."""
    force = _vec(state, force)
    rel = state.positions - _vec(state, position)
    fall = _falloff(torch.sqrt(dot3(rel, rel)), radius, state)
    return state.replace(ext_force=state.ext_force + fall[:, None] * force)


def drag_force(state: SimState, target, strength=5.0,
               radius=2.0) -> SimState:
    """Continuous drag toward a cursor / target point
    (``SoftBodyInteractor.cs:61-66``): the unit direction from the centre
    of mass to the target, times ``strength``, applied with
    ``add_force``'s falloff around the target."""
    target = _vec(state, target)
    direction = target - state.positions.mean(dim=0)
    norm = torch.sqrt(dot3(direction, direction))
    unit = torch.where(norm > 1e-9,
                       direction / torch.clamp(norm, min=1e-9), 0.0)
    return add_force(state, unit * _vec(state, strength), target, radius)


def squeeze_impulse(state: SimState, center, intensity=1.0,
                    radius=3.0) -> SimState:
    """Inward radial squeeze (``SoftBodyAnimator.SqueezeEffect``,
    ``SoftBodyAnimator.cs:76-94``): 50 x intensity x falloff along the
    inward direction."""
    d = state.positions - _vec(state, center)
    dist = torch.sqrt(dot3(d, d))
    inward = -d / torch.clamp(dist, min=1e-9)[:, None]
    mag = _falloff(dist, radius, state) * _vec(state, intensity) * 50.0
    return state.replace(ext_force=state.ext_force + inward * mag[:, None])


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


def add_wind(state: SimState, topo, direction, strength: float = 1.0,
             gustiness: float = 0.0, seed: int = 0) -> SimState:
    """Aerodynamic wind load on the surface (JAX ``forces.py:63-84``): each
    vertex takes ``strength * |n . d|`` along the unit wind direction d,
    n its area-weighted unit normal (``ops/normals.vertex_normals`` over
    ``topo.triangles``), so faces square to the wind catch it and edge-on
    faces do not, on both sides of a sheet.  The direction is divided by
    max(|d|, 1e-9) as a tensor.

    ``gustiness > 0`` scales each magnitude by 1 + gustiness * u, u uniform
    in [-1, 1) from ``torch.Generator(device=state.device)`` seeded with
    ``seed``: the same seed on the same device gives the same forces, and
    every magnitude stays within ``strength * catch * (1 +- gustiness)``.
    JAX's PRNG stream has no counterpart without JAX (nor do the CPU's and
    the card's generators agree), so with gusts only those properties hold
    across packages and devices; without gusts the force is JAX's."""
    d = _vec(state, direction)
    d = d / torch.clamp(torch.sqrt(dot3(d, d)), min=1e-9)
    normals = vertex_normals(state.positions, topo.triangles)
    mag = dot3(normals, d).abs() * _vec(state, strength)
    if gustiness > 0:
        gen = torch.Generator(device=state.device).manual_seed(seed)
        u = torch.rand(mag.shape, generator=gen, dtype=mag.dtype,
                       device=state.device) * 2.0 - 1.0
        mag = mag * (1.0 + _vec(state, gustiness) * u)
    return state.replace(ext_force=state.ext_force + mag[..., None] * d)
