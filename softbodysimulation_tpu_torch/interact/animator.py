"""Scripted force schedules and the kinematic rigid world, as functions of
time.

Counterpart of ``softbodysimulation_tpu/interact/animator.py``: the
coroutine animations of ``SoftBodyAnimator.cs:36-96`` as schedules that
map simulation time to an interaction impulse (``Curve``, a sampled
keyframe table evaluated by linear interpolation; ``ForceAnimation``,
``Pulse``, ``Squeeze``), and two rollouts: ``scheduled_rollout`` applies
the schedules before every step, ``kinematic_rollout`` installs each
step's collider poses from trajectory tensors.  Where the JAX package
scans (``lax.scan``), these are Python loops over the step function, so a
step on the card launches its kernels per frame; gradients flow from a
loss on the final state back to the trajectory tensors through the step's
own autograd (the plain engine, or a differentiable runner of
``kernels/diff.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..core.state import SimState
from .forces import add_force, squeeze_impulse


def _scalar(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Curve:
    """Piecewise-linear keyframe curve (AnimationCurve analog); clamped to
    the end values outside its times, as ``jnp.interp``."""

    times: Tuple[float, ...] = (0.0, 1.0)
    values: Tuple[float, ...] = (0.0, 1.0)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        ts = torch.tensor(self.times, dtype=t.dtype, device=t.device)
        vs = torch.tensor(self.values, dtype=t.dtype, device=t.device)
        k = torch.clamp(torch.searchsorted(ts, t.reshape(1), right=True)[0],
                        1, len(self.times) - 1)
        t0, t1, v0, v1 = ts[k - 1], ts[k], vs[k - 1], vs[k]
        frac = torch.clamp((t - t0) / (t1 - t0), 0.0, 1.0)
        return v0 + frac * (v1 - v0)

    @staticmethod
    def ease_in_out() -> "Curve":
        ts = tuple(i / 16 for i in range(17))
        vs = tuple(float(3 * t * t - 2 * t * t * t) for t in ts)
        return Curve(ts, vs)


@dataclasses.dataclass(frozen=True)
class ForceAnimation:
    """Curve-shaped directional force over a duration
    (``SoftBodyAnimator.AnimateForce``, ``SoftBodyAnimator.cs:42-57``)."""

    direction: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    max_force: float = 100.0
    duration: float = 2.0
    radius: float = 2.0
    curve: Curve = dataclasses.field(default_factory=Curve.ease_in_out)

    def apply(self, state: SimState, t, center) -> SimState:
        t = _scalar(t, state.positions)
        frac = torch.clamp(t / self.duration, 0.0, 1.0)
        mag = self.curve(frac) * self.max_force
        active = ((t >= 0.0) & (t <= self.duration)).to(t.dtype)
        d = _scalar(self.direction, state.positions)
        d = d / torch.clamp(torch.linalg.vector_norm(d), min=1e-9)
        return add_force(state, d * mag * active, center, self.radius)


@dataclasses.dataclass(frozen=True)
class Pulse:
    """Sinusoidal pulsing force (``SoftBodyAnimator.PulsingEffect``,
    ``SoftBodyAnimator.cs:59-69``)."""

    frequency: float = 1.0
    strength: float = 20.0
    radius: float = 1.0

    def apply(self, state: SimState, t, center) -> SimState:
        t = _scalar(t, state.positions)
        mag = (torch.sin(t * self.frequency * 2.0 * math.pi) * self.strength
               * (t >= 0.0).to(t.dtype))
        up = _scalar((0.0, 1.0, 0.0), state.positions)
        return add_force(state, up * mag, center, self.radius)


@dataclasses.dataclass(frozen=True)
class Squeeze:
    """sin-enveloped inward squeeze (``SoftBodyAnimator.SqueezeEffect``,
    ``SoftBodyAnimator.cs:76-94``)."""

    intensity: float = 1.0
    duration: float = 1.0
    radius: float = 3.0

    def apply(self, state: SimState, t, center) -> SimState:
        t = _scalar(t, state.positions)
        frac = torch.clamp(t / self.duration, 0.0, 1.0)
        envelope = torch.sin(frac * math.pi)
        active = ((t >= 0.0) & (t <= self.duration)).to(t.dtype)
        return squeeze_impulse(state, center,
                               self.intensity * envelope * active,
                               self.radius)


def scheduled_rollout(state: SimState, step_fn, animations, dt: float,
                      n_steps: int, t0: float = 0.0) -> SimState:
    """Run ``n_steps`` steps, each preceded by every scripted animation at
    its time.  ``animations``: ``(animation, start_time, center)`` triples
    (a ForceAnimation, Pulse or Squeeze gates itself to ``t >=
    start_time`` arithmetically, so entries that have not started or have
    expired add zero force).  Time is ``t0 + i * dt`` in float32, as the
    JAX scan computes it."""
    anims = [(a, float(st), c) for a, st, c in animations]
    for i in range(n_steps):
        t = torch.tensor(t0, dtype=torch.float32) + torch.tensor(
            float(i), dtype=torch.float32) * torch.tensor(
                dt, dtype=torch.float32)
        for anim, start, center in anims:
            state = anim.apply(state, t - start, center)
        state = step_fn(state)
    return state


def forward_velocities(traj: torch.Tensor, dt: float) -> torch.Tensor:
    """The collider velocity during step i of a pose trajectory ``(T, K,
    >= 3)``: ``(pose[i + 1] - pose[i]) / dt`` of the centers, the last step
    held (zero velocity), as a trajectory that stops there."""
    d = (traj[1:, :, :3] - traj[:-1, :, :3]) / torch.tensor(
        dt, dtype=traj.dtype, device=traj.device)
    return torch.cat([d, torch.zeros_like(d[:1])], dim=0)


def kinematic_rollout(state: SimState, step_fn, n_steps: int, dt: float,
                      sphere_traj=None, box_traj=None,
                      ground_traj=None) -> SimState:
    """Run ``n_steps`` steps with the rigid world scripted: before step i
    the state's ColliderSet takes pose i of each trajectory given
    (``sphere_traj`` (T, S, 4), ``box_traj`` (T, B, 6), ``ground_traj``
    (T,)), the collider velocities from ``forward_velocities``.  The state
    must carry a ColliderSet (``core.colliders.make_colliders``).
    Differentiable: a loss on the final state has gradients w.r.t. the
    trajectory tensors."""
    if state.colliders is None:
        raise ValueError("kinematic_rollout needs state.colliders "
                         "(make one with core.colliders.make_colliders)")
    sph_v = None if sphere_traj is None else forward_velocities(sphere_traj,
                                                                dt)
    box_v = None if box_traj is None else forward_velocities(box_traj, dt)
    for i in range(n_steps):
        c = state.colliders
        if sphere_traj is not None:
            c = c.replace(spheres=sphere_traj[i], sphere_velocities=sph_v[i])
        if box_traj is not None:
            c = c.replace(boxes=box_traj[i], box_velocities=box_v[i])
        if ground_traj is not None:
            c = c.replace(ground_height=ground_traj[i])
        state = step_fn(state.replace(colliders=c))
    return state
