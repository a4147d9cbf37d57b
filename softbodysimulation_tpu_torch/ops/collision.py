"""Collision projections on (N, 3) tensors: the ground plane (two
semantics) and sphere and axis-aligned box SDFs.

Counterpart of ``softbodysimulation_tpu/ops/collision.py``.  The engines
project against a ``RigidWorld``: tensors on the state's device, either a
``core/colliders.ColliderSet``'s traced poses (a 0-dim ground height, an
(S, 4) sphere table, a (B, 6) box table and the colliders' velocities,
which put the friction in each moving collider's frame) or the config's
constant ground, spheres and boxes with zero velocities, built once per
config and device.  Subtracting a zero velocity leaves every bit as it
was, so the config's rigid world and a ColliderSet take one path.  The
projections keep the JAX package's optional operands: left out, they are
the config's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.colliders import make_colliders
from ..core.config import SolverConfig
from .distance import dot3
from .integrate import over_dt


def friction_step(cfg: SolverConfig, dt: float) -> float:
    """dt * clip(friction, 0, 1), multiplied in float32 as JAX does."""
    return float(np.float32(dt)
                 * np.float32(min(max(cfg.friction, 0.0), 1.0)))


def _ground(cfg: SolverConfig, ground_height):
    return cfg.ground_height if ground_height is None else ground_height


def floor_project_xpbd(pred, prev_pos, inv_mass, dt, cfg: SolverConfig,
                       ground_height=None):
    """Position-level inequality ground constraint + positional friction
    (``SoftBodyCPU.cs:352-400``), applied to predicted positions during
    the solver iterations.  ``ground_height`` (a 0-dim tensor) overrides
    the config constant."""
    pen = _ground(cfg, ground_height) - pred[:, 1]  # >0 when below ground
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


def floor_velocity_reflect(pos, vel, inv_mass, dt, cfg: SolverConfig,
                           ground_height=None):
    """Velocity-level floor response of the flagship kernel
    ``ApplyFloorConstraint`` (``XPBDSoftBody.compute:272-316``): project to
    floor + offset, restitution plus penetration-proportional kick, and
    velocity-level friction scaled by a pseudo normal force.
    ``ground_height`` (a 0-dim tensor) overrides the config constant."""
    gh = _ground(cfg, ground_height)
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


def sphere_sdf_project(pred, prev_pos, inv_mass, dt, cfg: SolverConfig,
                       spheres=None, sphere_velocities=None):
    """Project predicted positions out of sphere colliders with positional
    friction in the contact tangent plane.  ``spheres`` ((S, 4)) overrides
    ``cfg.sphere_colliders``; ``sphere_velocities`` ((S, 3)) puts the
    friction in each moving collider's frame, so a sweeping sphere drags
    contacting particles along."""
    if spheres is None:
        spheres = RigidWorld.of(cfg, None, pred.device).spheres
    fr_dt = friction_step(cfg, dt)
    for k in range(spheres.shape[0]):
        center, radius = spheres[k, :3], spheres[k, 3]
        d = pred - center
        dist = torch.sqrt(dot3(d, d))
        n = d / torch.clamp(dist, min=1e-12)[:, None]
        pen = radius - dist
        active = (pen > 0) & (inv_mass >= cfg.static_inv_mass_eps)
        pred = pred + torch.where(active[:, None], n * pen[:, None], 0.0)
        vel = over_dt(pred - prev_pos, dt)
        if sphere_velocities is not None:
            vel = vel - sphere_velocities[k]
        vt = vel - dot3(vel, n)[:, None] * n
        pred = pred - torch.where(active[:, None], vt * fr_dt, 0.0)
    return pred


def box_sdf_project(pred, prev_pos, inv_mass, dt, cfg: SolverConfig,
                    boxes=None, box_velocities=None):
    """Project predicted positions out of axis-aligned boxes with
    positional friction.  A point inside a box is pushed out through its
    nearest face (the box SDF's interior gradient): along the axis of the
    smallest ``half - |local|``, ties to the first axis, on the side of
    ``sign(local)`` with ``sign(0) = +1``.  ``boxes`` ((B, 6)) overrides
    ``cfg.box_colliders``; ``box_velocities`` ((B, 3)) puts the friction
    in each moving collider's frame."""
    if boxes is None:
        boxes = RigidWorld.of(cfg, None, pred.device).boxes
    fr_dt = friction_step(cfg, dt)
    eye = torch.eye(3, dtype=pred.dtype, device=pred.device)
    for k in range(boxes.shape[0]):
        center, half = boxes[k, :3], boxes[k, 3:]
        local = pred - center
        face = half - torch.abs(local)              # > 0 inside, per axis
        inside = (face > 0).all(dim=1)
        active = inside & (inv_mass >= cfg.static_inv_mass_eps)
        axis = torch.argmin(face, dim=1)            # first of equal minima
        push = torch.gather(face, 1, axis[:, None])[:, 0]
        sign = torch.sign(torch.gather(local, 1, axis[:, None])[:, 0])
        sign = torch.where(sign == 0, 1.0, sign)
        row = eye[axis]
        pred = pred + torch.where(active[:, None],
                                  row * (sign * push)[:, None], 0.0)
        # positional friction in the face's tangent plane, relative to the
        # (possibly moving) collider
        n = row * sign[:, None]
        vel = over_dt(pred - prev_pos, dt)
        if box_velocities is not None:
            vel = vel - box_velocities[k]
        vt = vel - dot3(vel, n)[:, None] * n
        pred = pred - torch.where(active[:, None], vt * fr_dt, 0.0)
    return pred


# float32 columns of a row of the collider table (csrc/colliders.cuh KIN_W)
KIN_W = 9


@dataclasses.dataclass(frozen=True)
class RigidWorld:
    """The rigid world a substep projects against, as tensors on one
    device: a ColliderSet's traced poses, which replace the config's
    spheres, boxes and ground height, or the config's own as a
    ColliderSet with zero velocities (module docstring)."""

    ground: torch.Tensor               # ()
    spheres: torch.Tensor              # (S, 4)
    sphere_velocities: torch.Tensor    # (S, 3)
    boxes: torch.Tensor                # (B, 6)
    box_velocities: torch.Tensor       # (B, 3)

    @property
    def n_spheres(self) -> int:
        return self.spheres.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.boxes.shape[0]

    @staticmethod
    def of(cfg: SolverConfig, colliders, device) -> "RigidWorld":
        """The world of a state carrying ``colliders`` (a ColliderSet, or
        None for the config's) on ``device``."""
        if colliders is None:
            return _config_world(tuple(cfg.sphere_colliders),
                                 tuple(cfg.box_colliders), cfg.ground_height,
                                 str(torch.device(device)))
        c = colliders
        return RigidWorld(c.ground_height, c.spheres, c.sphere_velocities,
                          c.boxes, c.box_velocities)

    @functools.cached_property
    def table(self) -> torch.Tensor:
        """The float32 ``(1 + S + B, KIN_W)`` collider table the lattice and
        mesh kernels read on every launch (``csrc/colliders.cuh``): row 0
        the ground height, rows 1..S the spheres ``(cx, cy, cz, r, vx, vy,
        vz, 0, 0)``, rows 1+S..S+B the boxes ``(cx, cy, cz, hx, hy, hz,
        vx, vy, vz)`` -- the layout of the TPU kernels' traced pose block
        (``lattice_pallas.py:576-589``).  A few small tensor ops on the
        world's device, no host sync; once for a config's world."""
        dt, dev = self.spheres.dtype, self.spheres.device

        def zeros(rows, cols):
            return torch.zeros((rows, cols), dtype=dt, device=dev)

        return torch.cat([
            torch.cat([self.ground.reshape(1, 1), zeros(1, KIN_W - 1)], 1),
            torch.cat([self.spheres, self.sphere_velocities,
                       zeros(self.n_spheres, 2)], 1),
            torch.cat([self.boxes, self.box_velocities], 1)]).contiguous()

    def project_floor(self, pred, x, w, dt, cfg: SolverConfig):
        return floor_project_xpbd(pred, x, w, dt, cfg,
                                  ground_height=self.ground)

    def project_spheres(self, pred, x, w, dt, cfg: SolverConfig):
        return sphere_sdf_project(pred, x, w, dt, cfg, spheres=self.spheres,
                                  sphere_velocities=self.sphere_velocities)

    def project_boxes(self, pred, x, w, dt, cfg: SolverConfig):
        return box_sdf_project(pred, x, w, dt, cfg, boxes=self.boxes,
                               box_velocities=self.box_velocities)

    def reflect_floor(self, x, v, w, dt, cfg: SolverConfig):
        return floor_velocity_reflect(x, v, w, dt, cfg,
                                      ground_height=self.ground)


@functools.lru_cache(maxsize=64)
def _config_world(spheres, boxes, ground_height: float,
                  device: str) -> RigidWorld:
    """A config's rigid world on ``device`` (``spheres``, ``boxes``: its
    tuples of rows), built once."""
    c = make_colliders(spheres=spheres or None, boxes=boxes or None,
                       ground_height=ground_height, device=device)
    return RigidWorld.of(None, c, device)
