"""Kinematic rigid-collider state: the rigid world as ``SimState`` leaves.

Counterpart of ``softbodysimulation_tpu/core/colliders.py`` (``ColliderSet``,
``make_colliders``, ``colliders_from_config``).  The collider POSES are
tensors carried by the state -- an ``(S, 4)`` sphere table ``(cx, cy, cz,
r)``, a ``(B, 6)`` box table ``(cx, cy, cz, hx, hy, hz)`` (axis-aligned
half-extents), a 0-dim ground height and the colliders' ``(S, 3)`` /
``(B, 3)`` world-frame velocities -- so a scripted collider animates by
replacing a leaf between steps, with no rebuild of a runner, and gradients
flow from a loss on the final state back to the poses.  The velocities
enter only the friction term (tangential damping acts on the particle
velocity relative to the collider); zeros reproduce the static-collider
arithmetic exactly.

When ``SimState.colliders`` is ``None`` every engine takes its rigid world
from the config; when present, the ColliderSet REPLACES the config's
``sphere_colliders``, ``box_colliders`` and ``ground_height``.  Counts are
static: a kernel runner is built for ``kin_colliders=(S, B)``.

Every helper is out of place (``Tensor.index_put``, never an in-place
write), so a pose that requires a gradient keeps its graph.
"""

from __future__ import annotations

import dataclasses

import torch

from .state import on_device

FIELDS = ("spheres", "boxes", "ground_height", "sphere_velocities",
          "box_velocities")


def _set(t: torch.Tensor, i: int, start: int, value) -> torch.Tensor:
    """``t`` with row ``i``, columns ``start:start + len(value)``, set to
    ``value`` (out of place, differentiable in both)."""
    value = torch.as_tensor(value, dtype=t.dtype, device=t.device).reshape(-1)
    cols = torch.arange(start, start + value.shape[0], device=t.device)
    return t.index_put((torch.full_like(cols, i), cols), value)


@dataclasses.dataclass(frozen=True)
class ColliderSet:
    """Traced rigid-world poses (module docstring)."""

    spheres: torch.Tensor             # (S, 4) f32
    boxes: torch.Tensor               # (B, 6) f32
    ground_height: torch.Tensor       # ()     f32
    sphere_velocities: torch.Tensor   # (S, 3) f32
    box_velocities: torch.Tensor      # (B, 3) f32

    @property
    def n_spheres(self) -> int:
        return self.spheres.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.boxes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def replace(self, **kw) -> "ColliderSet":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "ColliderSet":
        """The set with ``fn`` applied to each of its tensors."""
        return ColliderSet(**{k: fn(getattr(self, k)) for k in FIELDS})

    def to(self, device) -> "ColliderSet":
        return self.map(lambda t: t.to(device))

    def with_sphere(self, i: int, center=None, radius=None,
                    velocity=None) -> "ColliderSet":
        """Sphere ``i``'s pose (and the velocity of its friction frame)
        replaced where given."""
        s, sv = self.spheres, self.sphere_velocities
        if center is not None:
            s = _set(s, i, 0, center)
        if radius is not None:
            s = _set(s, i, 3, radius)
        if velocity is not None:
            sv = _set(sv, i, 0, velocity)
        return self.replace(spheres=s, sphere_velocities=sv)

    def with_box(self, i: int, center=None, half_extents=None,
                 velocity=None) -> "ColliderSet":
        b, bv = self.boxes, self.box_velocities
        if center is not None:
            b = _set(b, i, 0, center)
        if half_extents is not None:
            b = _set(b, i, 3, half_extents)
        if velocity is not None:
            bv = _set(bv, i, 0, velocity)
        return self.replace(boxes=b, box_velocities=bv)

    def with_ground(self, height) -> "ColliderSet":
        return self.replace(ground_height=torch.as_tensor(
            height, dtype=self.spheres.dtype,
            device=self.device).reshape(()))


def kin_counts(colliders) -> "tuple | None":
    """``(n_spheres, n_boxes)`` of a ColliderSet, None for None."""
    if colliders is None:
        return None
    return colliders.n_spheres, colliders.n_boxes


def check_kin(kin, colliders, who: str):
    """The call-time check of a runner built with ``kin_colliders=kin`` (or
    None) on a state carrying ``colliders`` (a ColliderSet or None), as the
    TPU kernels make it (``lattice_pallas.py:1660-1682``,
    ``mesh_pallas.py:2010-2035``): the counts must match, and a runner
    built without colliders refuses a state that carries them."""
    have = kin_counts(colliders)
    if kin is not None:
        if have is None:
            raise ValueError(
                f"{who} built with kin_colliders needs a state carrying a "
                f"ColliderSet (core.colliders.make_colliders)")
        if have != tuple(kin):
            raise ValueError(
                f"ColliderSet counts ({have[0]} spheres, {have[1]} boxes) "
                f"do not match the {who}'s kin_colliders=({kin[0]}, "
                f"{kin[1]})")
    elif have is not None:
        raise NotImplementedError(
            f"this {who} was built without kin_colliders; rebuild with "
            f"kin_colliders=(n_spheres, n_boxes) to animate colliders")


def per_collider_count(build):
    """``SimState -> SimState`` calling the runner ``build(kin_colliders)``
    makes for the state's collider counts (None without a ColliderSet),
    each built once, so animating poses rebuilds nothing.  The runner
    without colliders is built at once, so its build-time refusals surface
    here."""
    runners = {None: build(None)}

    def fn(state):
        kin = kin_counts(state.colliders)
        if kin not in runners:
            runners[kin] = build(kin)
        return runners[kin](state)

    return fn


def make_colliders(spheres=None, boxes=None, ground_height=0.0,
                   sphere_velocities=None, box_velocities=None,
                   dtype=torch.float32, device="cuda") -> ColliderSet:
    """A ColliderSet on ``device`` (the card unless the caller asks for the
    CPU).  ``spheres``: rows (cx, cy, cz, r) or an (S, 4) array; ``boxes``:
    rows (cx, cy, cz, hx, hy, hz) or (B, 6).  Velocities default to zeros
    (the static-collider friction frame).  A tensor argument already of
    ``dtype`` on ``device`` is kept as it is, gradient and all."""
    device = on_device(device, "make_colliders")

    def table(a, cols):
        if a is None:
            return torch.zeros((0, cols), dtype=dtype, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device).reshape(-1,
                                                                       cols)

    sph, box = table(spheres, 4), table(boxes, 6)
    sv = (table(sphere_velocities, 3) if sphere_velocities is not None
          else torch.zeros((sph.shape[0], 3), dtype=dtype, device=device))
    bv = (table(box_velocities, 3) if box_velocities is not None
          else torch.zeros((box.shape[0], 3), dtype=dtype, device=device))
    if sv.shape[0] != sph.shape[0] or bv.shape[0] != box.shape[0]:
        raise ValueError("collider velocity row counts must match poses")
    gh = torch.as_tensor(ground_height, dtype=dtype,
                         device=device).reshape(())
    return ColliderSet(spheres=sph, boxes=box, ground_height=gh,
                       sphere_velocities=sv, box_velocities=bv)


def colliders_from_config(cfg, device="cuda") -> ColliderSet:
    """The config's static rigid world as a ColliderSet:
    ``state.replace(colliders=colliders_from_config(cfg, device))``
    reproduces the config-constant behaviour exactly (same formulas, zero
    collider velocities), and from there the poses can be animated."""
    return make_colliders(spheres=(tuple(cfg.sphere_colliders) or None),
                          boxes=(tuple(cfg.box_colliders) or None),
                          ground_height=cfg.ground_height, device=device)
