"""SimState: the dynamic simulation state as a frozen dataclass of tensors.

Counterpart of ``softbodysimulation_tpu/core/state.py`` (``SimState``,
``is_finite``, ``snapshot``, ``restore``) with the same field names and
shapes, so a state crosses between the two packages field by field as
numpy arrays (``state_from_numpy`` / ``state_to_numpy``).  Positions are
``(N, 3)`` float32, x-major for lattices (index = (x*res + y)*res + z).

Tensors are never mutated in place by the solvers: every step returns a
new ``SimState`` (``replace``), as the JAX package does.  Kinematic
collider sets are not ported yet, so ``colliders`` stays ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

_TENSOR_FIELDS = ("positions", "velocities", "inv_mass", "ext_force",
                  "lambda_dist", "lambda_bend", "lambda_volume", "lambda_tet")


@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic simulation state (see the JAX package's ``SimState`` for the
    mapping of each field to the reference).  ``inv_mass == 0`` marks a
    pinned particle."""

    positions: torch.Tensor          # (N, 3) f32
    velocities: torch.Tensor         # (N, 3) f32
    inv_mass: torch.Tensor           # (N,)   f32; 0 = pinned
    ext_force: torch.Tensor          # (N, 3) f32; consumed on first substep
    lambda_dist: torch.Tensor        # (E,)   f32
    lambda_bend: torch.Tensor        # (H,)   f32 (H may be 0)
    lambda_volume: torch.Tensor      # ()     f32
    lambda_tet: Optional[torch.Tensor] = None   # (T,) f32 or None
    colliders: Optional[Any] = None  # kinematic rigid world: not ported

    @property
    def n_particles(self) -> int:
        return self.positions.shape[0]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SimState":
        """The state with every tensor on ``device`` (tensors already there
        are shared, as ``Tensor.to`` does)."""
        return _map(self, lambda t: t.to(device))


def _map(state: SimState, fn) -> SimState:
    return state.replace(**{
        k: fn(getattr(state, k)) for k in _TENSOR_FIELDS
        if getattr(state, k) is not None})


def state_from_numpy(fields: Dict[str, Any], device="cpu") -> SimState:
    """Build a state from a mapping of field name -> array-like (for example
    ``{k: np.asarray(getattr(jax_state, k)) ...}``).  ``lambda_tet`` may be
    missing or None; ``colliders`` must be missing or None."""
    if fields.get("colliders") is not None:
        raise NotImplementedError("kinematic ColliderSets are not ported")
    kw = {}
    for k in _TENSOR_FIELDS:
        a = fields.get(k)
        if a is None:
            if k != "lambda_tet":
                raise ValueError(f"state_from_numpy: field {k!r} missing")
            continue
        kw[k] = torch.as_tensor(np.array(a, np.float32), device=device)
    return SimState(**kw)


def state_to_numpy(state: SimState) -> Dict[str, Optional[np.ndarray]]:
    """Field name -> float32 numpy array (None for an absent lambda_tet)."""
    out: Dict[str, Optional[np.ndarray]] = {}
    for k in _TENSOR_FIELDS:
        t = getattr(state, k)
        out[k] = None if t is None else t.detach().cpu().numpy().copy()
    return out


def is_finite(state: SimState) -> bool:
    """True iff every dynamic quantity is finite (one host sync)."""
    ok = torch.isfinite(state.positions).all()
    ok &= torch.isfinite(state.velocities).all()
    ok &= torch.isfinite(state.lambda_dist).all()
    if state.lambda_bend.shape[0]:
        ok &= torch.isfinite(state.lambda_bend).all()
    if state.lambda_tet is not None and state.lambda_tet.shape[0]:
        ok &= torch.isfinite(state.lambda_tet).all()
    return bool(ok)


def snapshot(state: SimState) -> SimState:
    """Host-side deep copy for restart (SoftBodyGPU.cs:126-127)."""
    return _map(state, lambda t: t.detach().cpu().clone())


def restore(state_like: SimState, device=None) -> SimState:
    """Re-upload a snapshot (to ``device``, default: where it lies) and zero
    the multipliers and the force accumulator (RestartSimulation,
    SoftBodyGPU.cs:188-212)."""
    dev = _map(state_like, lambda t: t.to(
        t.device if device is None else device, copy=True))
    return dev.replace(
        lambda_dist=torch.zeros_like(dev.lambda_dist),
        lambda_bend=torch.zeros_like(dev.lambda_bend),
        lambda_volume=torch.zeros_like(dev.lambda_volume),
        lambda_tet=(None if dev.lambda_tet is None
                    else torch.zeros_like(dev.lambda_tet)),
        ext_force=torch.zeros_like(dev.ext_force),
    )
