"""SimState and Topology as frozen dataclasses of tensors.

Counterpart of ``softbodysimulation_tpu/core/state.py`` (``SimState``,
``Topology``, ``make_state``, ``state_from_topology``, ``is_finite``,
``snapshot``, ``restore``) with the same field names, dtypes and shapes, so
a state or a topology crosses between the two packages field by field as
numpy arrays (``state_from_numpy`` / ``state_to_numpy``,
``topology_from_numpy``).  Positions are ``(N, 3)`` float32, x-major for
lattices (index = (x*res + y)*res + z).

Tensors are never mutated in place by the solvers: every step returns a
new ``SimState`` (``replace``), as the JAX package does.  The constructors
put their tensors on the card unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device they raise (``on_device``).
``colliders`` is ``None`` or a kinematic rigid world
(``core/colliders.ColliderSet``) on the positions' device; ``_map``,
``snapshot`` and ``restore`` carry it.  An ensemble is a state whose
leaves carry a leading body axis (``LEAF_RANK``, ``body_of``,
``stack_bodies``); every function here that maps leaves takes one as it
is, one shared ColliderSet acting on every body.  The
topology carries no one-hot window matrices (``windows``, ``bend_windows``,
``tet_windows``): they are a layout for the TPU's matrix unit, and the
port's engines gather by index instead; it keeps ``tet_window_perm``, an
index table whose presence marks a topology built with tet windows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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
    colliders: Optional[Any] = None  # core/colliders.ColliderSet or None

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


def on_device(device, who: str = "state") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where there is none
    raises (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device here; pass device='cpu' to run the plain "
            f"PyTorch engine on the CPU")
    return dev


def _map(state: SimState, fn) -> SimState:
    kw = {k: fn(getattr(state, k)) for k in _TENSOR_FIELDS
          if getattr(state, k) is not None}
    if state.colliders is not None:
        kw["colliders"] = state.colliders.map(fn)
    return state.replace(**kw)


def check_colliders(state: SimState):
    """Refuse a state whose ColliderSet lies on another device than its
    positions (no engine moves it quietly)."""
    c = state.colliders
    if c is not None and c.device != state.device:
        raise ValueError(f"state colliders on {c.device}, positions on "
                         f"{state.device}: move both to one device "
                         f"(SimState.to)")


# ---- ensembles: leaves with a leading body axis ---------------------------

# a tensor leaf's rank in a one-body state; a leaf of one more dimension
# carries a leading body axis (JAX ``kernels/diff.py:_LEAF_RANK``).  An
# ensemble's dynamic leaves are always batched; ``inv_mass`` may stay a
# shared ``(N,)`` leaf (the JAX mesh ensemble's default,
# ``mesh_pallas.py:814-830``), and ``lambda_volume`` a shared scalar.
LEAF_RANK = {"positions": 2, "velocities": 2, "inv_mass": 1,
             "ext_force": 2, "lambda_dist": 1, "lambda_bend": 1,
             "lambda_volume": 0, "lambda_tet": 1}


def body_count(state: SimState) -> int:
    """The body count of a batched state (positions ``(B, N, 3)``)."""
    if state.positions.ndim != 3:
        raise ValueError(f"not a batched state: positions have shape "
                         f"{tuple(state.positions.shape)}")
    return state.positions.shape[0]


def shared_leaves(state: SimState) -> Tuple[str, ...]:
    """The leaves of a batched state that lack the body axis (shared by
    every body)."""
    return tuple(k for k, r in LEAF_RANK.items()
                 if getattr(state, k) is not None
                 and getattr(state, k).ndim == r)


def body_of(state: SimState, i: int) -> SimState:
    """Body ``i`` of a batched state as a one-body state: its row of every
    batched leaf, the shared leaves and the ColliderSet as they are."""
    shared = shared_leaves(state)
    return state.replace(**{k: getattr(state, k)[i] for k in LEAF_RANK
                            if getattr(state, k) is not None
                            and k not in shared})


def stack_bodies(like: SimState, bodies) -> SimState:
    """The one-body states ``bodies`` as one batched state: every leaf that
    is batched in ``like`` stacked along a new leading axis, the leaves
    ``like`` shares kept from ``like`` (``body_of``'s inverse)."""
    shared = shared_leaves(like)
    return like.replace(**{
        k: torch.stack([getattr(b, k) for b in bodies]) for k in LEAF_RANK
        if getattr(like, k) is not None and k not in shared})


def body_contract(n_bodies: int, batched) -> bool:
    """Whether a runner for ``n_bodies`` takes batched ``(B, ...)`` leaves:
    ``batched=None`` means iff ``n_bodies > 1``; ``batched=True`` at one
    body is a one-body shard of an ensemble (``mesh_pallas.py:846-852``)."""
    if n_bodies < 1:
        raise ValueError("n_bodies must be >= 1")
    if batched is None:
        return n_bodies > 1
    if not batched and n_bodies > 1:
        raise ValueError("n_bodies > 1 requires the batched contract")
    return bool(batched)


def check_bodies(state: SimState, count: int, who: str):
    """Refuse, at call time, a state that is not a batch of ``count``
    bodies."""
    if state.positions.ndim != 3 or state.positions.shape[0] != count:
        raise ValueError(f"{who}: built for {count} bodies, got positions "
                         f"of shape {tuple(state.positions.shape)}")


def state_from_numpy(fields: Dict[str, Any], device="cuda") -> SimState:
    """Build a state from a mapping of field name -> array-like (for example
    ``{k: np.asarray(getattr(jax_state, k)) ...}``).  ``lambda_tet`` may be
    missing or None; ``colliders`` may be missing, None, or a mapping of
    the five ColliderSet fields (``core/colliders.FIELDS``) to array-likes,
    such as a JAX ColliderSet's leaves as numpy.  The leaves of a batched
    state carry a leading body axis ``(B, ...)``, as a JAX ensemble's do
    (``inv_mass`` shared ``(N,)`` or per body ``(B, N)``); they cross
    unchanged."""
    from . import colliders as _colliders

    device = on_device(device, "state_from_numpy")
    coll = fields.get("colliders")
    if coll is not None:
        unknown = set(coll) - set(_colliders.FIELDS)
        if unknown:
            raise ValueError(f"state_from_numpy: unknown collider fields "
                             f"{sorted(unknown)}")
        coll = _colliders.make_colliders(
            **{k: np.array(coll[k], np.float32) for k in _colliders.FIELDS
               if coll.get(k) is not None}, device=device)
    kw = {}
    for k in _TENSOR_FIELDS:
        a = fields.get(k)
        if a is None:
            if k != "lambda_tet":
                raise ValueError(f"state_from_numpy: field {k!r} missing")
            continue
        kw[k] = torch.as_tensor(np.array(a, np.float32), device=device)
    return SimState(**kw, colliders=coll)


def state_to_numpy(state: SimState) -> Dict[str, Any]:
    """Field name -> float32 numpy array (None for an absent lambda_tet);
    a state with colliders adds ``"colliders"``, a mapping of its five
    fields to arrays (``state_from_numpy`` takes it back)."""
    def arr(t):
        return t.detach().cpu().numpy().copy()

    out: Dict[str, Any] = {}
    for k in _TENSOR_FIELDS:
        t = getattr(state, k)
        out[k] = None if t is None else arr(t)
    if state.colliders is not None:
        out["colliders"] = {f.name: arr(getattr(state.colliders, f.name))
                            for f in dataclasses.fields(state.colliders)}
    return out


# eq=False: a topology hashes by identity, so runners can cache what they
# derive from it (per-edge constants, device copies)
@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Static constraint topology (see the JAX package's ``Topology`` for the
    mapping of each field to the reference).

    edges / rest_lengths / compliance — distance constraints; colors and the
    padded per-color buckets ``col_*`` for the COLORED solve mode; hinges
    ([A, B, C, D], hinge edge A-B, tips C and D) with rest dihedral angles,
    compliances and their own colour buckets; surface triangles and the rest
    volume; per-particle constraint degrees; and the incidence lists of the
    scatter-free Jacobi accumulation (row i: indices of particle i's
    contributions in the stacked (2E,) edge or (4H,) hinge corrections,
    padded with 2E or 4H).
    """

    edges: torch.Tensor            # (E, 2) i32
    rest_lengths: torch.Tensor     # (E,)   f32
    compliance: torch.Tensor       # (E,)   f32
    colors: torch.Tensor           # (E,)   i32
    col_edge_ids: torch.Tensor     # (C, M) i32 — indices into edges
    col_valid: torch.Tensor        # (C, M) f32 — 1.0 valid / 0.0 padding
    hinges: torch.Tensor           # (H, 4) i32
    rest_angles: torch.Tensor      # (H,)   f32
    bend_compliance: torch.Tensor  # (H,)   f32
    bend_colors: torch.Tensor      # (H,)   i32
    bcol_hinge_ids: torch.Tensor   # (Cb, Mb) i32
    bcol_valid: torch.Tensor       # (Cb, Mb) f32
    triangles: torch.Tensor        # (T, 3) i32
    rest_volume: torch.Tensor      # ()     f32
    degree: torch.Tensor           # (N,)   f32
    bend_degree: torch.Tensor      # (N,)   f32
    incidence: torch.Tensor        # (N, Dd) i32 into 2E contributions
    bend_incidence: torch.Tensor   # (N, Db) i32 into 4H contributions
    num_colors: int
    num_bend_colors: int
    n_particles: int
    tets: Optional[torch.Tensor] = None              # (T, 4) i32
    rest_tet_volumes: Optional[torch.Tensor] = None  # (T,) f32, 6 x V0
    tet_compliance: Optional[torch.Tensor] = None    # (T,) f32
    tcol_tet_ids: Optional[torch.Tensor] = None      # (Ct, Mt) i32
    tcol_valid: Optional[torch.Tensor] = None        # (Ct, Mt) f32
    tet_degree: Optional[torch.Tensor] = None        # (N,) f32
    tet_incidence: Optional[torch.Tensor] = None     # (N, Dt) i32
    num_tet_colors: int = 0
    # (T,) i32 window slot -> tet, set by build_windowed_topology where
    # JAX's tet windows fit: the windowed tet backend's precondition
    tet_window_perm: Optional[torch.Tensor] = None

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def n_hinges(self) -> int:
        return self.hinges.shape[0]

    @property
    def n_tets(self) -> int:
        return 0 if self.tets is None else self.tets.shape[0]

    def replace(self, **kw) -> "Topology":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Topology":
        """The topology with every tensor on ``device``."""
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


_TOPO_INT = {f.name for f in dataclasses.fields(Topology)
             if f.type == "int"}
_TOPO_I32 = ("edges", "colors", "col_edge_ids", "hinges", "bend_colors",
             "bcol_hinge_ids", "triangles", "incidence", "bend_incidence",
             "tets", "tcol_tet_ids", "tet_incidence", "tet_window_perm")
# the JAX topology's one-hot window matrices, which the port does not carry
_TOPO_WINDOW_FIELDS = ("windows", "bend_windows", "tet_windows")


def topology_from_numpy(fields: Dict[str, Any],
                        device="cuda") -> Topology:
    """Build a topology from a mapping of field name -> array-like or int,
    for example ``{f.name: getattr(jax_topo, f.name) for f in
    dataclasses.fields(jax_topo)}``.  Integer tables become int32, the rest
    float32; the window fields are dropped; an absent tet field stays
    None."""
    device = on_device(device, "topology_from_numpy")
    kw = {}
    for f in dataclasses.fields(Topology):
        a = fields.get(f.name)
        if a is None and f.default is dataclasses.MISSING:
            raise ValueError(f"topology_from_numpy: field {f.name!r} missing")
        if f.name in _TOPO_INT:
            kw[f.name] = int(f.default if a is None else a)
        elif a is not None:
            dt = np.int32 if f.name in _TOPO_I32 else np.float32
            kw[f.name] = torch.as_tensor(np.array(a, dt), device=device)
    unknown = (set(fields) - {f.name for f in dataclasses.fields(Topology)}
               - set(_TOPO_WINDOW_FIELDS))
    if unknown:
        raise ValueError(f"topology_from_numpy: unknown fields "
                         f"{sorted(unknown)}")
    return Topology(**kw)


def make_state(positions, inv_mass=None, velocities=None,
               n_edges: Optional[int] = None, n_hinges: int = 0,
               n_tets: int = 0, mass: float = 1.0, dtype=torch.float32,
               device="cuda") -> SimState:
    """An initial state: uniform particle mass, inv_mass = 1/mass, with mass
    <= 1e-4 meaning pinned (``SoftBodyParticleCPU.cs:14-23``); zero
    velocities, force accumulator and multipliers."""
    device = on_device(device, "make_state")
    positions = torch.as_tensor(np.asarray(positions), dtype=dtype,
                                device=device)
    n = positions.shape[0]
    if velocities is None:
        velocities = torch.zeros_like(positions)
    else:
        velocities = torch.as_tensor(np.asarray(velocities), dtype=dtype,
                                     device=device)
    if inv_mass is None:
        inv = 0.0 if mass <= 1e-4 else 1.0 / mass
        inv_mass = torch.full((n,), inv, dtype=dtype, device=device)
    else:
        inv_mass = torch.as_tensor(np.asarray(inv_mass), dtype=dtype,
                                   device=device)
    if n_edges is None:
        raise ValueError("n_edges required (pass topology.n_edges)")
    return SimState(
        positions=positions,
        velocities=velocities,
        inv_mass=inv_mass,
        ext_force=torch.zeros_like(positions),
        lambda_dist=torch.zeros((n_edges,), dtype=dtype, device=device),
        lambda_bend=torch.zeros((n_hinges,), dtype=dtype, device=device),
        lambda_volume=torch.zeros((), dtype=dtype, device=device),
        lambda_tet=(torch.zeros((n_tets,), dtype=dtype, device=device)
                    if n_tets else None),
    )


def state_from_topology(topology: Topology, positions, **kw) -> SimState:
    return make_state(positions, n_edges=topology.n_edges,
                      n_hinges=topology.n_hinges, n_tets=topology.n_tets,
                      **kw)


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
    """Re-upload a snapshot to ``device`` (the card unless the caller asks
    for the CPU, as the JAX package's ``restore`` re-uploads to its default
    device) and zero the multipliers and the force accumulator
    (RestartSimulation, SoftBodyGPU.cs:188-212)."""
    device = on_device("cuda" if device is None else device, "restore")
    dev = _map(state_like, lambda t: t.to(device, copy=True))
    return dev.replace(
        lambda_dist=torch.zeros_like(dev.lambda_dist),
        lambda_bend=torch.zeros_like(dev.lambda_bend),
        lambda_volume=torch.zeros_like(dev.lambda_volume),
        lambda_tet=(None if dev.lambda_tet is None
                    else torch.zeros_like(dev.lambda_tet)),
        ext_force=torch.zeros_like(dev.ext_force),
    )
