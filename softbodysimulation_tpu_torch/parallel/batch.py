"""Ensembles of independent bodies, and their bodies split over devices.

Counterpart of ``softbodysimulation_tpu/parallel/batch.py``, with its
names.  An ensemble is a ``SimState`` whose leaves carry a leading body
axis (``core/state.LEAF_RANK``): ``stack_states`` builds one, and the
batched steps advance every body of one topology together -- on a CUDA
state in one launch a pass of the B-1 (lattice) or B-3 (mesh) ensemble
kernel, on a CPU state in their plain twins.

Where the JAX package splits the body axis over a device mesh with
``shard_map``, a mesh here is a tuple of ``torch.device`` entries, one per
shard (``make_mesh``; an entry may repeat, so 4 or 8 shards fit on one card
or on the CPU).  ``shard_batched_state`` gives each entry a contiguous slab
of bodies (a tuple of batched states, one per entry);
``gather_batched_state`` joins them.  A sharded step runs one ensemble call
per shard on its own device, and no shard reads another's tensors: bodies
are independent.  ``make_sharded_ensemble_diagnostics`` reduces each shard
on its device and combines the per-shard scalars on the first entry (the
``pmax`` / ``psum`` / ``pmean`` of JAX).  Shards in separate processes
(``torch.distributed``) are not carried.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.colliders import kin_counts
from ..core.config import SolverConfig
from ..core.state import (LEAF_RANK, SimState, body_count, body_of,
                          check_colliders, on_device, shared_leaves,
                          stack_bodies)
from ..kernels import diff as _diff
from ..kernels import lattice_cuda as _lattice_cuda
from ..kernels import mesh_cuda as _mesh_cuda
from ..solvers import general as _general

Shards = Tuple[SimState, ...]

_BODY_LEAVES = tuple(LEAF_RANK)


def stack_states(states: Sequence[SimState]) -> SimState:
    """Stack one-body states into one batched state (bodies on axis 0).
    Every tensor leaf gains the body axis, ``inv_mass`` too, as JAX's
    ``jax.tree.map(jnp.stack, ...)``; the bodies share one ColliderSet (or
    none)."""
    coll = states[0].colliders
    if any(s.colliders is not coll for s in states):
        raise ValueError("stack_states: an ensemble shares one ColliderSet "
                         "(the same object on every state, or none)")
    return states[0].replace(**{
        k: torch.stack([getattr(s, k) for s in states])
        for k in _BODY_LEAVES if getattr(states[0], k) is not None})


def _drop_body_axis(st: SimState) -> SimState:
    """(1, ...) batched slab -> one-body state (colliders untouched: a
    shared rigid world has no body axis)."""
    return st.replace(**{
        k: getattr(st, k)[0] for k in _BODY_LEAVES
        if getattr(st, k) is not None and getattr(st, k).ndim > 0})


def _add_body_axis(st: SimState) -> SimState:
    return st.replace(**{
        k: getattr(st, k)[None] for k in _BODY_LEAVES
        if getattr(st, k) is not None})


def replicate_state(state: SimState, n_bodies: int) -> SimState:
    """``n_bodies`` copies of one body as a batched state (every leaf gains
    the body axis, as JAX's ``broadcast_to``)."""
    return state.replace(**{
        k: getattr(state, k).expand(
            (n_bodies,) + tuple(getattr(state, k).shape)).contiguous()
        for k in _BODY_LEAVES if getattr(state, k) is not None})


def body_slice(batched: SimState, i: int) -> SimState:
    """Body ``i`` of a batched state (``core/state.body_of``)."""
    return body_of(batched, i)


def make_batched_step(step_fn: Callable[[SimState], SimState]):
    """A one-body ``state -> state`` run on every body of a batched state,
    the results stacked (JAX: ``vmap``; here a loop)."""
    def fn(batched: SimState) -> SimState:
        return stack_bodies(batched, [step_fn(body_of(batched, i))
                                      for i in range(body_count(batched))])

    return fn


def make_batched_lattice_step(spec, cfg: SolverConfig, dt: float,
                              n_steps: int = 1):
    """``n_steps`` frames of every body of a batched lattice state (the ext
    force consumed on the first substep): the B-1 ensemble on a CUDA state,
    the lane-folded plain engine on a CPU state; a shared ColliderSet acts
    on every body."""
    def fn(batched: SimState) -> SimState:
        return _lattice_cuda.make_cuda_step(
            spec, cfg, dt, n_steps, kin_colliders=kin_counts(
                batched.colliders),
            n_bodies=body_count(batched), batched=True)(batched)

    return fn


def make_batched_general_step(topo, cfg: SolverConfig, dt: float,
                              n_steps: int = 1):
    """``n_steps`` frames of every body of a batched mesh state
    (``solvers/general.make_batched_step``: the B-3 ensemble on a CUDA
    state, the plain engine body by body on a CPU state)."""
    return _general.make_batched_step(topo, cfg, dt, n_steps)


# ------------------------------------------------------------ the shards
def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> Tuple[torch.device, ...]:
    """``n_devices`` shard devices: the visible cards (or ``device``'s
    one), taken in turn, so that more shards than cards repeat them; the
    CPU when the caller asks for it.  ``n_devices=None``: one per card."""
    dev = on_device(device, "make_mesh")
    if dev.type == "cuda" and dev.index is None:
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [dev]
    count = len(avail) if n_devices is None else int(n_devices)
    if count < 1:
        raise ValueError("make_mesh: at least one shard")
    return tuple(avail[i % len(avail)] for i in range(count))


def _slab(batched: SimState, mesh) -> int:
    b = body_count(batched)
    if b % len(mesh):
        raise ValueError(f"n_bodies={b} must divide the {len(mesh)}-device "
                         f"mesh")
    return b // len(mesh)


def shard_batched_state(batched: SimState, mesh) -> Shards:
    """Split the body axis into ``len(mesh)`` contiguous slabs, slab s on
    ``mesh[s]`` (the shared leaves and the ColliderSet on every device)."""
    check_colliders(batched)
    m = _slab(batched, mesh)
    shared = shared_leaves(batched)
    out = []
    for s, dev in enumerate(mesh):
        kw = {}
        for k in _BODY_LEAVES:
            t = getattr(batched, k)
            if t is not None:
                kw[k] = (t if k in shared else t[s * m:(s + 1) * m]).to(dev)
        if batched.colliders is not None:
            kw["colliders"] = batched.colliders.to(dev)
        out.append(batched.replace(**kw))
    return tuple(out)


def gather_batched_state(shards: Shards, device=None) -> SimState:
    """The shards joined into one batched state on ``device`` (the first
    shard's device by default), bodies in shard order."""
    dev = shards[0].device if device is None else torch.device(device)
    first = shards[0]
    shared = shared_leaves(first)
    kw = {}
    for k in _BODY_LEAVES:
        t = getattr(first, k)
        if t is not None:
            kw[k] = (t.to(dev) if k in shared else torch.cat(
                [getattr(s, k).to(dev) for s in shards]))
    if first.colliders is not None:
        kw["colliders"] = first.colliders.to(dev)
    return first.replace(**kw)


def _per_shard(mesh, shards: Shards, run, colliders=None) -> Shards:
    """``run(shard)`` on every shard (each on its own device); with
    ``colliders``, one shared ColliderSet on every shard, the shards'
    own colliders back on the results."""
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards for a {len(mesh)}-device "
                         f"mesh")
    out = []
    for dev, st in zip(mesh, shards):
        if st.device != dev:
            raise ValueError(f"shard on {st.device}, mesh entry {dev}")
        if colliders is not None:
            res = run(st.replace(colliders=colliders.to(dev)))
            out.append(res.replace(colliders=st.colliders))
        else:
            out.append(run(st))
    return tuple(out)


def make_sharded_lattice_step(spec, cfg: SolverConfig, dt: float, mesh,
                              n_steps: int = 1, kin_colliders: bool = False):
    """The batched lattice step on every shard (``make_batched_lattice_step``
    per shard: the B-1 ensemble of the shard's bodies on a card).
    ``kin_colliders=True``: the step takes ``(shards, colliders)``, one
    shared ColliderSet acting on every body of every shard."""
    step = make_batched_lattice_step(spec, cfg, dt, n_steps)
    if not kin_colliders:
        return lambda shards: _per_shard(mesh, shards, step)
    return lambda shards, colliders: _per_shard(mesh, shards, step,
                                                colliders)


def pick_lattice_ensemble_backend(spec, device="cuda") -> str:
    """``"cuda"`` (the B-1 ensemble) for shards on a CUDA device, ``"xla"``
    (the lane-folded plain engine) on the CPU.  The JAX rule (res^2 < 128
    -> XLA, ``batch.py:135-143``) measures the TPU's 128-lane tiles and has
    no meaning here, so ``spec`` does not enter; it stays for the JAX
    signature."""
    return "cuda" if torch.device(device).type == "cuda" else "xla"


def make_sharded_pallas_rollout(spec, cfg: SolverConfig, dt_sub: float,
                                n_substeps: int, mesh, n_bodies: int,
                                kin_colliders=None, **kernel_kw):
    """``n_substeps`` raw substeps (no ext force, as the single-body runner)
    of every shard's bodies: the B-1 ensemble runner per shard
    (``make_cuda_substep_runner(..., n_bodies=B_local)``; a CPU shard runs
    its plain twin, the lane-folded engine), and
    ``stepper.ensemble_backend`` says which
    (``pick_lattice_ensemble_backend`` of the mesh's device).  One body a
    shard runs the single-body runner through ``_drop_body_axis`` /
    ``_add_body_axis``, as JAX bridges it.  ``n_bodies`` is the global
    count and must divide by the mesh size.  ``kin_colliders=(S, B)``: the
    stepper takes ``(shards, colliders)``, one shared ColliderSet on every
    body."""
    n_shards = len(mesh)
    if n_bodies % n_shards:
        raise ValueError(f"n_bodies={n_bodies} must divide the "
                         f"{n_shards}-device mesh")
    b_local = n_bodies // n_shards
    runner = _lattice_cuda.make_cuda_substep_runner(
        spec, cfg, dt_sub, n_substeps, n_bodies=b_local,
        kin_colliders=kin_colliders, **kernel_kw)
    if b_local == 1:
        # one body a shard: the n_bodies=1 runner speaks the one-body
        # contract, so bridge the slab's body axis
        inner = runner

        def runner(st):
            return _add_body_axis(inner(_drop_body_axis(st)))

    if kin_colliders is not None:
        def stepper(shards: Shards, colliders) -> Shards:
            return _per_shard(mesh, shards, runner, colliders)
    else:
        def stepper(shards: Shards) -> Shards:
            return _per_shard(mesh, shards, runner)
    stepper.ensemble_backend = pick_lattice_ensemble_backend(spec, mesh[0])
    return stepper


def make_sharded_mesh_pallas_rollout(topo, cfg: SolverConfig, dt_sub: float,
                                     n_substeps: int, mesh, n_bodies: int,
                                     per_body_mass: bool = False,
                                     **kernel_kw):
    """The B-3 ensemble per shard: ``n_substeps`` substeps of each shard's
    bodies in one runner call (``make_mesh_cuda_substep_runner(...,
    n_bodies=B_local, batched=True, with_ext=True)``; a CPU shard runs the
    plain engine body by body).  ``inv_mass`` is the shared ``(N,)`` leaf,
    on every shard, or with ``per_body_mass=True`` a ``(B, N)`` leaf split
    with the bodies.  ``n_bodies`` is the global count."""
    n_shards = len(mesh)
    if n_bodies % n_shards:
        raise ValueError(f"n_bodies={n_bodies} must divide the "
                         f"{n_shards}-device mesh")
    runner = _mesh_cuda.make_mesh_cuda_substep_runner(
        topo, cfg, dt_sub, n_substeps, with_ext=True,
        n_bodies=n_bodies // n_shards, batched=True,
        per_body_mass=per_body_mass, **kernel_kw)
    return lambda shards: _per_shard(mesh, shards, runner)


def make_differentiable_sharded_mesh_rollout(topo, cfg: SolverConfig,
                                             dt_sub: float, n_substeps: int,
                                             mesh, n_bodies: int,
                                             per_body_mass: bool = False,
                                             remat_chunk: int = 0,
                                             **kernel_kw):
    """``make_sharded_mesh_pallas_rollout`` with gradients: each shard's
    B-3 ensemble forward paired with autograd through the plain engine
    body by body (ext force consumed on the first substep, zeroed after;
    ``remat_chunk`` chunks the ext-free tail of the backward).  A loss over
    every shard's result differentiates back to each shard's leaves, and a
    shared ``inv_mass`` (one tensor handed to every shard) gathers the
    bodies' cotangents from all shards."""
    _diff._guard_exact_forward(kernel_kw)
    _diff._check_chunk(max(n_substeps - 1, 1), remat_chunk)
    n_shards = len(mesh)
    if n_bodies % n_shards:
        raise ValueError(f"n_bodies={n_bodies} must divide the "
                         f"{n_shards}-device mesh")
    kernel = _mesh_cuda.make_mesh_cuda_substep_runner(
        topo, cfg, dt_sub, n_substeps, with_ext=True,
        n_bodies=n_bodies // n_shards, batched=True,
        per_body_mass=per_body_mass, **kernel_kw)
    tail = _diff._substep_rollout(
        lambda s, p, k: _general.run_substeps_plain(s, topo, cfg, dt_sub, k),
        n_substeps - 1, remat_chunk) if n_substeps > 1 else None

    def one(state: SimState) -> SimState:
        s = _general.run_substeps_plain(state, topo, cfg, dt_sub, 1,
                                        with_ext=True)
        return s if tail is None else tail(s)

    run = _diff.pair_with_vjp(kernel,
                              lambda st: _diff._vmap_batched(one, st))
    return lambda shards: _per_shard(mesh, shards, run)


def make_sharded_general_step(topo, cfg: SolverConfig, dt: float, mesh,
                              n_steps: int = 1):
    """The batched general step on every shard (the B-3 ensemble of the
    shard's bodies on a card)."""
    step = make_batched_general_step(topo, cfg, dt, n_steps)
    return lambda shards: _per_shard(mesh, shards, step)


def make_sharded_ensemble_diagnostics(mesh, ground_height: float = 0.0):
    """``fn(shards) -> (vmax, bad, height, ground)`` over every body of
    every shard: the largest |velocity| component, the bodies with a
    non-finite position, the mean height and the particles within 0.01 of
    the ground.  Each shard reduces on its own device; the per-shard
    scalars are combined on ``mesh[0]`` (max, sum, mean -- the shards are
    equal in size, so the mean of their means is the global mean -- and
    sum)."""
    def fn(shards: Shards):
        parts = []
        for dev, st in zip(mesh, shards):
            if st.device != dev:
                raise ValueError(f"shard on {st.device}, mesh entry {dev}")
            p, v = st.positions, st.velocities
            y = p[..., 1]
            parts.append((v.abs().amax(),
                          (~torch.isfinite(p).all(dim=2).all(dim=1)).sum(),
                          y.mean(),
                          ((y - ground_height).abs() < 0.01).sum()))
        home = mesh[0]
        cols = [torch.stack([part[i].to(home) for part in parts])
                for i in range(4)]
        return cols[0].amax(), cols[1].sum(), cols[2].mean(), cols[3].sum()

    return fn
