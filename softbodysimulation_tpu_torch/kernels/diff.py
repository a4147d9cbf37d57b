"""Differentiable runners: a kernel forward paired with the plain engine's
backward, and the factories of the differentiable path.

Counterpart of ``softbodysimulation_tpu/kernels/diff.py``.  The CUDA
kernels carry no autograd rules, and they compute the plain engines'
function (bit for bit for the mesh kernel, to float32 rounding for the
lattice kernel), so the gradient of a kernel rollout is taken as the
gradient of the plain engine at the same input:

  forward  -- the kernel, under ``no_grad`` (on a CPU state the kernel
              wrapper runs the plain engine);
  backward -- the plain engine re-run from the saved inputs with grad
              enabled, on the same device, then ``torch.autograd.grad``.

``pair_with_vjp`` and ``pair_with_vjp_params`` are that pairing as a
``torch.autograd.Function`` over the ``SimState`` tensor leaves, the
tensors of its ColliderSet (so gradients reach the collider poses) and
the materials.  ``remat_chunk = K`` runs the backward's replay as N/K chunks
under ``torch.utils.checkpoint``, so it holds O(N/K + K) states instead of
O(N).  ``make_differentiable_mesh_runner`` and
``make_differentiable_material_runner`` choose their backward:
``"xla"`` the pairing above (the name is the JAX package's: here it is
autograd through the plain engine), ``"fused"`` the hand-written B-5
backward (``kernels/mesh_diff.py``), ``"auto"`` fused where its envelope
covers the configuration, by the envelope alone.

The two ensemble runners pair the B-3 ensemble forward with autograd
through the plain engine body by body (``_vmap_batched``).  Not carried:
the TPU layout keywords (``block_edges``, ``synth_gd``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core.colliders import FIELDS as _COLLIDER_FIELDS
from ..core.colliders import ColliderSet
from ..core.state import SimState, body_count, body_of, stack_bodies

_LEAVES = ("positions", "velocities", "inv_mass", "ext_force", "lambda_dist",
           "lambda_bend", "lambda_volume", "lambda_tet")
_PARAMS = ("rest_lengths", "compliance")
# a ColliderSet's tensors, inputs of a rollout (its output state carries
# the same set): gradients reach the poses
COLLIDER_KEYS = tuple("colliders." + k for k in _COLLIDER_FIELDS)


def _flatten(state: SimState, params=None):
    """(keys, tensors) of a state's present leaves, its ColliderSet's
    tensors and the params."""
    keys = [k for k in _LEAVES if getattr(state, k) is not None]
    tensors = [getattr(state, k) for k in keys]
    if state.colliders is not None:
        keys += list(COLLIDER_KEYS)
        tensors += [getattr(state.colliders, k) for k in _COLLIDER_FIELDS]
    if params is not None:
        keys += list(_PARAMS)
        tensors += [params[k] for k in _PARAMS]
    return tuple(keys), tensors


def _unflatten(keys, tensors):
    """(state, params or None) from ``_flatten``'s output."""
    fields = dict(zip(keys, tensors))
    params = None
    if _PARAMS[0] in fields:
        params = {k: fields.pop(k) for k in _PARAMS}
    if COLLIDER_KEYS[0] in fields:
        fields["colliders"] = ColliderSet(**{
            k: fields.pop("colliders." + k) for k in _COLLIDER_FIELDS})
    return SimState(**fields), params


def _call(fn, state, params):
    return fn(state) if params is None else fn(state, params)


class _Paired(torch.autograd.Function):
    """Forward ``kernel_fn``, backward the VJP of ``plain_fn`` at the saved
    inputs."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, keys, *tensors):
        state, params = _unflatten(keys, tensors)
        out = _call(kernel_fn, state, params)
        ctx.plain_fn, ctx.keys = plain_fn, keys
        ctx.save_for_backward(*tensors)
        outs = []
        for k in keys:
            if k in _LEAVES:
                t = getattr(out, k)
                # a leaf the rollout passes through is returned as a view,
                # so that autograd gives the output a node of its own
                outs.append(t.view_as(t) if any(t is s for s in tensors)
                            else t)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_out):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            state, params = _unflatten(ctx.keys, ins)
            out = _call(ctx.plain_fn, state, params)
            pairs = [(getattr(out, k), g) for k, g in zip(
                [k for k in ctx.keys if k in _LEAVES], g_out)]
            pairs = [(o, g) for o, g in pairs if o.requires_grad]
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        ins, [g for _, g in pairs],
                                        allow_unused=True)
        return (None, None, None) + tuple(grads)


def _paired_apply(kernel_fn, plain_fn, state: SimState, params=None):
    keys, tensors = _flatten(state, params)
    outs = _Paired.apply(kernel_fn, plain_fn, keys, *tensors)
    return state.replace(**dict(zip([k for k in keys if k in _LEAVES],
                                    outs)))


def pair_with_vjp(kernel_fn, plain_fn):
    """``kernel_fn`` wrapped so that reverse mode flows through
    ``plain_fn``'s VJP.  Both are ``SimState -> SimState`` with the same
    semantics (a kernel runner and its plain engine's rollout)."""

    def run(state: SimState) -> SimState:
        return _paired_apply(kernel_fn, plain_fn, state)

    return run


def pair_with_vjp_params(kernel_fn, plain_fn):
    """``pair_with_vjp`` for runners that take a second differentiable
    argument, the materials ``{"rest_lengths": (E,), "compliance": (E,)}``:
    the forward runs ``kernel_fn(state, params)``, reverse mode flows
    through ``plain_fn(state, params)``'s VJP to the state leaves and both
    params."""

    def run(state: SimState, params) -> SimState:
        return _paired_apply(kernel_fn, plain_fn, state, params)

    return run


def _guard_exact_forward(kernel_kw: dict):
    """The pairing requires the exact-math kernel forward: ``approx_math``
    changes the kernel's arithmetic, so the plain backward would be
    linearized at a drifted trajectory (JAX's runners refuse it too)."""
    if kernel_kw.get("approx_math", False):
        raise NotImplementedError(
            "differentiable paired runners require the exact-math kernel "
            "forward: approx_math changes the kernel's arithmetic, so the "
            "plain backward would be linearized at a drifted trajectory. "
            "Drop approx_math for gradient work.")


def _check_chunk(n_substeps: int, remat_chunk: int):
    if remat_chunk and 0 < remat_chunk < n_substeps \
            and n_substeps % remat_chunk:
        raise ValueError(
            f"remat_chunk {remat_chunk} must divide n_substeps "
            f"{n_substeps}")


def _substep_rollout(run_k, n_substeps: int, remat_chunk: int = 0):
    """``(state, params=None) -> state`` advancing ``n_substeps`` through
    ``run_k(state, params, k)``, a plain engine's loop over ``k`` substeps
    (or, for the full-step runners, frames).  ``remat_chunk = K`` in (0, n_substeps) runs N/K calls of
    K, each under ``torch.utils.checkpoint``: reverse mode then keeps the
    N/K chunk-boundary states and one chunk in flight, replaying each
    chunk's identical arithmetic once more in the backward, so gradients
    equal the flat rollout's."""
    _check_chunk(n_substeps, remat_chunk)
    if not (remat_chunk and 0 < remat_chunk < n_substeps):
        return lambda state, params=None: run_k(state, params, n_substeps)

    def chunk(keys, *tensors):
        state, params = _unflatten(keys, tensors)
        out = run_k(state, params, remat_chunk)
        return tuple(getattr(out, k) for k in keys if k in _LEAVES)

    def roll(state, params=None):
        for _ in range(n_substeps // remat_chunk):
            keys, tensors = _flatten(state, params)
            outs = checkpoint(chunk, keys, *tensors, use_reentrant=False)
            state = state.replace(**dict(zip(
                [k for k in keys if k in _LEAVES], outs)))
        return state

    return roll


def make_differentiable_lattice_runner(spec, cfg, dt_sub: float,
                                       n_substeps: int,
                                       remat_chunk: int = 0, **kernel_kw):
    """Differentiable lattice rollout: the CUDA lattice kernel forward
    (``make_cuda_substep_runner``), the plain stencil engine's VJP backward
    (``remat_chunk`` bounds its memory, ``_substep_rollout``)."""
    _guard_exact_forward(kernel_kw)
    from ..solvers import lattice as lat
    from . import lattice_cuda

    kernel = lattice_cuda.make_cuda_substep_runner(spec, cfg, dt_sub,
                                                   n_substeps, **kernel_kw)
    plain = _substep_rollout(
        lambda s, p, k: lat.run_substeps_plain(s, spec, cfg, dt_sub, k),
        n_substeps, remat_chunk)
    return pair_with_vjp(kernel, plain)


def _check_cadence(cfg, remat_chunk, n):
    """A chunked plain replay restarts its substep count per chunk, so the
    self-collision cadence must divide the chunk."""
    if (cfg.enable_self_collision and remat_chunk and 0 < remat_chunk < n
            and remat_chunk % cfg.self_collision_every):
        raise ValueError(
            f"remat_chunk {remat_chunk} must be a multiple of "
            f"self_collision_every {cfg.self_collision_every}")


def _fused_chunk(remat_chunk, n_substeps):
    return (remat_chunk if remat_chunk and 0 < remat_chunk < n_substeps
            else None)


def make_differentiable_mesh_runner(topo, cfg, dt_sub: float,
                                    n_substeps: int, remat_chunk: int = 0,
                                    backward: str = "xla", **kernel_kw):
    """Differentiable mesh rollout over ``n_substeps`` raw substeps.

    ``backward``:

    * ``"xla"`` (default) -- the CUDA mesh kernel forward, autograd through
      the plain general engine backward; every configuration the kernel
      runs and every cotangent (``inv_mass`` included); ``remat_chunk``
      bounds its memory.
    * ``"fused"`` -- the hand-written B-5 backward
      (``mesh_diff.make_fused_differentiable_mesh_runner``): its envelope
      only (raises outside it), zero ``inv_mass`` / ``ext_force``
      cotangents; ``remat_chunk`` sets its chunk.
    * ``"auto"`` -- ``"fused"`` where the envelope covers the
      configuration, else ``"xla"``."""
    if backward not in ("xla", "fused", "auto"):
        raise ValueError(f"backward must be xla|fused|auto, got {backward}")
    _guard_exact_forward(kernel_kw)
    _check_chunk(n_substeps, remat_chunk)
    from . import mesh_diff

    kin = kernel_kw.get("kin_colliders")
    if backward == "fused" or (backward == "auto"
                               and mesh_diff.fused_envelope_ok(
                                   topo, cfg, n_substeps,
                                   kin_colliders=kin)):
        return mesh_diff.make_fused_differentiable_mesh_runner(
            topo, cfg, dt_sub, n_substeps,
            chunk_substeps=_fused_chunk(remat_chunk, n_substeps),
            kin_colliders=kin)
    _check_cadence(cfg, remat_chunk, n_substeps)
    from ..solvers import general
    from . import mesh_cuda

    kernel = mesh_cuda.make_mesh_cuda_substep_runner(topo, cfg, dt_sub,
                                                     n_substeps, **kernel_kw)
    plain = _substep_rollout(
        lambda s, p, k: general.run_substeps_plain(s, topo, cfg, dt_sub, k),
        n_substeps, remat_chunk)
    return pair_with_vjp(kernel, plain)


def make_differentiable_lattice_step(spec, cfg, dt: float, n_steps: int = 1,
                                     remat_chunk: int = 0):
    """Differentiable full-step lattice rollout: ``n_steps`` frames with the
    ext-force lifecycle (``ext_force`` consumed on the first substep and
    zeroed after), so gradients reach the forces a policy writes into the
    state.  Forward ``lattice_cuda.make_cuda_step``, backward the plain
    engine's ``multi_step_fn``."""
    from ..solvers import lattice as lat
    from . import lattice_cuda

    kernel = lattice_cuda.make_cuda_step(spec, cfg, dt, n_steps=n_steps)
    plain = _substep_rollout(
        lambda s, p, k: lat.multi_step_fn(s, spec, cfg, dt, k), n_steps,
        remat_chunk)
    return pair_with_vjp(kernel, plain)


def make_differentiable_mesh_step(topo, cfg, dt: float, n_steps: int = 1,
                                  remat_chunk: int = 0):
    """Differentiable full-step mesh rollout (ext-force lifecycle; a contact
    cadence routes as ``mesh_cuda.make_mesh_cuda_step`` routes it):
    forward the mesh kernel's step, backward the plain general engine's
    ``multi_step_fn``, self-collision included."""
    from ..solvers import general
    from . import mesh_cuda

    kernel = mesh_cuda.make_mesh_cuda_step(topo, cfg, dt, n_steps=n_steps)
    plain = _substep_rollout(
        lambda s, p, k: general.multi_step_fn(s, topo, cfg, dt, k), n_steps,
        remat_chunk)
    return pair_with_vjp(kernel, plain)


def make_differentiable_material_runner(topo, cfg, dt_sub: float,
                                        n_substeps: int,
                                        remat_chunk: int = 0,
                                        backward: str = "auto",
                                        **kernel_kw):
    """Differentiable-in-materials mesh rollout: ``fn(state, materials) ->
    SimState`` with ``materials = {"rest_lengths": (E,), "compliance":
    (E,)}`` (topology edge order, float32 on the state's device).  The
    forward runs the mesh kernel with the traced materials; gradients reach
    the state leaves and both material vectors.

    ``backward``: ``"fused"`` the B-5 backward with its in-kernel material
    cotangents (``mesh_diff.make_fused_differentiable_material_runner``;
    raises outside its envelope); ``"xla"`` autograd through the plain
    general engine at the traced materials; ``"auto"`` (default) fused
    where the envelope covers the configuration, else xla."""
    if backward not in ("xla", "fused", "auto"):
        raise ValueError(f"backward must be xla|fused|auto, got {backward}")
    _guard_exact_forward(kernel_kw)
    _check_chunk(n_substeps, remat_chunk)
    from . import mesh_diff

    if backward == "fused" or (backward == "auto"
                               and mesh_diff.fused_envelope_ok(
                                   topo, cfg, n_substeps, materials=True)):
        return mesh_diff.make_fused_differentiable_material_runner(
            topo, cfg, dt_sub, n_substeps,
            chunk_substeps=_fused_chunk(remat_chunk, n_substeps))
    _check_cadence(cfg, remat_chunk, n_substeps)
    from ..solvers import general
    from . import mesh_cuda

    kernel = mesh_cuda.make_mesh_cuda_substep_runner(topo, cfg, dt_sub,
                                                     n_substeps, **kernel_kw)
    plain = _substep_rollout(
        lambda s, p, k: general.run_substeps_plain(s, topo, cfg, dt_sub, k,
                                                   materials=p),
        n_substeps, remat_chunk)
    return pair_with_vjp_params(kernel, plain)


def _vmap_batched(one, state: SimState, *args) -> SimState:
    """The single-body rollout ``one`` over a batched state whose
    contract-legal shared leaves lack the body axis (JAX
    ``kernels/diff.py:339-355``): those leaves are broadcast for the
    bodies, so their cotangents sum back over the bodies through autograd,
    and come out with the shape they went in with.  ``one(state_i,
    *args_i)`` runs body by body (a loop: the plain engines do not trace
    under ``torch.func.vmap``); extra ``args`` carry the body axis."""
    b = body_count(state)
    bodies = [one(body_of(state, i), *(a[i] for a in args))
              for i in range(b)]
    return stack_bodies(state, bodies)


def make_differentiable_material_ensemble_runner(topo, cfg, dt_sub: float,
                                                 n_substeps: int,
                                                 n_bodies: int,
                                                 remat_chunk: int = 0,
                                                 **kernel_kw):
    """Differentiable heterogeneous-material farm (JAX ``diff.py:357-395``):
    ``fn(state, materials)`` with batched ``(B, ...)`` state leaves (a
    shared ``(N,)`` inv_mass) and per-body ``(B, E)`` ``rest_lengths`` /
    ``compliance`` (or shared ``(E,)`` ones).  The forward runs the B-3
    ensemble with them (every body in one launch a pass on the card); the
    backward is autograd through the plain engine body by body
    (``_vmap_batched``), so gradients come back per body, and a shared
    leaf's (inv_mass, shared materials) summed over the bodies.  ``remat_chunk`` bounds the backward's memory
    (``_substep_rollout``)."""
    _guard_exact_forward(kernel_kw)
    _check_chunk(n_substeps, remat_chunk)
    _check_cadence(cfg, remat_chunk, n_substeps)
    from ..solvers import general
    from . import mesh_cuda

    kernel = mesh_cuda.make_mesh_cuda_substep_runner(
        topo, cfg, dt_sub, n_substeps, n_bodies=n_bodies, batched=True,
        **kernel_kw)
    roll = _substep_rollout(
        lambda s, p, k: general.run_substeps_plain(s, topo, cfg, dt_sub, k,
                                                   materials=p),
        n_substeps, remat_chunk)

    def plain(state, materials):
        # shared (E,) materials broadcast to the bodies, so their
        # cotangent sums over them
        b = body_count(state)
        rest, comp = (m if m.ndim == 2 else m.expand(b, -1)
                      for m in (materials["rest_lengths"],
                                materials["compliance"]))
        return _vmap_batched(
            lambda s, r, c: roll(s, {"rest_lengths": r, "compliance": c}),
            state, rest, comp)

    return pair_with_vjp_params(kernel, plain)


def make_differentiable_mesh_ensemble_runner(topo, cfg, dt_sub: float,
                                             n_substeps: int, n_bodies: int,
                                             remat_chunk: int = 0,
                                             **kernel_kw):
    """Differentiable heterogeneous mesh farm (JAX ``diff.py:398-430``):
    the B-3 ensemble forward with ``per_body_mass=True`` (``inv_mass`` a
    per-body ``(B, N)`` leaf; replicate it for a homogeneous farm), the
    backward autograd through the plain engine body by body, so gradients
    reach every batched leaf, the per-body masses included (system
    identification)."""
    _guard_exact_forward(kernel_kw)
    _check_chunk(n_substeps, remat_chunk)
    _check_cadence(cfg, remat_chunk, n_substeps)
    from ..solvers import general
    from . import mesh_cuda

    kernel = mesh_cuda.make_mesh_cuda_substep_runner(
        topo, cfg, dt_sub, n_substeps, n_bodies=n_bodies, batched=True,
        per_body_mass=True, **kernel_kw)
    roll = _substep_rollout(
        lambda s, p, k: general.run_substeps_plain(s, topo, cfg, dt_sub, k),
        n_substeps, remat_chunk)
    return pair_with_vjp(kernel, lambda state: _vmap_batched(roll, state))
