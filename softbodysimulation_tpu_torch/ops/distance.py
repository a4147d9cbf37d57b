"""XPBD distance-constraint math, batched, on tensors.

Counterpart of ``softbodysimulation_tpu/ops/distance.py`` (semantics of
``CPUDistanceConstraint.Solve``, ``CPUDistanceConstraint.cs:46-117``), with
every guard and clamp as branchless masked arithmetic, in the JAX version's
operation order: the dot products are summed x + y + z, and every constant
is rounded to float32 before it meets a tensor, as JAX's weak typing
rounds it.
"""

from __future__ import annotations

import torch

from ..core.config import SolverConfig


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (..., 3) tensors, summed x + y + z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length_and_unit(d, approx_math: bool = False):
    """(length (K,), unit direction (K, 3)) of the (K, 3) vectors ``d``:
    ``sqrt(max(|d|^2, 1e-24))`` and ``d / length``, or with ``approx_math``
    (the mesh kernel's variant, ``mesh_pallas.py:1072-1075, 1103``)
    ``|d|^2 * rsqrt(max(|d|^2, 1e-24))`` and ``d * rsqrt``."""
    len_sq = dot3(d, d)
    if approx_math:
        inv = torch.rsqrt(torch.clamp(len_sq, min=1e-24))
        return len_sq * inv, d * inv[..., None]
    length = torch.sqrt(torch.clamp(len_sq, min=1e-24))
    return length, d / length[..., None]


def distance_delta_lambda(pa, pb, wa, wb, rest, compliance, lam, dt,
                          cfg: SolverConfig, approx_math: bool = False):
    """Per-constraint XPBD delta-lambda and unit gradient.

    All inputs batched over the leading axis.  Returns (dlambda (K,),
    normal (K,3)); invalid constraints (degenerate length, both endpoints
    static, tiny denominator) yield dlambda == 0.  ``approx_math``: the
    length and normal of ``length_and_unit``'s variant.
    """
    d = pb - pa
    length, n = length_and_unit(d, approx_math)

    c = length - rest
    alpha = compliance * (1.0 / (dt * dt))
    if cfg.min_alpha_tilde > 0:
        alpha = torch.clamp(alpha, min=cfg.min_alpha_tilde)
    denom = wa + wb + alpha

    valid = (
        (length >= cfg.eps_length)
        & (torch.abs(denom) >= cfg.eps_denominator)
        & ((wa >= cfg.static_inv_mass_eps) | (wb >= cfg.static_inv_mass_eps))
    )
    dl = (-c - alpha * lam) / torch.where(valid, denom, 1.0)
    if cfg.max_dlambda > 0:
        dl = torch.clamp(dl, -cfg.max_dlambda, cfg.max_dlambda)
    if cfg.max_dlambda_rel > 0:
        m = cfg.max_dlambda_rel * rest
        dl = torch.clamp(dl, -m, m)
    dl = torch.where(valid, dl, 0.0)
    return dl, n


def accumulate_lambda(lam, dl, cfg: SolverConfig):
    lam = lam + dl
    if cfg.lambda_clamp > 0:
        lam = torch.clamp(lam, -cfg.lambda_clamp, cfg.lambda_clamp)
    return lam


def constraint_error(positions, edges, rest):
    """|current length - rest| per edge (diagnostics,
    ``XPBDSoftBody.compute:256-266``)."""
    e = edges.long()
    d = positions[e[:, 1]] - positions[e[:, 0]]
    return torch.abs(torch.sqrt(dot3(d, d)) - rest)
