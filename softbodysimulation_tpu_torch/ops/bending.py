"""XPBD dihedral (bending) constraint math, batched and branchless, on
tensors.

Counterpart of ``softbodysimulation_tpu/ops/bending.py``
(``CPUBendingConstraint.Solve``, ``CPUBendingConstraint.cs:40-166``, with
the reference's control-flow bug fixed and its gradients replaced by the
autodiff-verified ones), differentiable by autograd: the arccos carries the
JAX version's clamped derivative (``_SafeArccos``).  The sinTheta
degeneracy guards are
masks: hard skip below ``bend_skip_sin_eps``, compliance softened by
``bend_soften_factor`` below ``bend_soften_sin_eps``.  Cross products are
taken component by component and dot products summed x + y + z, in the JAX
version's order, so that the CUDA mesh kernel can repeat the arithmetic.
"""

from __future__ import annotations

import torch

from ..core.config import SolverConfig
from .distance import dot3


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of (..., 3) tensors (``jnp.cross``'s terms)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def bending_delta_lambda(pa, pb, pc, pd, wa, wb, wc, wd, rest_angle,
                         compliance, lam, dt, cfg: SolverConfig,
                         approx_math: bool = False):
    """Returns (dlambda (K,), grad_a, grad_b, grad_c, grad_d each (K,3)).

    Hinge edge a-b, opposite tips c, d.  C = acos(n1.n2) - rest_angle with
    n1 = normalize((b-a) x (c-a)), n2 = normalize((d-a) x (b-a)).
    ``approx_math``: the normals scaled by the rsqrt of their squared
    lengths (the mesh kernel's variant, ``mesh_pallas.py:1193-1195``).
    """
    return bending_delta_lambda_rel(
        pb - pa, pc - pa, pd - pa, wa, wb, wc, wd, rest_angle,
        compliance, lam, dt, cfg, approx_math)


class _SafeArccos(torch.autograd.Function):
    """``torch.acos`` with the same forward bits and a clamped derivative
    (the custom JVP of the JAX version's ``_safe_arccos``).

    d/dx arccos = -1/sqrt(1 - x^2) is infinite at |x| = 1, a flat hinge (the
    rest state of any planar mesh), and a zero cotangent times that is NaN.
    Clamping 1 - x^2 at 1e-12 only changes lanes that ``bend_skip_sin_eps``
    already marks invalid."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.acos(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return -g / torch.sqrt(torch.clamp(1.0 - x * x, min=1e-12))


def _dihedral(e0, e1, e2, approx_math: bool = False):
    """(|n1|^2, |n2|^2, unit1, unit2, n1 / |n1|, n2 / |n2|, clipped cos)
    of the hinge normals n1 = e0 x e1, n2 = e2 x e0, where ``unit_k(v)``
    is ``v / |n_k|``, or with ``approx_math`` ``v * rsqrt(|n_k|^2)``."""
    n1 = cross3(e0, e1)
    n2 = cross3(e2, e0)
    l1sq = dot3(n1, n1)
    l2sq = dot3(n2, n2)
    if approx_math:
        i1 = torch.rsqrt(torch.clamp(l1sq, min=1e-24))[..., None]
        i2 = torch.rsqrt(torch.clamp(l2sq, min=1e-24))[..., None]

        def unit1(v):
            return v * i1

        def unit2(v):
            return v * i2
    else:
        l1 = torch.sqrt(torch.clamp(l1sq, min=1e-24))[..., None]
        l2 = torch.sqrt(torch.clamp(l2sq, min=1e-24))[..., None]

        def unit1(v):
            return v / l1

        def unit2(v):
            return v / l2
    n1n = unit1(n1)
    n2n = unit2(n2)
    cos = torch.clamp(dot3(n1n, n2n), -1.0, 1.0)
    return l1sq, l2sq, unit1, unit2, n1n, n2n, cos


def bending_delta_lambda_rel(e0, e1, e2, wa, wb, wc, wd, rest_angle,
                             compliance, lam, dt, cfg: SolverConfig,
                             approx_math: bool = False):
    """Same math in hinge-relative coordinates: e0 = pB-pA, e1 = pC-pA,
    e2 = pD-pA."""
    l1sq, l2sq, unit1, unit2, n1n, n2n, cos = _dihedral(e0, e1, e2,
                                                        approx_math)
    geom_ok = (l1sq >= 1e-9) & (l2sq >= 1e-9)
    angle = _SafeArccos.apply(cos)
    c = angle - rest_angle
    sin = torch.sin(angle)

    sin_ok = torch.abs(sin) >= cfg.bend_skip_sin_eps
    soften = torch.abs(sin) < cfg.bend_soften_sin_eps
    alpha = compliance * (1.0 / (dt * dt))
    alpha = torch.where(soften, alpha * cfg.bend_soften_factor, alpha)

    inv_sin = 1.0 / torch.where(sin_ok, sin, 1.0)

    # gradients of C = acos(n1.n2) - rest by the chain rule through the
    # normalized cross products (ops/bending.py of the JAX package):
    #   grad_b d = e1 x A + B x e2;  grad_c d = A x e0;  grad_d d = e0 x B
    #   grad C = -grad d / sin(theta)
    cos_b = cos[..., None]
    a_vec = unit1(n2n - cos_b * n1n)
    b_vec = unit2(n1n - cos_b * n2n)
    scale = (-inv_sin)[..., None]
    grad_b = scale * (cross3(e1, a_vec) + cross3(b_vec, e2))
    grad_c = scale * cross3(a_vec, e0)
    grad_d = scale * cross3(e0, b_vec)
    grad_a = -grad_b - grad_c - grad_d

    s = (wa * dot3(grad_a, grad_a) + wb * dot3(grad_b, grad_b)
         + wc * dot3(grad_c, grad_c) + wd * dot3(grad_d, grad_d))
    denom = s + alpha

    eps = cfg.static_inv_mass_eps
    any_dynamic = (wa >= eps) | (wb >= eps) | (wc >= eps) | (wd >= eps)
    valid = geom_ok & sin_ok & (denom >= 1e-9) & any_dynamic
    dl = (-c - alpha * lam) / torch.where(valid, denom, 1.0)
    if cfg.max_dlambda > 0:
        dl = torch.clamp(dl, -cfg.max_dlambda, cfg.max_dlambda)
    dl = torch.where(valid, dl, 0.0)
    vmask = valid[..., None]
    return (dl,
            torch.where(vmask, grad_a, 0.0),
            torch.where(vmask, grad_b, 0.0),
            torch.where(vmask, grad_c, 0.0),
            torch.where(vmask, grad_d, 0.0))


def hinge_masks(positions, hinges, cfg: SolverConfig):
    """Per hinge, the two masks of the sin(theta) bands at ``positions``:
    (sin >= bend_skip_sin_eps, sin < bend_soften_sin_eps).  Two runs that
    disagree on a mask took different branches of the bending update."""
    h = hinges.long()
    pa = positions[h[:, 0]]
    _, _, _, _, _, _, cos = _dihedral(positions[h[:, 1]] - pa,
                                      positions[h[:, 2]] - pa,
                                      positions[h[:, 3]] - pa)
    sin = torch.abs(torch.sin(torch.acos(cos)))
    return sin >= cfg.bend_skip_sin_eps, sin < cfg.bend_soften_sin_eps
