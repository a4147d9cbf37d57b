"""Per-tetrahedron volume constraints, batched, on tensors.

Counterpart of ``softbodysimulation_tpu/ops/tet_volume.py``: the
volumetric XPBD constraint C_t = 6 (V_t - p V0_t) per tet (``p`` is
``tet_pressure``) with the analytic gradients of 6V

    g1 = (p2 - p0) x (p3 - p0),  g2 = (p3 - p0) x (p1 - p0),
    g3 = (p1 - p0) x (p2 - p0),  g0 = -(g1 + g2 + g3).

Cross products are taken component by component and dot products summed
x + y + z, in the JAX version's operation order, so that the CUDA mesh
kernel can repeat the arithmetic.  Rest volumes are stored as 6 V0.
"""

from __future__ import annotations

import torch

from ..core.config import SolverConfig
from .bending import cross3
from .distance import dot3
from .integrate import scalar


def tet_volume6(p0, p1, p2, p3):
    """6x the signed tet volume: dot(p1 - p0, cross(p2 - p0, p3 - p0))."""
    return dot3(p1 - p0, cross3(p2 - p0, p3 - p0))


def tet_volumes6(positions, tets):
    """(T,) 6x signed volumes for an index tensor of tets."""
    p = positions[tets.long()]                       # (T, 4, 3)
    return tet_volume6(p[:, 0], p[:, 1], p[:, 2], p[:, 3])


def tet_delta_lambda_rel(e1, e2, e3, w0, w1, w2, w3, rest_vol6, compliance,
                         lam, dt, cfg: SolverConfig):
    """XPBD projection in relative coordinates (e_i = p_i - p0).  Returns
    (delta_lambda, g0, g1, g2, g3); a degenerate or all-pinned tet
    (denominator <= ``eps_denominator``) yields delta_lambda 0."""
    g1 = cross3(e2, e3)
    g2 = cross3(e3, e1)
    g3 = cross3(e1, e2)
    g0 = -(g1 + g2 + g3)
    vol6 = dot3(e1, g1)
    c = vol6 - cfg.tet_pressure * rest_vol6
    # a true division by dt^2 (a Python-float divisor becomes a multiply by
    # its reciprocal on CUDA)
    alpha = compliance / scalar(dt * dt, compliance)
    denom = (w0 * dot3(g0, g0) + w1 * dot3(g1, g1) + w2 * dot3(g2, g2)
             + w3 * dot3(g3, g3) + alpha)
    valid = denom > cfg.eps_denominator
    dl = (-c - alpha * lam) / torch.where(valid, denom, 1.0)
    return torch.where(valid, dl, 0.0), g0, g1, g2, g3


def tet_delta_lambda(p0, p1, p2, p3, w0, w1, w2, w3, rest_vol6, compliance,
                     lam, dt, cfg: SolverConfig):
    """XPBD projection from absolute endpoint positions."""
    return tet_delta_lambda_rel(p1 - p0, p2 - p0, p3 - p0, w0, w1, w2, w3,
                                rest_vol6, compliance, lam, dt, cfg)
