"""Global volume (pressure) constraint, on tensors.

Counterpart of ``softbodysimulation_tpu/ops/volume.py``: one XPBD
constraint C = V - pressure * V0 over a closed surface, with the analytic
gradient of V at every vertex.  Each triangle (p1, p2, p3) adds
p1 . (p2 x p3) / 6 to V and the corner gradients cross(p2, p3) / 6,
cross(p3, p1) / 6 and cross(p1, p2) / 6 to its three vertices.

The sums are taken in the CUDA mesh kernel's order (``csrc/mesh_xpbd.cu``)
so that the kernel and this plain version agree to the bit:

* a vertex's gradient is the gather of its corner rows through the
  triangle-corner incidence table (``corner_incidence``: corner k of
  triangle t is row k*T + t of the stacked corner gradients), added in
  column order (``ops/incidence.gather_sum``) -- not a scatter, so that
  autograd runs through it and the kernel's particle pass sums the same
  rows in the same order;
* V and sum_i w_i |g_i|^2 are ``block_sum``s: the kernel's one block of
  ``BLOCK`` threads, thread t adding elements t, t + BLOCK, ... in order,
  then a halving tree.

Divisions by 6 divide by a 0-dim tensor: a Python-float divisor becomes a
multiply by its reciprocal on CUDA.  The target volume is the JAX engine's
float32 product of the pressure, rounded to float32, and the rest volume.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SolverConfig
from ..topology.build import build_incidence
from .bending import cross3
from .distance import dot3
from .incidence import Incidence, gather_sum, ordered_sum
from .integrate import scalar

# threads of the kernel's reduction block (MX_THREADS in csrc/mesh_xpbd.cuh;
# the mesh kernel refuses to build where the two differ)
BLOCK = 256


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of the (M,) tensor ``v`` as the kernel's reduction block
    takes it: zero-padded to a multiple of ``BLOCK``, each of the ``BLOCK``
    lanes adding its strided elements in order, then the lanes added
    pairwise, halving (lane t takes t + half)."""
    m = v.shape[0]
    k = max(1, -(-m // BLOCK))
    x = torch.cat([v, v.new_zeros(k * BLOCK - m)]).reshape(k, BLOCK)
    s = ordered_sum(x.T[:, :, None])[:, 0]
    half = BLOCK // 2
    while half:
        s = s[:half] + s[half:2 * half]
        half //= 2
    return s[0]


def corner_table(triangles: torch.Tensor, n: int):
    """(table, pad): the padded triangle-corner incidence of ``n``
    particles on the host (row i: the corner rows k*T + t with
    triangles[t, k] == i, ascending, padded with ``pad`` = 3T).  The one
    owner of the corner layout: the plain engine splits it
    (``corner_incidence``), the CUDA kernel takes it as CSR."""
    tri = triangles.cpu().numpy()
    inc = build_incidence(tri, n)
    return torch.as_tensor(inc.astype(np.int64)), 3 * tri.shape[0]


def corner_incidence(triangles: torch.Tensor, n: int) -> Incidence:
    """``corner_table`` split for ``gather_sum``, on the triangles'
    device."""
    table, pad = corner_table(triangles, n)
    return Incidence.of(table.to(triangles.device), pad)


def corner_terms(positions: torch.Tensor, triangles: torch.Tensor):
    """(corner gradients (3T, 3) stacked by corner, volume terms (T,)
    p1 . (p2 x p3)) of the triangles at ``positions``."""
    tri = triangles.long()
    p1, p2, p3 = (positions[tri[:, k]] for k in range(3))
    six = scalar(6.0, positions)
    c23 = cross3(p2, p3)
    grads = torch.cat([c23 / six, cross3(p3, p1) / six, cross3(p1, p2) / six])
    return grads, dot3(p1, c23)


def enclosed_volume(positions: torch.Tensor,
                    triangles: torch.Tensor) -> torch.Tensor:
    """The signed volume enclosed by the triangles, a 0-dim tensor."""
    _, terms = corner_terms(positions, triangles)
    return block_sum(terms) / scalar(6.0, terms)


def volume_gradients(positions: torch.Tensor, triangles: torch.Tensor,
                     incidence: Incidence = None) -> torch.Tensor:
    """dV/dp per vertex, (N, 3): each vertex's corner gradients added in
    column order (``incidence``: ``corner_incidence``, built here when not
    given)."""
    if incidence is None:
        incidence = corner_incidence(triangles, positions.shape[0])
    grads, _ = corner_terms(positions, triangles)
    return gather_sum(grads, incidence)


def volume_project(pred, inv_mass, triangles, rest_volume, lam, dt,
                   cfg: SolverConfig, incidence: Incidence = None):
    """One XPBD projection of the global volume constraint.  Returns
    (pred', lam').  alpha = volume_compliance / dt^2; a denominator of at
    most 1e-12 (a fully pinned body without compliance) gives dlambda 0
    through a safe divisor, so the VJP stays finite."""
    if incidence is None:
        incidence = corner_incidence(triangles, pred.shape[0])
    corners, terms = corner_terms(pred, triangles)
    v = block_sum(terms) / scalar(6.0, terms)
    c = v - scalar(cfg.pressure, rest_volume) * rest_volume
    grads = gather_sum(corners, incidence)
    s = block_sum(inv_mass * dot3(grads, grads))
    alpha = scalar(cfg.volume_compliance / (dt * dt), pred)
    denom = s + alpha
    valid = denom > 1e-12
    dl = (-c - alpha * lam) / torch.where(valid, denom, 1.0)
    dl = torch.where(valid, dl, 0.0)
    return pred + (inv_mass[:, None] * dl) * grads, lam + dl
