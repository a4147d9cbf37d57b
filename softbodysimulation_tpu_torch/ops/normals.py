"""Mesh post-processing on the device: vertex normals, bounds and the
centre of mass.

Counterpart of ``softbodysimulation_tpu/ops/normals.py``: the per-frame
``Mesh.RecalculateNormals`` / ``RecalculateBounds`` of the reference
(``SoftBodySimulator.cs:868-869``) as area-weighted face normals summed
per vertex (``index_add_`` in place of the segment sum), so a headless
export never reads the positions back to the host first.  Each function
takes one body's ``(N, 3)`` positions or an ensemble's ``(B, N, 3)``.
"""

from __future__ import annotations

import torch


def vertex_normals(positions: torch.Tensor,
                   triangles: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals of unit length, shaped as
    ``positions``; a vertex of no triangle (or a zero sum) gets +Y, as
    SafeNormalize does (``XPBDSoftBody.compute:57-61``)."""
    tri = torch.as_tensor(triangles, device=positions.device).long()
    p1 = positions[..., tri[:, 0], :]
    p2 = positions[..., tri[:, 1], :]
    p3 = positions[..., tri[:, 2], :]
    # |cross| = 2 x area: the area weighting
    face_n = torch.linalg.cross(p2 - p1, p3 - p1, dim=-1)
    idx = torch.cat([tri[:, 0], tri[:, 1], tri[:, 2]])
    acc = torch.zeros_like(positions).index_add_(
        positions.ndim - 2, idx, torch.cat([face_n, face_n, face_n], dim=-2))
    length = torch.linalg.norm(acc, dim=-1, keepdim=True)
    up = positions.new_tensor([0.0, 1.0, 0.0])
    return torch.where(length > 1e-12,
                       acc / torch.clamp(length, min=1e-12), up)


def bounds(positions: torch.Tensor):
    """(min, max) corners over the particles (RecalculateBounds)."""
    return positions.amin(dim=-2), positions.amax(dim=-2)


def center_of_mass(positions: torch.Tensor, inv_mass=None) -> torch.Tensor:
    """The centre used to recentre a readback (``SoftBodySimulator.cs:
    850-863``): the mean of the positions, mass-weighted when ``inv_mass``
    is given (pinned particles, ``inv_mass == 0``, weigh nothing)."""
    if inv_mass is None:
        return positions.mean(dim=-2)
    mass = torch.where(inv_mass > 0,
                       1.0 / torch.clamp(inv_mass, min=1e-12), 0.0)
    total = torch.clamp(mass.sum(dim=-1, keepdim=True), min=1e-12)
    return (positions * mass[..., None]).sum(dim=-2) / total
