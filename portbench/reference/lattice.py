"""The benchmark's plain reference for braced res^3 lattices: a frozen copy
of the port's stencil XPBD engine and of the lattice topology, in plain
PyTorch, importing nothing of the program.

It is the lane-folded ensemble form of the engine: B bodies lie side by
side along the lane axis, ``(3, res, B*res^2)``, and the per-family masks,
tiled per body, kill the rolls' wrap across a body as they kill it across
a row.  One body is B = 1, whose layout is the single-body engine's, so
one loop serves both.  A substep is: the multipliers reset or decayed;
predict (gravity, the first substep's external force, damping, clamps);
under WARM_START one pre-apply pass a family; per iteration one Jacobi
(or two parity) passes a family, then the XPBD floor; finalize.

Only what a lattice configuration of the benchmark states is covered: no
tets, spheres, boxes, self-collision or velocity-reflect floor (``Engine``
refuses a configuration that asks for them).  Every constant is worked
out here from the configuration's sizes, in the order and precision of
the engine it copies, so that on one device the two agree to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

# (dx, dy, dz, kind), kind 0 structural, 1 shear, 2 bend: both diagonals
# of every face and all four cube diagonals
BRACED_FAMILIES: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0),
    (1, 1, 0, 1), (1, -1, 0, 1), (1, 0, 1, 1), (1, 0, -1, 1),
    (0, 1, 1, 1), (0, 1, -1, 1),
    (1, 1, 1, 2), (1, 1, -1, 2), (1, -1, 1, 2), (1, -1, -1, 2),
)

# the solver settings the engine reads; a configuration states each
SETTINGS = ("substeps", "iterations", "gravity", "gravity_is_acceleration",
            "damping", "damping_mode", "max_velocity", "max_force",
            "world_bounds", "solve_mode", "omega", "lambda_mode",
            "lambda_decay", "max_dlambda", "max_dlambda_rel", "lambda_clamp",
            "warm_start_clamp", "warm_start_fraction", "min_alpha_tilde",
            "floor_mode", "ground_height", "collision_compliance",
            "friction", "eps_length", "eps_denominator",
            "static_inv_mass_eps", "fast_math")


def lattice_points(res: int, size=(1.0, 1.0, 1.0),
                   center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """``(res^3, 3)`` float32 particle grid, index (x*res + y)*res + z."""
    size = np.asarray(size, dtype=np.float64)
    spacing = size / (res - 1)
    idx = np.arange(res, dtype=np.float64)
    axes = [idx * spacing[k] - size[k] * 0.5 for k in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return (pts + np.asarray(center, np.float64)).astype(np.float32)


def family_masks(res: int):
    """Per family ``(valid, parity0)``, boolean ``(res, res*res)``: the
    anchor has its partner in bounds; its coordinate along the family's
    leading axis is even."""
    xx, yy, zz = np.meshgrid(np.arange(res), np.arange(res), np.arange(res),
                             indexing="ij")
    out = []
    for dx, dy, dz, _ in BRACED_FAMILIES:
        valid = np.ones((res, res, res), bool)
        for coord, d in ((xx, dx), (yy, dy), (zz, dz)):
            if d > 0:
                valid &= coord < res - d
            elif d < 0:
                valid &= coord >= -d
        lead = xx if dx else (yy if dy else zz)
        out.append((valid.reshape(res, res * res),
                    ((lead % 2) == 0).reshape(res, res * res)))
    return out


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A braced lattice's sizes and per-family constants, from the
    configuration's own numbers."""

    res: int
    size: Tuple[float, float, float]
    rest: Tuple[float, ...]
    compliance: Tuple[float, ...]

    @staticmethod
    def of(conf: Dict) -> "Lattice":
        body = conf["body"]
        if not body["braced"]:
            raise NotImplementedError("reference: braced lattices only")
        res = int(body["res"])
        size = tuple(float(s) for s in body["size_m"])
        spacing = np.asarray(size) / (res - 1)
        comp = (body["structural_compliance"], body["shear_compliance"],
                body["bend_compliance"])
        rest = tuple(float(np.linalg.norm(spacing * np.abs(np.array(f[:3]))))
                     for f in BRACED_FAMILIES)
        return Lattice(res, size, rest,
                       tuple(float(comp[f[3]]) for f in BRACED_FAMILIES))

    @property
    def n(self) -> int:
        return self.res ** 3


def _roll_fwd(a, fam, res):
    dx, dy, dz, _ = fam
    if dx:
        a = torch.roll(a, -dx, dims=a.ndim - 2)
    k = dy * res + dz
    if k:
        a = torch.roll(a, -k, dims=a.ndim - 1)
    return a


def _roll_bwd(a, fam, res):
    dx, dy, dz, _ = fam
    k = dy * res + dz
    if k:
        a = torch.roll(a, k, dims=a.ndim - 1)
    if dx:
        a = torch.roll(a, dx, dims=a.ndim - 2)
    return a


def _over(a, dt):
    """``a / dt`` as a true division by ``dt`` rounded to ``a``'s dtype."""
    return a / torch.full((), dt, dtype=a.dtype, device=a.device)


class Engine:
    """The stencil engine for ``bodies`` bodies of ``lat`` under the
    solver settings ``s`` (the configuration's ``solver``), in ``dtype``
    on ``device``."""

    def __init__(self, lat: Lattice, s: Dict, bodies: int, device,
                 dtype=torch.float32):
        missing = [k for k in SETTINGS if k not in s]
        if missing:
            raise ValueError(f"reference: the configuration lacks {missing}")
        unsupported = {k: s[k] for k in ("enable_tet_volume",
                                         "enable_self_collision")
                       if s.get(k)}
        if (s.get("sphere_colliders") or s.get("box_colliders")
                or s["floor_mode"] not in ("xpbd_inequality", "none")
                or unsupported):
            raise NotImplementedError("reference: a lattice with the floor "
                                      "alone (no tets, colliders or "
                                      "self-collision)")
        if s["solve_mode"] not in ("jacobi", "colored"):
            raise ValueError(f"reference: solve mode {s['solve_mode']}")
        self.lat, self.s, self.b = lat, s, bodies
        self.device, self.dtype = torch.device(device), dtype
        res, b = lat.res, bodies
        self.masks = [(torch.as_tensor(v, device=device).repeat(1, b),
                       torch.as_tensor(p, device=device).repeat(1, b))
                      for v, p in family_masks(res)]
        self.g = torch.tensor(tuple(s["gravity"]), dtype=dtype,
                              device=device).reshape(3, 1, 1)
        self.ground = torch.as_tensor(s["ground_height"], dtype=dtype,
                                      device=device).reshape(())

    # -- layout: (B, N, 3) leaves <-> lane-folded planes ------------------

    def to_wide(self, t: torch.Tensor, k: int = 0) -> torch.Tensor:
        res, r2 = self.lat.res, self.lat.res ** 2
        b = self.b
        if k == 0:
            return t.reshape(b, res, r2, 3).permute(3, 1, 0, 2).reshape(
                3, res, b * r2)
        return t.reshape(b, k, res, r2).permute(1, 2, 0, 3).reshape(
            k, res, b * r2)

    def from_wide(self, a: torch.Tensor, k: int = 0) -> torch.Tensor:
        res, r2 = self.lat.res, self.lat.res ** 2
        b = self.b
        if k == 0:
            return a.reshape(3, res, b, r2).permute(2, 1, 3, 0).reshape(
                b, res * r2, 3)
        return a.reshape(k, res, b, r2).permute(2, 0, 1, 3).reshape(b, -1)

    def wide_mass(self, inv_mass: torch.Tensor) -> torch.Tensor:
        res, r2 = self.lat.res, self.lat.res ** 2
        return inv_mass.expand(self.b, res ** 3).reshape(
            self.b, res, r2).permute(1, 0, 2).reshape(res, self.b * r2)

    # -- one substep -------------------------------------------------------

    def _family(self, pred, w, wb, lam_f, fi, mask, relax, dt):
        s, fam, res = self.s, BRACED_FAMILIES[fi], self.lat.res
        rest, comp = self.lat.rest[fi], self.lat.compliance[fi]
        d = _roll_fwd(pred, fam, res) - pred
        len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        length = torch.sqrt(torch.clamp(len_sq, min=1e-24))
        c = length - rest
        alpha = comp / (dt * dt)
        if s["min_alpha_tilde"] > 0:
            alpha = max(alpha, s["min_alpha_tilde"])
        denom = w + wb + alpha
        dl = (-c - alpha * lam_f) / torch.clamp(denom, min=1e-30)
        if s["max_dlambda"] > 0:
            dl = torch.clamp(dl, -s["max_dlambda"], s["max_dlambda"])
        if s["max_dlambda_rel"] > 0:
            m = s["max_dlambda_rel"] * rest
            dl = torch.clamp(dl, -m, m)
        if s["fast_math"]:
            dl = dl * (mask if relax is None else mask * relax)
        else:
            active = (mask & (length >= s["eps_length"])
                      & (torch.abs(denom) >= s["eps_denominator"])
                      & ((w >= s["static_inv_mass_eps"])
                         | (wb >= s["static_inv_mass_eps"])))
            dl = torch.where(active, dl if relax is None else dl * relax,
                             0.0)
        lam_f = lam_f + dl
        if s["lambda_clamp"] > 0:
            lam_f = torch.clamp(lam_f, -s["lambda_clamp"], s["lambda_clamp"])
        dp = d * (dl / length)[None]
        pred = pred - w[None] * dp
        pred = pred + _roll_bwd(wb[None] * dp, fam, res)
        return pred, lam_f

    def _warm(self, pred, w, wb, lam_f, fi, valid):
        s, fam, res = self.s, BRACED_FAMILIES[fi], self.lat.res
        if s["warm_start_fraction"] != 1.0:
            lam_f = lam_f * s["warm_start_fraction"]
        if s["warm_start_clamp"] > 0:
            wmax = torch.clamp(torch.maximum(w, wb), min=1e-12)
            # a 0-dim tensor over wmax divides truly (a float over a
            # tensor would be a reciprocal times the float)
            lim = torch.full((), s["warm_start_clamp"] * self.lat.rest[fi],
                             dtype=wmax.dtype, device=wmax.device) / wmax
            lam_f = torch.clamp(lam_f, -lim, lim)
        d = _roll_fwd(pred, fam, res) - pred
        len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        length = torch.sqrt(torch.clamp(len_sq, min=1e-24))
        dl = torch.where(valid, lam_f, 0.0)
        dp = d * (dl / length)[None]
        pred = pred - w[None] * dp
        pred = pred + _roll_bwd(wb[None] * dp, fam, res)
        return pred, lam_f

    def _floor(self, pred, x, w, dt):
        s = self.s
        pen = self.ground - pred[1]
        denom = w + s["collision_compliance"] / (dt * dt)
        dl = pen / torch.clamp(denom, min=1e-30)
        hit = ((pen > 0) & (w >= s["static_inv_mass_eps"])
               & (torch.abs(denom) >= s["eps_denominator"]))
        p1 = pred[1] + torch.where(hit, w * dl, 0.0)
        fr = min(max(s["friction"], 0.0), 1.0)
        p0 = pred[0] - torch.where(hit, (pred[0] - x[0]) * fr, 0.0)
        p2 = pred[2] - torch.where(hit, (pred[2] - x[2]) * fr, 0.0)
        return torch.stack([p0, p1, p2])

    def substep(self, x, v, w, f, lam, dt, apply_ext: bool):
        """One substep on wide planes; returns (x, v, lam)."""
        s, res = self.s, self.lat.res
        if s["lambda_mode"] == "reset":
            lam = torch.zeros_like(lam)
        else:
            lam = lam * s["lambda_decay"]
        ext = f if apply_ext else torch.zeros_like(f)
        if s["gravity_is_acceleration"]:
            if s["max_force"] > 0:
                ext = torch.clamp(ext, -s["max_force"], s["max_force"])
            v = v + dt * (torch.where((w > 0)[None], self.g, 0.0)
                          + w[None] * ext)
        else:
            force = self.g + ext
            if s["max_force"] > 0:
                force = torch.clamp(force, -s["max_force"], s["max_force"])
            v = v + dt * w[None] * force
        if s["damping_mode"] == "per_step":
            v = v * (1.0 - min(max(s["damping"], 0.0), 1.0))
        else:
            v = v * (1.0 - s["damping"] * dt)
        if s["max_velocity"] > 0:
            v = torch.clamp(v, -s["max_velocity"], s["max_velocity"])
        pred = x + dt * v
        if s["world_bounds"] > 0:
            pred = torch.clamp(pred, -s["world_bounds"], s["world_bounds"])
        wb = [_roll_fwd(w, fam, res) for fam in BRACED_FAMILIES]
        if s["lambda_mode"] == "warm_start":
            parts = []
            for fi in range(len(BRACED_FAMILIES)):
                pred, lf = self._warm(pred, w, wb[fi], lam[fi], fi,
                                      self.masks[fi][0])
                parts.append(lf)
            lam = torch.stack(parts)
        relax = 0.5 * (s["omega"] if s["omega"] > 0 else 1.0)
        for _ in range(s["iterations"]):
            parts = []
            for fi in range(len(BRACED_FAMILIES)):
                valid, parity0 = self.masks[fi]
                lf = lam[fi]
                if s["solve_mode"] == "colored":
                    for m in (valid & parity0, valid & ~parity0):
                        if s["fast_math"]:
                            m = m.to(pred.dtype)
                        pred, lf = self._family(pred, w, wb[fi], lf, fi, m,
                                                None, dt)
                else:
                    m = valid.to(pred.dtype) if s["fast_math"] else valid
                    pred, lf = self._family(pred, w, wb[fi], lf, fi, m,
                                            relax, dt)
                parts.append(lf)
            lam = torch.stack(parts)
            if s["floor_mode"] == "xpbd_inequality":
                pred = self._floor(pred, x, w, dt)
        pinned = (w == 0.0)[None]
        v = torch.where(pinned, 0.0, _over(pred - x, dt))
        x = torch.where(pinned, x, pred)
        return x, v, lam

    def run(self, leaves: Dict[str, torch.Tensor], dt_sub: float,
            n_substeps: int, with_ext: bool) -> Dict[str, torch.Tensor]:
        """``n_substeps`` substeps of batched leaves ``positions``,
        ``velocities``, ``ext_force`` ``(B, N, 3)``, ``lambda_dist``
        ``(B, 13 N)``, ``inv_mass`` ``(B, N)``: the external force applied
        on the first substep and zeroed after when ``with_ext`` (else
        neither applied nor cleared).  Returns the new leaves."""
        k = len(BRACED_FAMILIES)
        x = self.to_wide(leaves["positions"])
        v = self.to_wide(leaves["velocities"])
        f = self.to_wide(leaves["ext_force"])
        lam = self.to_wide(leaves["lambda_dist"], k)
        w = self.wide_mass(leaves["inv_mass"])
        for i in range(n_substeps):
            x, v, lam = self.substep(x, v, w, f, lam, dt_sub,
                                     with_ext and i == 0)
        ext = (torch.zeros_like(leaves["ext_force"]) if with_ext
               else leaves["ext_force"])
        return {"positions": self.from_wide(x),
                "velocities": self.from_wide(v),
                "lambda_dist": self.from_wide(lam, k),
                "ext_force": ext, "inv_mass": leaves["inv_mass"]}


def inverse_mass(mass: float) -> float:
    """A particle's inverse mass: 0 (pinned) at or below 1e-4 kg."""
    return 0.0 if mass <= 1e-4 else 1.0 / mass
