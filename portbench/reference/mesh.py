"""The benchmark's plain reference for ensembles of closed triangle meshes:
distance constraints, the global volume constraint with one multiplier a
body, the XPBD floor with positional friction, and damping, in plain
PyTorch and NumPy, importing nothing of the program.

The mesh is built here from the configuration: an icosphere (the
icosahedron's 12 vertices normalised, each subdivision splitting every
triangle in four at its edges' normalised midpoints, scaled to the
radius), its unique edges ``(a < b)`` in lexicographic order, and its
triangles.  The configuration's mesh is the ``windowed`` one: particles
renumbered by reverse Cuthill-McKee (``rcm_order``), each edge's
endpoints renamed in place and the edges stable-sorted by their lower
endpoint, the triangles renamed in their own order.  Every leaf is
compared in that numbering, the program's own.

The engine is the plain twin of the program's mesh ensemble
(``run_substeps_plain_batched``: a substep's multipliers reset or decayed,
predict, per iteration a JACOBI distance pass, the volume projection and
the floor, under Chebyshev acceleration the momentum step and the floor
again, finalize), departing from it as follows:

- it is batched over the bodies, ``(B, N, 3)`` leaves and ``(B, ...)``
  multipliers, with no loop over them;
- it covers what a mesh configuration of the benchmark states and refuses
  the rest (``Engine``): no bending, tets, spheres, boxes, self-collision,
  velocity-reflect floor, COLORED sweep or WARM_START pre-apply;
- every constant (rest lengths and volume, degrees, relaxation, damping,
  friction, Chebyshev weights) is worked out here from the configuration;
- on the card a substep is replayed from one CUDA graph (``Reference`` in
  the mesh system), the same kernels in the same order;
- TF32 is switched off for every product (``Engine``).

To agree with the program to the bit, each sum is taken in the order the
program's mesh kernel takes it, written out here: a particle's corrections
added in the column order of its incidence row (the contributions
``a * K + k`` of the constraints ``k`` that have it as endpoint ``a``,
ascending), and a body's volume and ``sum w |g|^2`` as one block of
``BLOCK`` lanes (lane ``t`` adds elements ``t, t + BLOCK, ...`` in order,
then the lanes are added pairwise, halving).  Divisions are true
divisions by a 0-dim tensor, each constant rounded to the engine's dtype
as the program rounds it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

# the solver settings the engine reads; a configuration states each
SETTINGS = ("substeps", "iterations", "gravity", "gravity_is_acceleration",
            "damping", "damping_mode", "max_velocity", "max_force",
            "world_bounds", "solve_mode", "omega", "jacobi_rho",
            "jacobi_gamma", "jacobi_cheby_delay", "lambda_mode",
            "lambda_decay", "max_dlambda", "max_dlambda_rel", "lambda_clamp",
            "min_alpha_tilde", "enable_volume", "pressure",
            "volume_compliance", "floor_mode", "ground_height",
            "collision_compliance", "friction", "eps_length",
            "eps_denominator", "static_inv_mass_eps")
# lanes of the block that sums a body's volume terms
BLOCK = 256


def icosphere(subdivisions: int, radius: float):
    """``(vertices (N, 3) float32, triangles (T, 3) int64)`` of the
    icosphere, counter-clockwise seen from outside."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1))]
    scale = np.linalg.norm(verts[0])
    verts = [v / scale for v in verts]
    tris = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        made: Dict[tuple, int] = {}

        def mid(a, b):
            key = (a, b) if a < b else (b, a)
            if key not in made:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                made[key] = len(verts) - 1
            return made[key]

        split = []
        for a, b, c in tris:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = split
    pts = (np.stack(verts) * radius).astype(np.float32)
    return pts, np.asarray(tris, np.int64)


def unique_edges(triangles: np.ndarray) -> np.ndarray:
    """The triangles' undirected edges ``(a < b)``, once each, in
    lexicographic order, ``(E, 2)`` int64."""
    t = np.asarray(triangles, np.int64)
    sides = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    return np.unique(np.sort(sides, axis=1), axis=0)


def rcm_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee: ``order[i]`` is the old index of new
    particle ``i``.  Breadth first from each unvisited particle of least
    degree (ties by index), a particle's unvisited neighbours queued by
    degree (ties in the order its edges list them), the whole order
    reversed."""
    nbrs = [[] for _ in range(n)]
    for a, b in np.asarray(edges, np.int64).tolist():
        nbrs[a].append(b)
        nbrs[b].append(a)
    degree = [len(x) for x in nbrs]
    seen = [False] * n
    order = []
    for root in sorted(range(n), key=lambda i: degree[i]):
        if seen[root]:
            continue
        seen[root] = True
        queue, head = [root], 0
        while head < len(queue):
            u = queue[head]
            head += 1
            order.append(u)
            for w in sorted((w for w in nbrs[u] if not seen[w]),
                            key=lambda w: degree[w]):
                if not seen[w]:
                    seen[w] = True
                    queue.append(w)
    return np.asarray(order[::-1], np.int64)


def incidence(constraints: np.ndarray, n: int) -> np.ndarray:
    """``(N, D)`` int64: row ``i`` lists the contributions ``a * K + k``
    of the constraints ``k`` (of ``K``) with particle ``i`` as endpoint
    ``a``, ascending, padded with ``K * arity`` (an appended zero row);
    ``D`` is the longest row."""
    cons = np.asarray(constraints, np.int64)
    k, arity = cons.shape
    rows = [[] for _ in range(n)]
    for j, i in enumerate(cons.T.reshape(-1).tolist()):
        rows[i].append(j)          # j = a * K + k, ascending
    width = max(len(r) for r in rows)
    out = np.full((n, width), k * arity, np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One body of a mesh configuration in the windowed numbering, with
    its constants: ``positions`` ``(N, 3)`` float32 at rest about the
    origin, ``edges`` ``(E, 2)``, ``triangles`` ``(T, 3)``,
    ``rest_lengths`` ``(E,)`` and ``compliance`` ``(E,)`` float32,
    ``rest_volume`` (float32), ``degree`` ``(N,)`` (edges a particle
    has), and ``order`` (new -> old index of the raw icosphere)."""

    positions: np.ndarray
    edges: np.ndarray
    triangles: np.ndarray
    rest_lengths: np.ndarray
    compliance: np.ndarray
    rest_volume: np.float32
    degree: np.ndarray
    order: np.ndarray

    @staticmethod
    def of(conf: Dict) -> "Mesh":
        body = conf["body"]
        if body["mesh"] != "icosphere":
            raise NotImplementedError(f"reference: no mesh {body['mesh']!r}")
        verts, tris = icosphere(int(body["subdivisions"]),
                                float(body["radius_m"]))
        raw_edges = unique_edges(tris)
        n = verts.shape[0]
        order = rcm_order(raw_edges, n)
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n)
        edges = rank[raw_edges]
        edges = edges[np.argsort(edges.min(axis=1), kind="stable")]
        tris = rank[tris]
        p = verts.astype(np.float64)[order]
        rest = np.linalg.norm(p[edges[:, 1]] - p[edges[:, 0]],
                              axis=1).astype(np.float32)
        a, b, c = (p[tris[:, k]] for k in range(3))
        volume = np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0
        comp = np.full(edges.shape[0], body["compliance"], np.float32)
        degree = np.bincount(edges.reshape(-1), minlength=n)
        return Mesh(p.astype(np.float32), edges, tris, rest, comp,
                    np.float32(volume), degree.astype(np.float32), order)

    @property
    def n(self) -> int:
        return self.positions.shape[0]


def _dot(a, b):
    """Row-wise dot product of ``(..., 3)`` tensors, summed x + y + z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, a 0-dim tensor on its
    device: the divisor of a true division."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _row_sums(contrib: torch.Tensor, columns) -> torch.Tensor:
    """``(B, K, 3)`` contributions summed per particle through the columns
    of an ``incidence`` table, column by column from the first."""
    full = torch.cat([contrib, contrib.new_zeros(contrib.shape[0], 1, 3)], 1)
    out = full[:, columns[0]]
    for col in columns[1:]:
        out = out + full[:, col]
    return out


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """``(B, M)`` -> ``(B,)``: each row as one block of ``BLOCK`` lanes
    sums it (module docstring)."""
    b, m = v.shape
    k = max(1, -(-m // BLOCK))
    x = torch.cat([v, v.new_zeros(b, k * BLOCK - m)], 1).reshape(b, k, BLOCK)
    s = x[:, 0]
    for j in range(1, k):
        s = s + x[:, j]
    half = BLOCK // 2
    while half:
        s = s[:, :half] + s[:, half:2 * half]
        half //= 2
    return s[:, 0]


def chebyshev_weights(s: Dict):
    """The Chebyshev weight of each iteration, in float32 arithmetic, or
    None where the sweep is not accelerated (JACOBI with ``jacobi_rho > 0``
    and more iterations than ``jacobi_cheby_delay``)."""
    if not (s["solve_mode"] == "jacobi" and s["jacobi_rho"] > 0
            and s["iterations"] > s["jacobi_cheby_delay"]):
        return None
    rho2 = np.float32(s["jacobi_rho"] ** 2)
    om, out = np.float32(1.0), []
    for k in range(s["iterations"]):
        if k < s["jacobi_cheby_delay"]:
            om = np.float32(1.0)
        elif k == s["jacobi_cheby_delay"]:
            om = np.float32(2.0 / (2.0 - s["jacobi_rho"] ** 2))
        else:
            om = np.float32(4.0) / (np.float32(4.0) - rho2 * om)
        out.append(float(om))
    return out


class Engine:
    """The mesh XPBD engine for ``bodies`` bodies of ``mesh`` under the
    solver settings ``s`` (the configuration's ``solver``), in ``dtype``
    on ``device``."""

    def __init__(self, mesh: Mesh, s: Dict, bodies: int, device,
                 dtype=torch.float32):
        missing = [k for k in SETTINGS if k not in s]
        if missing:
            raise ValueError(f"reference: the configuration lacks {missing}")
        if (s.get("enable_bending") or s.get("enable_tet_volume")
                or s.get("enable_self_collision")
                or s.get("sphere_colliders") or s.get("box_colliders")
                or s["floor_mode"] not in ("xpbd_inequality", "none")
                or s["solve_mode"] != "jacobi"
                or s["lambda_mode"] not in ("reset", "decay")):
            raise NotImplementedError(
                "reference: JACOBI distance and volume passes with the XPBD "
                "floor alone, multipliers reset or decayed")
        self.mesh, self.s, self.b = mesh, s, bodies
        self.device, self.dtype = torch.device(device), dtype
        # float32 throughout: no product may run in TF32 (the engine has no
        # matrix product; this keeps a later one from rounding to 10 bits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        def dev(a, dt=dtype):
            return torch.as_tensor(a).to(device=device, dtype=dt)

        def columns(table):
            return tuple(dev(np.ascontiguousarray(table[:, k]), torch.long)
                         for k in range(table.shape[1]))

        one = np.float32(1.0)
        omega = np.float32(s["omega"] if s["omega"] > 0 else 1.0)
        e = mesh.edges
        maxdeg = np.maximum(np.maximum(mesh.degree[e[:, 0]],
                                       mesh.degree[e[:, 1]]), one)
        self.ea, self.eb = dev(e[:, 0], torch.long), dev(e[:, 1], torch.long)
        self.rest = dev(mesh.rest_lengths)
        self.compliance = dev(mesh.compliance)
        self.relax = dev(omega / maxdeg)
        self.edge_cols = columns(incidence(e, mesh.n))
        self.volume = s["enable_volume"] and mesh.triangles.shape[0] > 0
        self.tris = dev(mesh.triangles, torch.long)
        self.corner_cols = columns(incidence(mesh.triangles, mesh.n))
        rest_volume = dev(mesh.rest_volume)
        self.target = _const(s["pressure"], rest_volume) * rest_volume
        self.g = dev(np.asarray(s["gravity"], np.float32))
        self.ground = dev(np.float32(s["ground_height"]))
        fr = min(max(s["friction"], 0.0), 1.0)
        self.cheby = chebyshev_weights(s)
        self.fr, self.clip_damping = fr, min(max(s["damping"], 0.0), 1.0)

    def damping(self, dt: float) -> float:
        """The velocity factor a substep, rounded as the engine rounds
        it."""
        s = self.s
        if s["damping_mode"] == "per_step":
            return float(np.float32(1.0) - np.float32(self.clip_damping))
        return float(np.float32(1.0 - s["damping"] * dt))

    # -- the passes; tensors (B, N, 3), multipliers (B, E) and (B,) -------

    def _distance(self, pred, w, lam, dt):
        s = self.s
        wa, wb = w[:, self.ea], w[:, self.eb]
        d = pred[:, self.eb] - pred[:, self.ea]
        length = torch.sqrt(torch.clamp(_dot(d, d), min=1e-24))
        unit = d / length[..., None]
        c = length - self.rest
        alpha = self.compliance * (1.0 / (dt * dt))
        if s["min_alpha_tilde"] > 0:
            alpha = torch.clamp(alpha, min=s["min_alpha_tilde"])
        denom = wa + wb + alpha
        valid = ((length >= s["eps_length"])
                 & (torch.abs(denom) >= s["eps_denominator"])
                 & ((wa >= s["static_inv_mass_eps"])
                    | (wb >= s["static_inv_mass_eps"])))
        dl = (-c - alpha * lam) / torch.where(valid, denom, 1.0)
        if s["max_dlambda"] > 0:
            dl = torch.clamp(dl, -s["max_dlambda"], s["max_dlambda"])
        if s["max_dlambda_rel"] > 0:
            m = s["max_dlambda_rel"] * self.rest
            dl = torch.clamp(dl, -m, m)
        dl = torch.where(valid, dl, 0.0) * self.relax
        lam = lam + dl
        if s["lambda_clamp"] > 0:
            lam = torch.clamp(lam, -s["lambda_clamp"], s["lambda_clamp"])
        dp = dl[..., None] * unit
        contrib = torch.cat([-wa[..., None] * dp, wb[..., None] * dp], 1)
        return pred + _row_sums(contrib, self.edge_cols), lam

    def _volume(self, pred, w, lam, dt):
        p1, p2, p3 = (pred[:, self.tris[:, k]] for k in range(3))
        six = _const(6.0, pred)
        c23 = _cross(p2, p3)
        corners = torch.cat([c23 / six, _cross(p3, p1) / six,
                             _cross(p1, p2) / six], 1)
        c = _block_sum(_dot(p1, c23)) / six - self.target
        grads = _row_sums(corners, self.corner_cols)
        sw = _block_sum(w * _dot(grads, grads))
        alpha = _const(self.s["volume_compliance"] / (dt * dt), pred)
        denom = sw + alpha
        valid = denom > 1e-12
        dl = (-c - alpha * lam) / torch.where(valid, denom, 1.0)
        dl = torch.where(valid, dl, 0.0)
        return pred + (w[..., None] * dl[:, None, None]) * grads, lam + dl

    def _floor(self, pred, x, w, dt):
        s = self.s
        if s["floor_mode"] != "xpbd_inequality":
            return pred
        pen = self.ground - pred[..., 1]
        denom = w + s["collision_compliance"] / (dt * dt)
        active = ((pen > 0) & (w >= s["static_inv_mass_eps"])
                  & (torch.abs(denom) >= s["eps_denominator"]))
        dl = pen / torch.where(active, denom, 1.0)
        dy = torch.where(active, w * dl, 0.0)
        pred = torch.stack([pred[..., 0], pred[..., 1] + dy, pred[..., 2]],
                           -1)
        vel = (pred - x) / _const(dt, pred)
        tangent = torch.stack([vel[..., 0], torch.zeros_like(vel[..., 1]),
                               vel[..., 2]], -1)
        step = float(np.float32(dt) * np.float32(self.fr))
        return pred - torch.where(active[..., None], tangent * step, 0.0)

    def substep(self, x, v, w, f, lam, lam_v, dt, apply_ext: bool):
        """One substep; returns ``(x, v, lambda_dist, lambda_volume)``."""
        s = self.s
        if s["lambda_mode"] == "reset":
            lam = torch.zeros_like(lam)
            lam_v = torch.zeros_like(lam_v) if self.volume else lam_v
        else:
            lam = lam * s["lambda_decay"]
            lam_v = lam_v * s["lambda_decay"] if self.volume else lam_v
        ext = f if apply_ext else torch.zeros_like(f)
        if s["gravity_is_acceleration"]:
            if s["max_force"] > 0:
                ext = torch.clamp(ext, -s["max_force"], s["max_force"])
            dv = dt * (torch.where((w > 0)[..., None], self.g, 0.0)
                       + w[..., None] * ext)
        else:
            force = self.g + ext
            if s["max_force"] > 0:
                force = torch.clamp(force, -s["max_force"], s["max_force"])
            dv = dt * w[..., None] * force
        v = (v + dv) * self.damping(dt)
        if s["max_velocity"] > 0:
            v = torch.clamp(v, -s["max_velocity"], s["max_velocity"])
        pred = x + dt * v
        if s["world_bounds"] > 0:
            pred = torch.clamp(pred, -s["world_bounds"], s["world_bounds"])

        def project(pred, lam, lam_v):
            pred, lam = self._distance(pred, w, lam, dt)
            if self.volume:
                pred, lam_v = self._volume(pred, w, lam_v, dt)
            return self._floor(pred, x, w, dt), lam, lam_v

        if self.cheby is None:
            for _ in range(s["iterations"]):
                pred, lam, lam_v = project(pred, lam, lam_v)
        else:
            prev = pred
            for om in self.cheby:
                new, lam, lam_v = project(pred, lam, lam_v)
                acc = (om * (s["jacobi_gamma"] * (new - pred) + pred - prev)
                       + prev)
                prev, pred = pred, self._floor(acc, x, w, dt)
        pinned = (w == 0.0)[..., None]
        v = torch.where(pinned, 0.0, (pred - x) / _const(dt, pred))
        x = torch.where(pinned, x, pred)
        return x, v, lam, lam_v

    def run(self, leaves: Dict[str, torch.Tensor], dt_sub: float,
            n_substeps: int, with_ext: bool) -> Dict[str, torch.Tensor]:
        """``n_substeps`` substeps of batched leaves ``positions``,
        ``velocities``, ``ext_force`` ``(B, N, 3)``, ``lambda_dist``
        ``(B, E)``, ``lambda_volume`` ``(B,)``, ``inv_mass`` ``(B, N)``:
        the external force applied on the first substep and zeroed after
        when ``with_ext`` (else neither applied nor cleared).  Returns the
        new leaves."""
        x, v = leaves["positions"], leaves["velocities"]
        lam, lam_v = leaves["lambda_dist"], leaves["lambda_volume"]
        w, f = leaves["inv_mass"], leaves["ext_force"]
        for i in range(n_substeps):
            x, v, lam, lam_v = self.substep(x, v, w, f, lam, lam_v, dt_sub,
                                            with_ext and i == 0)
        return {"positions": x, "velocities": v, "lambda_dist": lam,
                "lambda_volume": lam_v,
                "ext_force": torch.zeros_like(f) if with_ext else f}
