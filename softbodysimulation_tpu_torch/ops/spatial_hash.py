"""Self-collision (particle-particle contact) backends, on tensors.

Counterpart of ``softbodysimulation_tpu/ops/spatial_hash.py``: one Jacobi
separation pass per call, corrections ``self_collision_omega *
(w_i / (w_i + w_j)) * overlap * n_ij`` summed over the touching pairs
(distance below ``2 * particle_radius``), in four backends:

* ``hash``   — a bounded G^3 grid, cells sorted by id, 27 neighbour cells
  x ``hash_cell_capacity`` entries per particle (approximate at capacity);
* ``dense``  — all pairs, the Gram trick ``d2 = |x_i|^2 + |x_j|^2 -
  2 x_i.x_j`` on centred positions, row blocks of ``dense_row_block``;
* ``blocked`` — the dense arithmetic restricted to the ``block_neighbors``
  nearest blocks (by block AABB distance) of ``collision_block_size``
  particles along a Hilbert curve; exact while no block drops a touching
  pair (``self_collision_blocked_dropped_pairs``).  This is the plain
  version of TPU kernel B-4 (``kernels/contact_pallas.py``): the
  ``blocked_pallas`` backend runs ``kernels/contact_cuda.py``, which
  launches the CUDA kernel for a CUDA tensor and runs this function for a
  CPU tensor;
* ``sorted`` — each particle against its ``sorted_window`` successors
  along the Hilbert curve (approximate).

The Hilbert order (``morton_order``) is computed once per substep and reused
across the solver's iterations.  The hash and sorted passes and the curve
order make no host sync on the card: no ``.item()``, no NumPy, constants
filled on the device or copied there once.  Sorts are stable and the top-M candidate
selection breaks ties by the lower block index, as ``jnp.argsort`` and
``lax.top_k`` do, so both packages pick the same candidates.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import SolverConfig
from .distance import dot3
from .integrate import scalar

_OFFSETS = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], dtype=np.int32)
_HILBERT_BITS = 9                          # 512 cells per axis


def _div(a: torch.Tensor, divisor) -> torch.Tensor:
    """``a / divisor`` as a true float32 division on every device (a
    Python-float divisor becomes a multiply by its reciprocal on CUDA); a
    tensor divisor as it is."""
    if not isinstance(divisor, torch.Tensor):
        divisor = scalar(divisor, a)
    return a / divisor


@functools.lru_cache(maxsize=8)
def _offsets(device) -> torch.Tensor:
    """The 27 neighbour-cell offsets on ``device``, copied there once."""
    return torch.as_tensor(_OFFSETS, device=device)


def _contact_coef(d2, wsum, radius, mask):
    """Per pair: ``overlap / (dist * wsum)`` where the pair touches, else 0,
    with the Gram-trick distance guard of the dense and blocked passes."""
    dist = torch.sqrt(torch.clamp(d2, min=1e-18))
    overlap = 2.0 * radius - dist
    touch = mask & (overlap > 0) & (dist > 1e-9) & (wsum > 1e-12)
    m = overlap / (torch.clamp(dist, min=1e-12)
                   * torch.clamp(wsum, min=1e-12))
    return torch.where(touch, m, 0.0)


# ------------------------------------------------------------------ hash
def self_collision_project(pred, inv_mass, cfg: SolverConfig):
    """One Jacobi separation pass over the hash grid."""
    n = pred.shape[0]
    dev = pred.device
    radius = cfg.particle_radius
    g = cfg.hash_grid_dim
    k = cfg.hash_cell_capacity

    origin = pred.min(dim=0).values
    coords = torch.clamp(torch.floor(_div(pred - origin, 2.0 * radius))
                         .to(torch.int32), 0, g - 1)
    cid = (coords[:, 0] * g + coords[:, 1]) * g + coords[:, 2]
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]

    offs = _offsets(dev)
    ncoords = coords[:, None, :] + offs[None, :, :]          # (N, 27, 3)
    in_grid = ((ncoords >= 0) & (ncoords < g)).all(dim=-1)
    ncid = (ncoords[..., 0] * g + ncoords[..., 1]) * g + ncoords[..., 2]

    starts = torch.searchsorted(sorted_cid, ncid.reshape(-1)).reshape(n, 27)
    slot = starts[:, :, None] + torch.arange(k, device=dev)[None, None, :]
    slot_ok = slot < n
    slot_c = torch.clamp(slot, max=n - 1)
    cand_cid = sorted_cid[slot_c]
    cand_idx = order[slot_c]
    valid = slot_ok & (cand_cid == ncid[:, :, None]) & in_grid[:, :, None]

    d = pred[:, None, None, :] - pred[cand_idx]               # (N, 27, K, 3)
    dist = torch.sqrt(torch.clamp(dot3(d, d), min=1e-24))
    not_self = cand_idx != torch.arange(n, device=dev)[:, None, None]
    overlap = 2.0 * radius - dist
    wi = inv_mass[:, None, None]
    wsum = wi + inv_mass[cand_idx]
    touch = (valid & not_self & (overlap > 0) & (dist > 1e-9)
             & (wsum > 1e-12))
    ndir = d / torch.clamp(dist, min=1e-12)[..., None]
    push = torch.where(touch, (wi / torch.clamp(wsum, min=1e-12)) * overlap,
                       0.0)
    corr = (ndir * push[..., None]).sum(dim=(1, 2))
    return pred + cfg.self_collision_omega * corr


# ----------------------------------------------------------------- dense
def self_collision_project_dense(pred, inv_mass, cfg: SolverConfig):
    """One exact all-pairs Jacobi separation pass (Gram trick on centred
    positions): ``corr_i = w_i (x_i sum_j m_ij - sum_j m_ij x_j)`` with
    ``m_ij = overlap / (dist * wsum)`` on touching pairs.  The JAX version
    pads the rows to whole ``dense_row_block`` blocks with particles parked
    far away at zero inverse mass, which touch nothing; here the rows run in
    chunks of about 2^22 pairs (memory only: the result does not depend on
    the chunking)."""
    n = pred.shape[0]
    x = pred - pred.mean(dim=0)
    sq = dot3(x, x)
    # a pair can touch only if d2 < (2r)^2 (with a margin far above the
    # rounding of the sqrt), so the guards run on those pairs alone
    near2 = (2.0 * cfg.particle_radius) ** 2 * 1.0001
    rows = max(1, (1 << 22) // n)
    corr = []
    for r0 in range(0, n, rows):
        xi, sqi, wi = x[r0:r0 + rows], sq[r0:r0 + rows], inv_mass[r0:r0 + rows]
        # (sqi + sqj) - 2 (xi . xj): the -2 scale is exact
        d2 = torch.addmm(sqi[:, None] + sq[None, :], xi, x.T, alpha=-2.0)
        ri, cj = (d2 < near2).nonzero(as_tuple=True)
        other = ri + r0 != cj
        ri, cj = ri[other], cj[other]
        m = _contact_coef(d2[ri, cj], wi[ri] + inv_mass[cj],
                          cfg.particle_radius, True)
        if d2.is_cuda:
            # index_add sums in no fixed order on the card: the dense
            # (rows, N) coefficients' row sums and product with x instead,
            # as the JAX version takes them
            m = d2.new_zeros(d2.shape).index_put((ri, cj), m)
            msum, mx = m.sum(dim=1), m @ x
        else:
            msum = wi.new_zeros(wi.shape).index_add(0, ri, m)
            mx = xi.new_zeros(xi.shape).index_add(0, ri, m[:, None] * x[cj])
        corr.append(wi[:, None] * (xi * msum[:, None] - mx))
    return pred + cfg.self_collision_omega * torch.cat(corr)


# --------------------------------------------------------------- blocked
def _blocked_layout(pred, inv_mass, order, cfg: SolverConfig):
    """Curve-sorted, block-padded, centred layout shared by the blocked pass
    and its diagnostics.  Pads replicate the last real particle's position
    (so the last block's AABB is not inflated) and are excluded from every
    pair by the id < n mask.  Returns (x, w, ids, touch, d2ab, n, block,
    nb)."""
    n = pred.shape[0]
    block = max(8, min(cfg.collision_block_size, n))
    npad = ((n + block - 1) // block) * block
    nb = npad // block

    x = pred[order] - pred.mean(dim=0)
    w = inv_mass[order]
    if npad != n:
        x = torch.cat([x, x[-1:].expand(npad - n, 3)])
        w = torch.cat([w, w.new_zeros(npad - n)])
    ids = torch.arange(npad, device=pred.device)

    xb = x.reshape(nb, block, 3)
    bmin = xb.min(dim=1).values                               # (nb, 3)
    bmax = xb.max(dim=1).values
    gap = torch.clamp(torch.maximum(bmin[:, None, :] - bmax[None, :, :],
                                    bmin[None, :, :] - bmax[:, None, :]),
                      min=0.0)
    d2ab = dot3(gap, gap)                                     # (nb, nb)
    touch = d2ab < (2.0 * cfg.particle_radius) ** 2
    return x, w, ids, touch, d2ab, n, block, nb


def select_candidates(touch, d2ab, m_nbr: int):
    """The ``m_nbr`` nearest touching blocks of every block: ``lax.top_k``
    of ``where(touch, -d2ab, -inf)``, equal keys in index order (a stable
    descending sort).  Returns (nbr (nb, M) int64, ok (nb, M) bool)."""
    key = torch.where(touch, -d2ab, float("-inf"))
    nbr = torch.sort(key, dim=1, descending=True, stable=True).indices
    nbr = nbr[:, :m_nbr]
    return nbr, touch.gather(1, nbr)


def self_collision_blocked_overflow(pred, inv_mass, order,
                                    cfg: SolverConfig):
    """Worst-case number of AABB-touching blocks dropped by the top-M
    candidate selection (0 => the blocked pass was exact here; conservative,
    see ``self_collision_blocked_dropped_pairs``)."""
    touch = _blocked_layout(pred, inv_mass, order, cfg)[3]
    return torch.clamp(touch.sum(dim=1).max() - cfg.block_neighbors, min=0)


def self_collision_blocked_dropped_pairs(pred, inv_mass, order,
                                         cfg: SolverConfig):
    """Number of real contact contributions the blocked pass misses here:
    directed pairs (a in block i, b in block j) within the contact
    diameter (under the pass's own guards) whose block i did not select
    block j among its top-M candidates.  0 => the pass covers exactly the
    pairs the dense backend would."""
    x, w, ids, touch, d2ab, n, block, nb = _blocked_layout(
        pred, inv_mass, order, cfg)
    nbr, ok = select_candidates(touch, d2ab, min(cfg.block_neighbors, nb))
    sel = torch.zeros_like(touch)
    sel[torch.arange(nb, device=x.device)[:, None], nbr] = ok
    bad = touch & ~sel                                        # (nb, nb)
    blk = ids // block
    r2 = (2.0 * cfg.particle_radius) ** 2
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(nb):
        rows = slice(i * block, (i + 1) * block)
        d = x[rows, None, :] - x[None, :, :]
        d2 = dot3(d, d)
        wsum = w[rows, None] + w[None, :]
        real = ((d2 < r2) & (d2 > 1e-18) & (wsum > 1e-12)
                & (ids[rows, None] < n) & (ids[None, :] < n)
                & bad[i][blk][None, :])
        total = total + real.sum()
    return total


def _blocked_pairs(pred, inv_mass, order, cfg: SolverConfig, chunk: int):
    """The blocked pass's pair coefficients, ``chunk`` row blocks at a time
    (memory only; the result does not depend on it): yields (xi (k, B, 3),
    wi (k, B), m (k, B, M*B), cx (k, M*B, 3)) and returns nothing else."""
    x, w, ids, touch, d2ab, n, block, nb = _blocked_layout(
        pred, inv_mass, order, cfg)
    m_nbr = min(cfg.block_neighbors, nb)
    nbr, ok = select_candidates(touch, d2ab, m_nbr)
    sq = dot3(x, x)
    xb, sqb, wb, idb = (x.reshape(nb, block, 3), sq.reshape(nb, block),
                        w.reshape(nb, block), ids.reshape(nb, block))
    for r0 in range(0, nb, chunk):
        r = slice(r0, min(r0 + chunk, nb))
        nb_r = nbr[r]
        k = nb_r.shape[0]
        cx = xb[nb_r].reshape(k, m_nbr * block, 3)
        csq = sqb[nb_r].reshape(k, m_nbr * block)
        cw = wb[nb_r].reshape(k, m_nbr * block)
        cid = idb[nb_r].reshape(k, m_nbr * block)
        cok = ok[r].repeat_interleave(block, dim=1)
        xi, sqi, wi, idi = xb[r], sqb[r], wb[r], idb[r]
        g = torch.bmm(xi, cx.transpose(1, 2))                 # (k, B, MB)
        d2 = sqi[:, :, None] + csq[:, None, :] - 2.0 * g
        mask = ((idi[:, :, None] != cid[:, None, :]) & cok[:, None, :]
                & (idi[:, :, None] < n) & (cid[:, None, :] < n))
        yield xi, wi, _contact_coef(d2, wi[:, :, None] + cw[:, None, :],
                                    cfg.particle_radius, mask), cx


def self_collision_project_blocked(pred, inv_mass, order, cfg: SolverConfig,
                                   chunk: int = 16):
    """One blocked Jacobi separation pass: dense contact arithmetic between
    each block of ``collision_block_size`` curve-sorted particles and its
    ``block_neighbors`` nearest AABB-touching blocks."""
    corr = torch.cat([
        wi[:, :, None] * (xi * m.sum(dim=2)[:, :, None] - torch.bmm(m, cx))
        for xi, wi, m, cx in _blocked_pairs(pred, inv_mass, order, cfg,
                                            chunk)])
    n = pred.shape[0]
    corr = corr.reshape(-1, 3)[:n]
    return pred + cfg.self_collision_omega * corr[torch.argsort(order)]


def blocked_touching_pairs(pred, inv_mass, order, cfg: SolverConfig,
                           chunk: int = 16):
    """The blocked pass's touching pairs: a bool ``(npad, M * B)`` mask,
    row = curve slot, column m * B + k = particle k of the row block's m-th
    candidate block (the layout ``kernels.contact_cuda.
    touching_pairs_cuda`` returns)."""
    return torch.cat([m > 0 for _, _, m, _ in _blocked_pairs(
        pred, inv_mass, order, cfg, chunk)]).flatten(0, 1)


# ---------------------------------------------------------------- sorted
def _spread_bits_3(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _hilbert_code(coords, b=_HILBERT_BITS):
    """3-D Hilbert index of int32 cell coordinates in [0, 2^b) (Skilling's
    transpose algorithm, then bit interleave), elementwise."""
    X = [coords[:, 0], coords[:, 1], coords[:, 2]]
    Q = 1 << (b - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0_swap = X[0] ^ t
            xi_swap = X[i] ^ t
            X[0] = torch.where(cond, X[0] ^ P, x0_swap)
            if i:
                X[i] = torch.where(cond, X[i], xi_swap)
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = 1 << (b - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    return ((_spread_bits_3(X[0]) << 2) | (_spread_bits_3(X[1]) << 1)
            | _spread_bits_3(X[2]))


def morton_order(pred, cfg: SolverConfig):
    """Sort permutation along a Hilbert curve of the quantized positions
    (the name is historical), computed once per substep; stable, so
    particles of one cell keep their index order.  The cell is the contact
    diameter, or coarser when the scene would not fit the 512^3 grid."""
    g = 1 << _HILBERT_BITS
    origin = pred.min(dim=0).values
    extent = (pred.max(dim=0).values - origin).max()
    cell = torch.clamp(_div(extent, g - 1), min=2.0 * cfg.particle_radius)
    coords = torch.clamp(torch.floor((pred - origin) / cell).to(torch.int32),
                         0, g - 1)
    return torch.argsort(_hilbert_code(coords), stable=True)


def self_collision_project_sorted(pred, inv_mass, order, cfg: SolverConfig):
    """One Jacobi separation pass over the curve-sorted sliding window:
    every particle against its ``sorted_window`` successors, the
    correction applied to both sides, mass-weighted."""
    n = pred.shape[0]
    w_win = min(cfg.sorted_window, n - 1)
    inv_order = torch.argsort(order)
    ps = pred[order]
    ws = inv_mass[order]
    corr = torch.zeros_like(ps)
    for j in range(1, w_win + 1):
        d = ps[:-j] - ps[j:]
        wi, wj = ws[:-j], ws[j:]
        dist = torch.sqrt(torch.clamp(dot3(d, d), min=1e-24))
        overlap = 2.0 * cfg.particle_radius - dist
        wsum = wi + wj
        touch = (overlap > 0) & (dist > 1e-9) & (wsum > 1e-12)
        ndir = d / dist[..., None]
        mag = torch.where(touch, overlap / torch.clamp(wsum, min=1e-12), 0.0)
        corr[:n - j] += ndir * (wi * mag)[..., None]
        corr[j:] -= ndir * (wj * mag)[..., None]
    return pred + cfg.self_collision_omega * corr[inv_order]


# -------------------------------------------------------------- dispatch
def project_self_collision(pred, inv_mass, order, cfg: SolverConfig):
    """One separation pass of the configured backend on (N, 3) positions.
    ``order`` is the curve order computed once per substep (None for the
    hash and dense backends, which do not use it)."""
    backend = cfg.self_collision_backend
    if backend == "sorted":
        return self_collision_project_sorted(pred, inv_mass, order, cfg)
    if backend == "blocked":
        return self_collision_project_blocked(pred, inv_mass, order, cfg)
    if backend == "blocked_pallas":
        from ..kernels import contact_cuda

        return contact_cuda.self_collision_project_blocked_cuda(
            pred, inv_mass, order, cfg)
    if backend == "dense":
        return self_collision_project_dense(pred, inv_mass, cfg)
    return self_collision_project(pred, inv_mass, cfg)


def needs_morton_order(cfg: SolverConfig) -> bool:
    return cfg.enable_self_collision and cfg.self_collision_backend in (
        "sorted", "blocked", "blocked_pallas")
