"""The hand-written CUDA blocked self-collision kernel
(``csrc/contact_xpbd.cu``), TPU kernel B-4's port.

``self_collision_project_blocked_cuda(pred, inv_mass, order, cfg)`` is the
drop-in twin of ``softbodysimulation_tpu/kernels/contact_pallas.py::
self_collision_project_blocked_pallas``: one blocked Jacobi separation
pass over ``(N, 3)`` positions, along the curve order ``order`` (from
``ops.spatial_hash.morton_order``).  A CUDA tensor launches the kernels
(or raises); a CPU tensor runs the plain version,
``ops.spatial_hash.self_collision_project_blocked``; any other device
raises.  The library is built with ``nvcc`` on the first CUDA call
(``kernels/_build.py``), never at import.  The mesh library links the same
source and runs the pass inside its substep loop
(``kernels/mesh_cuda.py``); the launches it makes there count here too.

The pass is three launches (stats; the layout with its block and
sub-block AABBs; the selection with the warp-culled pair tests), plus an
unsort-apply here.  ``design="serial"`` selects the design it replaced (a
thread per row walking every candidate pair, five launches), kept only so
that ``chip_smoke.py`` and the card tests can time and compare the two:
no route, config or environment variable selects it.
``warp_cull_plain`` is the plain mirror of the warp cull (its bound, the
sub-block boxes and which tests it keeps).

``launches`` counts the CUDA kernels of this pass launched by this module
and by the mesh library's loop; callers may reset it to 0 to count one
run.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.config import SolverConfig
from ..ops import spatial_hash as _sh
from . import _build

LIB_NAME = "contact_xpbd"
SOURCES = ("contact_xpbd.cu",)
# no FMA contraction: d2 and the pair guards are rounded as written
NVCC_EXTRA = ("-fmad=false",)
MAX_BLOCK = 1024                 # one thread per row particle
MAX_ROW_BLOCKS = 12 * 1024       # the serial selection's keys in 48 KB
# ContactParams.design
DESIGNS = {"culled": 0, "serial": 1}
# the warp cull (csrc/contact_xpbd.cu, cx_cull_bound): a warp's rows are
# SUB consecutive slots, as are a candidate sub-block's; slack on the
# largest |x|^2, the Gram error per unit of it, slack on the whole bound
SUB = 32
SMAX_SLACK = 1.0 + 2.0 ** -10
GRAM_ERR = 2.0 ** -19
CULL_SLACK = 1.0 + 2.0 ** -16

launches = 0   # CUDA kernels of the blocked pass launched (plain int)


class ContactParams(ctypes.Structure):
    """Mirror of ``struct ContactParams`` in ``csrc/contact_xpbd.cuh``."""

    _fields_ = [("n", ctypes.c_int), ("block", ctypes.c_int),
                ("nb", ctypes.c_int), ("m_nbr", ctypes.c_int),
                ("si", ctypes.c_int), ("sc", ctypes.c_int),
                ("diam", ctypes.c_float), ("diam2", ctypes.c_float),
                ("omega", ctypes.c_float), ("design", ctypes.c_int)]


_BUFFERS = ("pred", "w", "order", "stats", "xs", "sq", "ws", "xq", "box",
            "sbox", "nbr", "ok", "corr", "bits", "codes", "codes_sorted",
            "iota", "sort_temp")


class ContactBuffers(ctypes.Structure):
    """Mirror of ``struct ContactBuffers`` (device pointers, same order)."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _BUFFERS]
                + [("sort_temp_bytes", ctypes.c_longlong)])


def layout(n: int, cfg: SolverConfig):
    """(block, row blocks, padded count, candidates per row) of the blocked
    pass over n particles, as ``ops.spatial_hash._blocked_layout`` sizes
    it."""
    block = max(8, min(cfg.collision_block_size, n))
    npad = ((n + block - 1) // block) * block
    nb = npad // block
    return block, nb, npad, min(cfg.block_neighbors, nb)


def check_layout(n: int, cfg: SolverConfig):
    """Refuse what the kernel does not take: more than ``MAX_BLOCK``
    particles per block (one thread each), or more than ``MAX_ROW_BLOCKS``
    row blocks."""
    block, nb, _, _ = layout(n, cfg)
    if block > MAX_BLOCK:
        raise NotImplementedError(
            f"contact kernel: collision_block_size {block} > {MAX_BLOCK}")
    if nb > MAX_ROW_BLOCKS:
        raise NotImplementedError(
            f"contact kernel: {nb} row blocks > {MAX_ROW_BLOCKS}; raise "
            "collision_block_size")


def make_params(n: int, cfg: SolverConfig, si: int, sc: int,
                design: str = "culled") -> ContactParams:
    """The pass's constants, rounded to float32 as the plain version's
    Python floats are; positions element (i, c) at ``i * si + c * sc``."""
    block, nb, _, m_nbr = layout(n, cfg)
    p = ContactParams()
    p.n, p.block, p.nb, p.m_nbr, p.si, p.sc = n, block, nb, m_nbr, si, sc
    p.diam = 2.0 * cfg.particle_radius
    p.diam2 = (2.0 * cfg.particle_radius) ** 2
    p.omega = cfg.self_collision_omega
    p.design = DESIGNS[design]
    return p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's types."""
    lib = _build.load_library(LIB_NAME, SOURCES, NVCC_EXTRA)
    declare(lib)
    ptr = ctypes.c_void_p
    for name in ("contact_xpbd_project", "contact_xpbd_select_only",
                 "contact_xpbd_order_only"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ContactParams),
                       ctypes.POINTER(ContactBuffers), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong), ptr]
        fn.restype = ctypes.c_int
    lib.contact_xpbd_corr.argtypes = [ctypes.POINTER(ContactParams),
                                      ctypes.POINTER(ContactBuffers),
                                      ctypes.POINTER(ctypes.c_longlong), ptr]
    lib.contact_xpbd_corr.restype = ctypes.c_int
    return lib


def declare(lib: ctypes.CDLL):
    """Types of the entry points the contact and mesh libraries share, and
    the check that the ctypes mirrors match the C structs."""
    lib.contact_xpbd_params_size.restype = ctypes.c_int
    lib.contact_xpbd_buffers_size.restype = ctypes.c_int
    lib.contact_xpbd_sort_bytes.argtypes = [ctypes.c_int]
    lib.contact_xpbd_sort_bytes.restype = ctypes.c_longlong
    lib.contact_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.contact_xpbd_error_string.restype = ctypes.c_char_p
    if (lib.contact_xpbd_params_size() != ctypes.sizeof(ContactParams)
            or lib.contact_xpbd_buffers_size()
            != ctypes.sizeof(ContactBuffers)):
        raise RuntimeError("ContactParams / ContactBuffers layout differs "
                           "between contact_cuda.py and contact_xpbd.cuh")


def scratch(lib: ctypes.CDLL, n: int, cfg: SolverConfig, device,
            design: str = "culled") -> dict:
    """The pass's scratch tensors on ``device`` (ContactBuffers field ->
    tensor), the radix sort's included; the layout buffers are those of
    ``design`` only (the other design's stay NULL)."""
    block, nb, npad, m_nbr = layout(n, cfg)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    out = dict(order=i32(n), stats=f32(9), ws=f32(npad), box=f32(nb, 6),
               nbr=i32(nb, m_nbr), ok=i32(nb, m_nbr), corr=f32(3, npad),
               codes=i32(n), codes_sorted=i32(n), iota=i32(n),
               sort_temp=torch.empty(max(1, lib.contact_xpbd_sort_bytes(n)),
                                     dtype=torch.uint8, device=device))
    if DESIGNS[design] == DESIGNS["culled"]:
        out.update(xq=f32(npad, 4), sbox=f32(nb * -(-block // SUB), 8))
    else:
        out.update(xs=f32(3, npad), sq=f32(npad))
    return out


def buffers(tensors: dict) -> ContactBuffers:
    b = ContactBuffers(**{k: ctypes.c_void_p(t.data_ptr())
                          for k, t in tensors.items() if k in _BUFFERS})
    if "sort_temp" in tensors:
        b.sort_temp_bytes = tensors["sort_temp"].numel()
    return b


def _checked(pred, inv_mass, order, cfg: SolverConfig):
    n = pred.shape[0]
    if (pred.dtype != torch.float32 or tuple(pred.shape) != (n, 3)
            or inv_mass.dtype != torch.float32
            or tuple(inv_mass.shape) != (n,) or tuple(order.shape) != (n,)
            or inv_mass.device != pred.device
            or order.device != pred.device):
        raise ValueError("contact kernel: needs pred (N, 3) and inv_mass "
                         "(N,) float32 and order (N,) on one device")
    check_layout(n, cfg)
    return n


def _launch(entry: str, n: int, cfg: SolverConfig, tensors: dict, device,
            design: str):
    """Call one entry point of the library on the current stream."""
    global launches
    lib = _library()
    p = make_params(n, cfg, 3, 1, design)
    count = ctypes.c_longlong(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, entry)(ctypes.byref(p), ctypes.byref(buffers(tensors)),
                             device.index, ctypes.byref(count),
                             ctypes.c_void_p(stream))
    launches += count.value
    if rc != 0:
        msg = lib.contact_xpbd_error_string(rc).decode()
        raise RuntimeError(f"contact kernel launch failed: {msg} ({rc})")


def _c_pipeline(entry: str, pred, inv_mass, order, cfg: SolverConfig,
                design: str, touch_bits=False):
    """Run one entry point of the library on a copy of ``pred``; returns its
    tensors (``pred`` holds the result where the entry writes one)."""
    n = _checked(pred, inv_mass, order, cfg)
    lib = _library()
    t = scratch(lib, n, cfg, pred.device, design)
    t.update(pred=pred.contiguous().clone(), w=inv_mass.contiguous())
    if entry != "contact_xpbd_order_only":
        t["order"] = order.to(torch.int32).contiguous()
    if touch_bits:
        block, nb, npad, m_nbr = layout(n, cfg)
        t["bits"] = torch.empty((npad, (m_nbr * block + 31) // 32),
                                dtype=torch.int32, device=pred.device)
    _launch(entry, n, cfg, t, pred.device, design)
    return t


def self_collision_project_blocked_cuda(pred, inv_mass, order,
                                        cfg: SolverConfig, *,
                                        design: str = "culled"):
    """One blocked separation pass (``self_collision_project_blocked``
    semantics): a CUDA tensor launches the passes the mesh library's loop
    runs (stats; layout and AABBs; selection and pair tests) and an
    unsort-apply, a CPU tensor runs the plain version, any other device
    raises.  ``design="serial"``: the yardstick (module docstring), for
    the card tests and ``chip_smoke.py``, never a route.  No host sync."""
    if pred.device.type == "cuda":
        return _c_pipeline("contact_xpbd_project", pred, inv_mass, order,
                           cfg, design)["pred"]
    if pred.device.type == "cpu":
        return _sh.self_collision_project_blocked(pred, inv_mass, order, cfg)
    raise NotImplementedError(f"contact kernel: no path for {pred.device}")


def corr_runner(pred, inv_mass, order, cfg: SolverConfig,
                design: str = "culled"):
    """A function that launches the pass up to the correction, as the mesh
    library's loop runs it (three launches; the serial design's five), on
    scratch allocated once, for CUDA tensors: for timing the kernels
    without the standalone entry's per-call set-up (``chip_smoke.py``).
    Launches count in ``launches``."""
    n = _checked(pred, inv_mass, order, cfg)
    lib = _library()
    t = scratch(lib, n, cfg, pred.device, design)
    t.update(pred=pred.contiguous(), w=inv_mass.contiguous(),
             order=order.to(torch.int32).contiguous())
    p, b = make_params(n, cfg, 3, 1, design), buffers(t)
    count = ctypes.c_longlong(0)

    def run():
        global launches
        count.value = 0
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        rc = lib.contact_xpbd_corr(ctypes.byref(p), ctypes.byref(b),
                                   ctypes.byref(count),
                                   ctypes.c_void_p(stream))
        launches += count.value
        if rc != 0:
            msg = lib.contact_xpbd_error_string(rc).decode()
            raise RuntimeError(f"contact kernel launch failed: {msg} ({rc})")
        return t["corr"]

    return run


def touching_pairs_cuda(pred, inv_mass, order, cfg: SolverConfig,
                        design: str = "culled"):
    """The pass's touching pairs as the pair kernel classifies them: a bool
    ``(npad, M * B)`` mask in the layout of
    ``ops.spatial_hash.blocked_touching_pairs`` (CUDA tensors; a
    diagnostic, not on the hot path)."""
    t = _c_pipeline("contact_xpbd_project", pred, inv_mass, order, cfg,
                    design, touch_bits=True)
    block, m_nbr = layout(pred.shape[0], cfg)[0], t["nbr"].shape[1]
    shifts = torch.arange(32, device=pred.device, dtype=torch.int32)
    bits = (t["bits"][:, :, None] >> shifts) & 1
    return bits.reshape(t["bits"].shape[0], -1)[:, :m_nbr * block].bool()


def curve_order_cuda(pred, cfg: SolverConfig):
    """The mesh library's curve order of (N, 3) CUDA positions (int32), which
    equals ``ops.spatial_hash.morton_order``."""
    z = torch.zeros(pred.shape[0], dtype=torch.int32, device=pred.device)
    return _c_pipeline("contact_xpbd_order_only", pred, z.float(), z,
                       cfg, "culled")["order"]


def candidates_cuda(pred, inv_mass, order, cfg: SolverConfig,
                    design: str = "culled"):
    """The mesh library's candidate blocks (nbr, ok) of (N, 3) CUDA
    positions in the curve order ``order``: ``ops.spatial_hash.
    select_candidates`` of its own centred layout."""
    t = _c_pipeline("contact_xpbd_select_only", pred, inv_mass, order, cfg,
                    design)
    return t["nbr"], t["ok"].bool()


def touch_bound(diam: float) -> np.float32:
    """The cheap test's bound (``t_touch`` in ``csrc/contact_xpbd.cu``):
    float32(diam) squared, rounded up to a float32."""
    d = np.float32(diam)
    t = np.float32(d * d)
    # the double product of two float32 is exact
    if float(t) < float(d) * float(d):
        t = np.nextafter(t, np.float32(np.inf))
    return t


def _gap2(alo, ahi, blo, bhi):
    """Squared gaps between AABBs as ``cx_gap2`` takes them (broadcast)."""
    g = torch.clamp(torch.maximum(alo - bhi, blo - ahi), min=0.0)
    return ((g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1])
            + g[..., 2] * g[..., 2])


def warp_cull_plain(pred, inv_mass, order, cfg: SolverConfig):
    """The plain mirror of the culled design's warp cull, in float32: the
    bound from the stats of ``pred`` (``cx_cull_bound``), the AABB of each
    warp's 32 rows in the plain layout, and, for each row slot and
    candidate column of the touching candidates, whether its warp skips
    the candidate point (the kernel skips a whole sub-block first only
    where it would skip each of its points).  Returns (skip: bool
    ``(npad, M * B)`` in the layout of ``ops.spatial_hash.
    blocked_touching_pairs``, the pair tests the cull keeps, the candidate
    pair tests of touching blocks)."""
    x, _, _, touch, d2ab, _, block, nb = _sh._blocked_layout(
        pred, inv_mass, order, cfg)
    m_nbr = min(cfg.block_neighbors, nb)
    nbr, ok = _sh.select_candidates(touch, d2ab, m_nbr)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    mean = pred.mean(dim=0)
    e = torch.maximum((pred.amax(dim=0) - mean).abs(),
                      (mean - pred.amin(dim=0)).abs())
    smax = ((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) * f32(SMAX_SLACK)
    t_touch = f32(float(touch_bound(2.0 * cfg.particle_radius)))
    t_cull = (t_touch + smax * f32(GRAM_ERR)) * f32(CULL_SLACK)
    nsub = -(-block // SUB)
    pad = nsub * SUB - block
    xb = x.reshape(nb, block, 3)
    lo = torch.cat([xb, xb.new_full((nb, pad, 3), float("inf"))], 1)
    hi = torch.cat([xb, xb.new_full((nb, pad, 3), float("-inf"))], 1)
    lo = lo.reshape(nb, nsub, SUB, 3).amin(dim=2)[:, :, None, None]
    hi = hi.reshape(nb, nsub, SUB, 3).amax(dim=2)[:, :, None, None]
    pts = xb[nbr][:, None]                                 # (nb, 1, M, B, 3)
    # (row block, warp, candidate, candidate particle)
    skip = _gap2(lo, hi, pts, pts) > t_cull
    rows = torch.full((nsub,), SUB, device=x.device)
    rows[-1] = block - (nsub - 1) * SUB
    kept = ((~skip) & ok[:, None, :, None]).sum(dim=(2, 3))  # (nb, nsub)
    full = skip[:, torch.arange(block, device=x.device) // SUB]
    return (full.reshape(nb * block, m_nbr * block), int((kept * rows).sum()),
            int(ok.sum()) * block * block)
