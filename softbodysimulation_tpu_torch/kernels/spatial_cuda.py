"""The hand-written CUDA slab kernel (``csrc/spatial_xpbd.cu``, TPU kernel
B-6) and its runner.

Counterpart of ``softbodysimulation_tpu/kernels/spatial_pallas.py``:
``make_spatial_cuda_substep`` stands for ``make_spatial_pallas_substep``.
One lattice is split along x into slabs, one per entry of ``devices``
(repeats allowed), and each slab runs its substep loop on its own CUDA
stream, the halo planes moved between passes by device-to-device copies
(``csrc/spatial_xpbd.cu`` says how they are ordered).

Device dispatch, with no fallback: slabs on CUDA devices launch the kernel
(or raise); slabs on the CPU run the kernel's plain version, the sharded
engine ``parallel.spatial.run_sharded_plain``.  The library is built with
``nvcc`` on the first CUDA call (``kernels/_build.py``), never at import.

``launches`` counts the CUDA kernels this module has launched, ``copies``
the halo copies and ``bytes_exchanged`` their bytes; callers may reset them
to 0 to count one run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.colliders import check_kin
from ..core.config import SolverConfig
from ..ops import collision as _collision
from ..ops import integrate as _integrate
from ..parallel import spatial as _spatial
from ..topology.lattice import LatticeSpec
from . import _build
from . import lattice_cuda as _lc

LIB_NAME = "spatial_xpbd"
SOURCES = ("spatial_xpbd.cu",)
NVCC_EXTRA = ("-fmad=false",)
MAX_SLABS = 64

launches = 0          # CUDA kernels launched by this module
copies = 0            # halo copies between slabs
bytes_exchanged = 0   # bytes those copies moved


class SlabArgs(ctypes.Structure):
    """Mirror of ``struct SlabArgs`` in ``csrc/spatial_xpbd.cu`` (every
    field 8 bytes wide, same order)."""

    _fields_ = [("device", ctypes.c_longlong)] + [
        (name, ctypes.c_void_p) for name in (
            "stream", "caller_stream", "x", "v", "w", "f", "lam",
            "lam_scratch", "pred_a", "pred_b", "w_left", "w_right",
            "halo_left", "halo_right")]


def _check_supported(cfg: SolverConfig, spec: LatticeSpec, n_slabs: int):
    """Build-time refusals: the sharded engine's, and what the kernel does
    not carry (the TPU kernel's ``_check_supported`` and its plane and
    offset rules; not its TPU-only res^2 % 128 lane rule)."""
    _spatial.check_supported(cfg, spec)
    xla = ("; the sharded torch engine carries it on the card: "
           "make_spatial_lattice_step(..., backend=\"xla\")")
    if cfg.enable_tet_volume:
        raise NotImplementedError(
            "spatial kernel: per-cell tets are not carried" + xla)
    if cfg.sphere_colliders or cfg.box_colliders:
        raise NotImplementedError(
            "spatial kernel: SDF colliders are not carried" + xla)
    if spec.res // n_slabs < 2:
        raise NotImplementedError(
            "spatial kernel needs >= 2 x-planes per slab" + xla)
    if any(fam[0] not in (0, 1) for fam in spec.families):
        raise NotImplementedError(
            "spatial kernel: family x-offsets must be 0 or 1")
    if spec.n_families > _lc.MAX_FAM:
        raise NotImplementedError(
            f"spatial kernel: at most {_lc.MAX_FAM} offset families")
    if n_slabs > MAX_SLABS:
        raise NotImplementedError(
            f"spatial kernel: at most {MAX_SLABS} slabs")


def make_params(spec: LatticeSpec, cfg: SolverConfig, dt: float,
                n_slabs: int) -> _lc.LatticeParams:
    """The lattice kernel's constants for one slab of ``n_slabs``, with the
    plain sharded engine's roundings where they differ from the lattice
    engine's: the damping factor and the friction step of ``ops/``, and
    ``fast_math`` off (no spatial engine reads it)."""
    p = _lc.make_params(spec, cfg.replace(fast_math=False), dt)
    p.n = spec.n_particles // n_slabs
    p.damp_factor = _integrate.damping_factor(cfg, dt)
    p.sphere_dt_fr = _collision.friction_step(cfg, dt)
    return p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's types."""
    lib = _build.load_library(LIB_NAME, SOURCES, NVCC_EXTRA)
    lib.spatial_xpbd_slab_args_size.argtypes = []
    lib.spatial_xpbd_slab_args_size.restype = ctypes.c_int
    lib.spatial_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.spatial_xpbd_error_string.restype = ctypes.c_char_p
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.spatial_xpbd_run.argtypes = [
        ctypes.POINTER(_lc.LatticeParams), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(SlabArgs), ctypes.c_int, ctypes.c_int, ll, ll, ll]
    lib.spatial_xpbd_run.restype = ctypes.c_int
    if lib.spatial_xpbd_slab_args_size() != ctypes.sizeof(SlabArgs):
        raise RuntimeError("SlabArgs layout differs between spatial_cuda.py "
                           "and spatial_xpbd.cu")
    return lib


@functools.lru_cache(maxsize=None)
def _slab_stream(device: torch.device, slab: int) -> torch.cuda.Stream:
    """Slab ``slab``'s own stream on ``device`` (one per slab index, so
    slabs that share a card run on streams of their own)."""
    return torch.cuda.Stream(device=device)


def _checked(name, t, rows, m, device):
    shape = (rows, m) if rows else (m,)
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"spatial kernel: {name} must be float32 on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"spatial kernel: {name} must be contiguous "
                         f"{shape}, got {tuple(t.shape)}")
    return t


def run_slabs_cuda(sharded: _spatial.ShardedLatticeState, spec: LatticeSpec,
                   cfg: SolverConfig, dt_sub: float, n_substeps: int,
                   with_ext: bool = True) -> _spatial.ShardedLatticeState:
    """Launch the slab kernel for ``n_substeps`` substeps of slabs on CUDA
    devices; the semantics of ``parallel.spatial.run_sharded_plain``.  No
    host sync."""
    global launches, copies, bytes_exchanged
    devices = sharded.devices
    n_slabs = len(devices)
    _check_supported(cfg, spec, n_slabs)
    _spatial.check_tets(sharded, cfg)
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"spatial kernel: slabs on "
                         f"{[str(d) for d in devices]}, not CUDA")
    res, nfam = spec.res, spec.n_families
    r2 = res * res
    planes = res // n_slabs
    m = planes * r2
    keep, out, args = [], [], (SlabArgs * n_slabs)()
    for s, (slab, dev) in enumerate(zip(sharded.slabs, devices)):
        x = _checked("positions", slab.positions, 3, m, dev).clone()
        v = _checked("velocities", slab.velocities, 3, m, dev).clone()
        w = _checked("inv_mass", slab.inv_mass, 0, m, dev)
        f = _checked("ext_force", slab.ext_force, 3, m, dev)
        lam = _checked("lambda_dist", slab.lambda_dist, nfam, m,
                       dev).clone()
        scratch = [torch.empty_like(lam), torch.empty_like(x),
                   torch.empty_like(x)]
        # the halo planes of a slab without that neighbour stay zero, as
        # the plain exchange's
        halos = [torch.zeros((r2,), dtype=torch.float32, device=dev),
                 torch.zeros((r2,), dtype=torch.float32, device=dev),
                 torch.zeros((2, 4, r2), dtype=torch.float32, device=dev),
                 torch.zeros((2, 3, r2), dtype=torch.float32, device=dev)]
        stream = _slab_stream(dev, s)
        a = args[s]
        a.device = dev.index
        a.stream = stream.cuda_stream
        a.caller_stream = torch.cuda.current_stream(dev).cuda_stream
        for name, t in zip(("x", "v", "w", "f", "lam", "lam_scratch",
                            "pred_a", "pred_b", "w_left", "w_right",
                            "halo_left", "halo_right"),
                           (x, v, w, f, lam, *scratch, *halos)):
            setattr(a, name, t.data_ptr())
        keep += [x, v, lam, *scratch, *halos]
        out.append(slab.replace(
            positions=x, velocities=v, lambda_dist=lam,
            ext_force=torch.zeros_like(f) if with_ext else f))
    params = make_params(spec, cfg, dt_sub, n_slabs)
    counts = [ctypes.c_longlong(0) for _ in range(3)]
    rc = _library().spatial_xpbd_run(
        ctypes.byref(params), n_slabs, planes, args, int(with_ext),
        n_substeps, *(ctypes.byref(c) for c in counts))
    launches += counts[0].value
    copies += counts[1].value
    bytes_exchanged += counts[2].value
    if rc != 0:
        msg = _library().spatial_xpbd_error_string(rc).decode()
        raise RuntimeError(f"spatial kernel launch failed: {msg} ({rc})")
    # ``keep`` holds the scratch until here; the caller's streams wait for
    # the slab streams (joined in the run), so the allocator reuses it only
    # after the kernels
    return sharded.replace(slabs=tuple(out))


def advance(sharded: _spatial.ShardedLatticeState, spec: LatticeSpec,
            cfg: SolverConfig, dt_sub: float, n_substeps: int,
            with_ext: bool = True) -> _spatial.ShardedLatticeState:
    """Slabs on CUDA devices launch the kernel; slabs on the CPU run the
    plain sharded engine; any other device raises."""
    kind = sharded.devices[0].type
    if kind == "cuda":
        return run_slabs_cuda(sharded, spec, cfg, dt_sub, n_substeps,
                              with_ext)
    if kind == "cpu":
        return _spatial.run_sharded_plain(sharded, spec, cfg, dt_sub,
                                          n_substeps, with_ext)
    raise NotImplementedError(f"spatial kernel: no path for slabs on "
                              f"{kind}")


def make_spatial_cuda_substep(spec: LatticeSpec, cfg: SolverConfig,
                              dt: float, devices, n_steps: int = 1):
    """A step advancing ``n_steps`` frames of ``cfg.substeps`` substeps of
    one lattice in slabs over ``devices``, ``ext_force`` consumed on the
    first substep and zeroed after; it takes a ``SimState`` or a
    ``ShardedLatticeState`` and returns the same kind.  What the kernel
    does not carry raises ``NotImplementedError`` here, at build time."""
    devs = _spatial.slab_devices(devices, spec.res)
    _check_supported(cfg, spec, len(devs))
    dt_sub = dt / cfg.substeps
    n_sub = n_steps * cfg.substeps

    def run(sh):
        # the kernel carries no colliders: a collider state is refused
        check_kin(None, sh.colliders and sh.colliders[0],
                  "slab kernel step")
        return advance(sh, spec, cfg, dt_sub, n_sub, with_ext=True)

    return _spatial.stepper(spec, devs, run)
