"""The port's twin of ``bench.py``: particle-substeps per second of the
res-40 braced lattice (64,000 particles) on one GPU.

    python -m softbodysimulation_tpu_torch.bench

The workload is ``bench.py``'s ``build()``: RESET, JACOBI x 1,
``fast_math``, 8 substeps of 1/480 s, floor with friction 0.3, 1 g
particles (``mass=0.001``), and its ``BENCH_RES``, ``BENCH_SUBSTEPS``,
``BENCH_SUBSTEPS_PER_CALL`` and ``BENCH_SECONDS`` knobs.  The plain stencil
engine on the card gives the reference rollout of ``SUBSTEPS_PER_CALL``
substeps; then the lattice kernel (TPU kernel B-1's port) with
``approx_math``, then exact, each from the same start.  A candidate counts
only if its rollout stays within 1e-3 of the reference and its state
passes ``bench.py``'s health gates (finite, ymin > -1e-2, height > 0.5)
after it is timed; a candidate that fails to build, to launch or a gate
fails the run with a nonzero exit.  Timing syncs with
``torch.cuda.synchronize()``.

Prints one JSON line: ``metric``, ``value`` and ``unit`` as ``bench.py``
prints them (the best engine's rate), each engine's rate and drift, and
the card's name.  Without a card it prints nothing and exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from .core.config import LambdaMode, SolveMode, SolverConfig
from .kernels import lattice_cuda
from .solvers import lattice as lat
from .topology import lattice

DT = 1.0 / 60.0
DRIFT_GATE = 1e-3


@dataclasses.dataclass(frozen=True)
class Settings:
    res: int = 40
    substeps: int = 8
    substeps_per_call: int = 2000
    seconds: float = 5.0

    @staticmethod
    def from_env() -> "Settings":
        """``bench.py``'s environment knobs."""
        return Settings(
            res=int(os.environ.get("BENCH_RES", "40")),
            substeps=int(os.environ.get("BENCH_SUBSTEPS", "8")),
            substeps_per_call=int(os.environ.get("BENCH_SUBSTEPS_PER_CALL",
                                                 "2000")),
            seconds=float(os.environ.get("BENCH_SECONDS", "5.0")))


def build(settings: Settings, device="cuda"):
    """(spec, config, state): ``bench.py``'s ``build()``."""
    spec = lattice.lattice_spec(settings.res, braced=True)
    cfg = SolverConfig(
        substeps=settings.substeps,
        iterations=1,
        damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        fast_math=True,
        ground_height=0.0,
        friction=0.3,
    )
    state = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                   mass=0.001, device=device)
    return spec, cfg, state


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def health(positions: torch.Tensor) -> None:
    """``bench.py``'s gates on a state's positions; raises on a failure."""
    p = positions.detach().cpu()
    if not bool(torch.isfinite(p).all()):
        raise RuntimeError("non-finite state after benchmark")
    ymin = float(p[:, 1].min())
    if ymin <= -1e-2:
        raise RuntimeError(f"floor violated after benchmark: {ymin}")
    height = float(p[:, 1].max()) - ymin
    if height <= 0.5:
        raise RuntimeError(f"cube degenerated during benchmark: {height}")


def drift(name: str, out, ref) -> float:
    """max |dx| of a candidate's rollout against the reference's, gated at
    ``DRIFT_GATE``."""
    d = float((out.positions - ref.positions).abs().max())
    if not d < DRIFT_GATE:
        raise RuntimeError(f"{name} diverges from the plain engine: {d}")
    return d


def measure(step, state, n_particles: int, n_substeps: int, seconds: float,
            device) -> float:
    """Particle-substeps per second of ``step`` (``n_substeps`` a call)
    from ``state``, synchronising every 10 calls until ``seconds`` have
    passed; the health gates then hold on the end state."""
    calls = 0
    sync(device)
    t0 = time.perf_counter()
    while True:
        state = step(state)
        calls += 1
        if calls % 10 == 0:
            sync(device)
            if time.perf_counter() - t0 >= seconds:
                break
    sync(device)
    elapsed = time.perf_counter() - t0
    health(state.positions)
    return n_particles * calls * n_substeps / elapsed


def run(settings: Settings, device="cuda") -> dict:
    """Every engine's rate and drift: ``{"plain": ..., "cuda_approx": ...,
    "cuda": ...}``, each ``{"rate": particle-substeps/s, "drift": max
    |dx|}``; raises where a candidate fails."""
    spec, cfg, state = build(settings, device)
    dt_sub = DT / settings.substeps
    n, k = spec.n_particles, settings.substeps_per_call
    sync(device)
    t0 = time.perf_counter()
    # the plain stencil engine itself (the solver's make_substep_runner
    # would launch the kernel on a CUDA state)
    ref = lat.run_substeps_plain(state, spec, cfg, dt_sub, k)
    sync(device)
    engines = {"plain": {"rate": n * k / (time.perf_counter() - t0),
                         "drift": 0.0}}
    health(ref.positions)
    for name, approx in (("cuda_approx", True), ("cuda", False)):
        runner = lattice_cuda.make_cuda_substep_runner(
            spec, cfg, dt_sub, k, approx_math=approx)
        warm = runner(state)
        d = drift(name, warm, ref)
        engines[name] = {"rate": measure(runner, warm, n, k,
                                         settings.seconds, device),
                         "drift": d}
    return engines


def result_line(engines: dict, n_particles: int, device_name: str) -> dict:
    """``bench.py``'s line (the best engine wins), with every engine's
    rate and drift."""
    engine, best = max(engines.items(), key=lambda kv: kv[1]["rate"])
    return {
        "metric": f"particle_substeps_per_sec_{n_particles // 1000}k_1gpu_"
                  f"{engine}",
        "value": float(f"{best['rate']:.4g}"),
        "unit": "particle-substeps/s",
        "engines": {k: {"rate": float(f"{v['rate']:.4g}"),
                        "drift": v["drift"]} for k, v in engines.items()},
        "device": device_name,
    }


def main(settings: Settings | None = None) -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the port's bench runs only on a GPU",
              file=sys.stderr)
        return 1
    settings = settings or Settings.from_env()
    engines = run(settings, "cuda")
    n = lattice.lattice_spec(settings.res, braced=True).n_particles
    print(json.dumps(result_line(engines, n,
                                 torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
