#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's lattice main path through the entry points a user calls
and fails (nonzero exit) if any phase fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the CUDA lattice kernel built from ``softbodysimulation_tpu_torch/csrc``
   with ``nvcc`` (sm_90a), and the build time;
3. kernel vs its plain PyTorch version on the card, at res 6 over 12-18
   substeps, for each configuration the CPU tests hold against the JAX
   package (``tests/test_torch_cases.py``): max |dx| < 1e-5,
   max |dlambda| < 1e-6 and < 1 % of max |lambda|, max |dv| < 1e-5 / dt_sub;
4. the main path at full size: the ``flagship_perf`` scene (braced res-40
   lattice, 64,000 particles) through ``make_cuda_substep_runner`` for 2000
   substeps, with ``bench.py``'s health gates (finite, ymin > -1e-2, height
   > 0.5), its drift gate (max |dx| < 1e-3 against the plain version from
   the same start) and the kernel's launch count; then, from the rested
   state with seeded velocity jitter, 16 substeps of kernel vs plain at
   the parity gates of phase 3;
5. the entry configuration (res 16, WARM_START) through ``make_cuda_step``
   for 60 frames with a poke at frame 10: finite, ``ext_force`` reads back
   0, and the poke moves the centre of mass; then, from that state and a
   second poke, 4 frames (16 substeps, multipliers carried between them)
   of ``make_cuda_step`` vs the plain ``multi_step_fn`` at the same gates;
6. particle-substeps/s of the kernel and of the plain version at res 40,
   timed with CUDA events over windows of at least a second, two windows
   each, taken in turns; the best window and the range are printed.

Prints one JSON line of kernels, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero and prints no result.  ``--profile`` adds a torch.profiler
breakdown of 200 main-path substeps (device time by kernel, host time per
launch, device idle share).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RES_MAIN = 40
MAIN_SUBSTEPS = 2000
DX_TOL = 1e-5
DLAM_TOL = 1e-6
# multipliers of 1 g particles are ~1e-6 in size, where DLAM_TOL alone
# would pass any output; so they must also agree to 1 % of their largest
LAM_REL = 1e-2
DRIFT_TOL = 1e-3


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def compare(torch, name, out, ref, start, dt_sub, n_sub, is_finite):
    """Hold a kernel result against the plain engine's from the same start
    (positions 1e-5, multipliers 1e-6 and LAM_REL of their largest
    magnitude, velocities 1e-5 / dt_sub, since v = (pred - x) / dt_sub) and
    raise when it disagrees.  Returns max |dx|."""
    torch.cuda.synchronize()
    d = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
         for k in ("positions", "lambda_dist", "velocities")}
    lam = float(ref.lambda_dist.abs().max())
    moved = float((out.positions - start.positions).abs().max())
    print(f"# parity {name}: max|dx|={d['positions']:.3e} "
          f"max|dlam|={d['lambda_dist']:.3e} (max|lam|={lam:.3e}) "
          f"max|dv|={d['velocities']:.3e} (moved {moved:.3e}) over "
          f"{n_sub} substeps")
    if not (d["positions"] < DX_TOL and d["lambda_dist"] < DLAM_TOL
            and d["lambda_dist"] <= LAM_REL * lam
            and d["velocities"] < DX_TOL / dt_sub and is_finite(out)):
        raise RuntimeError(f"kernel disagrees with plain on {name}: {d}")
    return d["positions"]


def cuda_ms(torch, fn, reps):
    """Milliseconds per call of ``fn`` on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_main_path(torch, run, state):
    """Device time by kernel, host time per launch and the device's idle
    share over one call of ``run`` (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in dev)
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"# profile: {name[:60]}: {n} x {t / n:.3f} us = {t:.1f} us")
    launch = [e for e in prof.events() if e.name == "cudaLaunchKernel"]
    if launch:
        host = sum(e.time_range.elapsed_us() for e in launch)
        print(f"# profile: host cudaLaunchKernel {len(launch)} x "
              f"{host / len(launch):.3f} us")
    print(f"# profile: wall {wall_us:.1f} us, device span {span:.1f} us, "
          f"device busy {busy:.1f} us, idle share of the span "
          f"{1 - busy / span:.4f}, of the wall {1 - busy / wall_us:.4f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_cases as lattice_cases

    from softbodysimulation_tpu_torch.core import config as C
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.interact import forces
    from softbodysimulation_tpu_torch.kernels import _build
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.solvers import lattice as lat
    from softbodysimulation_tpu_torch.topology import lattice as top
    from softbodysimulation_tpu_torch import is_finite, state_from_numpy

    # 1. the card
    smi = smi_line()
    print(f"# gpu: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    path, log = _build.build_library(lc.LIB_NAME, lc.SOURCES)
    build_s = time.perf_counter() - t0
    print(f"# build: {os.path.relpath(path, HERE)} in {build_s:.2f} s")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"#   {ln.strip()}")

    # 3. kernel vs plain on the card, res 6
    max_err = 0.0
    for name, (cfg, inputs, substeps) in lattice_cases.parity_cases().items():
        spec = top.lattice_spec(6, braced=inputs.get("braced", True))
        st = state_from_numpy(lattice_cases.seeded_inputs(6, **inputs),
                              device="cuda")
        dt_sub, n_sub, with_ext = lattice_cases.run_length(cfg, substeps)
        out = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_sub,
                                          with_ext=with_ext)(st)
        ref = lat.run_substeps_plain(st, spec, cfg, dt_sub, n_sub,
                                     with_ext=with_ext)
        max_err = max(max_err, compare(torch, f"{name} res 6", out, ref, st,
                                       dt_sub, n_sub, is_finite))

    # 4. the main path at full size
    state, _, info = scenes.flagship_perf(res=RES_MAIN, device="cuda")
    spec, cfg = info["spec"], info["config"]
    dt_sub = info["dt"] / cfg.substeps
    runner = lc.make_cuda_substep_runner(spec, cfg, dt_sub, MAIN_SUBSTEPS)
    torch.cuda.synchronize()
    lc.launches = 0
    t0 = time.perf_counter()
    out = runner(state)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = lc.launches
    p = out.positions.cpu().numpy()
    height = float(p[:, 1].max() - p[:, 1].min())
    ymin = float(p[:, 1].min())
    print(f"# main path: flagship_perf res {RES_MAIN} "
          f"({spec.n_particles} particles, {spec.n_families} families), "
          f"{MAIN_SUBSTEPS} substeps in {main_s:.3f} s wall, "
          f"{main_launches} kernel launches")
    print(f"# health: finite={bool(np.isfinite(p).all())} ymin={ymin:.6f} "
          f"height={height:.6f}")
    if not np.isfinite(p).all():
        raise RuntimeError("non-finite state after the main path")
    if ymin <= -1e-2:
        raise RuntimeError(f"floor violated: ymin={ymin}")
    if height <= 0.5:
        raise RuntimeError(f"cube degenerated: height={height}")
    if main_launches <= 0:
        raise RuntimeError("the main path launched no kernel")
    plain = lat.run_substeps_plain(state, spec, cfg, dt_sub, MAIN_SUBSTEPS)
    drift = float((out.positions - plain.positions).abs().max())
    print(f"# drift vs plain, {MAIN_SUBSTEPS} substeps from the same start: "
          f"{drift:.3e} (gate {DRIFT_TOL})")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"kernel drifts from the plain engine: {drift}")
    # the main-path shapes at the parity gates, from the rested state (on
    # the floor) with velocity jitter ~ N(0, 0.05) from a seed, so that the
    # body moves and its constraints load
    n_cmp = 16
    jitter = np.random.default_rng(0).normal(0.0, 0.05, (spec.n_particles, 3))
    start = out.replace(velocities=out.velocities + torch.as_tensor(
        jitter, dtype=torch.float32, device="cuda"))
    max_err = max(max_err, compare(
        torch, f"bench res {RES_MAIN}",
        lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_cmp)(start),
        lat.run_substeps_plain(start, spec, cfg, dt_sub, n_cmp), start,
        dt_sub, n_cmp, is_finite))

    # 5. the entry configuration with a poke
    ecfg = C.SolverConfig(substeps=4, iterations=1, damping=0.02,
                          solve_mode=C.SolveMode.JACOBI,
                          lambda_mode=C.LambdaMode.WARM_START,
                          lambda_decay=1.0, ground_height=0.0, friction=0.3)
    espec = top.lattice_spec(16, braced=True)
    step = lc.make_cuda_step(espec, ecfg, 1 / 60)
    poked = control = lat.make_lattice_state(espec, center=(0.0, 1.0, 0.0),
                                             device="cuda")
    before = lc.launches
    for frame in range(60):
        if frame == 10:
            com = poked.positions.mean(0)
            poked = forces.add_force(poked, (300.0, 0.0, 0.0),
                                     com.tolist(), radius=1.0)
        poked, control = step(poked), step(control)
        if frame == 10 and float(poked.ext_force.abs().max()) != 0.0:
            raise RuntimeError("ext_force not consumed by the step")
    torch.cuda.synchronize()
    shift = float((poked.positions.mean(0)
                   - control.positions.mean(0)).abs().max())
    ok_entry = is_finite(poked) and is_finite(control)
    print(f"# entry: res 16 WARM_START, 60 frames x 4 substeps, "
          f"{lc.launches - before} launches, finite={ok_entry}, "
          f"poke moved the COM by {shift:.4f} vs the unpoked run")
    if not ok_entry or shift <= 1e-3:
        raise RuntimeError(f"entry phase failed: finite={ok_entry} "
                           f"shift={shift}")
    # the entry shapes at the parity gates: 4 frames from the poked state
    # with its carried multipliers and a second poke (ext force consumed on
    # the first substep)
    start = forces.add_force(poked, (-200.0, 100.0, 0.0),
                             poked.positions.mean(0).tolist(), radius=1.0)
    max_err = max(max_err, compare(
        torch, "entry res 16",
        lc.make_cuda_step(espec, ecfg, 1 / 60, n_steps=4)(start),
        lat.multi_step_fn(start, espec, ecfg, 1 / 60, 4), start,
        1 / 60 / ecfg.substeps, 4 * ecfg.substeps, is_finite))

    # 6. throughput at res 40 (CUDA events), kernel and plain, in turns,
    # each window at least a second long
    n_k, reps_k, n_p = MAIN_SUBSTEPS, 8, 300
    k_run = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_k)
    times = {"kernel": [], "plain": []}
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms = cuda_ms(torch, lambda: k_run(state), reps_k) / n_k
        else:
            ms = cuda_ms(torch, lambda: lat.run_substeps_plain(
                state, spec, cfg, dt_sub, n_p), 1) / n_p
        times[order].append(ms)
    ms_k = min(times["kernel"])
    ms_p = min(times["plain"])
    n = spec.n_particles
    print(f"# throughput res {RES_MAIN} ({smi}), best of two windows: "
          f"kernel {ms_k:.5f} ms/substep = {n / ms_k * 1e3:.4e} "
          f"particle-substeps/s over {reps_k * n_k} substeps; plain "
          f"{ms_p:.5f} ms/substep = {n / ms_p * 1e3:.4e} particle-substeps/s"
          f" over {n_p} substeps")
    for key in ("kernel", "plain"):
        lo, hi = min(times[key]), max(times[key])
        print(f"# throughput range {key}: {lo:.5f}-{hi:.5f} ms/substep = "
              f"{n / hi * 1e3:.4e}-{n / lo * 1e3:.4e} particle-substeps/s "
              f"(windows in turn order: {times[key]})")

    if "--profile" in sys.argv[1:]:
        profile_main_path(
            torch, lc.make_cuda_substep_runner(spec, cfg, dt_sub, 200),
            state)

    print(json.dumps({"kernels": [{
        "name": "lattice_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/lattice_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/lattice_pallas.py:501",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
