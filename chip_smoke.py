#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's lattice and mesh main paths through the entry points a
user calls and fails (nonzero exit) if any phase fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the CUDA lattice kernel built from ``softbodysimulation_tpu_torch/csrc``
   with ``nvcc`` (sm_90a), and the build time (both kernels' ``nvcc`` runs
   are started together);
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
   each, taken in turns; the best window and the range are printed;
7. the CUDA mesh kernel built from the same directory, its build time and
   ``-Xptxas -v`` registers and spills;
8. mesh kernel vs plain on the card for every case the CPU tests hold
   against the JAX package (``tests/test_torch_mesh_cases.py``): max |dx| <
   2e-5 (JACOBI) / 1e-5 (COLORED), max |dlambda_dist| < 1e-6, max
   |dlambda_bend| < 5e-6, both multipliers within 1 % of their largest,
   and the number of hinges whose bending-band masks differ between the
   two results;
9. the mesh main path at full size: the ``cloth_xl`` scene (res 129,
   16,641 particles, 49,408 edges, 48,896 hinges; JACOBI x 2 iterations,
   4 substeps, WARM_START, bending, floor, top row pinned) through
   ``make_mesh_cuda_step`` for 240 frames with a poke at frame 60 that has
   a z component: finite, the pinned row bit-identical to its start, ymin
   > -1e-2, ``ext_force`` reads back 0, the poke moves the centre of mass
   against an unpoked run, launches > 0; from the frame-120 state, 16
   substeps of kernel vs plain at the phase-8 gates; and the whole
   240-frame rollout against the plain engine from the same start (drift
   gate 1e-3; where the scene proves chaotic, 3x the spread between the
   plain engine on the card and on the CPU, at least 1e-4, and the smoke
   says so);
10. particle-substeps/s of the mesh kernel and of the plain engine at
   ``cloth_xl``, as phase 6 times the lattice.

Prints one JSON line of kernels, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero and prints no result.  ``--profile`` adds a torch.profiler
breakdown of 200 substeps of each main path (device time by kernel, host
time per launch, device idle share).
"""

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
RES_MAIN = 40
MAIN_SUBSTEPS = 2000
DX_TOL = 1e-5
DLAM_TOL = 1e-6
# multipliers of 1 g particles are ~1e-6 in size, where DLAM_TOL alone
# would pass any output; so they must also agree to 1 % of their largest
LAM_REL = 1e-2
DRIFT_TOL = 1e-3
MESH_FRAMES = 240


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


def timed_build(build, name, sources, extra=()):
    """Build one library; returns (path, compiler output, seconds)."""
    t0 = time.perf_counter()
    path, log = build.build_library(name, sources, extra)
    return path, log, time.perf_counter() - t0


def print_build(built):
    path, log, secs = built
    print(f"# build: {os.path.relpath(path, HERE)} in {secs:.2f} s")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"#   {ln.strip()}")


def mask_flips(torch, out, ref, topo, cfg):
    """Hinges whose bending-band masks (sin >= skip, sin < soften) differ
    between two results, evaluated at their final positions."""
    from softbodysimulation_tpu_torch.ops.bending import hinge_masks

    if not (cfg.enable_bending and topo.n_hinges):
        return 0
    hinges = topo.hinges.to(out.positions.device)
    a = hinge_masks(out.positions, hinges, cfg)
    b = hinge_masks(ref.positions, hinges, cfg)
    return int(((a[0] != b[0]) | (a[1] != b[1])).sum())


def mesh_compare(torch, name, out, ref, start, topo, cfg, n_sub, gates,
                 is_finite):
    """Hold a mesh kernel result against the plain engine's from the same
    start: positions at the case's gate, both multipliers at theirs and
    within LAM_REL of their largest magnitude; prints the mask-flip count.
    Raises when it disagrees.  Returns max |dx|."""
    torch.cuda.synchronize()
    dx_gate, dlam_gate, dbend_gate = gates
    dx = float((out.positions - ref.positions).abs().max())
    d, lam = {}, {}
    for k in ("lambda_dist", "lambda_bend"):
        r = getattr(ref, k)
        d[k] = float((getattr(out, k) - r).abs().max()) if r.numel() else 0.0
        lam[k] = float(r.abs().max()) if r.numel() else 0.0
    flips = mask_flips(torch, out, ref, topo, cfg)
    moved = float((out.positions - start.positions).abs().max())
    print(f"# mesh parity {name}: max|dx|={dx:.3e} "
          f"max|dlam|={d['lambda_dist']:.3e} (max|lam|="
          f"{lam['lambda_dist']:.3e}) max|dlam_bend|="
          f"{d['lambda_bend']:.3e} (max|lam_bend|={lam['lambda_bend']:.3e})"
          f" mask flips={flips} (moved {moved:.3e}) over {n_sub} substeps")
    ok = (dx < dx_gate and d["lambda_dist"] < dlam_gate
          and d["lambda_bend"] < dbend_gate and is_finite(out)
          and all(d[k] <= LAM_REL * lam[k] for k in d))
    if not ok:
        raise RuntimeError(f"mesh kernel disagrees with plain on {name}: "
                           f"dx={dx} {d} {lam}")
    return dx


def timed_windows(torch, runs, min_s=1.0):
    """ms per substep of each named runner, two CUDA-event windows of at
    least ``min_s`` each, taken in turns (a, b, b, a).  ``runs`` maps a name
    to (fn, substeps per call); each window's call count comes from a
    timed trial call."""
    reps = {}
    for key, (fn, _) in runs.items():
        t = cuda_ms(torch, fn, 1)
        reps[key] = max(1, math.ceil(1.2 * min_s * 1e3 / t))
    times = {key: [] for key in runs}
    a, b = list(runs)
    for key in (a, b, b, a):
        fn, per_call = runs[key]
        times[key].append(cuda_ms(torch, fn, reps[key]) / per_call)
    return times, reps


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
    import test_torch_mesh_cases as mesh_cases

    from softbodysimulation_tpu_torch.core import config as C
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.interact import forces
    from softbodysimulation_tpu_torch.kernels import _build
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.solvers import general
    from softbodysimulation_tpu_torch.solvers import lattice as lat
    from softbodysimulation_tpu_torch.topology import lattice as top
    from softbodysimulation_tpu_torch import is_finite, state_from_numpy

    # 1. the card
    smi = smi_line()
    print(f"# gpu: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build: one nvcc per source, started together
    with ThreadPoolExecutor(2) as pool:
        lattice_build = pool.submit(timed_build, _build, lc.LIB_NAME,
                                    lc.SOURCES)
        mesh_build = pool.submit(timed_build, _build, mc.LIB_NAME,
                                 mc.SOURCES, mc.NVCC_EXTRA)
        lattice_build, mesh_build = (lattice_build.result(),
                                     mesh_build.result())
    print_build(lattice_build)

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

    # 7. the mesh kernel's build (started with the lattice kernel's)
    print_build(mesh_build)

    # 8. mesh kernel vs plain on the card, every case of the CPU tests
    mesh_err = 0.0
    for name, (mcfg, kind, kw, frames) in mesh_cases.mesh_cases().items():
        mtopo, fields = mesh_cases.case_inputs(kind, **kw)
        st = state_from_numpy(fields, device="cuda")
        gates = (mesh_cases.dx_gate(mcfg), mesh_cases.DLAM_DIST,
                 mesh_cases.DLAM_BEND)
        mesh_err = max(mesh_err, mesh_compare(
            torch, name,
            mc.make_mesh_cuda_step(mtopo, mcfg, 1 / 60, n_steps=frames)(st),
            general.multi_step_fn(st, mtopo, mcfg, 1 / 60, frames), st,
            mtopo, mcfg, frames * mcfg.substeps, gates, is_finite))

    # 9. the mesh main path at full size: cloth_xl, a poke at frame 60
    t0 = time.perf_counter()
    cstate, cstep, cinfo = scenes.cloth_xl(device="cuda")
    ctopo, ccfg, cdt = cinfo["topology"], cinfo["config"], cinfo["dt"]
    cdt_sub = cdt / ccfg.substeps
    pins = torch.as_tensor(cinfo["pinned"], device="cuda")
    print(f"# mesh main path: cloth_xl built in "
          f"{time.perf_counter() - t0:.2f} s: {ctopo.n_particles} "
          f"particles, {ctopo.n_edges} edges, {ctopo.n_hinges} hinges, "
          f"{len(cinfo['pinned'])} pinned")

    def poke(st):
        return forces.add_force(st, (0.0, 100.0, 600.0),
                                st.positions.mean(0).tolist(), radius=0.4)

    def rollout(st, step, control=None):
        """MESH_FRAMES frames, poked at frame 60; returns the end state,
        the frame-120 state and, with an unpoked ``control`` run stepped
        alongside, the largest shift of the centre of mass between the two
        (read after frames 60 and 70 and at the end)."""
        at120, shifts = None, []
        for frame in range(MESH_FRAMES):
            if frame == 60:
                st = poke(st)
            if frame == 120:
                at120 = st
            st = step(st)
            if control is not None:
                control = step(control)
                if frame in (60, 70, MESH_FRAMES - 1):
                    shifts.append(float((st.positions.mean(0)
                                         - control.positions.mean(0))
                                        .abs().max()))
            if frame == 60 and float(st.ext_force.abs().max()) != 0.0:
                raise RuntimeError("ext_force not consumed by the step")
        return st, at120, max(shifts, default=0.0)

    torch.cuda.synchronize()
    mc.launches = 0
    t0 = time.perf_counter()
    poked, at120, shift = rollout(cstate, cstep, control=cstate)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    mesh_launches = mc.launches
    p = poked.positions
    ymin = float(p[:, 1].min())
    pins_ok = torch.equal(p[pins], cstate.positions[pins])
    ok_mesh = is_finite(poked)
    print(f"# mesh main path: 2 x {MESH_FRAMES} frames x {ccfg.substeps} "
          f"substeps in {mesh_s:.3f} s wall, {mesh_launches} kernel "
          f"launches; finite={ok_mesh} ymin={ymin:.6f} pinned row "
          f"unmoved={pins_ok} ext_force={float(poked.ext_force.abs().max())}"
          f", the poke moved the COM by up to {shift:.4f} vs the unpoked "
          f"run")
    if not (ok_mesh and pins_ok and ymin > ccfg.ground_height - 1e-2
            and float(poked.ext_force.abs().max()) == 0.0 and shift > 1e-3
            and mesh_launches > 0):
        raise RuntimeError("mesh main path failed its health gates")
    gates = (mesh_cases.DX_JACOBI, mesh_cases.DLAM_DIST,
             mesh_cases.DLAM_BEND)
    mesh_err = max(mesh_err, mesh_compare(
        torch, "cloth_xl from frame 120",
        mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub, 16)(at120),
        general.run_substeps_plain(at120, ctopo, ccfg, cdt_sub, 16), at120,
        ctopo, ccfg, 16, gates, is_finite))

    def plain_step(st):
        return general.step_fn(st, ctopo, ccfg, cdt)

    plain, _, _ = rollout(cstate, plain_step)
    drift = float((p - plain.positions).abs().max())
    gate, why = DRIFT_TOL, "the fixed gate"
    if not drift < DRIFT_TOL:
        # chaotic scene: gate on the spread between two plain formulations
        # (the plain engine on the card and on the CPU) at the same horizon
        cpu, _, _ = rollout(cstate.to("cpu"), plain_step)
        spread = float((plain.positions.cpu() - cpu.positions).abs().max())
        gate = max(3.0 * spread, 1e-4)
        why = (f"self-calibrating: 3 x the plain card-vs-CPU spread "
               f"{spread:.3e}, at least 1e-4, because the fixed gate "
               f"{DRIFT_TOL} failed")
    print(f"# mesh drift vs plain, {MESH_FRAMES} frames from the same start"
          f" with the same poke: {drift:.3e} (gate {gate:.3e}, {why}); "
          f"mask flips at the end: "
          f"{mask_flips(torch, poked, plain, ctopo, ccfg)}")
    if not drift < gate:
        raise RuntimeError(f"mesh kernel drifts from the plain engine: "
                           f"{drift}")

    # 10. throughput at cloth_xl (CUDA events), plain and kernel in turns
    n_k, n_p = 500, 20
    k_mesh = mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub, n_k)
    mtimes, mreps = timed_windows(torch, {
        "plain": (lambda: general.run_substeps_plain(
            cstate, ctopo, ccfg, cdt_sub, n_p), n_p),
        "kernel": (lambda: k_mesh(cstate), n_k)})
    ms_mk, ms_mp = min(mtimes["kernel"]), min(mtimes["plain"])
    nm = ctopo.n_particles
    print(f"# throughput cloth_xl ({smi}), best of two windows: kernel "
          f"{ms_mk:.5f} ms/substep = {nm / ms_mk * 1e3:.4e} "
          f"particle-substeps/s over {mreps['kernel'] * n_k} substeps; "
          f"plain {ms_mp:.5f} ms/substep = {nm / ms_mp * 1e3:.4e} "
          f"particle-substeps/s over {mreps['plain'] * n_p} substeps")
    for key in ("kernel", "plain"):
        lo, hi = min(mtimes[key]), max(mtimes[key])
        print(f"# throughput range {key}: {lo:.5f}-{hi:.5f} ms/substep = "
              f"{nm / hi * 1e3:.4e}-{nm / lo * 1e3:.4e} particle-substeps/s "
              f"(windows in turn order: {mtimes[key]})")

    if "--profile" in sys.argv[1:]:
        profile_main_path(
            torch, lc.make_cuda_substep_runner(spec, cfg, dt_sub, 200),
            state)
        profile_main_path(
            torch, mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub,
                                                    200), cstate)

    print(json.dumps({"kernels": [{
        "name": "lattice_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/lattice_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/lattice_pallas.py:501",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }, {
        "name": "mesh_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/mesh_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/mesh_pallas.py:789",
        "launches": mesh_launches,
        "max_abs_err": mesh_err,
        "ms": ms_mk,
        "plain_ms": ms_mp,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
