#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's lattice, mesh, contact, differentiable, spatial,
kinematic-collider, ensemble, approx-math, contact-cadence and volume main
paths through the entry points a user calls and fails (nonzero exit) if
any phase fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the CUDA lattice kernel built from ``softbodysimulation_tpu_torch/csrc``
   with ``nvcc`` (sm_90a), the build time (the four libraries' ``nvcc``
   runs are started together) and ``-Xptxas -v``'s registers, spills and
   shared memory of each kernel, the persistent kernel's three barrier
   variants among them;
3. kernel vs its plain PyTorch version on the card, at res 6 over 12-18
   substeps, for each configuration the CPU tests hold against the JAX
   package (``tests/test_torch_cases.py``): max |dx| < 1e-5,
   max |dlambda| < 1e-6 and < 1 % of max |lambda|, max |dv| < 1e-5 / dt_sub;
4. the main path at full size: the ``flagship_perf`` scene (braced res-40
   lattice, 64,000 particles) through ``make_cuda_substep_runner`` for 2000
   substeps, with ``bench.py``'s health gates (finite, ymin > -1e-2, height
   > 0.5), its drift gate (max |dx| < 1e-3 against the plain version from
   the same start) and the kernel's launch count (one persistent launch
   for the call); then, from the rested state with seeded velocity
   jitter, 16 substeps of kernel vs plain at the parity gates of phase 3,
   and the persistent kernel against the per-pass loop to the bit, exact
   and approx;
5. the entry configuration (res 16, WARM_START) through ``make_cuda_step``
   for 60 frames with a poke at frame 10: finite, ``ext_force`` reads back
   0, and the poke moves the centre of mass, one launch a frame; then,
   from that state and a second poke, 4 frames (16 substeps, multipliers
   carried between them) of ``make_cuda_step`` vs the plain
   ``multi_step_fn`` at the same gates; ms per substep of one frame a
   call, the persistent kernel against the per-pass loop (``b1_designs``:
   in turns, per-pass, persistent, persistent, per-pass, with their
   launches a call);
6. particle-substeps/s of the kernel and of the plain version at res 40,
   timed with CUDA events over windows of at least a second, two windows
   each, taken in turns; the best window and the range are printed; the
   persistent kernel against the per-pass loop as in phase 5;
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
   ``cloth_xl``, as phase 6 times the lattice;
11. the contact kernel's build (``csrc/contact_xpbd.cu``, TPU kernel B-4;
   the mesh library links it too), registers and spills;
12. the B-4 pass (the passes the mesh loop runs, then an unsort-apply)
   vs the plain blocked pass on the card, on the seeded clouds of
   ``tests/test_torch_contact_cases.py`` and on the 20,243-particle states
   of phase 14 (frames 30, 60 and 90): max |dx| < 1e-5, the library's
   curve order and candidate blocks equal to the plain ones, no pair
   classified differently; then on each state B-4's culled design
   against the serial one it replaced (``b4_designs``): the same
   candidates and touching bits, |dx| < 1e-6, two runs to the bit, ms a
   pass of each in turns (serial, culled, culled, serial) with its
   launches, the pair tests the warp cull keeps and the bound; at frame
   90 each kernel of the pass from the profiler, and the launches of one
   contact substep in the mesh loop with each design (at most 3 a culled
   pass);
13. the mesh kernel vs the plain engine for every tet case (|dx| < 2e-5,
   |dlambda_tet| < 1e-5) and contact case (|dx| < 2e-4) of
   ``tests/test_torch_contact_cases.py``, every multiplier within 1 % of
   its largest;
14. the contact path at full size: the ball-on-cloth of
   ``scripts/bench_multibody_scale.py`` (20,243 particles, 1,280 tets,
   blocked contact every 3rd substep, B = 128, M = 32) through
   ``make_mesh_cuda_step`` for 30 frames: 0 dropped pairs at the warm state
   and at the end, finite, the rim bit-identical, ymin > -1e-2, the ball
   above the floor and the cloth deflected under it, launches of both
   libraries; 16 substeps kernel vs plain from the warm state (2e-4, and
   the multipliers within 1 %); a 30-frame drift kernel vs plain, gated at
   3x the spread between two exact plain runs with (B, M) = (128, 32) and
   (256, 18), at least 1e-4; then 16 substeps of parity from that
   in-contact state, and 30 more frames of the kernel path into
   contact-rich rest (health, 0 dropped pairs), where the B-4 pass is
   timed against its bound (operations counted from this state's
   candidate and touching pairs) and the plain engine's hub sums (on the
   device, one scan each) are timed;
15. the catalogued ``ball_on_cloth`` (619 particles, dense contact every
   substep) through ``make_mesh_cuda_step`` for 120 frames: the ball rests
   on the cloth (ball > 0.55, cloth centre < 0.99, rim within 1e-4 of 1),
   and without contact it falls through (< 0.25);
16. particle-substeps/s of the kernel path and of the plain engine for
   phases 14 and 15, from their in-contact states (frame 90 of phase 14,
   frame 120 of phase 15), as phase 6 times them, and launches per
   substep; the 20k substep with each of B-4's designs, in turns;
17. the fused mesh backward's kernels (``csrc/mesh_diff_xpbd.cu``, TPU
   kernel B-5, built into the mesh library in phase 2), registers and
   spills;
18. B-5 (``backward_chunk_cuda``) vs its plain version
   (``backward_chunk_plain``) on the card for every case of
   ``tests/test_torch_diff_cases.py``: max |dg| / max |g| < 1e-5 for each
   of gx, gv, glambda, g_rest, g_comp; both vs autograd through the plain
   engine < 1e-4 (the JAX suite's gradient gate); the mesh kernel's traced
   materials equal to its static path bit for bit;
19. the differentiable main path at full width, the scene and config of
   ``scripts/bench_diff.py`` (``icosphere(4, 0.5)``, 2,562 particles,
   7,680 edges, lifted by 1.0, compliance 1e-6, JACOBI with Chebyshev,
   4 iterations, RESET, floor, dt_sub 1/240): the gradient of
   sum(positions^2) w.r.t. a launch velocity through
   ``make_differentiable_mesh_runner`` at 40 substeps with
   ``backward="fused"`` (the launch counts read around it) and ``"xla"``
   (autograd through the plain engine): finite, non-trivial, within 1e-4;
   the same at 240 substeps (printed), the 240-substep fused gradient in
   40-substep chunks against one chunk; B-5 vs plain at the 40- and
   240-substep shapes (< 1e-5); at 240 substeps a float64 witness on the
   CPU (``--f64-witness``, a process of its own started with the smoke),
   autograd through the plain engine against ``backward_chunk_plain``
   (< 1e-9), and both float32 gradients against it (printed); 30 fit
   steps; the materials gradient, fused vs xla;
   ``config10`` at its own sizes and ``config6`` cut to 20 frames and 2
   gradient steps (their losses shrink);
20. particle-substeps/s of ``grad_fused`` / ``grad_xla``, the 240-substep
   pair, ``grad_materials_{fused,xla}`` and ``fitloop30_fused``, timed as
   phase 6 times (CUDA events, windows of at least a second, in turns),
   the launches per backward substep, and B-5's bound at the 40-substep
   shapes (``diff_work``);
21. the slab kernel's build (``csrc/spatial_xpbd.cu``, TPU kernel B-6),
   registers and spills, and those of the lattice library's tet sweep;
22. on the card: the lattice kernel with tets vs the plain engine for the
   tet cases of ``tests/test_torch_spatial_cases.py`` (|dx| < 2e-5,
   |dlambda_tet| < 1e-5); B-6 vs the sharded torch engine
   (``parallel/spatial.py``, ``backend="xla"``) for every case it carries,
   up to four slabs on one card, at phase 3's gates, and how many are bit
   for bit; a race check, four slabs on four streams run five times,
   equal to the bit;
23. ``solid_lattice`` at full size (res 40, 64,000 particles, 355,914
   tets) through ``make_cuda_step`` for 250 frames: finite, ymin > -1e-2,
   height > 0.5, tet volume within 5 % of rest (the JAX package's own
   solid gate: its engine rests at 0.977 here); 480 substeps of drift vs
   the plain engine (gate 1e-3, volumes 1e-4 apart); 16 substeps of
   parity from the rested state with velocity jitter;
24. the spatial path at full width: ``bench.py``'s configuration with
   ``fast_math`` off on the braced res-128 lattice (2,097,152 particles) in
   4 slabs of 32 planes on one card, 2000 substeps through B-6
   (``make_spatial_lattice_step``): finite, ymin > -1e-2, launches,
   exchange copies and bytes, its height and drift beside B-1's from the
   same start (the body pancakes on both); ``bench.py``'s height gate and
   the drift gate vs B-1 (1e-3) at res 68 (``SPATIAL_CUT_RES``), 4 slabs
   of 17 planes; B-6 in one slab equal to the bit to the four slabs at res
   128 and at res 72 and 84, where the drift from B-1 is printed; 16
   substeps of parity vs the sharded torch engine from
   the res-128 state; where two or more cards are visible, one slab per
   card equal to the one-card result bit for bit;
25. particle-substeps/s, timed as phase 6 times them: B-6 at res 128 in 4
   slabs, B-1 at res 128 and the sharded torch engine there; B-6 at res 40
   in 4 slabs against B-1 at res 40; ``solid_lattice`` through B-1 and the
   plain engine; and B-6's bound (``lattice_work`` at the slab shapes,
   plus the exchanged planes where the slabs sit on more than one card);
   B-1's two designs at res 128 and at ``solid_lattice``, as in phase 5;
26. the lattice kernel with the rigid world against its plain version for
   every case of ``tests/test_torch_collider_cases.py`` at phase 3's gates
   (config boxes; kinematic spheres and boxes with velocities; an
   animated ground in both floor modes; each pose moved once on the same
   runner); ``sphere_sweep`` at res 40 (64,000 particles) for 240
   animated frames through one runner (finite, ymin > -1e-2, the slab
   pushed along +x), its first 60 frames also through the plain engine
   (max |dx| < 1e-5 at frame 60);
   at that width a config box standing in the slab and a kinematic box
   sweeping against the sphere, 60 frames each through the kernel and
   the plain engine (the same gates, the box emptied or the slab moved);
   ms per substep of that config with poses and without, and launches
   per substep with and without (equal, also at ``flagship_perf``); B-1's
   two designs with poses, as in phase 5;
27. the mesh kernel with the rigid world against the plain engine for the
   mesh cases of that module at phase 8's gates; ``cloth_xl`` with a
   kinematic sphere sweeping through it for 240 frames through the kernel
   (finite, pinned row unmoved, the cloth pushed), its first 60 against
   the plain engine (drift < 1e-3), timed;
   a config box and a kinematic box at that width, as in phase 26;
28. B-5's pose cotangents on the ``bench_diff`` scene with a kinematic
   sphere overlapping the shell, 40 substeps, a random-weighted loss:
   against ``backward_chunk_plain`` (< 1e-5) and autograd (< 1e-4) on one
   scale across the pose leaves; the runner's chunks of 10 against one
   chunk (rtol 1e-5); ``config11_collider_control.run(engine="fused")``
   at its defaults (its loss shrinks); ms per 40-substep chunk with and
   without the pose cotangents, and the bound with them;
29. the B-1 ensembles (``n_bodies > 1``): every case of
   ``tests/test_torch_ensemble_cases.py`` at res 6 (WARM_START JACOBI with
   an ext force on one body, COLORED, RESET, tets, a shared kinematic
   sphere, the batched contract at one body) against the lane-folded plain
   engine at phase 3's gates, every row equal to the single-body kernel to
   the bit; example 5 at its defaults (1,024 res-4 bodies, 120 frames x 4
   substeps) through ``config5_batch_1024.run`` (``make_batched_step``,
   the launches read around it): finite, ymin > -1e-2, unit normals,
   bodies 0, 511 and 1023 equal to the single-body kernel to the bit,
   launches a call equal to one body's, 480-substep drift against the
   plain engine < 1e-3;
30. the B-3 ensembles: every mesh case of that module (shared and per-body
   masses, per-body materials, bending, COLORED, tets, dense contact, a
   shared kinematic sphere) against the plain engine body by body at phase
   8's gates, rows equal to the single-body kernel; the farm of
   ``scripts/bench_mesh_ensemble.py`` (``icosphere(4, 0.5)`` x 32, JACOBI
   x 4, 4 substeps, floor) for 240 frames through
   ``make_batched_general_step`` with shared and with per-body masses:
   finite, ymin, drift < 1e-3 against the plain engine on bodies 0, 7, 19,
   31 (shared) and 0, 31 (per-body), rows 0 and 31 equal to the
   single-body kernel; the contact farm of
   ``scripts/bench_ensemble_contact.py`` (``ball_on_cloth`` x 8, 120
   frames): every ball above 0.55 on a cloth below 0.99, rows 0, 3, 7
   equal to the single-body kernel;
31. the material ensemble x 16 and the per-body-mass ensemble x 8 on the
   ``bench_diff`` scene at 40 substeps (the mass ensemble launched with a
   seeded velocity field, without which a uniform body's loss hardly
   depends on its masses): their gradients against autograd through the
   plain engine on the last body (< 1e-4); a float64 witness on the card
   that does not share that backward: autograd through the plain engine
   in float64 against a central difference of the loss along a seeded
   direction (< 1e-4), and the float32 gradient along that direction
   against the difference (< 0.1; the float32 gradient's own rounding,
   printed with its largest element's error); four
   shards on one card equal to one shard to the bit for the lattice
   rollout at example 5's geometry and for the mesh farm, and their
   ensemble diagnostics equal;
32. particle-substeps/s of each ensemble (example 5, the mesh farm, the
   contact farm), its plain twin and the single-body kernel looped over
   its bodies, timed as phase 10 times (CUDA events, windows in turns,
   of at least half a second);
   launches a call (B-1) or a substep (B-3), the ensemble's equal to one
   body's; the bounds (``lattice_work`` x B, ``mesh_work`` with B bodies'
   state and the shared tables once); B-1's two designs at example 5, as
   in phase 5;
33. B-1 with ``approx_math`` (rsqrtf and the approximate reciprocal) at
   ``bench.py``'s workload, phase 4's start: the two intrinsics against
   ``torch.rsqrt`` and ``torch.reciprocal`` on 2^20 floats (how many
   differ, by how many ulps); 2000 substeps with its launches, the health
   gates and the drift against phase 4's exact plain rollout (< 1e-3, as
   ``bench.py`` gates it); 16 substeps against its plain twin from the
   rested state with velocity jitter (< 1e-4); ms per substep, exact and
   approx, in timed windows; B-1's two designs with approx, as in phase
   5;
34. B-3 with ``approx_math`` at ``cloth_xl`` from a poked, loaded state:
   16 substeps against its twin (positions < 5e-3, multipliers < 5e-4,
   JAX's band for its approx kernel) with its launches; ms per substep,
   exact and approx;
35. the lattice hybrid contact runner at the 64k contact-cadence config of
   ``scripts/bench_contact_kernel.py`` (res 40, ``blocked_pallas`` B = 128
   M = 4, contact every 8th of 8 substeps, radius 0.55 x spacing): exact
   against the plain stencil cadence over 24 substeps (< 1e-5; both run
   B-4 for contact, so the gap and whether it is 0 are printed), approx
   within 1e-3 of exact; a 400-substep rollout of each (finite, min y >
   -radius, its B-1 and B-4 launches); ms per substep of both and of the
   plain cadence; B-4's two designs on the hybrid's contact pass at its
   rested state, as phase 12 times them, with each kernel's time;
36. example 4 (two cubes, ``hash`` self-collision) through
   ``general.make_step`` on a CUDA state against the CPU for the 200
   frames before its first poke (< 1e-3), ms per frame; the hash and
   sorted passes and the curve order under
   ``torch.cuda.set_sync_debug_mode("error")``;
37. ``entry()``'s ``fn`` once on the card against the CPU (< 1e-5), and
   the bench twin's ``main()`` (its JSON line, 2 s windows);
38. B-3 with the global volume constraint against its plain twin on every
   case of ``tests/test_torch_volume_cases.py`` (every solve mode under
   every lambda mode, example 3's config, bending, dense contact and the
   per-tet volume in JACOBI and COLORED, ensembles of two and three bodies
   with a ``(B,)`` ``lambda_volume``, one with dense contact): every leaf
   equal to the bit (beside dense contact, positions within 2e-4 and
   ``lambda_volume`` within 1e-4), ``lambda_volume`` nonzero; ensemble rows against the single-body kernel to
   the bit in one body's launches, and a shared scalar ``lambda_volume``
   refused;
39. the volume path at full width: example 3's inflated ball on
   ``icosphere(5, 0.4)`` (10,242 particles, 20,480 triangles) through
   ``general.make_step`` for 240 frames: finite, V/V0 > 1.05, the ball
   resting on the collider (min distance to its centre > 0.75), launches
   a substep; 16 substeps of parity from frame 120; the 240-frame drift
   against the plain engine (< 1e-3); ms per substep of the kernel and the plain engine, and the
   bound; the pressurized farm (phase 30's 32 x ``icosphere(4, 0.5)`` with
   example 3's volume settings and a ``(32,)`` ``lambda_volume``, each
   body dropped from its own height) for 240 frames: finite, V/V0 > 1.05
   in every body, rows 0 and 31 equal to the single-body kernel to the bit,
   launches equal to one body's, drift against plain on those rows < 1e-3,
   ms per substep beside the plain twin;
40. examples 1, 2, 3 and 9 at the JAX tests' cuts on the card against the
   CPU: within 1e-5, or 3x the card's own spread when its positions are
   moved one ulp before every frame (the band ``tests/test_torch_
   examples.py`` holds the port to JAX with);
41. B-1's barriers (``barrier_phase``): ``__syncthreads`` with whole
   bodies a block against the grid barrier for bodies of 64 to 1,728
   particles, one and many; the grid barrier at res 40 on 250, 125 and
   65 blocks; the persistent kernel against the per-pass loop from res 64
   to res 100;
42. B-3's persistent kernel against its per-pass loop (``b3_phase``) on
   every mesh, tet, contact, volume, ensemble and collider case (mesh
   cases exact and with ``approx_math``), each barrier forced on two
   ensembles, a many-block cloth five times: to the bit, one launch a
   call without blocked contact.

B-3's two designs are also timed in turns (``b3_designs``: per-pass,
persistent, persistent, per-pass, the two results equal to the bit, with
launches a call and a substep of each) at cloth_xl (phase 10), the 20k
frame-90 substep and the catalogued ball_on_cloth (phase 16), the farm
and the contact farm (phase 32), approx cloth_xl (phase 34), the inflated
ball and the pressurized farm (phase 39); phase 14 holds them to the bit
at the 20k frame-30, -60 and -90 states and the hub warps' sums to the
plain engine's bits there without contact; phase 15 the dense pass (a
warp a row) within 1e-5 of the plain pass; phase 16 splits the 20k
particle passes by the rows they sum (``particle_passes``).

Prints one JSON line of kernels (with each kernel's bound, the least time
the card could take for the same work, from ``bound_ms``; B-1's row adds
its design, barrier, the per-pass loop's ms and every shape's pair of
designs; B-4's row adds the serial design's call, both designs' mesh-loop
pass alone, and the bound over every candidate pair test), the card's name
and power limit, and as its last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits nonzero and prints no result.
``--profile`` adds a torch.profiler breakdown of each main path (device
time by kernel, host time per launch, device idle share).
``--b3-profile`` runs only ``particle_passes`` at the 20k frame-90 state
and at cloth_xl through the per-pass loop, against whichever package sits
beside this file (so a parent tree can be profiled with it).
"""

import dataclasses
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


def cuda_ms(torch, fn, reps, warm=True):
    """Milliseconds per call of ``fn`` on the card (CUDA events, one warm-up
    call first unless ``warm`` is false)."""
    if warm:
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


def particle_passes(torch, label, run, state, smi):
    """B-3's particle passes over one call of ``run`` from ``state``, split
    by the rows each sums, read from the kernel launched before it (the
    per-pass loop: edge, hinge or tet rows after their constraint pass;
    otherwise no sum, a contact or volume apply): {class: (launches, us)},
    printed with the other kernels of the call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(state)
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    rows = {"edge_kernel": "edge rows", "hinge_kernel": "hinge rows",
            "tet_kernel": "tet rows"}
    out, prev = {}, ""
    for e in dev:
        name = e.name.split("(")[0].split("<")[0].split()[-1]
        key = (f"particle_kernel, {rows.get(prev, 'no sum')}"
               if name == "particle_kernel" else name)
        n, t = out.get(key, (0, 0.0))
        out[key] = (n + 1, t + e.time_range.elapsed_us())
        prev = name
    for key, (n, t) in sorted(out.items(), key=lambda kv: -kv[1][1]):
        print(f"# particle passes, {label} ({smi}): {key}: {n} x "
              f"{t / n:.3f} us = {t:.1f} us")
    return out


def b3_profile(torch) -> int:
    """``--b3-profile``: B-3's particle passes (``particle_passes``) at the
    20k ball-on-cloth's frame-90 state (6 substeps) and at cloth_xl after
    30 frames (4 substeps), through the per-pass loop (the library's only
    design before the persistent one).  Runs against whichever package
    sits beside this file, so a parent tree can be profiled with it."""
    import inspect

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_contact_cases as K

    from softbodysimulation_tpu_torch import state_from_numpy
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc

    smi = smi_line()
    print(f"# gpu: {smi}")
    kw = ({"design": "per_pass"} if "design" in inspect.signature(
        mc.run_substeps_cuda).parameters else {})
    topo, fields, cfg, _ = K.scaled_ball_on_cloth(K.modules())
    st = state_from_numpy(fields, device="cuda")
    step = mc.make_mesh_cuda_step(topo, cfg, 1 / 60)
    for _ in range(90):
        st = step(st)
    dt_sub = 1 / 60 / cfg.substeps
    particle_passes(torch, "20k ball-on-cloth, frame 90, 6 substeps",
                    lambda s: mc.run_substeps_cuda(s, topo, cfg, dt_sub, 6,
                                                   **kw), st, smi)
    cst, cstep, cinfo = scenes.cloth_xl(device="cuda")
    for _ in range(30):
        cst = cstep(cst)
    ctopo, ccfg = cinfo["topology"], cinfo["config"]
    cdt = cinfo["dt"] / ccfg.substeps
    particle_passes(torch, "cloth_xl, frame 30, 4 substeps",
                    lambda s: mc.run_substeps_cuda(s, ctopo, ccfg, cdt, 4,
                                                   **kw), cst, smi)
    return 0


def timed_build(build, name, sources, extra=()):
    """Build one library; returns (path, compiler output, seconds)."""
    t0 = time.perf_counter()
    path, log = build.build_library(name, sources, extra)
    return path, log, time.perf_counter() - t0


def print_build(built, kernels=None):
    """The build's time and its ``-Xptxas -v`` register and spill lines;
    with ``kernels``, only those of entry functions whose names hold one
    of them."""
    path, log, secs = built
    print(f"# build: {os.path.relpath(path, HERE)} in {secs:.2f} s")
    keep = kernels is None
    for ln in log.splitlines():
        if "Compiling entry function" in ln and kernels is not None:
            name = ln.split("'")[1] if "'" in ln else ln
            keep = any(f"{len(k)}{k}" in name for k in kernels)
        if keep and ("registers" in ln or "spill" in ln or "Compiling" in ln):
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


def timed_windows(torch, runs, min_s=1.0, warm=True):
    """ms per substep of each named runner, two CUDA-event windows of at
    least ``min_s`` each, taken in turns (a, b, b, a; or a, b, c, c, b, a).
    ``runs`` maps a name to (fn, substeps per call); each window's call
    count comes from a timed trial call, after a warm-up call unless
    ``warm`` is false (every runner has run before)."""
    reps = {}
    for key, (fn, _) in runs.items():
        t = cuda_ms(torch, fn, 1, warm)
        reps[key] = max(1, math.ceil(1.2 * min_s * 1e3 / t))
    times = {key: [] for key in runs}
    keys = list(runs)
    for key in keys + keys[::-1]:
        fn, per_call = runs[key]
        times[key].append(cuda_ms(torch, fn, reps[key], warm=False)
                          / per_call)
    return times, reps


# B-1's two designs at each shape the smoke times (b1_designs): the
# persistent kernel (one launch a call, every route) and the per-pass loop
# it replaced (one launch a pass, the yardstick)
B1_DESIGNS = []


def b1_designs(torch, lc, label, st, spec, cfg, dt_sub, n_sub, smi,
               min_s=0.5, **kw):
    """ms per substep of the per-pass loop and the persistent kernel on one
    call of ``n_sub`` substeps from ``st``, in turns (per-pass, persistent,
    persistent, per-pass), their launches per call, and, for the
    persistent kernel, its plan; recorded in B1_DESIGNS."""
    def run(design):
        return lambda: lc.run_substeps_cuda(st, spec, cfg, dt_sub, n_sub,
                                            design=design, **kw)

    runs = {"per_pass": (run("per_pass"), n_sub),
            "persistent": (run("persistent"), n_sub)}
    calls = {}
    for key, (fn, _) in runs.items():
        before = lc.launches
        fn()
        calls[key] = lc.launches - before
    times, reps = timed_windows(torch, runs, min_s=min_s)
    bodies = st.positions.shape[0] if kw.get("batched") else 1
    sched = lc.schedule_for(spec, bodies, st.device)
    rec = dict(shape=label, substeps_per_call=n_sub,
               ms=min(times["persistent"]), per_pass_ms=min(times["per_pass"]),
               windows=times["persistent"], per_pass_windows=times["per_pass"],
               launches_per_call=calls["persistent"],
               per_pass_launches_per_call=calls["per_pass"],
               barrier=sched.barrier, grid=sched.grid, chunk=sched.chunk)
    spread = max(max(v) - min(v) for v in times.values())
    rec["speedup"] = rec["per_pass_ms"] / rec["ms"]
    rec["beats_by_more_than_spread"] = (rec["per_pass_ms"] - rec["ms"]
                                        > spread)
    B1_DESIGNS.append(rec)
    print(f"# B-1 designs, {label} ({smi}), {n_sub} substeps a call: "
          f"per-pass {rec['per_pass_ms']:.5f} ms/substep "
          f"({calls['per_pass']} launches a call; windows "
          f"{times['per_pass']}), persistent {rec['ms']:.5f} ms/substep "
          f"({calls['persistent']} launch a call; windows "
          f"{times['persistent']}; {sched.barrier} barrier, {sched.grid} "
          f"blocks of {sched.chunk} particles): {rec['speedup']:.2f}x, "
          f"beyond the windows' spread {spread:.5f}: "
          f"{rec['beats_by_more_than_spread']}")
    return rec



# B-3's two designs at each path the smoke times them (b3_designs): the
# persistent kernel (one launch a contact-free stretch, every route) and
# the per-pass loop it replaced (one launch a pass, the yardstick)
B3_DESIGNS = []


def b3_designs(torch, mc, cc, label, st, topo, cfg, dt_sub, n_sub, smi,
               min_s=0.5, **kw):
    """ms per substep of B-3's per-pass loop and persistent kernel on one
    call of ``n_sub`` substeps from ``st``, in turns (per-pass,
    persistent, persistent, per-pass), their launches a call and a
    substep (and B-4's, with blocked contact), the persistent kernel's
    plan; the two results equal to the bit, or it raises.  Recorded in
    B3_DESIGNS."""
    def run(design):
        return lambda: mc.run_substeps_cuda(st, topo, cfg, dt_sub, n_sub,
                                            design=design, **kw)

    runs = {"per_pass": (run("per_pass"), n_sub),
            "persistent": (run("persistent"), n_sub)}
    calls, outs = {}, {}
    for key, (fn, _) in runs.items():
        before = (mc.launches, cc.launches)
        outs[key] = fn()
        torch.cuda.synchronize()
        calls[key] = (mc.launches - before[0], cc.launches - before[1])
    bad = b3_bits(torch, outs["persistent"], outs["per_pass"])
    if bad:
        raise RuntimeError(f"B-3 designs differ at {label}: {bad}")
    times, _ = timed_windows(torch, runs, min_s=min_s)
    bodies = st.positions.shape[0] if kw.get("batched") else 1
    p = mc.make_params(topo, cfg, dt_sub)
    if st.lambda_tet is None:
        p.n_tets = 0
    sched = mc.schedule_for(mc.tile_counts(p), bodies, st.device)
    rec = dict(shape=label, substeps_per_call=n_sub,
               ms=min(times["persistent"]), per_pass_ms=min(times["per_pass"]),
               windows=times["persistent"], per_pass_windows=times["per_pass"],
               launches_per_call=calls["persistent"][0],
               per_pass_launches_per_call=calls["per_pass"][0],
               launches_per_substep=calls["persistent"][0] / n_sub,
               per_pass_launches_per_substep=calls["per_pass"][0] / n_sub,
               contact_launches_per_substep=calls["persistent"][1] / n_sub,
               barrier=sched.barrier, grid=sched.grid)
    spread = max(max(v) - min(v) for v in times.values())
    rec["speedup"] = rec["per_pass_ms"] / rec["ms"]
    rec["beats_by_more_than_spread"] = (rec["per_pass_ms"] - rec["ms"]
                                        > spread)
    B3_DESIGNS.append(rec)
    print(f"# B-3 designs, {label} ({smi}), {n_sub} substeps a call: "
          f"per-pass {rec['per_pass_ms']:.5f} ms/substep "
          f"({calls['per_pass'][0]} launches a call; windows "
          f"{times['per_pass']}), persistent {rec['ms']:.5f} ms/substep "
          f"({calls['persistent'][0]} launches a call, "
          f"{rec['launches_per_substep']:.3f} a substep, B-4's "
          f"{rec['contact_launches_per_substep']:.3f}; windows "
          f"{times['persistent']}; {sched.barrier} barrier, {sched.grid} "
          f"blocks): {rec['speedup']:.2f}x, beyond the windows' spread "
          f"{spread:.5f}: {rec['beats_by_more_than_spread']}; the two "
          f"results equal to the bit")
    return rec


B3_LEAVES = ("positions", "velocities", "lambda_dist", "lambda_bend",
             "lambda_tet", "lambda_volume", "ext_force")


def b3_bits(torch, a, b):
    """The leaves of two mesh results that differ in any bit."""
    bad = []
    for k in B3_LEAVES:
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (x is not None and not torch.equal(
                x.reshape(-1).view(torch.int32),
                y.reshape(-1).view(torch.int32))):
            bad.append(k)
    return bad


def kernel_times(torch, fn, calls):
    """Device time of each kernel over ``calls`` calls of ``fn``
    (torch.profiler, CUPTI): {name: (launches, us)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, t + e.time_range.elapsed_us())
    if not out:
        raise RuntimeError("the profiler recorded no device activity")
    return out


# B-4's two designs at each state the smoke times them (b4_designs): the
# culled pass (the main path) and the serial one it replaced (the
# yardstick)
B4_DESIGNS = []


def b4_designs(torch, cc, sh, label, pred, inv, cfg, smi, profile=False):
    """B-4's culled pass against the serial one on one state: the same
    candidates and touching bits, |dx| < 1e-6, two culled runs to the bit;
    ms a pass of each in turns (serial, culled, culled, serial), launches
    a pass, the pair tests the warp cull keeps (its plain mirror), the
    bound, and with ``profile`` each kernel of the pass; recorded in
    B4_DESIGNS.  ``call_ms`` is the standalone call (set-up, the pass and
    its apply), ``loop_pass_ms`` the mesh loop's pass alone.  The bound
    counts the pair tests the warp cull keeps; ``bound_ms_all_candidates``
    every candidate pair test of touching blocks, the serial design's
    work.  Raises when the designs disagree."""
    order = sh.morton_order(pred, cfg)

    def run(design):
        return lambda: cc.self_collision_project_blocked_cuda(
            pred, inv, order, cfg, design=design)

    outs, calls = {}, {}
    for design in ("serial", "culled"):
        before = cc.launches
        outs[design] = run(design)()
        torch.cuda.synchronize()
        calls[design] = cc.launches - before
    again = run("culled")()
    same_bits = torch.equal(cc.touching_pairs_cuda(pred, inv, order, cfg),
                            cc.touching_pairs_cuda(pred, inv, order, cfg,
                                                   "serial"))
    sel = [cc.candidates_cuda(pred, inv, order, cfg, d)
           for d in ("culled", "serial")]
    same_sel = all(torch.equal(a, b) for a, b in zip(*sel))
    dx = float((outs["culled"] - outs["serial"]).abs().max())
    repeat = torch.equal(again.view(torch.int32),
                         outs["culled"].view(torch.int32))
    # the pass as the mesh loop runs it (its kernels alone), then the
    # standalone entry's whole call (with its set-up and the apply)
    corr = {d: cc.corr_runner(pred, inv, order, cfg, d)
            for d in ("serial", "culled")}
    times, _ = timed_windows(torch, {"serial": (corr["serial"], 1),
                                     "culled": (corr["culled"], 1)},
                             min_s=0.3)
    calls_t, _ = timed_windows(torch, {"serial": (run("serial"), 1),
                                       "culled": (run("culled"), 1)},
                               min_s=0.3, warm=False)
    skip, kept, cand = cc.warp_cull_plain(pred, inv, order, cfg)
    # near points a row: what a row warp tests, each of its rows
    block = cc.layout(pred.shape[0], cfg)[0]
    ok = sel[0][1]
    near = ((~skip) & ok.repeat_interleave(block, 1)
            .repeat_interleave(block, 0)).sum(dim=1)
    touching = int(sh.blocked_touching_pairs(pred, inv, order, cfg).sum())
    nbytes = pred.shape[0] * (12 + 4 + 4 + 12)
    bound = bound_ms(nbytes, PAIR_OPS * kept + TOUCH_OPS * touching)
    bound_all = bound_ms(nbytes, PAIR_OPS * cand + TOUCH_OPS * touching)
    rec = dict(state=label, loop_pass_ms=min(times["culled"]),
               serial_loop_pass_ms=min(times["serial"]),
               windows=times["culled"], serial_windows=times["serial"],
               call_ms=min(calls_t["culled"]),
               serial_call_ms=min(calls_t["serial"]),
               call_windows=calls_t["culled"],
               serial_call_windows=calls_t["serial"],
               launches_per_pass=calls["culled"],
               serial_launches_per_pass=calls["serial"],
               pair_tests=cand, pair_tests_after_cull=kept,
               near_max=int(near.max()), near_mean=float(near.float().mean()),
               touching_pairs=touching, bound_ms=bound[0],
               bound_by=bound[1], bound_ms_all_candidates=bound_all[0],
               bound_by_all_candidates=bound_all[1],
               max_abs_err_vs_serial=dx)
    print(f"# B-4 designs, {label} ({pred.shape[0]} particles, B="
          f"{cfg.collision_block_size} M={cfg.block_neighbors}; {smi}): "
          f"the mesh loop's pass: serial {rec['serial_loop_pass_ms']:.5f} "
          f"ms (windows {times['serial']}), culled "
          f"{rec['loop_pass_ms']:.5f} (windows {times['culled']}): "
          f"{rec['serial_loop_pass_ms'] / rec['loop_pass_ms']:.2f}x; the "
          f"standalone call with its apply: serial "
          f"{rec['serial_call_ms']:.5f} ms ({calls['serial']} launches; "
          f"windows {calls_t['serial']}), culled {rec['call_ms']:.5f} "
          f"({calls['culled']} launches; windows {calls_t['culled']}); "
          f"bound {bound[0]:.5f} ms ({bound[1]}; the kept tests), "
          f"{bound_all[0]:.5f} ms ({bound_all[1]}) over every candidate "
          f"test; {cand} candidate pair "
          f"tests, {kept} after the warp cull "
          f"({kept / max(cand, 1):.4f}; near points a row: mean "
          f"{rec['near_mean']:.1f}, max {rec['near_max']} at slot "
          f"{int(near.argmax())}), {touching} touching; culled vs "
          f"serial: touching bits equal={same_bits}, candidates equal="
          f"{same_sel}, max|dx|={dx:.3e}, two runs to the bit={repeat}")
    if not (same_bits and same_sel and dx < 1e-6 and repeat):
        raise RuntimeError(f"B-4's culled pass parts from the serial one "
                           f"at {label}")
    if profile:
        LATE_PROFILES.append(lambda: b4_profile(torch, run, label, rec))
        if "--profile" not in sys.argv[1:]:
            LATE_PROFILES.pop()()
    B4_DESIGNS.append(rec)
    return rec


# b4_designs' kernel breakdowns and B-3's particle passes still to print:
# with --profile they wait until the main paths' profiles have run (a
# profiler session in the middle of the smoke left the later ones empty)
LATE_PROFILES = []


def b4_profile(torch, run, label, rec):
    """Each kernel of one standalone B-4 call in either design, from the
    profiler (20 calls), printed and recorded in ``rec``."""
    calls = 20
    for design in ("serial", "culled"):
        kt = kernel_times(torch, run(design), calls)
        # each kernel's mean time x its launches a call (the profiler may
        # drop some of a long run's events)
        own = {k.split("(")[0]: (max(1, round(n / calls)), t / n)
               for k, (n, t) in kt.items() if "cx_" in k}
        rec[f"{design}_kernels_us"] = {k: c * us for k, (c, us) in
                                       own.items()}
        print(f"# B-4 profile, {design}, {label}: "
              + "; ".join(f"{k} {c} x {us:.3f} us" for k, (c, us) in
                          sorted(own.items(), key=lambda kv: -kv[1][1]))
              + f"; the call's kernels "
              f"{sum(rec[f'{design}_kernels_us'].values()):.3f} us")


# phase 41: the bodies whose barrier is timed both ways (res, bodies):
# ensembles of some 64k particles and single bodies, around BLOCK_BODY_MAX
CROSSOVER = [(4, 1024), (6, 304), (8, 128), (10, 64), (12, 38), (6, 1),
             (8, 1), (10, 1), (12, 1)]
# phase 41: one body from L2-resident to far beyond it (res, substeps a
# call), the persistent kernel against the per-pass loop
DESIGN_SIZES = [(64, 200), (80, 100), (100, 50)]


def b3_phase(torch, mc, general, smi):
    """Phase 42: B-3's persistent kernel against its per-pass loop on every
    configuration the CPU tests hold against JAX -- each mesh case exact
    and with ``approx_math``, each tet and contact case, each volume case
    (one body and ensembles), each mesh ensemble case (shared and per-body
    masses, per-body materials, a kinematic sphere, dense contact), each
    collider case (its poses moved once) -- to the bit, one launch a call
    without blocked contact; then each barrier forced on a small body and
    an ensemble, and a many-block run repeated five times, to the bit.
    Raises on any difference.  Returns the number of configurations."""
    import test_torch_collider_cases as collider_cases
    import test_torch_contact_cases as K
    import test_torch_ensemble_cases as E
    import test_torch_mesh_cases as M
    import test_torch_volume_cases as V

    from softbodysimulation_tpu_torch import state_from_numpy
    from softbodysimulation_tpu_torch.core import scenes

    t0 = time.perf_counter()
    checked = 0

    def both(label, st, topo, cfg, dt_sub, n_sub, one_launch=True,
             schedule=None, **kw):
        nonlocal checked
        runs = {}
        for design in mc.DESIGNS:
            before = mc.launches
            runs[design] = (mc.run_substeps_cuda(
                st, topo, cfg, dt_sub, n_sub, design=design,
                schedule=schedule if design == "persistent" else None,
                **kw), mc.launches - before)
        torch.cuda.synchronize()
        bad = b3_bits(torch, runs["persistent"][0], runs["per_pass"][0])
        if bad or (one_launch and runs["persistent"][1] != 1):
            raise RuntimeError(f"B-3 designs differ on {label}: {bad}, "
                               f"{runs['persistent'][1]} launches")
        checked += 1
        return runs["persistent"][0]

    for name, (cfg, kind, kw, frames) in M.mesh_cases().items():
        topo, fields = M.case_inputs(kind, **kw)
        st = state_from_numpy(fields, device="cuda")
        for approx in (False, True):
            both(f"mesh {name} approx={approx}", st, topo, cfg,
                 1 / 60 / cfg.substeps, frames * cfg.substeps,
                 with_ext=True, approx_math=approx)
    for name, (cfg, kind, kw, frames) in K.tet_cases().items():
        topo, fields = K.tet_inputs(kind, K.modules(), **kw)
        both(f"tets {name}", state_from_numpy(fields, device="cuda"), topo,
             cfg, 1 / 60 / cfg.substeps, frames * cfg.substeps,
             with_ext=True)
    topo, fields, _ = K.contact_scene(K.modules())
    for name, (cfg, frames) in K.contact_cases().items():
        both(f"contact {name}", state_from_numpy(fields, device="cuda"),
             topo, cfg, 1 / 60 / cfg.substeps, frames * cfg.substeps,
             one_launch=cfg.self_collision_backend == "dense",
             with_ext=True)
    for name in V.volume_cases():
        cfg, topo, fields, nb, frames = V.case_inputs(name)
        both(f"volume {name}", state_from_numpy(fields, device="cuda"), topo,
             cfg, V.DT / cfg.substeps, frames * cfg.substeps, with_ext=True,
             batched=nb > 1)
    for name in E.mesh_ensemble_cases():
        topo, cfg, st, mats, frames, opts = E.mesh_case(name, "cuda")
        both(f"ensemble {name}", st, topo, cfg, E.DT / cfg.substeps,
             frames * cfg.substeps, with_ext=True, materials=mats,
             batched=True, per_body_mass=bool(opts.get("per_body_mass")))
        if name in ("colored", "dense_contact"):
            p = mc.make_params(topo, cfg, E.DT / cfg.substeps)
            if st.lambda_tet is None:
                p.n_tets = 0
            for barrier in mc.BARRIERS:
                sched = mc.schedule_for(mc.tile_counts(p),
                                        st.positions.shape[0], st.device,
                                        barrier=barrier)
                both(f"ensemble {name}, {barrier} barrier", st, topo, cfg,
                     E.DT / cfg.substeps, frames * cfg.substeps,
                     schedule=sched, with_ext=True, materials=mats,
                     batched=True,
                     per_body_mass=bool(opts.get("per_body_mass")))
    for name in collider_cases.mesh_collider_cases():
        def runner(design):
            return lambda topo, cfg, dt, frames, kin: (
                lambda st: mc.run_substeps_cuda(
                    st, topo, cfg, dt / cfg.substeps,
                    frames * cfg.substeps, with_ext=True, design=design))

        new = collider_cases.mesh_runs(name, "cuda", runner("persistent"),
                                       general.multi_step_fn)
        old = collider_cases.mesh_runs(name, "cuda", runner("per_pass"),
                                       general.multi_step_fn)
        for (a, _, _), (b, _, _) in zip(new, old):
            if b3_bits(torch, a, b):
                raise RuntimeError(f"B-3 designs differ on colliders {name}")
            checked += 1
    st, _, info = scenes.cloth(res=48, device="cuda")
    ref = mc.run_substeps_cuda(st, info["topology"], info["config"],
                               1 / 240, 40, with_ext=True, design="per_pass")
    for _ in range(5):
        out = mc.run_substeps_cuda(st, info["topology"], info["config"],
                                   1 / 240, 40, with_ext=True)
        if b3_bits(torch, out, ref):
            raise RuntimeError("B-3's persistent kernel is not repeatable")
    print(f"# B-3 designs to the bit ({smi}): the persistent kernel equals "
          f"the per-pass loop on {checked} configurations (one launch a "
          f"call without blocked contact), and a 48 x 48 cloth over 40 "
          f"substeps five times; {time.perf_counter() - t0:.1f} s")
    return checked


def barrier_phase(torch, lc, lat, top, cfg, smi):
    """41. The persistent kernel's barriers, in turns at each shape:
    ``__syncthreads`` with whole bodies a block against the grid barrier
    across CROSSOVER; the grid barrier at res 40 on fewer, fuller blocks;
    the persistent kernel against the per-pass loop on one body from res
    64 to res 100 (DESIGN_SIZES).  Rest lattices under the bench
    configuration, ms per substep."""
    t0 = time.perf_counter()
    out = {"crossover": []}

    def windows(spec, bodies, n_sub, barriers):
        st = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device="cuda")
        if bodies > 1:
            st = st.replace(**{k: getattr(st, k).expand(
                bodies, *getattr(st, k).shape).contiguous()
                for k in ("positions", "velocities", "ext_force",
                          "lambda_dist")})
        runs = {}
        for b in barriers:
            sched = lc.schedule_for(spec, bodies, st.device, barrier=b)
            runs[b] = (lambda sc=sched: lc.run_substeps_cuda(
                st, spec, cfg, 1 / 480, n_sub, batched=bodies > 1,
                schedule=sc), n_sub)
        times, _ = timed_windows(torch, runs, min_s=0.3)
        return {b: min(t) for b, t in times.items()}, times

    for res, bodies in CROSSOVER:
        best, times = windows(top.lattice_spec(res, braced=True), bodies,
                              40, ("block", lc.GRID_BARRIER))
        out["crossover"].append(dict(res=res, bodies=bodies, **best))
        print(f"# barrier crossover, {bodies} x res {res} ({res ** 3} "
              f"particles a body; {smi}): block {best['block']:.5f}, "
              f"{lc.GRID_BARRIER} {best[lc.GRID_BARRIER]:.5f} ms/substep "
              f"(windows in turns {times}); the shape's rule takes "
              f"{lc.choose_barrier(top.lattice_spec(res, braced=True))}")
    # fewer blocks, more particles a thread: the barrier's cost against a
    # thread's own
    spec = top.lattice_spec(40, braced=True)
    st = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0), mass=0.001,
                                device="cuda")
    sms, per_sm = lc.device_occupancy(st.device.index, lc.GRID_BARRIER)
    runs = {}
    for g in (250, 132, 66):
        sc = lc.plan_schedule(spec, 1, sms, per_sm, grid=g)
        runs[f"{sc.grid} blocks of {sc.chunk}"] = (
            lambda sc=sc: lc.run_substeps_cuda(st, spec, cfg, 1 / 480, 400,
                                               schedule=sc), 400)
    times, _ = timed_windows(torch, runs, min_s=0.3)
    out["grid_sizes"] = {k: min(v) for k, v in times.items()}
    print(f"# grid sizes at res 40, {lc.GRID_BARRIER} barrier ({smi}), ms "
          f"a substep: {out['grid_sizes']} (windows in turns {times})")
    for res, n_sub in DESIGN_SIZES:
        spec = top.lattice_spec(res, braced=True)
        st = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device="cuda")
        b1_designs(torch, lc, f"rest res {res} ({res ** 3} particles)", st,
                   spec, cfg, 1 / 480, n_sub, smi, min_s=0.3)
    print(f"# time: phase 41 took {time.perf_counter() - t0:.1f} s")
    return out


# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
CONTACT_WARM_FRAMES = 30
CONTACT_DRIFT_FRAMES = 30
# frames the kernel path runs on after the drift, into contact-rich rest
CONTACT_REST_FRAMES = 30
# float32 operations of one candidate pair of the B-4 pass that does not
# touch (the Gram d2: 3 products, 2 sums, 3 for sq_i + sq_j - 2g; one
# compare with the diameter) and the further ones of a touching pair
# (sqrt, overlap, wsum, two max, product, division, the m sum, 3 fused
# m x_j sums of 2 each)
PAIR_OPS = 9
TOUCH_OPS = 14
CATALOG_FRAMES = 120


def bound_ms(nbytes, ops):
    """The least time the card could take for work of ``nbytes`` bytes
    (each input read once, each output written once) and ``ops`` float32
    operations: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# float32 operations of one particle's projection against one collider,
# counted from csrc/colliders.cuh (box_project) and the sphere blocks of
# csrc/lattice_xpbd.cu and mesh_xpbd.cuh (sphere_project), as B5_* below
# are counted: the push (difference, squared length, root, normal,
# penetration, gate), the velocity relative to the collider and the
# friction's tangential part
SPHERE_OPS = 48
BOX_OPS = 49
# the 1 + S + B rows of the collider table (csrc/colliders.cuh), 9 floats
KIN_ROW_BYTES = 36


def collider_work(n, counts, passes):
    """(bytes, operations) of ``passes`` contact projections of ``n``
    particles against ``counts = (spheres, boxes)``: the collider table
    read once, SPHERE_OPS / BOX_OPS per particle per collider per pass."""
    s, b = counts
    return (1 + s + b) * KIN_ROW_BYTES, passes * n * (SPHERE_OPS * s
                                                      + BOX_OPS * b)


def lattice_work(spec, cfg, colliders=(0, 0)):
    """(bytes, operations) of one lattice substep: positions and velocities
    read and written, inverse masses read, every family's multipliers
    written, and read unless the mode is RESET (which zeroes them in the
    predict and never reads them); ~30 operations per constraint projection
    (difference, length, the XPBD update, two corrections) per iteration;
    and the contacts against ``colliders = (spheres, boxes)`` (the config's
    unless given) once per iteration (``collider_work``)."""
    from softbodysimulation_tpu_torch.core.config import LambdaMode
    n, fam = spec.n_particles, spec.n_families
    lam = 4 * fam * (1 if cfg.lambda_mode == LambdaMode.RESET else 2)
    counts = (max(colliders[0], len(cfg.sphere_colliders)),
              max(colliders[1], len(cfg.box_colliders)))
    cb, cops = collider_work(n, counts, cfg.iterations)
    return (n * (24 * 2 + 4 + lam) + cb,
            30 * n * fam * cfg.iterations + cops)


def mesh_work(topo, cfg, colliders=(0, 0), bodies=1):
    """(bytes, operations) of one mesh substep: the state read and written,
    the per-constraint tables and CSR incidence rows read once (those of a
    family the mesh lacks not at all), the multipliers written, and read
    unless the mode is RESET (which zeroes them in the predict and never
    reads them); per iteration ~30 operations per edge,
    ~150 per hinge (normals, acos, sin, four gradients), ~120 per tet, ~10
    per particle (the sums and the floor), and with the volume on its
    triangles, corner incidence rows and VOLUME_* operations (the
    passes' scratch, an intermediate, not counted); and the contacts
    against
    ``colliders = (spheres, boxes)`` (the config's unless given) once per
    iteration, twice with Chebyshev (``collider_work``).  An ensemble of
    ``bodies`` moves each body's state and multipliers and does each
    body's operations, and reads the shared tables (and inverse masses)
    once."""
    from softbodysimulation_tpu_torch.core.config import LambdaMode
    from softbodysimulation_tpu_torch.solvers import general
    n, e, h, t = topo.n_particles, topo.n_edges, topo.n_hinges, topo.n_tets
    lam = 4 * (1 if cfg.lambda_mode == LambdaMode.RESET else 2)
    per_body = n * 24 * 2 + lam * (e + h + t)
    shared = (4 * n + e * (8 + 16) + h * (16 + 12) + t * (16 + 12)
              + 4 * (n + 1 + 2 * e)                             # CSR rows
              + (4 * (n + 1 + 4 * h) if h else 0)
              + (4 * (n + 1 + 4 * t) + 4 * n if t else 0))
    ops = cfg.iterations * (30 * e + 150 * h + 120 * t + 10 * n)
    if general.volume_on(cfg, topo):
        tri = topo.triangles.shape[0]
        # the triangles and their corner incidence rows (CSR) read once,
        # the multiplier written (and read outside RESET)
        shared += 12 * tri + 4 * (n + 1 + 3 * tri)
        per_body += lam
        ops += cfg.iterations * (VOLUME_TRI_OPS * tri
                                 + VOLUME_PARTICLE_OPS * n + VOLUME_BLOCK_OPS)
    counts = (max(colliders[0], len(cfg.sphere_colliders)),
              max(colliders[1], len(cfg.box_colliders)))
    passes = cfg.iterations * (2 if general.accelerated(cfg) else 1)
    cb, cops = collider_work(n, counts, passes)
    return bodies * per_body + shared + cb, bodies * (ops + cops)


# float32 operations of B-3's volume passes per iteration, counted from the
# kernel bodies in csrc/mesh_xpbd.cu as B5_* below are counted.  Per
# triangle: tri_kernel's three cross products (9 each), the volume term's
# dot product (5) and nine divisions by 6 (41); vol_grad_kernel's row sums,
# 3 adds for each of the triangle's 3 corners (9); vol_reduce_kernel's
# strided sum (1).  Per particle: vol_grad_kernel's w |g|^2 (6),
# vol_reduce_kernel's strided sum (1), the apply in particle_kernel (7).
# Per body: the reduction block's two halving trees (2 x 255) and the
# multiplier's update (8).
VOLUME_TRI_OPS = 41 + 9 + 1
VOLUME_PARTICLE_OPS = 6 + 1 + 7
VOLUME_BLOCK_OPS = 2 * 255 + 8


DIFF_DT = 1.0 / 240.0
GRAD_SUBSTEPS = 40
LONG_GRAD_SUBSTEPS = 240
FITLOOP_STEPS = 30
# config6 cut to 20 of its 60 frames and 2 gradient steps: its backward is
# autograd through the plain stencil engine, about 8 s a step at 60 frames
CONFIG6_FRAMES = 20
CONFIG6_ITERS = 2
# the kernels of csrc/mesh_diff_xpbd.cu (the mesh library's build log
# names them in mangled form)
B5_KERNELS = ("stash_sub_kernel", "stash_kernel", "new_kernel",
              "fin_bwd_kernel", "iter_bwd_kernel", "edge_bwd_kernel",
              "sum_bwd_kernel", "predict_bwd_kernel")
# float32 operations of a B-5 chunk at the bench_diff configuration
# (JACOBI + Chebyshev, RESET, the XPBD floor; no clamps, spheres, world
# bounds or materials), counted from the kernel bodies in
# csrc/mesh_diff_xpbd.cu and mesh_xpbd.cu{,h}: each add, subtract,
# multiply, divide, square root, min / max and comparison of a value (a
# negation or absolute value is an operand modifier and counts nothing;
# loop-invariant scalars once per thread).  Per edge per iteration: the
# replay's edge_kernel 34, the cotangent's edge_bwd_kernel 67, and the
# three row sums (particle_kernel, new_kernel, sum_bwd_kernel) 3 adds per
# coordinate at each of the edge's 2 endpoints, 18.  Per particle per
# iteration: new_kernel 3; particle_kernel 37 (the sum 3, the floor twice
# at 8, the Chebyshev step 18); iter_bwd_kernel 58 (the replayed floor 8
# and Chebyshev step 18, two floor VJPs at 5, the mix 16, the two anchor
# cotangents 6); sum_bwd_kernel 6.  Per particle per substep:
# predict_kernel 24, finalize 7, fin_bwd_kernel 7, sum_bwd_kernel's prev
# term 3, predict_bwd_kernel 33.  Not counted: the floor's friction and
# normal-row work on a particle in contact (up to 50 a particle-iteration),
# which the 40-substep chunk of the bound does not meet (phase 19 prints
# its lowest point, above the floor).
B5_EDGE_ITER_OPS = 34 + 67 + 18
B5_PARTICLE_ITER_OPS = 3 + 37 + 58 + 6
B5_PARTICLE_SUB_OPS = 24 + 7 + 7 + 3 + 33


# B-5's kinematic pose cotangents, per particle, per sphere, per contact
# VJP (once an iteration, twice with Chebyshev): sphere_bwd of
# csrc/mesh_diff_xpbd.cu recomputes the projection's parts (37) and takes
# its VJP with the seven pose-plane additions (72), after replaying the
# floor before it (8); the replayed forward projects the sphere once per
# contact pass too (SPHERE_OPS); the ground's cotangent is 4 more a floor
# VJP; pose_sum_kernel adds each of the 1 + 7S planes over the particles
B5_SPHERE_VJP_OPS = 37 + 72 + 8
B5_GROUND_VJP_OPS = 4


def diff_work(topo, cfg, n_substeps, kin_spheres=0):
    """(bytes, operations) of one B-5 chunk of ``n_substeps``.  Bytes: the
    inputs read once (the edges and three per-edge constants, the CSR rows,
    x, v, inverse masses and multipliers, the output cotangents) and the
    entry cotangents written once; the stash is the kernel's intermediate,
    not an input or an output, and is not counted.  Operations: the counts
    above.  With ``kin_spheres`` (a ColliderSet's spheres): the collider
    table read, the 1 + 7S pose cotangents written, and the pose VJPs and
    sums (the B5_SPHERE_* counts); the static sphere VJP of a config's
    spheres is not counted (the main path has none)."""
    from softbodysimulation_tpu_torch.solvers import general
    n, e, k = topo.n_particles, topo.n_edges, cfg.iterations
    nbytes = (e * (8 + 12) + 4 * (n + 1 + 2 * e)    # edges, rest/alpha/relax
              + n * (12 + 12 + 4) + 4 * e          # x, v, w, lambda
              + 2 * (n * 24 + 4 * e))              # cotangents in and out
    ops = n_substeps * (k * (B5_EDGE_ITER_OPS * e + B5_PARTICLE_ITER_OPS * n)
                        + B5_PARTICLE_SUB_OPS * n)
    if kin_spheres:
        s = kin_spheres
        passes = n_substeps * k * (2 if general.accelerated(cfg) else 1)
        nbytes += (1 + s) * KIN_ROW_BYTES + 4 * (1 + 7 * s)
        ops += passes * n * (s * (B5_SPHERE_VJP_OPS + SPHERE_OPS)
                             + B5_GROUND_VJP_OPS) + (1 + 7 * s) * n
    return nbytes, ops


# gate of the float64 witness: autograd through the plain engine against
# backward_chunk_plain, the same derivative, parted by float64 rounding
F64_TOL = 1e-9


def diff_scene(torch, device):
    """The scene and config of ``scripts/bench_diff.py`` (its fallback
    mesh): (topology, config, the state on ``device``, the launch
    velocity)."""
    import numpy as np
    from softbodysimulation_tpu_torch import state_from_topology
    from softbodysimulation_tpu_torch.core import config as C
    from softbodysimulation_tpu_torch.topology import build, mesh

    pos, topo = build.topology_from_mesh(mesh.icosphere(4, radius=0.5),
                                         compliance=1e-6, windowed=True)
    pos = pos + np.array([0.0, 1.0, 0.0], np.float32)
    cfg = C.SolverConfig(substeps=4, iterations=4, damping=0.02,
                         solve_mode=C.SolveMode.JACOBI,
                         gravity_is_acceleration=True, ground_height=0.0,
                         friction=0.3)
    return (topo, cfg, state_from_topology(topo, pos, device=device),
            torch.tensor([0.1, 0.0, 0.0], device=device))


def as_f64(st):
    """A one-body mesh state in float64."""
    return st.replace(**{k: getattr(st, k).double() for k in (
        "positions", "velocities", "inv_mass", "ext_force", "lambda_dist",
        "lambda_bend", "lambda_volume")})


def f64_witness() -> int:
    """``--f64-witness``: the gradient of sum(x^2) w.r.t. the launch
    velocity over LONG_GRAD_SUBSTEPS of the bench_diff scene, in float64 on
    the CPU, twice (autograd through the plain engine, and
    ``backward_chunk_plain``), printed as one JSON line.  The smoke runs it
    in a process of its own while the card works (``f64_witness_check``
    reads it)."""
    import torch

    sys.path.insert(0, HERE)
    from softbodysimulation_tpu_torch.kernels import mesh_diff as md
    from softbodysimulation_tpu_torch.solvers import general

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    topo, cfg, st, v0 = diff_scene(torch, "cpu")
    st = as_f64(st)
    ns, n, v0 = LONG_GRAD_SUBSTEPS, topo.n_particles, v0.double()
    v = v0.clone().requires_grad_()
    out = general.run_substeps_plain(st.replace(velocities=v.expand(n, 3)),
                                     topo, cfg, DIFF_DT, ns)
    loss = (out.positions ** 2).sum()
    (g_auto,) = torch.autograd.grad(loss, v)
    end = out.positions.detach()
    _, gv, _ = md.backward_chunk_plain(
        topo, cfg, DIFF_DT, ns, st.inv_mass, st.positions,
        v0.expand(n, 3).contiguous(), st.lambda_dist, 2.0 * end,
        torch.zeros_like(end), torch.zeros_like(st.lambda_dist))
    print(json.dumps({"loss": float(loss.detach()),
                      "autograd": g_auto.tolist(),
                      "plain": gv.sum(0).tolist(),
                      "seconds": time.perf_counter() - t0}))
    return 0


def f64_witness_check(torch, proc, grads32):
    """Read the witness process's line; raise unless its two float64
    gradients agree to F64_TOL; print each float32 gradient of ``grads32``
    against it."""
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the float64 witness failed ({proc.returncode})")
    w = json.loads(out.strip().splitlines()[-1])
    g_auto, g_plain = (torch.tensor(w[k], dtype=torch.float64)
                       for k in ("autograd", "plain"))
    scale = float(g_auto.abs().max())
    rel = float((g_plain - g_auto).abs().max()) / scale
    print(f"# float64 witness, {LONG_GRAD_SUBSTEPS} substeps on the CPU "
          f"({w['seconds']:.1f} s, beside the card's phases): loss "
          f"{w['loss']:.9f}; grad autograd {g_auto.numpy()} "
          f"backward_chunk_plain {g_plain.numpy()}, max|dg|/max|g| = "
          f"{rel:.3e} (gate {F64_TOL})")
    for key, g in grads32.items():
        d = float((g.cpu().double() - g_auto).abs().max()) / scale
        print(f"# float32 {key} gradient vs the float64 witness: "
              f"max|dg|/max|g| = {d:.3e}")
    if not (rel < F64_TOL and scale > 1e-3):
        raise RuntimeError(f"the float64 VJP disagrees with autograd: {rel}")


def timed_alone(torch, fn, per_call, min_s=1.0):
    """ms per substep of one runner, two CUDA-event windows of at least
    ``min_s`` each."""
    t = cuda_ms(torch, fn, 1)
    reps = max(1, math.ceil(1.2 * min_s * 1e3 / t))
    return [cuda_ms(torch, fn, reps, warm=False) / per_call
            for _ in range(2)], reps


def diff_phases(torch, built, smi, witness):
    """Phases 17-20, the differentiable path (``witness``: the float64
    witness's process).  Returns the B-5 kernel's JSON numbers and the
    gradient to profile."""
    import test_torch_diff_cases as D
    from softbodysimulation_tpu_torch.examples import config6_diffsim
    from softbodysimulation_tpu_torch.examples import config10_material_fit
    from softbodysimulation_tpu_torch.kernels import diff as kd
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.kernels import mesh_diff as md
    from softbodysimulation_tpu_torch.solvers import general

    # 17. B-5's kernels, built into the mesh library in phase 2
    print("# B-5: csrc/mesh_diff_xpbd.cu, built into the mesh library")
    print_build(built, B5_KERNELS)

    def errs(got, ref):
        return D.normalized_errors({k: v.cpu() for k, v in got.items()},
                                   {k: v.cpu() for k, v in ref.items()})

    def abs_err(got, ref):
        return max(float((got[k] - ref[k]).abs().max()) for k in ref)

    # 18. B-5 vs plain (and both vs autograd) for every diff case
    t0 = time.perf_counter()
    b5_err = 0.0
    for name, (cfg, n_sub, _, kw) in D.diff_cases().items():
        topo, fields = D.case_inputs(kw)
        st, cot, mats = D.port_inputs(fields, "cuda")
        got = D.chunk_vjp(md.backward_chunk_cuda, topo, cfg, n_sub, st, cot,
                          mats)
        plain = D.chunk_vjp(md.backward_chunk_plain, topo, cfg, n_sub, st,
                            cot, mats)
        auto = D.autograd_vjp(topo, cfg, n_sub, st, cot, mats)
        e_plain, e_kauto, e_pauto = (errs(got, plain), errs(got, auto),
                                     errs(plain, auto))
        b5_err = max(b5_err, abs_err(got, plain))
        print(f"# B-5 case {name} ({n_sub} substeps): kernel vs plain "
              + " ".join(f"{k}={v:.2e}" for k, v in e_plain.items())
              + f"; vs autograd kernel {max(e_kauto.values()):.2e} plain "
              f"{max(e_pauto.values()):.2e}; max|gx|="
              f"{float(auto['gx'].abs().max()):.3e}")
        if not (max(e_plain.values()) < D.KERNEL_TOL
                and max(e_kauto.values()) < D.GRAD_TOL
                and max(e_pauto.values()) < D.GRAD_TOL
                and float(auto["gx"].abs().max()) > 1e-3):
            raise RuntimeError(f"B-5 disagrees on {name}")
    cfg, n_sub, _, kw = D.diff_cases()["clamps"]
    cfg = cfg.replace(min_alpha_tilde=0.0576, max_dlambda_rel=0.05)
    topo, fields = D.case_inputs(kw)
    st, _, _ = D.port_inputs(fields, "cuda")
    run = mc.make_mesh_cuda_substep_runner(topo, cfg, D.DT, n_sub)
    static = run(st)
    traced = run(st, {"rest_lengths": topo.rest_lengths.cuda(),
                      "compliance": topo.compliance.cuda()})
    same = (torch.equal(static.positions, traced.positions)
            and torch.equal(static.lambda_dist, traced.lambda_dist))
    print(f"# traced materials vs the static path (min_alpha_tilde, "
          f"max_dlambda_rel, DECAY): bit for bit={same}")
    if not same:
        raise RuntimeError("traced materials differ from the static path")

    print(f"# time: phase 18 took {time.perf_counter() - t0:.1f} s")

    # 19. the differentiable main path at full width
    t0 = time.perf_counter()
    topo, cfg, st, v0 = diff_scene(torch, "cuda")
    n = topo.n_particles
    print(f"# diff main path: icosphere(4) {n} particles, {topo.n_edges} "
          f"edges, JACOBI x {cfg.iterations} (Chebyshev rho "
          f"{cfg.jacobi_rho}), RESET, floor; stash of a "
          f"{GRAD_SUBSTEPS}-substep chunk "
          f"{md.stash_bytes(topo, cfg, GRAD_SUBSTEPS) / 1e9:.4f} GB, of "
          f"{LONG_GRAD_SUBSTEPS} {md.stash_bytes(topo, cfg, LONG_GRAD_SUBSTEPS) / 1e9:.4f} GB")

    def vel_grad(run):
        def f(v=None):
            v = (v0 if v is None else v).clone().requires_grad_()
            out = run(st.replace(velocities=v.expand(n, 3)))
            loss = (out.positions ** 2).sum()
            (g,) = torch.autograd.grad(loss, v)
            return loss.detach(), g
        return f

    runners = {(bk, ns): kd.make_differentiable_mesh_runner(
        topo, cfg, DIFF_DT, ns, backward=bk)
        for bk in ("fused", "xla") for ns in (GRAD_SUBSTEPS,
                                              LONG_GRAD_SUBSTEPS)}
    vel_grad(runners["fused", GRAD_SUBSTEPS])()      # warm: builds, tables
    torch.cuda.synchronize()
    mc.launches = md.launches = 0
    val_f, g_f = vel_grad(runners["fused", GRAD_SUBSTEPS])()
    torch.cuda.synchronize()
    main_b5, main_fwd = md.launches, mc.launches
    val_x, g_x = vel_grad(runners["xla", GRAD_SUBSTEPS])()
    rel = float((g_f - g_x).abs().max() / g_x.abs().max())
    print(f"# diff main path, {GRAD_SUBSTEPS} substeps: loss fused "
          f"{float(val_f):.6f} xla {float(val_x):.6f}; grad fused "
          f"{g_f.cpu().numpy()} xla {g_x.cpu().numpy()}, max|dg|/max|g| = "
          f"{rel:.3e}; launches: {main_fwd} forward (mesh_xpbd) + {main_b5} "
          f"backward (mesh_diff_xpbd) = {main_b5 / GRAD_SUBSTEPS:.2f} B-5 "
          f"launches per backward substep")
    if not (bool(torch.isfinite(g_f).all()) and rel < D.GRAD_TOL
            and float(g_x.abs().max()) > 1e-3 and main_b5 > 0
            and main_fwd > 0):
        raise RuntimeError(f"fused and xla gradients disagree: {rel}")
    # the longer horizon, through the body's landing and slide: both
    # backwards linearize at the same trajectory (the forward is bit for bit
    # the plain engine's); the fused backward in 40-substep chunks
    # (boundaries recomputed by the forward kernel) must equal it in one
    # chunk, and B-5 its plain version, below; the float64 witness then
    # says how far each float32 gradient is from the exact one
    ns = LONG_GRAD_SUBSTEPS
    val_fl, g_fl = vel_grad(runners["fused", ns])()
    val_xl, g_xl = vel_grad(runners["xla", ns])()
    rel_l = float((g_fl - g_xl).abs().max() / g_xl.abs().max())
    print(f"# diff main path, {ns} substeps: loss fused "
          f"{float(val_fl):.6f} xla {float(val_xl):.6f}; grad fused "
          f"{g_fl.cpu().numpy()} xla {g_xl.cpu().numpy()}, "
          f"max|dg|/max|g| = {rel_l:.3e}")
    if not bool(torch.isfinite(g_fl).all() and torch.isfinite(g_xl).all()):
        raise RuntimeError(f"non-finite {ns}-substep gradients")
    _, g_ch = vel_grad(kd.make_differentiable_mesh_runner(
        topo, cfg, DIFF_DT, LONG_GRAD_SUBSTEPS, remat_chunk=GRAD_SUBSTEPS,
        backward="fused"))()
    print(f"# fused backward at {LONG_GRAD_SUBSTEPS} substeps in "
          f"{GRAD_SUBSTEPS}-substep chunks vs one chunk: bit for bit="
          f"{torch.equal(g_ch, g_fl)}, max|dg|/max|g| = "
          f"{float((g_ch - g_fl).abs().max() / g_fl.abs().max()):.3e}")
    if not float((g_ch - g_fl).abs().max() / g_fl.abs().max()) \
            < D.KERNEL_TOL:
        raise RuntimeError("the chunked fused backward disagrees")
    # the kernel and its plain version at the main path's shapes: one
    # chunk of 40 and of 240 substeps, the loss's own cotangent at the
    # output
    start = st.replace(velocities=v0.expand(n, 3).contiguous())
    chunk_args = {}
    for ns in (GRAD_SUBSTEPS, LONG_GRAD_SUBSTEPS):
        out = runners["fused", ns](start)
        ref_out = general.run_substeps_plain(start, topo, cfg, DIFF_DT, ns)
        fwd_same = torch.equal(out.positions, ref_out.positions)
        cot = (2.0 * out.positions, torch.zeros_like(out.velocities),
               torch.zeros_like(out.lambda_dist))
        args = chunk_args[ns] = (topo, cfg, DIFF_DT, ns, start.inv_mass,
                                 start.positions, start.velocities,
                                 start.lambda_dist, *cot)
        k_out = dict(zip(D.GRAD_KEYS, md.backward_chunk_cuda(*args)))
        p_out = dict(zip(D.GRAD_KEYS, md.backward_chunk_plain(*args)))
        e_main = errs(k_out, p_out)
        b5_err = max(b5_err, abs_err(k_out, p_out))
        low = float(out.positions[:, 1].min())
        print(f"# B-5 vs plain at the main path's shapes ({ns}-substep "
              f"chunk): " + " ".join(f"{k}={v:.2e}"
                                     for k, v in e_main.items())
              + f" (normalized), max |dg| {abs_err(k_out, p_out):.3e}; the "
              f"kernel forward bit for bit with the plain engine={fwd_same}"
              f"; lowest point at the end {low:.6f} (floor "
              f"{cfg.ground_height})")
        if not (max(e_main.values()) < D.KERNEL_TOL and fwd_same):
            raise RuntimeError(f"B-5 disagrees with plain at the main path "
                               f"({ns} substeps)")
    f64_witness_check(torch, witness, {"fused": g_fl, "xla": g_xl})
    args = chunk_args[GRAD_SUBSTEPS]
    reps = 5
    ms_b5 = cuda_ms(torch, lambda: md.backward_chunk_cuda(*args), reps)
    ms_b5_plain = cuda_ms(torch, lambda: md.backward_chunk_plain(*args), 1,
                          warm=False)

    def fitloop(run):
        v, first, last = v0, None, None
        for _ in range(FITLOOP_STEPS):
            last, g = vel_grad(run)(v)
            first = last if first is None else first
            v = v - 1e-6 * g
        return float(first), float(last), v

    l_first, l_last, v_fit = fitloop(runners["fused", GRAD_SUBSTEPS])
    print(f"# fitloop{FITLOOP_STEPS} (fused, lr 1e-6): loss {l_first:.6f} -> "
          f"{l_last:.6f}, v {v_fit.cpu().numpy()}")
    if not (math.isfinite(l_last) and l_last <= l_first):
        raise RuntimeError("the fit loop did not descend")
    mats0 = {"rest_lengths": topo.rest_lengths.cuda(),
             "compliance": topo.compliance.cuda()}
    mat_runs = {bk: kd.make_differentiable_material_runner(
        topo, cfg, DIFF_DT, GRAD_SUBSTEPS, backward=bk)
        for bk in ("fused", "xla")}

    def mat_grad(run):
        def f():
            m = {k: v.clone().requires_grad_() for k, v in mats0.items()}
            loss = (run(st, m).positions ** 2).sum()
            return torch.autograd.grad(loss, [m["rest_lengths"],
                                              m["compliance"]])
        return f

    gm_f, gm_x = mat_grad(mat_runs["fused"])(), mat_grad(mat_runs["xla"])()
    e_mat = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(gm_f, gm_x)]
    print(f"# materials gradient, {GRAD_SUBSTEPS} substeps, fused vs xla: "
          f"rest {e_mat[0]:.3e} compliance {e_mat[1]:.3e} (max|g_rest|="
          f"{float(gm_x[0].abs().max()):.3e}, max|g_comp|="
          f"{float(gm_x[1].abs().max()):.3e})")
    if not (max(e_mat) < D.GRAD_TOL
            and float(gm_x[0].abs().max()) > 1e-3):
        raise RuntimeError(f"materials gradients disagree: {e_mat}")
    l0, l1, err0, err1 = config10_material_fit.run(device="cuda",
                                                   verbose=False)
    print(f"# config10 (fused backward): trajectory loss {l0:.3e} -> "
          f"{l1:.3e}, mean |rest error| {err0:.4f} -> {err1:.4f}")
    if not (l1 < l0 and err1 < err0):
        raise RuntimeError("config10's fit did not shrink its losses")
    t6 = time.perf_counter()
    _, hist = config6_diffsim.run(steps=CONFIG6_FRAMES, device="cuda",
                                  verbose=False, opt_iters=CONFIG6_ITERS)
    print(f"# config6 (paired lattice runner, {CONFIG6_FRAMES} frames, "
          f"{CONFIG6_ITERS} steps): loss "
          f"{hist[0]:.4f} -> {hist[-1]:.6f} ({time.perf_counter() - t6:.1f} "
          f"s)")
    if not hist[-1] < hist[0]:
        raise RuntimeError("config6's loss did not drop")

    print(f"# time: phase 19 took {time.perf_counter() - t0:.1f} s")

    # 20. throughput of the differentiable path, in turns (every runner
    # ran in phase 19)
    rows = {}
    for a, b, ns in (("grad_fused", "grad_xla", GRAD_SUBSTEPS),
                     ("grad_fused_long", "grad_xla_long",
                      LONG_GRAD_SUBSTEPS)):
        times, reps = timed_windows(torch, {
            a: (vel_grad(runners["fused", ns]), ns),
            b: (vel_grad(runners["xla", ns]), ns)}, warm=False)
        rows.update({k: (times[k], reps[k] * ns) for k in (a, b)})
    times, reps = timed_windows(torch, {
        "grad_materials_fused": (mat_grad(mat_runs["fused"]),
                                 GRAD_SUBSTEPS),
        "grad_materials_xla": (mat_grad(mat_runs["xla"]), GRAD_SUBSTEPS)},
        warm=False)
    rows.update({k: (t, reps[k] * GRAD_SUBSTEPS) for k, t in times.items()})
    per = GRAD_SUBSTEPS * FITLOOP_STEPS
    t_fit, reps = timed_alone(torch, lambda: fitloop(
        runners["fused", GRAD_SUBSTEPS]), per)
    rows[f"fitloop{FITLOOP_STEPS}_fused"] = (t_fit, reps * per)
    for key, (t, subs) in rows.items():
        print(f"# throughput {key} ({smi}): best {min(t):.5f} ms/substep = "
              f"{n / min(t) * 1e3:.4e} particle-substeps/s over {subs} "
              f"substeps a window (windows in turn order: {t})")
    work = diff_work(topo, cfg, GRAD_SUBSTEPS)
    bnd = bound_ms(*work)
    print(f"# B-5 chunk of {GRAD_SUBSTEPS} substeps ({smi}): kernel "
          f"{ms_b5:.4f} ms, plain {ms_b5_plain:.4f} ms; bound {bnd[0]:.5f} "
          f"ms ({bnd[1]}: {work[0]} bytes of inputs and outputs, "
          f"{work[1]} operations: {B5_EDGE_ITER_OPS} per edge and "
          f"{B5_PARTICLE_ITER_OPS} per particle per iteration, "
          f"{B5_PARTICLE_SUB_OPS} per particle per substep), "
          f"{ms_b5 / bnd[0]:.0f}x the bound; stash "
          f"{md.stash_bytes(topo, cfg, GRAD_SUBSTEPS)} bytes (an "
          f"intermediate, not in the bound); "
          f"{main_b5 / GRAD_SUBSTEPS:.2f} launches per backward substep")
    # --profile: one 40-substep gradient through the fused backward
    grad_fused = vel_grad(runners["fused", GRAD_SUBSTEPS])
    return dict(launches=main_b5, max_abs_err=b5_err, ms=ms_b5,
                plain_ms=ms_b5_plain, bound=bnd,
                profile=[(lambda _: grad_fused(), st)])


def contact_phases(torch, np, built, K, cc, mc, general, scenes, is_finite,
                   state_from_numpy, smi, mask_flips):
    """Phases 11-16, the multi-body contact path.  Returns the contact
    kernel's JSON numbers and the runners to profile."""
    from softbodysimulation_tpu_torch.diag.diagnostics import (
        blocked_dropped_pairs)
    from softbodysimulation_tpu_torch.ops import spatial_hash as sh

    # 11. the contact kernel's build (started with the others)
    print_build(built)
    mods = K.modules()
    dt = 1 / 60

    # 14. the contact path at full size, through the user's entry point
    t0 = time.perf_counter()
    topo, fields, cfg, nc = K.scaled_ball_on_cloth(mods)
    plain_cfg = cfg.replace(self_collision_backend="blocked")
    dt_sub = dt / cfg.substeps
    print(f"# contact main path: scaled ball_on_cloth built in "
          f"{time.perf_counter() - t0:.2f} s: {topo.n_particles} particles "
          f"({nc} cloth), {topo.n_edges} edges, {topo.n_hinges} hinges, "
          f"{topo.n_tets} tets; incidence widths {topo.incidence.shape[1]} "
          f"(edges), {topo.tet_incidence.shape[1]} (tets); blocked "
          f"B={cfg.collision_block_size} M={cfg.block_neighbors} every "
          f"{cfg.self_collision_every}")
    start = state_from_numpy(fields, device="cuda")
    rim = torch.as_tensor(np.flatnonzero(fields["inv_mass"] == 0),
                          device="cuda")
    step = mc.make_mesh_cuda_step(topo, cfg, dt, device="cuda")
    torch.cuda.synchronize()
    mc.launches = cc.launches = 0
    t0 = time.perf_counter()
    warm = start
    for _ in range(CONTACT_WARM_FRAMES):
        warm = step(warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    main_mesh, main_contact = mc.launches, cc.launches
    print(f"# contact main path: {CONTACT_WARM_FRAMES} frames x "
          f"{cfg.substeps} substeps in {warm_s:.3f} s wall, {main_mesh} mesh "
          f"and {main_contact} contact kernel launches")
    if not (main_mesh > 0 and main_contact > 0):
        raise RuntimeError("the contact path did not launch both libraries")

    # 12. B-4 vs plain on the card: the seeded clouds here, the 20k states
    # (warm, and in contact after the drift) with phase 14
    def b4_vs_plain(name, pred, inv, ccfg, profile=False):
        """One B-4 pass and its plain version; the library's order and
        candidates against the plain ones, no pair classified differently;
        then the serial design against it (``b4_designs``); raises when
        they disagree.  Returns (max |dx|, the order, the candidates' ok
        mask, the count of touching pairs)."""
        order = sh.morton_order(pred, ccfg)
        same_order = torch.equal(cc.curve_order_cuda(pred, ccfg).long(),
                                 order)
        *_, touch, d2ab, _, _, nb = sh._blocked_layout(pred, inv, order, ccfg)
        nbr, ok = sh.select_candidates(touch, d2ab,
                                       min(ccfg.block_neighbors, nb))
        knbr, kok = cc.candidates_cuda(pred, inv, order, ccfg)
        same_sel = torch.equal(knbr.long(), nbr) and torch.equal(kok, ok)
        out = cc.self_collision_project_blocked_cuda(pred, inv, order, ccfg)
        ref = sh.self_collision_project_blocked(pred, inv, order, ccfg)
        flips = int((cc.touching_pairs_cuda(pred, inv, order, ccfg)
                     != sh.blocked_touching_pairs(pred, inv, order,
                                                  ccfg)).sum())
        touching = int(sh.blocked_touching_pairs(pred, inv, order,
                                                 ccfg).sum())
        dx = float((out - ref).abs().max())
        moved = float((ref - pred).abs().max())
        print(f"# B-4 vs plain, {name} ({pred.shape[0]} particles, "
              f"B={ccfg.collision_block_size} M={ccfg.block_neighbors}): "
              f"max|dx|={dx:.3e} (moved {moved:.3e}), curve order equal="
              f"{same_order}, candidates equal={same_sel}, {touching} "
              f"touching pairs, {flips} classified differently")
        if not (dx < K.DX_PASS and same_order and same_sel and flips == 0):
            raise RuntimeError(f"B-4 kernel disagrees with plain on {name}")
        # the serial design it replaced, in turns, on the same state
        b4_designs(torch, cc, sh, name, pred, inv, ccfg, smi,
                   profile=profile)
        return dx, order, ok, touching

    b4_err = 0.0
    for name in K.CLOUDS:
        x, w = K.cloud(name)
        b4_err = max(b4_err, b4_vs_plain(
            name, torch.as_tensor(x, device="cuda"),
            torch.as_tensor(w, device="cuda"),
            K.cloud_config(name, "blocked_pallas"))[0])
    b4_err = max(b4_err, b4_vs_plain("warm 20k", warm.positions,
                                     warm.inv_mass, cfg)[0])

    # 13. every tet and contact case, kernel vs plain
    lam_keys = ("lambda_dist", "lambda_bend", "lambda_tet")

    def lam_report(out, ref):
        d = {}
        for k in lam_keys:
            r = getattr(ref, k)
            if r is not None and r.numel():
                d[k] = (float((getattr(out, k) - r).abs().max()),
                        float(r.abs().max()))
        return d

    def lam_ok(d):
        return all(dk <= 1e-2 * mk for dk, mk in d.values())

    for name, (tcfg, kind, kw, frames) in K.tet_cases().items():
        ttopo, tf = K.tet_inputs(kind, mods, **kw)
        st = state_from_numpy(tf, device="cuda")
        out = mc.make_mesh_cuda_step(ttopo, tcfg, dt, n_steps=frames)(st)
        ref = general.multi_step_fn(st, ttopo, tcfg, dt, frames)
        dx = float((out.positions - ref.positions).abs().max())
        d = lam_report(out, ref)
        print(f"# tet case {name}: max|dx|={dx:.3e} "
              + " ".join(f"max|d{k}|={v[0]:.3e} (max {v[1]:.3e})"
                         for k, v in d.items()))
        if not (dx < K.DX_TET and d["lambda_tet"][0] < K.DLAM_TET
                and lam_ok(d) and is_finite(out)):
            raise RuntimeError(f"mesh kernel disagrees with plain on {name}")
    ctopo, cf, _ = K.contact_scene(mods)
    for name, (kcfg, frames) in K.contact_cases().items():
        backends = ((kcfg.self_collision_backend, "blocked_pallas")
                    if kcfg.self_collision_backend == "blocked"
                    else (kcfg.self_collision_backend,))
        for backend in backends:
            kc = kcfg.replace(self_collision_backend=backend)
            st = state_from_numpy(cf, device="cuda")
            out = mc.make_mesh_cuda_step(ctopo, kc, dt, n_steps=frames)(st)
            ref = general.multi_step_fn(st, ctopo, kcfg, dt, frames)
            dx = float((out.positions - ref.positions).abs().max())
            d = lam_report(out, ref)
            print(f"# contact case {name} ({backend}): max|dx|={dx:.3e} "
                  + " ".join(f"max|d{k}|={v[0]:.3e} (max {v[1]:.3e})"
                             for k, v in d.items()))
            if not (dx < K.DX_CONTACT and lam_ok(d) and is_finite(out)):
                raise RuntimeError(f"mesh kernel disagrees with plain on "
                                   f"{name} ({backend})")

    # 14, continued: exactness, health, parity and drift
    p = warm.positions
    ymin = float(p[:, 1].min())
    ball_min, cloth_min = float(p[nc:, 1].min()), float(p[:nc, 1].min())
    rim_ok = torch.equal(p[rim], start.positions[rim])
    dropped_warm = blocked_dropped_pairs(warm, cfg)
    print(f"# contact health after {CONTACT_WARM_FRAMES} frames: finite="
          f"{is_finite(warm)} ymin={ymin:.6f} ball min y={ball_min:.6f} "
          f"cloth min y={cloth_min:.6f} rim unmoved={rim_ok} dropped pairs="
          f"{dropped_warm}")
    if not (is_finite(warm) and rim_ok and ymin > -1e-2 and ball_min > 0.05
            and cloth_min < 0.99 and dropped_warm == 0):
        raise RuntimeError("contact main path failed its health gates")
    out = mc.make_mesh_cuda_substep_runner(topo, cfg, dt_sub, 16)(warm)
    ref = general.run_substeps_plain(warm, topo, plain_cfg, dt_sub, 16)
    dx = float((out.positions - ref.positions).abs().max())
    d = lam_report(out, ref)
    print(f"# contact parity from the warm state, 16 substeps: max|dx|="
          f"{dx:.3e} " + " ".join(f"max|d{k}|={v[0]:.3e} (max {v[1]:.3e})"
                                  for k, v in d.items()))
    if not (dx < K.DX_CONTACT and lam_ok(d)):
        raise RuntimeError("contact path disagrees with plain at 20k")
    alt_cfg = plain_cfg.replace(collision_block_size=256, block_neighbors=18)
    if blocked_dropped_pairs(warm, alt_cfg) != 0:
        raise RuntimeError("the (256, 18) plain run is not exact")
    kern, plain, alt = warm, warm, warm
    for _ in range(CONTACT_DRIFT_FRAMES):
        kern = step(kern)
        plain = general.step_fn(plain, topo, plain_cfg, dt)
        alt = general.step_fn(alt, topo, alt_cfg, dt)
    drift = float((kern.positions - plain.positions).abs().max())
    spread = float((plain.positions - alt.positions).abs().max())
    gate = max(3.0 * spread, 1e-4)
    dropped_end = blocked_dropped_pairs(kern, cfg)
    print(f"# contact drift vs plain, {CONTACT_DRIFT_FRAMES} frames from "
          f"the warm state: {drift:.3e} (gate {gate:.3e} = max(3 x the "
          f"spread {spread:.3e} between plain runs at (B, M) = (128, 32) and "
          f"(256, 18), 1e-4)); dropped pairs at the end {dropped_end} "
          f"(plain (256, 18): {blocked_dropped_pairs(alt, alt_cfg)})")
    if not (drift < gate and dropped_end == 0 and is_finite(kern)):
        raise RuntimeError(f"contact path drifts from plain: {drift}")
    # the ball is in the cloth now: the pass and 16 substeps once more
    dx_end = b4_vs_plain(
        f"20k after {CONTACT_WARM_FRAMES + CONTACT_DRIFT_FRAMES} frames",
        kern.positions, kern.inv_mass, cfg)[0]
    b4_err = max(b4_err, dx_end)
    # contact passes round differently from the plain ones (the pair sums'
    # order), and the sagging cloth's near-flat hinges turn an ulp into a
    # flipped bending mask: lambda_bend is reported with its flips and held
    # to the position gate only
    out = mc.make_mesh_cuda_substep_runner(topo, cfg, dt_sub, 16)(kern)
    ref = general.run_substeps_plain(kern, topo, plain_cfg, dt_sub, 16)
    dx = float((out.positions - ref.positions).abs().max())
    d = lam_report(out, ref)
    print(f"# contact parity from the in-contact state, 16 substeps: "
          f"max|dx|={dx:.3e} " + " ".join(
              f"max|d{k}|={v[0]:.3e} (max {v[1]:.3e})" for k, v in d.items())
          + f"; bending-mask flips {mask_flips(torch, out, ref, topo, cfg)}")
    if not (dx < K.DX_CONTACT
            and lam_ok({k: v for k, v in d.items() if k != "lambda_bend"})):
        raise RuntimeError("contact path disagrees with plain in contact")
    # on into contact-rich rest on the kernel path, where the B-4 pass
    # and the throughput of phase 16 are timed
    rest = kern
    for _ in range(CONTACT_REST_FRAMES):
        rest = step(rest)
    frame = CONTACT_WARM_FRAMES + CONTACT_DRIFT_FRAMES + CONTACT_REST_FRAMES
    p = rest.positions
    dropped_rest = blocked_dropped_pairs(rest, cfg)
    print(f"# contact health at frame {frame}: finite={is_finite(rest)} "
          f"ymin={float(p[:, 1].min()):.6f} ball min y="
          f"{float(p[nc:, 1].min()):.6f} cloth min y="
          f"{float(p[:nc, 1].min()):.6f} rim unmoved="
          f"{torch.equal(p[rim], start.positions[rim])} dropped pairs="
          f"{dropped_rest}")
    if not (is_finite(rest) and torch.equal(p[rim], start.positions[rim])
            and float(p[:, 1].min()) > -1e-2 and dropped_rest == 0):
        raise RuntimeError(f"contact main path failed its health gates at "
                           f"frame {frame}")
    # B-3's two designs at the 20k states: a frame's substeps (blocked
    # contact, the persistent kernel split around each B-4 pass) to the
    # bit, the persistent kernel twice to the bit; and without contact the
    # hub warps' sums (642 edge and 1,280 tet columns) keep the plain
    # engine's bits
    for at, st in ((CONTACT_WARM_FRAMES, warm),
                   (CONTACT_WARM_FRAMES + CONTACT_DRIFT_FRAMES, kern),
                   (frame, rest)):
        runs = [mc.run_substeps_cuda(st, topo, cfg, dt_sub, cfg.substeps,
                                     design=d)
                for d in ("persistent", "per_pass", "persistent")]
        bad = (b3_bits(torch, runs[0], runs[1])
               + b3_bits(torch, runs[0], runs[2]))
        print(f"# B-3 designs at the 20k frame-{at} state, {cfg.substeps} "
              f"substeps: persistent equal to per-pass and to itself to the "
              f"bit: {not bad}")
        if bad:
            raise RuntimeError(f"B-3 designs differ at 20k frame {at}: {bad}")
    hub_cfg = cfg.replace(enable_self_collision=False)
    hub_out = mc.run_substeps_cuda(rest, topo, hub_cfg, dt_sub, 3)
    hub_ref = general.run_substeps_plain(rest, topo, hub_cfg, dt_sub, 3)
    hub_bad = [k for k in ("positions", "velocities", "lambda_dist",
                           "lambda_bend", "lambda_tet")
               if not torch.equal(getattr(hub_out, k), getattr(hub_ref, k))]
    print(f"# B-3 hub rows at 20k (no contact, 3 substeps): the kernel's "
          f"warp sums equal the plain engine's column-order sums to the bit: "
          f"{not hub_bad}")
    if hub_bad:
        raise RuntimeError(f"B-3's hub warps part from the twin: {hub_bad}")
    dx_rest, order, ok, touching = b4_vs_plain(
        f"20k at frame {frame}", rest.positions, rest.inv_mass, cfg,
        profile=True)
    b4_err = max(b4_err, dx_rest)
    # the pass's time there: the standalone call (the passes the mesh loop
    # runs, stats; layout and AABBs; selection and pairs, and the
    # unsort-apply), as the plain pass is timed, and the mesh loop's pass
    pred, inv = rest.positions, rest.inv_mass
    rec90 = B4_DESIGNS[-1]
    ms_b4 = rec90["call_ms"]
    reps = 50
    ms_b4_plain = cuda_ms(torch, lambda: sh.self_collision_project_blocked(
        pred, inv, order, cfg), reps)
    pairs = int(ok.sum()) * cfg.collision_block_size ** 2
    kept = rec90["pair_tests_after_cull"]
    b4_bound = (rec90["bound_ms"], rec90["bound_by"])
    print(f"# B-4 pass at frame {frame} ({smi}): kernel {ms_b4:.4f} ms "
          f"(the standalone culled call with its apply, best window; the "
          f"mesh loop's pass alone {rec90['loop_pass_ms']:.4f}), plain "
          f"{ms_b4_plain:.4f} ms "
          f"per pass over {reps} passes; {pairs} "
          f"candidate pair tests, {kept} kept by the warp cull, "
          f"{touching} touching; bound "
          f"{b4_bound[0]:.5f} ms ({b4_bound[1]}: {PAIR_OPS} operations per "
          f"kept pair test, {TOUCH_OPS} more per touching pair; over every "
          f"candidate test {rec90['bound_ms_all_candidates']:.5f} ms)")
    # launches a B-4 pass in the mesh loop: one contact substep (its curve
    # order, 3 launches, and its passes) in each design
    loop = {}
    for design in ("serial", "culled"):
        before = cc.launches
        mc.run_substeps_cuda(rest, topo, cfg, dt_sub,
                             cfg.self_collision_every, contact_design=design)
        loop[design] = cc.launches - before
    n_pass = (loop["serial"] - loop["culled"]) // 2
    per_pass = (loop["culled"] - 3) / n_pass
    print(f"# B-4 in the mesh loop, one contact substep: {n_pass} passes; "
          f"serial {loop['serial']} launches "
          f"({(loop['serial'] - 3) / n_pass:.0f} a pass), culled "
          f"{loop['culled']} ({per_pass:.0f} a pass)")
    if not (n_pass > 0 and per_pass <= 3):
        raise RuntimeError(f"the mesh loop launches {per_pass} kernels a "
                           f"B-4 pass")
    # what the plain engine's column-order hub sums (ops/incidence
    # .gather_sum, the hub rows on the device, one scan each) cost it per
    # substep at this scene
    from softbodysimulation_tpu_torch.ops.incidence import (Incidence,
                                                            gather_sum)

    hub_ms = 0.0
    for table, width in ((topo.tet_incidence, 4 * topo.n_tets),
                         (topo.incidence, 2 * topo.n_edges)):
        inc = Incidence.of(table.to("cuda"), width)
        bare = dataclasses.replace(inc, hub_rows=inc.hub_rows[:0],
                                   hub=inc.hub[:0])
        contrib = torch.randn((width, 3), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
        hub_ms += (cuda_ms(torch, lambda: gather_sum(contrib, inc), 20)
                   - cuda_ms(torch, lambda: gather_sum(contrib, bare), 20))
    print(f"# plain engine's hub rows (summed on the device in column "
          f"order, one scan each): {hub_ms * cfg.iterations:.4f} ms "
          f"per substep "
          f"({cfg.iterations} iterations x {hub_ms:.4f} ms for the tet and "
          f"edge hubs)")

    # 15. the catalogued ball_on_cloth: resting on the cloth, and falling
    # through without contact
    bstate, bstep, binfo = scenes.ball_on_cloth(device="cuda")
    bnc = binfo["n_cloth"]
    off_cfg = binfo["config"].replace(enable_self_collision=False)
    bstep_off = mc.make_mesh_cuda_step(binfo["topology"], off_cfg, dt)
    on, off = bstate, bstate
    torch.cuda.synchronize()
    mc.launches = 0
    for _ in range(CATALOG_FRAMES):
        on = bstep(on)
    torch.cuda.synchronize()
    cat_launches = mc.launches
    for _ in range(CATALOG_FRAMES):
        off = bstep_off(off)
    po, pf = on.positions, off.positions
    ball_on = float(po[bnc:, 1].min())
    cloth_on = float(po[:bnc, 1].min())
    rim_on = float(po[:bnc, 1].max())
    ball_off = float(pf[bnc:, 1].min())
    print(f"# catalogued ball_on_cloth ({binfo['topology'].n_particles} "
          f"particles, dense contact) after {CATALOG_FRAMES} frames: ball "
          f"min y={ball_on:.4f} cloth min y={cloth_on:.4f} rim y={rim_on:.6f}"
          f" ({cat_launches} launches); without contact ball min y="
          f"{ball_off:.4f}")
    if not (is_finite(on) and ball_on > 0.55 and cloth_on < 0.99
            and abs(rim_on - 1.0) < 1e-4 and ball_off < 0.25
            and cat_launches > 0):
        raise RuntimeError("catalogued ball_on_cloth failed its physics")
    # the dense pass split across warps: one substep of one iteration (one
    # pass) from the resting state against the plain pass; a pair
    # classified differently would move its particles by their overlap
    one_cfg = binfo["config"].replace(iterations=1)
    one_dt = dt / one_cfg.substeps
    dense_dx = float((mc.run_substeps_cuda(on, binfo["topology"], one_cfg,
                                           one_dt, 1).positions
                      - general.run_substeps_plain(
                          on, binfo["topology"], one_cfg, one_dt,
                          1).positions).abs().max())
    print(f"# B-3 dense pass (a warp a row) vs plain, one pass from the "
          f"resting catalogued state: max|dx|={dense_dx:.3e} (gate 1e-5)")
    if not dense_dx < 1e-5:
        raise RuntimeError(f"B-3's dense pass parts from plain: {dense_dx}")

    # 16. throughput, kernel path and plain engine, in turns
    cat_topo, cat_cfg = binfo["topology"], binfo["config"]
    cat_sub = dt / cat_cfg.substeps
    rows = (("scaled ball_on_cloth", topo, cfg, plain_cfg, dt_sub, rest, 60,
             6),
            ("catalogued ball_on_cloth", cat_topo, cat_cfg, cat_cfg, cat_sub,
             on, 600, 12))
    profile = []
    for name, tp, kc, pc, ds, st, n_k, n_p in rows:
        krun = mc.make_mesh_cuda_substep_runner(tp, kc, ds, n_k)
        before = (mc.launches, cc.launches)
        krun(st)
        torch.cuda.synchronize()
        per_sub = ((mc.launches - before[0]) / n_k,
                   (cc.launches - before[1]) / n_k)
        times, reps = timed_windows(torch, {
            "plain": (lambda: general.run_substeps_plain(st, tp, pc, ds, n_p),
                      n_p),
            "kernel": (lambda: krun(st), n_k)})
        nn = tp.n_particles
        ms_k, ms_p = min(times["kernel"]), min(times["plain"])
        print(f"# throughput {name} ({smi}), best of two windows: kernel "
              f"{ms_k:.5f} ms/substep = {nn / ms_k * 1e3:.4e} "
              f"particle-substeps/s over {reps['kernel'] * n_k} substeps; "
              f"plain {ms_p:.5f} ms/substep = {nn / ms_p * 1e3:.4e} "
              f"particle-substeps/s over {reps['plain'] * n_p} substeps; "
              f"{per_sub[0]:.2f} mesh + {per_sub[1]:.2f} contact launches "
              f"per substep")
        for key in ("kernel", "plain"):
            lo, hi = min(times[key]), max(times[key])
            print(f"# throughput range {key}: {lo:.5f}-{hi:.5f} ms/substep "
                  f"(windows in turn order: {times[key]})")
        bnd = bound_ms(*mesh_work(tp, kc))
        print(f"# bound of one {name} substep without its contact passes: "
              f"{bnd[0]:.5f} ms ({bnd[1]})")
        if kc.self_collision_backend == "blocked_pallas":
            # the substep with B-4's serial design in its contact passes
            def srun(st=st, tp=tp, kc=kc, ds=ds, n_k=n_k):
                return mc.run_substeps_cuda(st, tp, kc, ds, n_k,
                                            contact_design="serial")

            before = cc.launches
            srun()
            torch.cuda.synchronize()
            s_per_sub = (cc.launches - before) / n_k
            dtimes, _ = timed_windows(torch, {"serial": (srun, n_k),
                                              "culled": (lambda: krun(st),
                                                         n_k)})
            substep = dict(ms=min(dtimes["culled"]),
                           serial_ms=min(dtimes["serial"]),
                           windows=dtimes["culled"],
                           serial_windows=dtimes["serial"],
                           contact_launches=per_sub[1],
                           serial_contact_launches=s_per_sub)
            print(f"# {name} substep with B-4's designs in turns ({smi}): "
                  f"serial {substep['serial_ms']:.5f} ms/substep "
                  f"({s_per_sub:.2f} contact launches a substep; windows "
                  f"{dtimes['serial']}), culled {substep['ms']:.5f} "
                  f"({per_sub[1]:.2f}; windows {dtimes['culled']}): "
                  f"{substep['serial_ms'] / substep['ms']:.2f}x")
        b3_designs(torch, mc, cc, f"{name}, {nn} particles", st, tp, kc, ds,
                   n_k, smi)
        profile.append((mc.make_mesh_cuda_substep_runner(tp, kc, ds, 6), st))
    # the 20k particle passes by the rows they sum (the per-pass loop, where
    # each is a launch of its own): the hub's rows against the others
    particle_us = {}

    def show_passes():
        try:
            passes = particle_passes(
                torch, "20k ball-on-cloth at frame 90, 6 substeps",
                lambda s: mc.run_substeps_cuda(s, topo, cfg, dt_sub, 6,
                                               design="per_pass"), rest, smi)
        except RuntimeError as err:   # a timing, not a gate
            print(f"# particle passes at 20k not profiled: {err}")
            passes = {}
        particle_us.update({k.split(", ")[1]: v[1] / v[0]
                            for k, v in passes.items()
                            if k.startswith("particle_kernel")})

    LATE_PROFILES.append(show_passes)
    if "--profile" not in sys.argv[1:]:
        LATE_PROFILES.pop()()
    return dict(launches=main_contact, max_abs_err=b4_err, ms=ms_b4,
                plain_ms=ms_b4_plain, bound=b4_bound, profile=profile,
                rec90=rec90, substep=substep, loop_launches=loop,
                particle_us=particle_us)


# the spatial path (phases 21-25): the res-128 braced lattice in 4 slabs of
# 32 planes on one card, bench.py's configuration with fast_math off (no
# spatial engine reads it)
SPATIAL_RES = 128
SPATIAL_SLABS = 4
# bench.py's body pancakes at res 128 on B-1 as on B-6 (1 kg-per-1000
# particles, 1 Jacobi iteration: height 0.22 after 2000 substeps), so its
# height gate and the drift gate against B-1 are held at the largest res
# that passes them on B-1 and B-6 alike (res 68, 314,432 particles; B-1
# keeps height > 0.5 up to res 84, but from res 72 the sagging body parts
# B-6 from B-1 by more than 1e-3: scripts/torch_spatial_cut.py)
SPATIAL_CUT_RES = 68
# past the cut: where B-6 in one slab is held to the bit against four slabs
# and its drift from B-1 printed
SPATIAL_WITNESS_RES = (72, 84)
SPATIAL_SUBSTEPS = 2000
SOLID_FRAMES = 250                 # 2000 substeps of solid_lattice
SOLID_DRIFT_SUBSTEPS = 480
TET_DX, TET_DLAM = 2e-5, 1e-5
# solid_lattice's volume gate: the JAX package's own (its solid soak,
# scripts/soak_solid_streamed.py:69).  At this configuration (1 Jacobi
# iteration, 8 substeps) its stencil engine rests at 0.97706 of the rest
# volume (scripts/soak_solid_streamed.out.json), so a 1 % gate fails any
# faithful engine; the kernel is also held to the plain engine's volume
SOLID_VOL_TOL = 0.05
SOLID_VOL_MATCH = 1e-4
RACE_RUNS = 5


def tet_compare(torch, name, out, ref, start, n_sub, is_finite):
    """A lattice result with tets against the plain engine's: positions
    TET_DX, tet multipliers TET_DLAM, distance multipliers DLAM_TOL, each
    within LAM_REL of its largest.  Raises when it disagrees; returns max
    |dx|."""
    torch.cuda.synchronize()
    dx = float((out.positions - ref.positions).abs().max())
    d = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
         for k in ("lambda_dist", "lambda_tet")}
    lam = {k: float(getattr(ref, k).abs().max()) for k in d}
    moved = float((out.positions - start.positions).abs().max())
    print(f"# tet parity {name}: max|dx|={dx:.3e} max|dlam|="
          f"{d['lambda_dist']:.3e} (max|lam|={lam['lambda_dist']:.3e}) "
          f"max|dlam_tet|={d['lambda_tet']:.3e} (max|lam_tet|="
          f"{lam['lambda_tet']:.3e}) bit for bit="
          f"{torch.equal(out.positions, ref.positions)} (moved "
          f"{moved:.3e}) over {n_sub} substeps")
    if not (dx < TET_DX and d["lambda_dist"] < DLAM_TOL
            and d["lambda_tet"] < TET_DLAM and is_finite(out)
            and all(d[k] <= LAM_REL * lam[k] for k in d)):
        raise RuntimeError(f"lattice kernel tets disagree with plain on "
                           f"{name}: dx={dx} {d} {lam}")
    return dx


def spatial_phases(torch, np, spatial_build, lattice_build, smi,
                   is_finite, state_from_numpy, lattice_ms):
    """Phases 21-25, the spatial (x-slab sharded) lattice and the solid
    lattice (``lattice_ms``: phase 6's B-1 ms per substep at res 40).
    Returns the slab kernel's JSON numbers, the tet sweep's and the runs to
    profile."""
    import test_torch_spatial_cases as SC
    from softbodysimulation_tpu_torch.core import config as C
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.kernels import spatial_cuda as sc
    from softbodysimulation_tpu_torch.ops import tet_volume
    from softbodysimulation_tpu_torch.parallel import spatial as psp
    from softbodysimulation_tpu_torch.solvers import lattice as lat
    from softbodysimulation_tpu_torch.topology import lattice as top
    from softbodysimulation_tpu_torch.topology import tets as T

    t_phases = time.perf_counter()
    cuda = torch.device("cuda", torch.cuda.current_device())

    def jittered(st, seed=0):
        """``st`` with velocity jitter ~ N(0, 0.05) from a seed, so the body
        moves and its constraints load."""
        jit = np.random.default_rng(seed).normal(0.0, 0.05,
                                                 tuple(st.velocities.shape))
        return st.replace(velocities=st.velocities + torch.as_tensor(
            jit, dtype=torch.float32, device=st.device))

    # 21. the slab kernel's build (started with the others in phase 2), and
    # the lattice library's tet sweep
    print_build(spatial_build)
    print_build(lattice_build, kernels=("tet_cell_kernel",
                                        "tet_apply_kernel"))

    # 22. parity on the card: B-1's tets vs the plain engine; B-6 vs the
    # sharded torch engine (up to four slabs on one card); the race check
    b6_err, tet_err, bits = 0.0, 0.0, []
    for name, (cfg, inputs, d, res, frames) in SC.spatial_cases().items():
        spec = top.lattice_spec(res, braced=True)
        st = state_from_numpy(SC.case_inputs(res, **inputs), device=cuda)
        n_sub = frames * cfg.substeps
        if cfg.enable_tet_volume:
            tet_err = max(tet_err, tet_compare(
                torch, f"B-1 {name} res {res}",
                lc.make_cuda_step(spec, cfg, SC.DT, n_steps=frames)(st),
                lat.multi_step_fn(st, spec, cfg, SC.DT, frames), st, n_sub,
                is_finite))
        if SC.kernel_carries(cfg, d, res):
            devs = [cuda] * d
            out = sc.make_spatial_cuda_substep(spec, cfg, SC.DT, devs,
                                               n_steps=frames)(st)
            ref = psp.make_spatial_lattice_step(spec, cfg, SC.DT, devs,
                                                n_steps=frames,
                                                backend="xla")(st)
            b6_err = max(b6_err, compare(
                torch, f"B-6 {name} res {res} over {d} slabs", out, ref,
                st, SC.DT / cfg.substeps, n_sub, is_finite))
            bits.append(torch.equal(out.positions, ref.positions)
                        and torch.equal(out.lambda_dist, ref.lambda_dist)
                        and torch.equal(out.velocities, ref.velocities))
    print(f"# B-6 vs the sharded torch engine: bit for bit in "
          f"{sum(bits)} of {len(bits)} cases")
    cfg, inputs, d, res, frames = SC.spatial_cases()["colored_reset"]
    spec = top.lattice_spec(res, braced=True)
    st = state_from_numpy(SC.case_inputs(res, **inputs), device=cuda)
    race = sc.make_spatial_cuda_substep(spec, cfg, SC.DT, [cuda] * d,
                                        n_steps=frames)
    first = race(st)
    same = [torch.equal(race(st).positions, first.positions)
            for _ in range(RACE_RUNS - 1)]
    print(f"# race check: {d} slabs on {d} streams, {RACE_RUNS} runs of "
          f"colored_reset: equal to the bit in {sum(same)} of "
          f"{len(same)} reruns")
    if not all(same):
        raise RuntimeError("the slab kernel's result changes between runs")

    # 23. solid_lattice at full size through make_cuda_step
    t0 = time.perf_counter()
    solid, solid_step, info = scenes.solid_lattice(device=cuda)
    tspec, tcfg = info["spec"], info["config"]
    tdt_sub = info["dt"] / tcfg.substeps
    tets = torch.as_tensor(T.cube_lattice_tets(tspec.res), device=cuda)
    vol0 = float(tet_volume.tet_volumes6(solid.positions, tets).sum())
    torch.cuda.synchronize()
    lc.launches = 0
    out = solid
    for _ in range(SOLID_FRAMES):
        out = solid_step(out)
    torch.cuda.synchronize()
    solid_s = time.perf_counter() - t0
    solid_launches = lc.launches
    p = out.positions
    vol = float(tet_volume.tet_volumes6(p, tets).sum())
    ymin = float(p[:, 1].min())
    height = float(p[:, 1].max() - p[:, 1].min())
    print(f"# solid_lattice: res {tspec.res} ({tspec.n_particles} "
          f"particles, {tets.shape[0]} tets), {SOLID_FRAMES} frames x "
          f"{tcfg.substeps} substeps through make_cuda_step in "
          f"{solid_s:.3f} s wall, {solid_launches} launches "
          f"({solid_launches / (SOLID_FRAMES * tcfg.substeps):.2f} a "
          f"substep); finite={is_finite(out)} ymin={ymin:.6f} "
          f"height={height:.6f} volume/rest={vol / vol0:.6f}")
    if not (is_finite(out) and ymin > -1e-2 and height > 0.5
            and abs(vol / vol0 - 1.0) < SOLID_VOL_TOL and solid_launches > 0):
        raise RuntimeError("solid_lattice failed its health gates")
    k_drift = lc.make_cuda_substep_runner(tspec, tcfg, tdt_sub,
                                          SOLID_DRIFT_SUBSTEPS,
                                          with_ext=True)(solid)
    p_drift = lat.run_substeps_plain(solid, tspec, tcfg, tdt_sub,
                                     SOLID_DRIFT_SUBSTEPS, with_ext=True)
    drift = float((k_drift.positions - p_drift.positions).abs().max())
    k_vol, p_vol = (float(tet_volume.tet_volumes6(r.positions, tets).sum())
                    / vol0 for r in (k_drift, p_drift))
    print(f"# solid_lattice drift vs plain, {SOLID_DRIFT_SUBSTEPS} substeps "
          f"from the same start: {drift:.3e} (gate {DRIFT_TOL}); "
          f"volume/rest kernel {k_vol:.6f}, plain {p_vol:.6f} (gate "
          f"{SOLID_VOL_MATCH} apart)")
    if not (drift < DRIFT_TOL and abs(k_vol - p_vol) < SOLID_VOL_MATCH):
        raise RuntimeError(f"solid lattice drifts from plain: {drift}, "
                           f"volume {k_vol} vs {p_vol}")
    start = jittered(out)
    tet_err = max(tet_err, tet_compare(
        torch, f"solid_lattice res {tspec.res} from rest",
        lc.make_cuda_substep_runner(tspec, tcfg, tdt_sub, 16)(start),
        lat.run_substeps_plain(start, tspec, tcfg, tdt_sub, 16), start, 16,
        is_finite))

    # 24. the spatial path at full width: bench.py's config, the res-128
    # body in 4 slabs of 32 planes on one card, through the kernel route
    scfg = C.SolverConfig(substeps=8, iterations=1, damping=0.02,
                          solve_mode=C.SolveMode.JACOBI,
                          lambda_mode=C.LambdaMode.RESET,
                          gravity_is_acceleration=True, ground_height=0.0,
                          friction=0.3)
    sspec = top.lattice_spec(SPATIAL_RES, braced=True)
    sdt_sub = 1 / 60 / scfg.substeps
    sstate = lat.make_lattice_state(sspec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device=cuda)
    devs = [cuda] * SPATIAL_SLABS
    sharded = psp.shard_lattice_state(sstate, sspec, devs)
    frames = SPATIAL_SUBSTEPS // scfg.substeps
    b6_step = psp.make_spatial_lattice_step(sspec, scfg, 1 / 60, devs,
                                            n_steps=frames)
    torch.cuda.synchronize()
    sc.launches = sc.copies = sc.bytes_exchanged = 0
    t0 = time.perf_counter()
    b6_out = b6_step(sharded)
    torch.cuda.synchronize()
    b6_s = time.perf_counter() - t0
    main_b6 = (sc.launches, sc.copies, sc.bytes_exchanged)
    res_out = psp.gather_lattice_state(b6_out)
    print(f"# spatial main path: res {SPATIAL_RES} ({sspec.n_particles} "
          f"particles) in {SPATIAL_SLABS} slabs of "
          f"{SPATIAL_RES // SPATIAL_SLABS} planes on one card, "
          f"{SPATIAL_SUBSTEPS} substeps in {b6_s:.3f} s wall: "
          f"{main_b6[0]} launches, {main_b6[1]} exchange copies, "
          f"{main_b6[2]} bytes exchanged "
          f"({main_b6[0] / SPATIAL_SUBSTEPS:.2f} launches, "
          f"{main_b6[1] / SPATIAL_SUBSTEPS:.2f} copies and "
          f"{main_b6[2] / SPATIAL_SUBSTEPS:.0f} bytes a substep)")
    if not main_b6[0] > 0:
        raise RuntimeError("the spatial main path launched no kernel")

    def b6_vs_b1(res, state, out):
        """bench.py's health of a B-6 result and its drift from B-1 on one
        device from the same start: (finite, ymin, height, B-1's height,
        drift)."""
        spec = top.lattice_spec(res, braced=True)
        b1 = lc.make_cuda_substep_runner(spec, scfg, sdt_sub,
                                         SPATIAL_SUBSTEPS)(state).positions
        p = out.positions
        return (is_finite(out), float(p[:, 1].min()),
                float(p[:, 1].max() - p[:, 1].min()),
                float(b1[:, 1].max() - b1[:, 1].min()),
                float((p - b1).abs().max()))

    ok, ymin, height, b1_height, drift = b6_vs_b1(SPATIAL_RES, sstate,
                                                  res_out)
    print(f"# health at res {SPATIAL_RES}: finite={ok} ymin={ymin:.6f} "
          f"height={height:.6f}, B-1 from the same start: height "
          f"{b1_height:.6f}, drift {drift:.3e} (the body pancakes on both, "
          f"so bench.py's height gate and the drift gate are held at res "
          f"{SPATIAL_CUT_RES} below)")
    if not (ok and ymin > -1e-2):
        raise RuntimeError("the spatial main path failed its health gates")

    def slab_count_witness(res, state, four):
        """Whether B-6 in one slab over the same SPATIAL_SUBSTEPS substeps
        equals ``four`` (the four-slab result) to the bit."""
        spec = top.lattice_spec(res, braced=True)
        one = psp.make_spatial_lattice_step(spec, scfg, 1 / 60, [cuda],
                                            n_steps=frames)(state)
        return all(torch.equal(getattr(one, k), getattr(four, k))
                   for k in ("positions", "velocities", "lambda_dist"))

    # the slab count changes no bit, so one slab against four at full size
    # is also a race check where launches overlap on the four streams
    same = slab_count_witness(SPATIAL_RES, sstate, res_out)
    print(f"# B-6 in 1 slab vs {SPATIAL_SLABS} slabs at res {SPATIAL_RES}, "
          f"{SPATIAL_SUBSTEPS} substeps: bit for bit={same}")
    if not same:
        raise RuntimeError("the slab count changes the slab kernel's result")
    # where the body sags past the cut, B-6 parts from B-1 by its arithmetic
    # (dp = dl * (d / len)), not by its slabs: one slab equals four there
    for wres in SPATIAL_WITNESS_RES:
        wspec = top.lattice_spec(wres, braced=True)
        wstate = lat.make_lattice_state(wspec, center=(0.0, 0.6, 0.0),
                                        mass=0.001, device=cuda)
        four = psp.make_spatial_lattice_step(wspec, scfg, 1 / 60, devs,
                                             n_steps=frames)(wstate)
        same = slab_count_witness(wres, wstate, four)
        ok, ymin, height, b1_height, drift = b6_vs_b1(wres, wstate, four)
        print(f"# witness at res {wres}: B-6 in 1 slab vs {SPATIAL_SLABS} "
              f"slabs bit for bit={same}; {SPATIAL_SUBSTEPS} substeps: "
              f"height {height:.6f} (B-1 {b1_height:.6f}), drift vs B-1 "
              f"{drift:.3e}")
        if not (same and ok):
            raise RuntimeError(f"the slab count changes the slab kernel's "
                               f"result at res {wres}")
    cspec = top.lattice_spec(SPATIAL_CUT_RES, braced=True)
    cstate = lat.make_lattice_state(cspec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device=cuda)
    cut_out = psp.make_spatial_lattice_step(cspec, scfg, 1 / 60, devs,
                                            n_steps=frames)(cstate)
    ok, ymin, height, b1_height, drift = b6_vs_b1(SPATIAL_CUT_RES, cstate,
                                                  cut_out)
    print(f"# health at res {SPATIAL_CUT_RES} ({cspec.n_particles} "
          f"particles, {SPATIAL_SLABS} slabs of "
          f"{SPATIAL_CUT_RES // SPATIAL_SLABS} planes), {SPATIAL_SUBSTEPS} "
          f"substeps through B-6: finite={ok} ymin={ymin:.6f} "
          f"height={height:.6f} (B-1: {b1_height:.6f}); drift vs B-1 from "
          f"the same start: {drift:.3e} (gate {DRIFT_TOL})")
    if not (ok and ymin > -1e-2 and height > 0.5):
        raise RuntimeError(f"the spatial path failed its health gates at "
                           f"res {SPATIAL_CUT_RES}")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"the slab kernel drifts from B-1: {drift}")
    start = psp.shard_lattice_state(jittered(res_out), sspec, devs)
    b6_16 = psp.make_spatial_lattice_step(sspec, scfg, 1 / 60, devs,
                                          n_steps=2)
    plain_16 = psp.make_spatial_lattice_step(sspec, scfg, 1 / 60, devs,
                                             n_steps=2, backend="xla")
    out16 = psp.gather_lattice_state(b6_16(start))
    ref16 = psp.gather_lattice_state(plain_16(start))
    b6_err = max(b6_err, compare(
        torch, f"B-6 res {SPATIAL_RES} over {SPATIAL_SLABS} slabs after "
        f"{SPATIAL_SUBSTEPS} substeps", out16, ref16,
        psp.gather_lattice_state(start), sdt_sub,
        16, is_finite))
    print(f"# bit for bit at res {SPATIAL_RES}: "
          f"{torch.equal(out16.positions, ref16.positions)}")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        k = 4 if n_cards >= 4 else 2
        multi = [torch.device("cuda", i) for i in range(k)]
        one_card = psp.make_spatial_lattice_step(
            sspec, scfg, 1 / 60, devs, n_steps=8)(sstate)
        many = psp.make_spatial_lattice_step(
            sspec, scfg, 1 / 60, multi, n_steps=8)(sstate)
        same = torch.equal(many.positions, one_card.positions)
        print(f"# one slab per card on {k} cards vs {SPATIAL_SLABS} slabs "
              f"on one card, 64 substeps: bit for bit={same}")
        if not same:
            raise RuntimeError("slabs on several cards differ from one")
    else:
        print("# one slab per card: not run (one card visible)")

    # 25. throughput (CUDA events, windows of at least a second, in turns)
    n_b6 = 200
    b6_run = psp.make_spatial_lattice_step(sspec, scfg, 1 / 60, devs,
                                           n_steps=n_b6 // scfg.substeps)
    b1_run = lc.make_cuda_substep_runner(sspec, scfg, sdt_sub, n_b6)
    xla_run = psp.make_spatial_lattice_step(sspec, scfg, 1 / 60, devs,
                                            backend="xla")
    rested = b6_out
    times, reps = timed_windows(torch, {
        "B-6": (lambda: b6_run(rested), n_b6),
        "B-1": (lambda: b1_run(res_out), n_b6),
        "sharded torch": (lambda: xla_run(rested), scfg.substeps)})
    spec40 = top.lattice_spec(40, braced=True)
    st40 = lat.make_lattice_state(spec40, center=(0.0, 0.6, 0.0),
                                  mass=0.001, device=cuda)
    sh40 = psp.shard_lattice_state(st40, spec40, devs)
    b6_40 = psp.make_spatial_lattice_step(spec40, scfg, 1 / 60, devs,
                                          n_steps=n_b6 // scfg.substeps)
    b1_40 = lc.make_cuda_substep_runner(spec40, scfg, sdt_sub, n_b6)
    t40, r40 = timed_windows(torch, {
        "B-6 res 40": (lambda: b6_40(sh40), n_b6),
        "B-1 res 40": (lambda: b1_40(st40), n_b6)})
    n_solid = 80
    k_solid = lc.make_cuda_substep_runner(tspec, tcfg, tdt_sub, n_solid)
    tsol, rsol = timed_windows(torch, {
        "solid B-1": (lambda: k_solid(out), n_solid),
        "solid plain": (lambda: lat.run_substeps_plain(
            out, tspec, tcfg, tdt_sub, tcfg.substeps), tcfg.substeps)})
    b1_designs(torch, lc, f"res {SPATIAL_RES} (bench config, fast_math "
               f"off)", res_out, sspec, scfg, sdt_sub, n_b6, smi)
    b1_designs(torch, lc, "solid_lattice res 40", out, tspec, tcfg, tdt_sub,
               n_solid, smi)
    for group, rp, n in ((times, reps, sspec.n_particles),
                         (t40, r40, spec40.n_particles),
                         (tsol, rsol, tspec.n_particles)):
        for key, ts in group.items():
            print(f"# throughput {key} ({smi}): best {min(ts):.5f} "
                  f"ms/substep = {n / min(ts) * 1e3:.4e} "
                  f"particle-substeps/s; windows in turn order {ts}; "
                  f"{rp[key]} calls a window")
    # the plane copies are part of the function only when they cross
    # devices; with every slab on one card they are the design's own
    per_sub = main_b6[2] / SPATIAL_SUBSTEPS
    crossing = per_sub if len(set(devs)) > 1 else 0.0
    nbytes, ops = lattice_work(sspec, scfg)
    bound = bound_ms(nbytes + crossing, ops)
    print(f"# B-6 bound at res {SPATIAL_RES}: {bound[0]:.5f} ms a substep "
          f"({bound[1]}; lattice_work at the slab shapes plus {crossing:.0f} "
          f"bytes of planes crossing devices; {per_sub:.0f} bytes a substep "
          f"copied between slabs on {len(set(devs))} device(s))")
    print(f"# slabbing costs {min(times['B-6']) / min(times['B-1']):.3f}x "
          f"B-1 at res {SPATIAL_RES} and "
          f"{min(t40['B-6 res 40']) / min(t40['B-1 res 40']):.3f}x at res "
          f"40; solid_lattice through B-1 costs "
          f"{min(tsol['solid B-1']) / lattice_ms:.3f}x the plain lattice's "
          f"B-1 at res 40 (phase 6)")
    print(f"# time: phases 21-25 took "
          f"{time.perf_counter() - t_phases:.1f} s")
    profile = [(psp.make_spatial_lattice_step(sspec, scfg, 1 / 60, devs,
                                              n_steps=2), rested),
               (lc.make_cuda_substep_runner(tspec, tcfg, tdt_sub, 16), out)]
    return dict(launches=main_b6[0], max_abs_err=b6_err,
                ms=min(times["B-6"]), plain_ms=min(times["sharded torch"]),
                bound=bound, exchange_bytes=per_sub, tet_err=tet_err,
                tet_launches=solid_launches,
                profile=profile)


SWEEP_RES = 40
SWEEP_FRAMES = 240
CLOTH_SWEEP_FRAMES = 240
KIN_GRAD_SUBSTEPS = 40
# the box sweeps, and the depth at which the two kinematic sweeps are held
# against the plain engine (their kernels run SWEEP_FRAMES and
# CLOTH_SWEEP_FRAMES); 60 frames keep the whole smoke near 400 s
BOX_FRAMES = 60


def paired_frames(kstep, pstep, state, animate, frames):
    """The states after ``frames`` frames of a kernel step and of the plain
    engine's, frame i's poses set by ``animate(i, state)``."""
    k = p = state
    for i in range(frames):
        k = kstep(animate(i, k))
        p = pstep(animate(i, p))
    return k, p


def inside_box(torch, p, box, margin=1e-4):
    """How many of the positions ``p`` lie inside ``box`` (cx, cy, cz, hx,
    hy, hz), ``margin`` in from its faces."""
    c = torch.tensor(box[:3], device=p.device)
    h = torch.tensor(box[3:], device=p.device)
    return int(((p - c).abs() < h - margin).all(dim=1).sum())


def box_sweeps(torch, what, kernel, plain, scene, is_finite, gate):
    """A config box and a kinematic box with a velocity at a main path's
    width, each ``BOX_FRAMES`` frames through a kernel step and the plain
    engine's.  ``kernel(cfg, kin)`` and ``plain(cfg)`` make the steps;
    ``scene`` = (cfg, state without colliders, the config box, the
    ColliderSet state, its animation, the sweep's state at BOX_FRAMES
    without the box).  Gates: finite, on the floor, max |dx| < ``gate``,
    the config box emptied and the kinematic box moving the body off the
    sweep without it.  Returns {label: max |dx|}."""
    cfg, bare, cbox, kstate, animate, sweep_only = scene
    bcfg = cfg.replace(box_colliders=(cbox,))
    before = inside_box(torch, bare.positions, cbox)
    runs = {"config box": (kernel(bcfg, None), plain(bcfg), bare,
                           lambda i, s_: s_),
            "kinematic box": (kernel(cfg, (1, 1)), plain(cfg), kstate,
                              animate)}
    errs = {}
    for label, (kstep, pstep, s0, anim) in runs.items():
        k, p = paired_frames(kstep, pstep, s0, anim, BOX_FRAMES)
        dx = float((k.positions - p.positions).abs().max())
        ymin = float(k.positions[:, 1].min())
        if label == "config box":
            after = inside_box(torch, k.positions, cbox)
            acted = before > 0 and after == 0
            note = f"particles inside the box {before} -> {after}"
        else:
            moved = float((k.positions - sweep_only.positions).abs().max())
            acted = moved > 1e-2
            note = f"moved {moved:.4f} off the sweep without the box"
        print(f"# {what} with a {label}, {BOX_FRAMES} frames, kernel vs "
              f"plain: max|dx| {dx:.3e} (gate {gate}); finite="
              f"{is_finite(k)} ymin={ymin:.6f}; {note}")
        if not (is_finite(k) and ymin > -1e-2 and dx < gate and acted):
            raise RuntimeError(f"{what} with a {label} failed its gates")
        errs[label] = dx
    return errs


def collider_phases(torch, np, smi, is_finite):
    """Phases 26-28, the kinematic rigid world (config boxes, ColliderSet
    poses and pose cotangents) in B-1, B-3 and B-5.  Returns the numbers
    each kernel's JSON entry gains."""
    import test_torch_collider_cases as K
    from softbodysimulation_tpu_torch import make_colliders
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.core.colliders import ColliderSet
    from softbodysimulation_tpu_torch.examples import \
        config11_collider_control
    from softbodysimulation_tpu_torch.kernels import diff as kd
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.kernels import mesh_diff as md
    from softbodysimulation_tpu_torch.solvers import general
    from softbodysimulation_tpu_torch.solvers import lattice as lat

    out = {}

    # 26. B-1 with the rigid world
    t0 = time.perf_counter()
    # the largest |dx| of the cases with a ColliderSet, and of those with
    # boxes (the config's or kinematic)
    errs = {"kin": 0.0, "box": 0.0}
    for name, (cfg, kin, _, n_sub) in K.lattice_collider_cases().items():
        runs = K.lattice_runs(name, "cuda", lambda sp, c, dt, n, k:
                              lc.make_cuda_substep_runner(
                                  sp, c, dt, n, kin_colliders=k),
                              lat.run_substeps_plain)
        for i, (got, ref, start) in enumerate(runs):
            label = f"{name}{' moved, same runner' if i else ''} res 6"
            err = compare(torch, label, got, ref, start, 1 / 480, n_sub,
                          is_finite)
            if kin is not None:
                errs["kin"] = max(errs["kin"], err)
            if cfg.box_colliders or (kin or {}).get("boxes"):
                errs["box"] = max(errs["box"], err)
        if len(runs) == 2 and torch.equal(runs[0][0].positions,
                                          runs[1][0].positions):
            raise RuntimeError(f"{name}: a moved pose changed nothing")
    state, step, info = scenes.sphere_sweep(res=SWEEP_RES, device="cuda")
    spec, cfg, dt = info["spec"], info["config"], info["dt"]
    animate = info["animate"]
    n = spec.n_particles
    x0 = float(state.positions[:, 0].mean())
    torch.cuda.synchronize()
    lc.launches = 0
    tk = time.perf_counter()
    st = state
    for i in range(SWEEP_FRAMES):
        st = step(animate(i, st))
        if i + 1 == BOX_FRAMES:
            half = st
    torch.cuda.synchronize()
    tk = time.perf_counter() - tk
    sweep_launches = lc.launches
    sub = SWEEP_FRAMES * cfg.substeps
    tp = time.perf_counter()
    ref = state
    for i in range(BOX_FRAMES):
        ref = lat.step_fn(animate(i, ref), spec, cfg, dt)
    torch.cuda.synchronize()
    tp = time.perf_counter() - tp
    p = st.positions
    dx = float((half.positions - ref.positions).abs().max())
    ymin = float(p[:, 1].min())
    shift = float(p[:, 0].mean()) - x0
    print(f"# sphere_sweep res {SWEEP_RES} ({n} particles), "
          f"{SWEEP_FRAMES} animated frames x {cfg.substeps} substeps "
          f"through ONE runner (built once by the scene, kin_colliders="
          f"{info['kin_colliders']}; each frame a new pose in the table): "
          f"{tk:.3f} s wall, {sweep_launches} launches = "
          f"{sweep_launches / sub:.2f} a substep; finite={is_finite(st)} "
          f"ymin={ymin:.6f} slab pushed {shift:.4f} along +x; at frame "
          f"{BOX_FRAMES} max|dx| vs plain {dx:.3e} (gate {DX_TOL}, plain "
          f"{tp:.3f} s)")
    if not (is_finite(st) and ymin > -1e-2 and shift > 0.05
            and dx < DX_TOL and sweep_launches > 0):
        raise RuntimeError("sphere_sweep failed its gates")
    errs["kin"] = max(errs["kin"], dx)
    # boxes over the whole res-40 grid: a config box standing in the slab,
    # and a box sweeping along -x against the sphere
    kstate = state.replace(colliders=make_colliders(
        spheres=state.colliders.spheres, boxes=[(1.6, 0.3, 0.0, 0.2, 0.2,
                                                 0.2)],
        box_velocities=[(-2.0, 0.0, 0.0)], ground_height=0.0,
        device="cuda"))

    def box_sweep(i, st_):
        st_ = animate(i, st_)
        return st_.replace(colliders=st_.colliders.with_box(
            0, center=(1.6 - 2.0 * i * dt, 0.3, 0.0)))

    box_dx = box_sweeps(
        torch, f"sphere_sweep res {SWEEP_RES}",
        lambda c, k: lc.make_cuda_step(spec, c, dt, kin_colliders=k),
        lambda c: lambda s_: lat.step_fn(s_, spec, c, dt),
        (cfg, state.replace(colliders=None), (0.0, 0.3, 0.0, 0.2, 0.3, 0.2),
         kstate, box_sweep, half), is_finite, DX_TOL)
    errs["kin"] = max(errs["kin"], box_dx["kinematic box"])
    errs["box"] = max([errs["box"]] + list(box_dx.values()))
    # ms per substep with poses and without (the same body, config, state
    # at frame 30 with the sphere inside it), launches per substep of each
    mid = state
    for i in range(30):
        mid = step(animate(i, mid))
    mid = animate(30, mid)
    bare = mid.replace(colliders=None)
    n_k = 480
    k_kin = lc.make_cuda_substep_runner(spec, cfg, dt / cfg.substeps, n_k,
                                        kin_colliders=(1, 0))
    k_bare = lc.make_cuda_substep_runner(spec, cfg, dt / cfg.substeps, n_k)
    per = {}
    for key, run, s_ in (("poses", k_kin, mid), ("no poses", k_bare, bare)):
        lc.launches = 0
        run(s_)
        per[key] = lc.launches / n_k
    times, reps = timed_windows(torch, {
        "poses": (lambda: k_kin(mid), n_k),
        "no poses": (lambda: k_bare(bare), n_k)})
    print(f"# B-1 sweep config ({smi}): with poses "
          f"{min(times['poses']):.5f} ms/substep, without "
          f"{min(times['no poses']):.5f} ms/substep (best of two windows; "
          f"{times}); launches per substep {per['poses']:.5f} with poses, "
          f"{per['no poses']:.5f} without ({n_k} substeps a call)")
    b1_designs(torch, lc, f"sphere_sweep res {SWEEP_RES} with poses", mid,
               spec, cfg, dt / cfg.substeps, 240, smi)
    if per["poses"] != per["no poses"]:
        raise RuntimeError(f"poses changed the launches per substep: {per}")
    fstate, _, finfo = scenes.flagship_perf(res=SWEEP_RES, device="cuda")
    fspec, fcfg = finfo["spec"], finfo["config"]
    for key, st_, kin in (("poses", fstate.replace(colliders=make_colliders(
            spheres=[(0.0, 0.2, 0.0, 0.3)], device="cuda")), (1, 0)),
            ("no poses", fstate, None)):
        lc.launches = 0
        lc.make_cuda_substep_runner(fspec, fcfg, 1 / 480, 8,
                                    kin_colliders=kin)(st_)
        per[key] = lc.launches / 8
    print(f"# B-1 at the main path's config (flagship_perf res "
          f"{SWEEP_RES}): launches per substep {per['poses']:.5f} with a "
          f"kinematic sphere, {per['no poses']:.5f} without (8 a call)")
    if per["poses"] != per["no poses"]:
        raise RuntimeError(f"poses changed the launches per substep: {per}")
    out["lattice"] = dict(kin_err=errs["kin"], box_err=errs["box"],
                          ms_poses=min(times["poses"]),
                          ms_bare=min(times["no poses"]))
    print(f"# time: phase 26 took {time.perf_counter() - t0:.1f} s")

    # 27. B-3 with the rigid world
    t0 = time.perf_counter()
    merrs = {"kin": 0.0, "box": 0.0}
    for name, (cfg, kin, _, frames) in K.mesh_collider_cases().items():
        runs = K.mesh_runs(name, "cuda", lambda t, c, dt, f, k:
                           mc.make_mesh_cuda_step(t, c, dt, n_steps=f,
                                                  kin_colliders=k),
                           general.multi_step_fn)
        M = K._mesh_cases
        gates = (M.dx_gate(cfg), M.DLAM_DIST, M.DLAM_BEND)
        topo = M.case_inputs("sphere")[0]
        for i, (got, ref, start) in enumerate(runs):
            err = mesh_compare(torch, f"{name}{' moved' if i else ''}", got,
                               ref, start, topo, cfg,
                               frames * cfg.substeps, gates, is_finite)
            if kin is not None:
                merrs["kin"] = max(merrs["kin"], err)
            if cfg.box_colliders or (kin or {}).get("boxes"):
                merrs["box"] = max(merrs["box"], err)
    cstate, _, cinfo = scenes.cloth_xl(device="cuda")
    ctopo, ccfg, cdt = cinfo["topology"], cinfo["config"], cinfo["dt"]
    pins = torch.as_tensor(cinfo["pinned"], device="cuda")
    radius, speed, z0 = 0.25, 1.0, -0.8
    cstate = cstate.replace(colliders=make_colliders(
        spheres=[(0.0, 1.1, z0, radius)], ground_height=ccfg.ground_height,
        device="cuda"))

    def sweep(i, st_):
        return st_.replace(colliders=st_.colliders.with_sphere(
            0, center=(0.0, 1.1, z0 + speed * i * cdt),
            velocity=(0.0, 0.0, speed)))

    cstep = mc.make_mesh_cuda_step(ctopo, ccfg, cdt, kin_colliders=(1, 0))
    torch.cuda.synchronize()
    mc.launches = 0
    tk = time.perf_counter()
    ck = cstate
    for i in range(CLOTH_SWEEP_FRAMES):
        ck = cstep(sweep(i, ck))
        if i + 1 == BOX_FRAMES:
            half = ck
    torch.cuda.synchronize()
    tk = time.perf_counter() - tk
    cloth_launches = mc.launches
    tp = time.perf_counter()
    cp = cstate
    for i in range(BOX_FRAMES):
        cp = general.step_fn(sweep(i, cp), ctopo, ccfg, cdt)
    torch.cuda.synchronize()
    tp = time.perf_counter() - tp
    dx = float((half.positions - cp.positions).abs().max())
    zmax = float(ck.positions[:, 2].max())
    pins_ok = torch.equal(ck.positions[pins], cstate.positions[pins])
    print(f"# cloth_xl ({ctopo.n_particles} particles) with a kinematic "
          f"sphere (r {radius}) sweeping along +z through it, "
          f"{CLOTH_SWEEP_FRAMES} frames x {ccfg.substeps} substeps: B-3 "
          f"{tk:.3f} s wall, {cloth_launches} launches = "
          f"{cloth_launches / (CLOTH_SWEEP_FRAMES * ccfg.substeps):.2f} a "
          f"substep; finite={is_finite(ck)} pinned row unmoved={pins_ok} "
          f"ymin={float(ck.positions[:, 1].min()):.6f} max z {zmax:.4f} "
          f"(pushed); at frame {BOX_FRAMES} max|dx| vs plain {dx:.3e} "
          f"(gate {DRIFT_TOL}, plain {tp:.3f} s)")
    if not (is_finite(ck) and pins_ok and zmax > 0.05 and dx < DRIFT_TOL
            and cloth_launches > 0):
        raise RuntimeError("the cloth_xl sweep failed its gates")
    merrs["kin"] = max(merrs["kin"], dx)
    # boxes over the whole cloth: a config box the cloth hangs through,
    # and a box sweeping along +z through it beside the sphere
    kstate = cstate.replace(colliders=make_colliders(
        spheres=cstate.colliders.spheres, boxes=[(0.3, 0.9, z0, 0.12, 0.12,
                                                  0.12)],
        box_velocities=[(0.0, 0.0, speed)], ground_height=ccfg.ground_height,
        device="cuda"))

    def box_sweep(i, st_):
        st_ = sweep(i, st_)
        return st_.replace(colliders=st_.colliders.with_box(
            0, center=(0.3, 0.9, z0 + speed * i * cdt)))

    box_dx = box_sweeps(
        torch, f"cloth_xl ({ctopo.n_particles} particles)",
        lambda c, k: mc.make_mesh_cuda_step(ctopo, c, cdt, kin_colliders=k),
        lambda c: lambda s_: general.step_fn(s_, ctopo, c, cdt),
        (ccfg, cstate.replace(colliders=None),
         (0.0, 1.0, 0.05, 0.2, 0.15, 0.1), kstate, box_sweep, half),
        is_finite, DRIFT_TOL)
    merrs["kin"] = max(merrs["kin"], box_dx["kinematic box"])
    merrs["box"] = max([merrs["box"]] + list(box_dx.values()))
    n_k, n_p = 400, 20
    mid = cstate
    for i in range(60):
        mid = cstep(sweep(i, mid))
    mid = sweep(60, mid)
    k_cloth = mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt / 4, n_k,
                                               kin_colliders=(1, 0))
    mtimes, _ = timed_windows(torch, {
        "plain": (lambda: general.run_substeps_plain(
            mid, ctopo, ccfg, cdt / 4, n_p), n_p),
        "kernel": (lambda: k_cloth(mid), n_k)})
    print(f"# B-3 cloth_xl with a kinematic sphere ({smi}): kernel "
          f"{min(mtimes['kernel']):.5f} ms/substep, plain "
          f"{min(mtimes['plain']):.5f} ms/substep ({mtimes})")
    out["mesh"] = dict(kin_err=merrs["kin"], box_err=merrs["box"],
                       ms=min(mtimes["kernel"]),
                       plain_ms=min(mtimes["plain"]))
    print(f"# time: phase 27 took {time.perf_counter() - t0:.1f} s")

    # 28. B-5's pose cotangents at the bench_diff scene
    t0 = time.perf_counter()
    topo, cfg, st, _ = diff_scene(torch, "cuda")
    cfg = cfg.replace(ground_height=123.0)      # the ColliderSet's wins
    # the sphere overlaps the shell's +x side and the ground (0.55) its
    # bottom (0.5) from the first substep, so every pose cotangent fires
    coll = make_colliders(spheres=[(0.6, 1.0, 0.0, 0.2)],
                          sphere_velocities=[(0.4, 0.0, 0.1)],
                          ground_height=0.55, device="cuda")
    wts = torch.tensor(K.loss_weights(topo.n_particles), device="cuda")
    ns = KIN_GRAD_SUBSTEPS
    md.launches = 0
    got = K.chunk_pose_grads(md.backward_chunk_cuda, topo, cfg, ns, st,
                             coll, wts)
    torch.cuda.synchronize()
    kin_launches = md.launches
    plain = K.chunk_pose_grads(md.backward_chunk_plain, topo, cfg, ns, st,
                               coll, wts)
    auto = K.autograd_pose_grads(topo, cfg, ns, st, coll, wts)
    e_plain, scale = K.pose_error(got, plain)
    e_auto, _ = K.pose_error(got, auto)

    def runner_grads(chunk):
        run = kd.make_differentiable_mesh_runner(
            topo, cfg, DIFF_DT, ns, remat_chunk=chunk, backward="fused",
            kin_colliders=(1, 0))
        leaves = {k: getattr(coll, k).clone().requires_grad_()
                  for k in ("spheres", "boxes", "ground_height",
                            "sphere_velocities", "box_velocities")}
        o = run(st.replace(colliders=ColliderSet(**leaves)))
        keys = ("spheres", "sphere_velocities", "ground_height")
        return dict(zip(keys, torch.autograd.grad(
            (wts * o.positions).sum(), [leaves[k] for k in keys])))

    flat, chunked = runner_grads(0), runner_grads(10)
    chunk_ok = all(torch.allclose(chunked[k], flat[k], rtol=1e-5,
                                  atol=1e-8) for k in flat)
    print(f"# B-5 pose cotangents, bench_diff scene ({topo.n_particles} "
          f"particles, a kinematic sphere overlapping the shell, "
          f"{ns} substeps, random-weighted loss): kernel "
          + ", ".join(f"{k} {got[k].numpy().round(5).tolist()}"
                      for k in got)
          + f"; vs backward_chunk_plain {e_plain:.3e}, vs autograd "
          f"{e_auto:.3e} (max|dg| / max|g| on one scale, {scale:.4e}); "
          f"runner in chunks of 10 vs flat within rtol 1e-5: {chunk_ok}; "
          f"{kin_launches} launches")
    if not (e_plain < 1e-5 and e_auto < 1e-4 and chunk_ok and scale > 1e-3
            and kin_launches > 0
            and all(float(g.abs().max()) > 0 for g in got.values())):
        raise RuntimeError("B-5's pose cotangents disagree")
    t11 = time.perf_counter()
    _, hist = config11_collider_control.run(engine="fused", device="cuda",
                                            verbose=False)
    print(f"# config11 (fused B-3 + B-5, defaults): loss {hist[0]:.5f} -> "
          f"{hist[-1]:.5f} over {len(hist) - 1} gradient steps "
          f"({time.perf_counter() - t11:.1f} s)")
    if not hist[-1] < hist[0]:
        raise RuntimeError("config11's loss did not shrink")
    z = torch.zeros_like(st.positions)
    zl = torch.zeros_like(st.lambda_dist)
    bare_cfg = cfg.replace(ground_height=0.55)

    def chunk(c, cf):
        return md.backward_chunk_cuda(topo, cf, DIFF_DT, ns, st.inv_mass,
                                      st.positions, st.velocities,
                                      st.lambda_dist, wts, z, zl,
                                      colliders=c)

    ms_kin = cuda_ms(torch, lambda: chunk(coll, cfg), 5)
    ms_bare = cuda_ms(torch, lambda: chunk(None, bare_cfg), 5)
    ms_plain = cuda_ms(torch, lambda: md.backward_chunk_plain(
        topo, cfg, DIFF_DT, ns, st.inv_mass, st.positions, st.velocities,
        st.lambda_dist, wts, z, zl, colliders=coll), 1, warm=False)
    work = diff_work(topo, cfg, ns, kin_spheres=1)
    bnd = bound_ms(*work)
    print(f"# B-5 chunk of {ns} substeps ({smi}): with pose cotangents "
          f"{ms_kin:.4f} ms, without (no ColliderSet, the config's floor "
          f"at the same height) "
          f"{ms_bare:.4f} ms; plain {ms_plain:.4f} ms; bound with poses "
          f"{bnd[0]:.5f} ms ({bnd[1]}: {work[0]} bytes, {work[1]} "
          f"operations), {ms_kin / bnd[0]:.0f}x it")
    out["diff"] = dict(kin_grad_rel_err=e_plain, ms_kin=ms_kin,
                       ms_bare=ms_bare)
    print(f"# time: phase 28 took {time.perf_counter() - t0:.1f} s")
    return out


ENSEMBLE_RES = 6
# example 5 at its defaults: 1,024 res-4 bodies, 120 frames x 4 substeps
EXAMPLE5_FRAMES = 120
EXAMPLE5_ROWS = (0, 511, 1023)
# the farm of scripts/bench_mesh_ensemble.py (its icosphere(4, 0.5)
# fallback, the bench_diff scene's body and config) x 32
FARM_BODIES = 32
FARM_FRAMES = 240
FARM_DRIFT_ROWS = (0, 7, 19, 31)
# the per-body-mass farm's drift rows: the lightest and the heaviest body
# (four rows there would add some 10 s of plain engine to the smoke)
MASS_FARM_DRIFT_ROWS = (0, 31)
# the contact farm of scripts/bench_ensemble_contact.py: ball_on_cloth x 8
CONTACT_FARM_BODIES = 8
CONTACT_FARM_ROWS = (0, 3, 7)
MAT_ENSEMBLE_BODIES = 16
MASS_ENSEMBLE_BODIES = 8
SHARDS = 4
SHARD_SUBSTEPS = 40
ENSEMBLE_LEAVES = ("positions", "velocities", "lambda_dist", "lambda_bend",
                   "lambda_tet")


def rows_equal(torch, what, out, start, single, rows, materials=None):
    """Rows ``rows`` of an ensemble result against the single-body runner
    ``single`` on those bodies of ``start``: raises unless every leaf is
    equal to the bit."""
    import test_torch_ensemble_cases as E
    from softbodysimulation_tpu_torch.core.state import body_of

    singles = []
    for i in rows:
        mat = (None if materials is None
               else {k: v[i] for k, v in materials.items()})
        singles.append(single(body_of(start, i)) if mat is None
                       else single(body_of(start, i), mat))
    picked = out.replace(**{k: getattr(out, k)[list(rows)]
                            for k in ENSEMBLE_LEAVES
                            if getattr(out, k) is not None})
    bad = E.row_mismatches(picked, singles, ENSEMBLE_LEAVES)
    print(f"# {what}: rows {list(rows)} equal to the single-body kernel to "
          f"the bit: {not bad}")
    if bad:
        raise RuntimeError(f"{what}: ensemble rows differ from the "
                           f"single-body kernel: {bad[:6]}")


def farm_state(torch, np, state, n_bodies, spread, seed=1):
    """``n_bodies`` copies of a one-body state (its inv_mass shared),
    scattered by seeded offsets: x and z in [-spread[0], spread[0]), y in
    [0, spread[1]) (``scripts/bench_mesh_ensemble.py``'s batch_states)."""
    from softbodysimulation_tpu_torch.parallel import batch as pbatch

    rng = np.random.RandomState(seed)
    offs = np.stack([rng.uniform(-spread[0], spread[0], n_bodies),
                     rng.uniform(0.0, spread[1], n_bodies),
                     rng.uniform(-spread[0], spread[0], n_bodies)],
                    1).astype(np.float32)
    farm = pbatch.replicate_state(state, n_bodies)
    return farm.replace(inv_mass=state.inv_mass,
                        positions=farm.positions + torch.as_tensor(
                            offs, device=farm.device)[:, None, :])


def grad_rel(torch, got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# phase 31's float64 witness: the central difference's step along the
# seeded direction d (d_k = z_k theta_k, z standard normal), per leaf, and
# its gates
GRAD_FD_EPS = {"rest_lengths": 1e-6, "inv_mass": 1e-4}
GRAD_FD_TOL = 1e-4
GRAD_F32_TOL = 0.1


def grad_witness(torch, topo, cfg, st, leaf, g32, compliance=None):
    """A witness of one body's float32 ensemble gradient ``g32`` of
    sum(x^2) over GRAD_SUBSTEPS w.r.t. ``leaf`` (``"rest_lengths"``, with
    the body's ``compliance``, or ``"inv_mass"``) that does not share its
    backward: a central difference of the loss along a seeded direction d,
    the plain engine in float64 on the body's device.  Returns the
    autograd-through-plain float64 gradient's error along d, the float32
    one's, both relative to the difference, and max|g32 - g64| /
    max|g64|."""
    from softbodysimulation_tpu_torch.solvers import general

    st = as_f64(st)
    comp = None if compliance is None else compliance.double()

    def loss(theta):
        if leaf == "inv_mass":
            s_, tp = st.replace(inv_mass=theta), topo
        else:
            s_, tp = st, topo.replace(rest_lengths=theta, compliance=comp)
        return (general.run_substeps_plain(s_, tp, cfg, DIFF_DT,
                                           GRAD_SUBSTEPS).positions
                ** 2).sum()

    theta = (st.inv_mass if leaf == "inv_mass"
             else topo.rest_lengths.to(st.device).double())
    th = theta.clone().requires_grad_()
    (g64,) = torch.autograd.grad(loss(th), th)
    gen = torch.Generator().manual_seed(7)
    d = torch.randn(tuple(theta.shape), generator=gen,
                    dtype=torch.float64).to(theta.device) * theta
    eps = GRAD_FD_EPS[leaf]
    with torch.no_grad():
        fd = float((loss(theta + eps * d) - loss(theta - eps * d))
                   / (2.0 * eps))
    along = [abs(float((g * d).sum()) - fd) / abs(fd)
             for g in (g64, g32.double())]
    return along[0], along[1], grad_rel(torch, g32.double(), g64)


def ensemble_phases(torch, np, smi, is_finite):
    """Phases 29-32: the ensembles of B-1 and B-3, their differentiable
    and sharded forms, and their throughput.  Returns the two JSON entries
    ("kernels") and the runs ``--profile`` traces ("profile")."""
    import test_torch_ensemble_cases as E
    import test_torch_mesh_cases as mesh_cases
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.core.state import body_of
    from softbodysimulation_tpu_torch.examples import config5_batch_1024
    from softbodysimulation_tpu_torch.kernels import diff as kd
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.parallel import batch as pbatch
    from softbodysimulation_tpu_torch.solvers import general
    from softbodysimulation_tpu_torch.solvers import lattice as lat

    # 29. B-1 ensembles: every case, then example 5 at its defaults
    t0 = time.perf_counter()
    lat_err = 0.0
    for name in E.lattice_ensemble_cases():
        spec, cfg, st, frames, kin, batched = E.lattice_case(
            name, ENSEMBLE_RES, "cuda")
        nb = st.positions.shape[0]
        n_sub = frames * cfg.substeps
        ens = lc.make_cuda_step(spec, cfg, E.DT, frames, kin_colliders=kin,
                                n_bodies=nb, batched=batched)(st)
        ref = lat.run_substeps_plain_batched(st, spec, cfg,
                                             E.DT / cfg.substeps, n_sub,
                                             with_ext=True)
        lat_err = max(lat_err, compare(
            torch, f"B-1 ensemble {name} x {nb} res {ENSEMBLE_RES}", ens,
            ref, st, E.DT / cfg.substeps, n_sub, is_finite))
        rows_equal(torch, f"B-1 ensemble {name}", ens, st,
                   lc.make_cuda_step(spec, cfg, E.DT, frames,
                                     kin_colliders=kin), range(nb))
    torch.cuda.synchronize()
    lc.launches = 0
    t1 = time.perf_counter()
    ex5, normals = config5_batch_1024.run(steps=EXAMPLE5_FRAMES,
                                          verbose=False)
    torch.cuda.synchronize()
    ex5_s = time.perf_counter() - t1
    ex5_launches = lc.launches
    spec5, cfg5, start5 = config5_batch_1024.make_ensemble()
    nb5, n5 = start5.positions.shape[:2]
    ex5_sub = EXAMPLE5_FRAMES * cfg5.substeps
    p = ex5.positions
    ymin = float(p[..., 1].min())
    unit = bool(torch.allclose(torch.linalg.norm(normals, dim=-1),
                               torch.ones_like(normals[..., 0]), atol=1e-3))
    print(f"# example 5: {nb5} bodies x {n5} particles, {EXAMPLE5_FRAMES} "
          f"frames x {cfg5.substeps} substeps through make_batched_step in "
          f"{ex5_s:.3f} s wall, {ex5_launches} launches "
          f"({ex5_launches / ex5_sub:.3f} a substep); finite="
          f"{is_finite(ex5)} ymin={ymin:.6f} normals unit={unit}")
    if not (is_finite(ex5) and ymin > -1e-2 and unit and ex5_launches > 0):
        raise RuntimeError("example 5 failed its health gates")
    single5 = lc.make_cuda_step(spec5, cfg5, 1 / 60, EXAMPLE5_FRAMES)
    lc.launches = 0
    rows_equal(torch, "example 5", ex5, start5, single5, EXAMPLE5_ROWS)
    one_launches = lc.launches / len(EXAMPLE5_ROWS)
    print(f"# example 5 launches a substep: ensemble "
          f"{ex5_launches / ex5_sub:.3f}, one body {one_launches / ex5_sub:.3f}")
    if ex5_launches != one_launches:
        raise RuntimeError("the ensemble's launches grow with its bodies")
    plain5 = lat.run_substeps_plain_batched(start5, spec5, cfg5,
                                            1 / 60 / cfg5.substeps, ex5_sub,
                                            with_ext=True)
    ex5_drift = float((p - plain5.positions).abs().max())
    print(f"# example 5 drift vs the lane-folded plain engine, {ex5_sub} "
          f"substeps: {ex5_drift:.3e} (gate {DRIFT_TOL})")
    if not ex5_drift < DRIFT_TOL:
        raise RuntimeError(f"example 5 drifts from plain: {ex5_drift}")
    print(f"# time: phase 29 took {time.perf_counter() - t0:.1f} s")

    # 30. B-3 ensembles: every case, the mesh farm, the contact farm
    t0 = time.perf_counter()
    mesh_err = 0.0
    for name in E.mesh_ensemble_cases():
        topo, cfg, st, mats, frames, opts = E.mesh_case(name, "cuda")
        nb = st.positions.shape[0]
        kin = opts.get("kin")
        ens = mc.make_mesh_cuda_step(
            topo, cfg, E.DT, frames, kin_colliders=kin, n_bodies=nb,
            per_body_mass=bool(opts.get("per_body_mass")))(st, mats)
        ref = general.run_substeps_plain_batched(
            st, topo, cfg, E.DT / cfg.substeps, frames * cfg.substeps,
            with_ext=True, materials=mats)
        torch.cuda.synchronize()
        dx = float((ens.positions - ref.positions).abs().max())
        d = {k: float((getattr(ens, k) - getattr(ref, k)).abs().max())
             for k in ("lambda_dist", "lambda_bend")
             if getattr(ref, k).numel()}
        big = {k: float(getattr(ref, k).abs().max()) for k in d}
        gates = {"lambda_dist": mesh_cases.DLAM_DIST,
                 "lambda_bend": mesh_cases.DLAM_BEND}
        print(f"# B-3 ensemble {name} x {nb}: max|dx|={dx:.3e} (gate "
              f"{E.dx_gate(cfg)}) " + " ".join(
                  f"max|d{k}|={d[k]:.3e} (max {big[k]:.3e})" for k in d))
        if not (is_finite(ens) and dx < E.dx_gate(cfg)
                and all(d[k] <= LAM_REL * big[k] for k in d)
                and (cfg.enable_self_collision
                     or all(d[k] < gates[k] for k in d))):
            raise RuntimeError(f"B-3 ensemble {name} disagrees with plain")
        mesh_err = max(mesh_err, dx)
        rows_equal(torch, f"B-3 ensemble {name}", ens, st,
                   mc.make_mesh_cuda_step(topo, cfg, E.DT, frames,
                                          kin_colliders=kin), range(nb),
                   mats)

    ftopo, fcfg, fstate, _ = diff_scene(torch, "cuda")
    farm = farm_state(torch, np, fstate, FARM_BODIES, (4.0, 2.0))
    fdt_sub = 1 / 60 / fcfg.substeps
    f_sub = FARM_FRAMES * fcfg.substeps
    fstep = pbatch.make_batched_general_step(ftopo, fcfg, 1 / 60,
                                             n_steps=FARM_FRAMES)
    farm_single = mc.make_mesh_cuda_step(ftopo, fcfg, 1 / 60, FARM_FRAMES)
    farm_launches = None
    for label, start, drift_rows in (
            ("shared masses", farm, FARM_DRIFT_ROWS),
            ("per-body masses", farm.replace(inv_mass=farm.inv_mass[None]
                                             * torch.linspace(
                                                 0.5, 1.5, FARM_BODIES,
                                                 device="cuda")[:, None]),
             MASS_FARM_DRIFT_ROWS)):
        torch.cuda.synchronize()
        mc.launches = 0
        t1 = time.perf_counter()
        fout = fstep(start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if farm_launches is None:
            farm_launches = mc.launches
        ymin = float(fout.positions[..., 1].min())
        drift = max(float((fout.positions[i] - general.run_substeps_plain(
            body_of(start, i), ftopo, fcfg, fdt_sub, f_sub,
            with_ext=True).positions).abs().max())
            for i in drift_rows)
        print(f"# mesh farm ({label}): {FARM_BODIES} x {ftopo.n_particles} "
              f"particles, {FARM_FRAMES} frames x {fcfg.substeps} substeps "
              f"in {wall:.3f} s wall, {mc.launches} launches; finite="
              f"{is_finite(fout)} ymin={ymin:.6f}; drift vs plain on bodies "
              f"{list(drift_rows)}: {drift:.3e} (gate {DRIFT_TOL})")
        if not (is_finite(fout) and ymin > -1e-2 and drift < DRIFT_TOL
                and mc.launches > 0):
            raise RuntimeError(f"mesh farm ({label}) failed its gates")
        mesh_err = max(mesh_err, drift)
        rows_equal(torch, f"mesh farm ({label})", fout, start, farm_single,
                   (0, FARM_BODIES - 1))

    cstate, _, cinfo = scenes.ball_on_cloth(device="cuda")
    ctopo, ccfg, cdt = cinfo["topology"], cinfo["config"], cinfo["dt"]
    nc = cinfo["n_cloth"]
    cfarm = farm_state(torch, np, cstate, CONTACT_FARM_BODIES, (0.02, 0.0))
    torch.cuda.synchronize()
    mc.launches = 0
    cout = pbatch.make_batched_general_step(ctopo, ccfg, cdt,
                                            n_steps=CATALOG_FRAMES)(cfarm)
    torch.cuda.synchronize()
    contact_launches = mc.launches
    ball = cout.positions[:, nc:, 1].amin(dim=1)
    cloth = cout.positions[:, :nc, 1].amin(dim=1)
    print(f"# contact farm: ball_on_cloth x {CONTACT_FARM_BODIES}, "
          f"{CATALOG_FRAMES} frames, {contact_launches} launches: ball min "
          f"y {float(ball.min()):.4f}-{float(ball.max()):.4f}, cloth min y "
          f"{float(cloth.min()):.4f}-{float(cloth.max()):.4f}")
    if not (is_finite(cout) and bool((ball > 0.55).all())
            and bool((cloth < 0.99).all())):
        raise RuntimeError("contact farm failed its physics")
    rows_equal(torch, "contact farm", cout, cfarm,
               mc.make_mesh_cuda_step(ctopo, ccfg, cdt, CATALOG_FRAMES),
               CONTACT_FARM_ROWS)
    print(f"# time: phase 30 took {time.perf_counter() - t0:.1f} s")

    # 31. differentiable and sharded ensembles
    t0 = time.perf_counter()
    dtopo, dcfg, dstate, v0 = diff_scene(torch, "cuda")
    dstate = dstate.replace(velocities=dstate.velocities + v0)
    grad_err = 0.0

    def plain_grad(st, leaf, mats=None):
        out = general.run_substeps_plain(st, dtopo, dcfg, DIFF_DT,
                                         GRAD_SUBSTEPS, materials=mats)
        return torch.autograd.grad((out.positions ** 2).sum(), leaf)[0]

    nb = MAT_ENSEMBLE_BODIES
    scale = torch.linspace(1.0, 1.05, nb, device="cuda")[:, None]
    mats = {"rest_lengths": (dtopo.rest_lengths.to("cuda")[None]
                             * scale).requires_grad_(),
            "compliance": dtopo.compliance.to("cuda")[None].expand(
                nb, -1) * (1.0 + 3.0 * (scale - 1.0) / 0.05)}
    batched = pbatch.replicate_state(dstate, nb).replace(
        inv_mass=dstate.inv_mass)
    run = kd.make_differentiable_material_ensemble_runner(
        dtopo, dcfg, DIFF_DT, GRAD_SUBSTEPS, n_bodies=nb)
    g = torch.autograd.grad((run(batched, mats).positions ** 2).sum(),
                            mats["rest_lengths"])[0]
    for i in (nb - 1,):
        rest = mats["rest_lengths"][i].detach().requires_grad_()
        ref = plain_grad(body_of(batched, i), rest,
                         {"rest_lengths": rest,
                          "compliance": mats["compliance"][i]})
        grad_err = max(grad_err, grad_rel(torch, g[i], ref))
    witness = {"materials": grad_witness(
        torch, dtopo.replace(rest_lengths=mats["rest_lengths"][-1].detach()),
        dcfg, body_of(batched, nb - 1), "rest_lengths", g[-1],
        mats["compliance"][-1])}
    nb = MASS_ENSEMBLE_BODIES
    im = (dstate.inv_mass[None] * torch.linspace(1.0, 1.5, nb,
                                                 device="cuda")[:, None])
    im = im.requires_grad_()
    gen = torch.Generator().manual_seed(3)
    batched = pbatch.replicate_state(dstate.replace(
        velocities=dstate.velocities + 0.05 * torch.randn(
            tuple(dstate.velocities.shape), generator=gen).to("cuda")), nb)
    run = kd.make_differentiable_mesh_ensemble_runner(
        dtopo, dcfg, DIFF_DT, GRAD_SUBSTEPS, n_bodies=nb)
    g = torch.autograd.grad((run(batched.replace(inv_mass=im)).positions
                             ** 2).sum(), im)[0]
    for i in (nb - 1,):
        w = im[i].detach().requires_grad_()
        ref = plain_grad(body_of(batched, i).replace(inv_mass=w), w)
        grad_err = max(grad_err, grad_rel(torch, g[i], ref))
    witness["per-body masses"] = grad_witness(
        torch, dtopo, dcfg, body_of(batched, nb - 1).replace(
            inv_mass=im[-1].detach()), "inv_mass", g[-1])
    print(f"# ensemble gradients (bench_diff scene, {GRAD_SUBSTEPS} "
          f"substeps): materials x {MAT_ENSEMBLE_BODIES} and per-body masses"
          f" x {MASS_ENSEMBLE_BODIES} vs autograd through the plain engine "
          f"on their last bodies: max |dg| / max |g| = "
          f"{grad_err:.3e} (gate 1e-4)")
    if not grad_err < 1e-4:
        raise RuntimeError("ensemble gradients disagree with autograd")
    for what, (e64, e32, emax) in witness.items():
        print(f"# ensemble gradient ({what}), last body, along a seeded "
              f"direction vs a float64 central difference: float64 "
              f"autograd through the plain engine {e64:.3e} (gate "
              f"{GRAD_FD_TOL}), the float32 ensemble {e32:.3e} (gate "
              f"{GRAD_F32_TOL}); float32 vs float64 gradient max|dg|/max|g| "
              f"= {emax:.3e}")
        if not (e64 < GRAD_FD_TOL and e32 < GRAD_F32_TOL):
            raise RuntimeError(f"ensemble gradient ({what}) disagrees with "
                               f"its finite difference")

    def sharded(make, start, n_shards):
        mesh = pbatch.make_mesh(n_shards)
        shards = pbatch.shard_batched_state(start, mesh)
        res = make(mesh)(shards)
        diag = pbatch.make_sharded_ensemble_diagnostics(mesh)(res)
        return pbatch.gather_batched_state(res), [float(x) for x in diag]

    for what, make, start in (
            ("example 5 lattice rollout", lambda m: (
                pbatch.make_sharded_pallas_rollout(
                    spec5, cfg5, 1 / 60 / cfg5.substeps, SHARD_SUBSTEPS, m,
                    nb5)), start5),
            ("mesh farm rollout", lambda m: (
                pbatch.make_sharded_mesh_pallas_rollout(
                    ftopo, fcfg, fdt_sub, SHARD_SUBSTEPS, m, FARM_BODIES)),
             farm)):
        one, d1 = sharded(make, start, 1)
        four, d4 = sharded(make, start, SHARDS)
        same = all(torch.equal(getattr(one, k), getattr(four, k))
                   for k in ("positions", "velocities", "lambda_dist"))
        diag_ok = (d1[0] == d4[0] and d1[1] == d4[1] == 0 and d1[3] == d4[3]
                   and abs(d1[2] - d4[2]) <= 1e-6 * abs(d1[2]))
        print(f"# {what}: {SHARDS} shards on one card equal one shard to "
              f"the bit: {same}; diagnostics (vmax, bad, height, on ground) "
              f"one shard {d1}, {SHARDS} shards {d4}")
        if not (same and diag_ok):
            raise RuntimeError(f"sharded {what} differs from one shard")
    print(f"# time: phase 31 took {time.perf_counter() - t0:.1f} s")

    # 32. throughput: each ensemble, its plain twin, the single-body kernel
    # looped over its bodies
    t0 = time.perf_counter()
    results = {}

    def loop_of(runner, start, rows):
        bodies = [body_of(start, i) for i in rows]
        return lambda: [runner(b) for b in bodies]

    for key, spec_runs, n_bodies_, n_part in (
            ("lattice", lambda: {
                "plain": (lambda: lat.run_substeps_plain_batched(
                    start5, spec5, cfg5, 1 / 240, 20), 20),
                "ensemble": (lambda e=lc.make_cuda_substep_runner(
                    spec5, cfg5, 1 / 240, 480, n_bodies=nb5): e(start5),
                    480),
                "loop": (loop_of(lc.make_cuda_substep_runner(
                    spec5, cfg5, 1 / 240, 4), start5, range(nb5)), 4)},
             nb5, n5),
            ("mesh", lambda: {
                "plain": (lambda: general.run_substeps_plain_batched(
                    farm, ftopo, fcfg, fdt_sub, 4), 4),
                "ensemble": (lambda e=mc.make_mesh_cuda_substep_runner(
                    ftopo, fcfg, fdt_sub, 400, n_bodies=FARM_BODIES):
                    e(farm), 400),
                "loop": (loop_of(mc.make_mesh_cuda_substep_runner(
                    ftopo, fcfg, fdt_sub, 40), farm, range(FARM_BODIES)),
                    40)}, FARM_BODIES, ftopo.n_particles),
            ("contact", lambda: {
                "plain": (lambda: general.run_substeps_plain_batched(
                    cout, ctopo, ccfg, cdt / ccfg.substeps, 1), 1),
                "ensemble": (lambda e=mc.make_mesh_cuda_substep_runner(
                    ctopo, ccfg, cdt / ccfg.substeps, 60,
                    n_bodies=CONTACT_FARM_BODIES): e(cout), 60),
                "loop": (loop_of(mc.make_mesh_cuda_substep_runner(
                    ctopo, ccfg, cdt / ccfg.substeps, 6), cout,
                    range(CONTACT_FARM_BODIES)), 6)},
             CONTACT_FARM_BODIES, ctopo.n_particles)):
        runs = spec_runs()
        counter = lc if key == "lattice" else mc
        per_sub = {}
        for name in ("ensemble", "loop"):
            counter.launches = 0
            runs[name][0]()
            # B-1 and B-3 launch once a call (for every body)
            per_sub[name] = counter.launches / (
                1 if name == "ensemble" else n_bodies_)
        times, reps = timed_windows(torch, runs, min_s=0.5)
        total = n_bodies_ * n_part
        best = {k: min(v) for k, v in times.items()}
        for k in runs:
            print(f"# throughput {key} ensemble ({smi}), {k}: best "
                  f"{best[k]:.5f} ms/substep = {total / best[k] * 1e3:.4e} "
                  f"particle-substeps/s (windows in turn order: {times[k]}, "
                  f"{reps[k]} calls each)")
        print(f"# {key} ensemble launches a call: "
              f"{per_sub['ensemble']:.3f} for {n_bodies_} bodies, "
              f"{per_sub['loop']:.3f} for one body; "
              f"the ensemble {best['loop'] / best['ensemble']:.1f}x the loop")
        if per_sub["ensemble"] != per_sub["loop"]:
            raise RuntimeError(f"{key} ensemble launches grow with bodies")
        results[key] = (best, times, per_sub)
    b1_designs(torch, lc, f"example 5 ({nb5} x res {spec5.res})", start5,
               spec5, cfg5, 1 / 240, 40, smi, batched=True)
    b3_designs(torch, mc, cc, f"farm ({FARM_BODIES} x {ftopo.n_particles})",
               farm, ftopo, fcfg, fdt_sub, 400, smi, batched=True)
    b3_designs(torch, mc, cc, f"contact farm ({CONTACT_FARM_BODIES} x "
               f"{ctopo.n_particles}, dense)", cout, ctopo, ccfg,
               cdt / ccfg.substeps, 60, smi, batched=True)
    print(f"# time: phase 32 took {time.perf_counter() - t0:.1f} s")

    lat_bound = bound_ms(*[nb5 * x for x in lattice_work(spec5, cfg5)])
    mesh_bound = bound_ms(*mesh_work(ftopo, fcfg, bodies=FARM_BODIES))
    contact_bound = bound_ms(*mesh_work(ctopo, ccfg,
                                        bodies=CONTACT_FARM_BODIES))
    lb, mb, cb = (results[k][0] for k in ("lattice", "mesh", "contact"))
    print(f"# ensemble bounds ({smi}): example 5 {lat_bound[0]:.5f} ms "
          f"({lat_bound[1]}), B-1 ensemble at {lb['ensemble'] / lat_bound[0]:.1f}"
          f"x; mesh farm {mesh_bound[0]:.5f} ms ({mesh_bound[1]}), B-3 at "
          f"{mb['ensemble'] / mesh_bound[0]:.1f}x; contact farm "
          f"{contact_bound[0]:.5f} ms ({contact_bound[1]}, contact passes "
          f"not counted)")
    kernels = [{
        "name": "lattice_xpbd_ensemble",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/lattice_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/lattice_pallas.py:501",
        "launches": ex5_launches,
        "max_abs_err": max(lat_err, ex5_drift),
        "ms": lb["ensemble"],
        "plain_ms": lb["plain"],
        "bound_ms": lat_bound[0],
        "bound_by": lat_bound[1],
        "library_ms": None,
        "bodies": nb5,
        "loop_ms": lb["loop"],
        # one launch a call of the persistent kernel, for every body
        "launches_per_call": results["lattice"][2]["ensemble"],
    }, {
        "name": "mesh_xpbd_ensemble",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/mesh_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/mesh_pallas.py:789",
        "launches": farm_launches,
        "max_abs_err": mesh_err,
        "ms": mb["ensemble"],
        "plain_ms": mb["plain"],
        "bound_ms": mesh_bound[0],
        "bound_by": mesh_bound[1],
        "library_ms": None,
        "bodies": FARM_BODIES,
        "loop_ms": mb["loop"],
        "launches_per_call": results["mesh"][2]["ensemble"],
        "contact_farm_ms": cb["ensemble"],
        "contact_farm_plain_ms": cb["plain"],
        "contact_farm_loop_ms": cb["loop"],
        "contact_farm_launches": contact_launches,
        "grad_rel_err": grad_err,
        "grad_fd_rel_err": {k: {"float64": v[0], "float32": v[1]}
                            for k, v in witness.items()},
    }]
    profile = [(lc.make_cuda_substep_runner(spec5, cfg5, 1 / 240, 200,
                                            n_bodies=nb5), start5),
               (mc.make_mesh_cuda_substep_runner(
                   ftopo, fcfg, fdt_sub, 200, n_bodies=FARM_BODIES), farm)]
    return {"kernels": kernels, "profile": profile}


# phases 33-37: approx_math in B-1 and B-3, the lattice hybrid contact
# runner, hash on the card, the entry and bench twins
APPROX_PARITY_SUBSTEPS = 16
# B-1 approx against its twin over 16 res-40 substeps: rcp.approx is not
# IEEE, so a tolerance, not the bits
APPROX_KERNEL_GATE = 1e-4
# B-3 approx against its twin: JAX's own band for its approx kernel
# (tests/test_mesh_pallas.py:111-118), positions and multipliers
MESH_APPROX_GATES = (5e-3, 5e-4)
# the 64k contact-cadence config of scripts/bench_contact_kernel.py:58-67,
# :149-153: the bench lattice, blocked B-4 contact (B = 128, M = 4) every
# 8th substep, particle radius 0.55 x spacing, dt_sub 1/480
HYBRID_EVERY = 8
HYBRID_PARITY_SUBSTEPS = 24
HYBRID_ROLLOUT_SUBSTEPS = 400
# example 4 on the card against the CPU over the 200 frames before its
# first poke: the cubes land and touch, and contact grows rounding
# differences between card and CPU, so the gate is the repo's drift gate
EX4_FRAMES = 200
EX4_GATE = 1e-3


def approx_ulps(torch, a, b):
    """How many elements of two float32 tensors differ, and by how many
    units in the last place at most."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ia != ib).sum()), int((ia - ib).abs().max())


def cadence_phases(torch, np, smi, is_finite, main_state, main_plain):
    """Phases 33-37: B-1 and B-3 with ``approx_math``, the lattice hybrid
    contact runner at the 64k contact-cadence config, example 4 (``hash``)
    on the card, the entry and bench twins.  ``main_state`` and
    ``main_plain`` are phase 4's start and its 2000-substep plain rollout
    (the bench.py workload).  Returns the kernels line's new fields
    ("lattice", "mesh") and the runs ``--profile`` traces ("profile")."""
    from softbodysimulation_tpu_torch import bench as pbench
    from softbodysimulation_tpu_torch import entry as pentry
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.core.config import (LambdaMode,
                                                          SolveMode,
                                                          SolverConfig)
    from softbodysimulation_tpu_torch.examples import (
        config4_interactive_poke as ex4)
    from softbodysimulation_tpu_torch.interact import forces
    from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.ops import spatial_hash
    from softbodysimulation_tpu_torch.solvers import general
    from softbodysimulation_tpu_torch.solvers import lattice as lat

    # 33. B-1 approx at the bench.py workload (phase 4's start)
    settings = pbench.Settings()
    spec, cfg, state = pbench.build(settings, "cuda")
    if not torch.equal(state.positions, main_state.positions):
        raise RuntimeError("the bench twin's start is not phase 4's")
    dt_sub = pbench.DT / settings.substeps
    n_long = settings.substeps_per_call
    x = 10.0 ** (torch.rand(1 << 20, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
                 * 16.0 - 8.0)
    r_k, c_k = lc.approx_probe(x)
    rs_n, rs_ulp = approx_ulps(torch, r_k, torch.rsqrt(x))
    rc_n, rc_ulp = approx_ulps(torch, c_k, torch.reciprocal(x))
    print(f"# approx intrinsics on {x.numel()} floats in [1e-8, 1e8]: "
          f"rsqrtf vs torch.rsqrt differ in {rs_n} (bit for bit: "
          f"{rs_n == 0}; at most {rs_ulp} ulp), rcp.approx vs "
          f"torch.reciprocal in {rc_n} (at most {rc_ulp} ulp)")
    approx_run = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_long,
                                             approx_math=True)
    torch.cuda.synchronize()
    lc.launches = 0
    a_out = approx_run(state)
    torch.cuda.synchronize()
    approx_launches = lc.launches
    pbench.health(a_out.positions)
    drift = float((a_out.positions - main_plain.positions).abs().max())
    print(f"# B-1 approx_math at the bench workload: {n_long} substeps, "
          f"{approx_launches} launches, health ok; drift vs the exact "
          f"plain engine {drift:.3e} (gate {DRIFT_TOL}, bench.py's)")
    if approx_launches <= 0:
        raise RuntimeError("the approx path launched no kernel")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"B-1 approx drifts from the plain engine: "
                           f"{drift}")
    jitter = np.random.default_rng(0).normal(0.0, 0.05, (spec.n_particles, 3))
    start = a_out.replace(velocities=a_out.velocities + torch.as_tensor(
        jitter, dtype=torch.float32, device="cuda"))
    n_cmp = APPROX_PARITY_SUBSTEPS
    k16 = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_cmp,
                                      approx_math=True)(start)
    p16 = lat.run_substeps_plain(start, spec, cfg, dt_sub, n_cmp,
                                 approx_math=True)
    torch.cuda.synchronize()
    approx_err = float((k16.positions - p16.positions).abs().max())
    dlam = float((k16.lambda_dist - p16.lambda_dist).abs().max())
    dv = float((k16.velocities - p16.velocities).abs().max())
    print(f"# B-1 approx vs its twin, {n_cmp} substeps from the rested "
          f"state with jitter: max|dx|={approx_err:.3e} (gate "
          f"{APPROX_KERNEL_GATE}) max|dlam|={dlam:.3e} max|dv|={dv:.3e}; "
          f"equal to the bit: {torch.equal(k16.positions, p16.positions)}")
    if not (approx_err < APPROX_KERNEL_GATE and is_finite(k16)):
        raise RuntimeError(f"B-1 approx disagrees with its twin: "
                           f"{approx_err}")
    exact_run = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_long)
    times, _ = timed_windows(torch, {
        "exact": (lambda: exact_run(state), n_long),
        "approx": (lambda: approx_run(state), n_long)})
    ms_exact, ms_approx = min(times["exact"]), min(times["approx"])
    print(f"# B-1 ms/substep at res {settings.res} ({smi}), windows in "
          f"turns: exact {times['exact']}, approx {times['approx']}; best "
          f"exact {ms_exact:.5f}, approx {ms_approx:.5f} "
          f"({spec.n_particles / ms_approx * 1e3:.4e} "
          f"particle-substeps/s)")
    b1_designs(torch, lc, f"bench res {settings.res} approx_math", state,
               spec, cfg, dt_sub, n_long, smi, approx_math=True)

    # 34. B-3 approx on cloth_xl, from a loaded state (30 frames under
    # gravity, a poke out of the plane, 10 more frames)
    cstate, _, cinfo = scenes.cloth_xl(device="cuda")
    ctopo, ccfg, cdt = cinfo["topology"], cinfo["config"], cinfo["dt"]
    cdt_sub = cdt / ccfg.substeps
    loaded = mc.make_mesh_cuda_step(ctopo, ccfg, cdt, n_steps=30)(cstate)
    loaded = forces.add_force(loaded, (0.0, 100.0, 600.0),
                              loaded.positions.mean(0).tolist(), radius=0.4)
    loaded = mc.make_mesh_cuda_step(ctopo, ccfg, cdt, n_steps=10)(loaded)
    torch.cuda.synchronize()
    mc.launches = 0
    mk = mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub, n_cmp,
                                          approx_math=True)(loaded)
    torch.cuda.synchronize()
    mesh_approx_launches = mc.launches
    mp = general.run_substeps_plain(loaded, ctopo, ccfg, cdt_sub, n_cmp,
                                    approx_math=True)
    me = general.run_substeps_plain(loaded, ctopo, ccfg, cdt_sub, n_cmp)
    mesh_approx_err = float((mk.positions - mp.positions).abs().max())
    mdl = {k: float((getattr(mk, k) - getattr(mp, k)).abs().max())
           for k in ("lambda_dist", "lambda_bend")}
    print(f"# B-3 approx vs its twin at cloth_xl, {n_cmp} substeps from a "
          f"poked state: max|dx|={mesh_approx_err:.3e} max|dlam|="
          f"{mdl['lambda_dist']:.3e} max|dlam_bend|={mdl['lambda_bend']:.3e}"
          f" (gates {MESH_APPROX_GATES}, JAX's band), "
          f"{mesh_approx_launches} launches; vs the exact plain engine "
          f"max|dx|={float((mk.positions - me.positions).abs().max()):.3e}")
    if mesh_approx_launches <= 0:
        raise RuntimeError("the mesh approx path launched no kernel")
    if not (mesh_approx_err < MESH_APPROX_GATES[0] and is_finite(mk)
            and max(mdl.values()) < MESH_APPROX_GATES[1]):
        raise RuntimeError(f"B-3 approx disagrees with its twin: "
                           f"{mesh_approx_err} {mdl}")
    n_m = 500
    m_exact = mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub, n_m)
    m_approx = mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub, n_m,
                                                approx_math=True)
    mtimes, _ = timed_windows(torch, {
        "exact": (lambda: m_exact(loaded), n_m),
        "approx": (lambda: m_approx(loaded), n_m)})
    print(f"# B-3 ms/substep at cloth_xl ({smi}), windows in turns: exact "
          f"{mtimes['exact']}, approx {mtimes['approx']}")
    b3_designs(torch, mc, cc, "cloth_xl approx_math", loaded, ctopo, ccfg,
               cdt_sub, n_m, smi, approx_math=True)

    # 35. the hybrid contact runner at the 64k contact-cadence config
    spacing = 1.0 / (settings.res - 1)
    radius = 0.55 * spacing
    hcfg = SolverConfig(substeps=8, iterations=1, damping=0.02,
                        solve_mode=SolveMode.JACOBI,
                        lambda_mode=LambdaMode.RESET,
                        gravity_is_acceleration=True, fast_math=True,
                        enable_self_collision=True, particle_radius=radius,
                        self_collision_backend="blocked_pallas",
                        collision_block_size=128, block_neighbors=4,
                        self_collision_every=HYBRID_EVERY,
                        ground_height=0.0, friction=0.3)
    hstate = lat.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                    mass=0.001, device="cuda")
    dt_h = 1.0 / 480.0
    if lc.route(hcfg) != "hybrid":
        raise RuntimeError(f"the cadence config routes to {lc.route(hcfg)}")
    n_par = HYBRID_PARITY_SUBSTEPS
    h24 = lc.make_hybrid_contact_runner(spec, hcfg, dt_h, n_par)(hstate)
    p24 = lat.run_substeps_plain(hstate, spec, hcfg, dt_h, n_par)
    a24 = lc.make_hybrid_contact_runner(spec, hcfg, dt_h, n_par,
                                        approx_math=True)(hstate)
    torch.cuda.synchronize()
    hyb_gap = float((h24.positions - p24.positions).abs().max())
    hyb_approx = float((a24.positions - h24.positions).abs().max())
    print(f"# hybrid at the 64k contact cadence (res {settings.res}, "
          f"blocked_pallas B=128 M=4, every {HYBRID_EVERY}, radius "
          f"{radius:.5f}): exact vs the plain stencil cadence over {n_par}"
          f" substeps max|dx|={hyb_gap:.3e}, equal to the bit: "
          f"{torch.equal(h24.positions, p24.positions)}; approx vs exact "
          f"{hyb_approx:.3e} (gate {DRIFT_TOL})")
    if not (hyb_gap < DX_TOL and is_finite(h24)):
        raise RuntimeError(f"the hybrid disagrees with the plain cadence: "
                           f"{hyb_gap}")
    if not hyb_approx < DRIFT_TOL:
        raise RuntimeError(f"the approx hybrid drifts: {hyb_approx}")
    n_roll = HYBRID_ROLLOUT_SUBSTEPS
    hyb_runs = {}
    for name, approx in (("hybrid", False), ("hybrid_approx", True)):
        run = lc.make_hybrid_contact_runner(spec, hcfg, dt_h, n_roll,
                                            approx_math=approx)
        torch.cuda.synchronize()
        lc.launches = cc.launches = 0
        t0 = time.perf_counter()
        end = run(hstate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kl, cl = lc.launches, cc.launches
        ymin = float(end.positions[:, 1].min())
        print(f"# {name}: {n_roll} substeps in {wall:.3f} s wall, "
              f"{kl} B-1 and {cl} B-4 launches ({(kl + cl) / n_roll:.3f} a "
              f"substep), finite={is_finite(end)} min_y={ymin:.5f} (gate "
              f"> -{radius:.5f})")
        if kl <= 0 or cl <= 0:
            raise RuntimeError(f"{name} launched no B-1 or no B-4 kernel")
        if not (is_finite(end) and ymin > -radius):
            raise RuntimeError(f"{name} failed its health gates")
        hyb_runs[name] = (run, (kl + cl) / n_roll, end)
    plain_par = (lambda: lat.run_substeps_plain(hstate, spec, hcfg, dt_h,
                                                n_par), n_par)
    htimes, _ = timed_windows(torch, {
        "hybrid": (lambda: hyb_runs["hybrid"][0](hstate), n_roll),
        "hybrid_approx": (lambda: hyb_runs["hybrid_approx"][0](hstate),
                          n_roll),
        "plain": plain_par})
    print(f"# hybrid ms/substep ({smi}), windows in turns: "
          + "; ".join(f"{k} {v}" for k, v in htimes.items()))
    # B-4's two designs on the hybrid's contact pass, at its rested state
    hend = hyb_runs["hybrid"][2]
    b4_designs(torch, cc, spatial_hash, f"64k hybrid after {n_roll} "
               f"substeps", hend.positions, hend.inv_mass, hcfg, smi,
               profile=True)

    # 36. example 4 (hash self-collision, the general engine) on the card
    topo4, cfg4, st4 = ex4.scene(device="cpu")
    step4 = general.make_step(topo4, cfg4, 1 / 60)
    card, cpu = st4.to("cuda"), st4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EX4_FRAMES):
        card = step4(card)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(EX4_FRAMES):
        cpu = step4(cpu)
    t_cpu = time.perf_counter() - t0
    ex4_gap = float((card.positions.cpu() - cpu.positions).abs().max())
    pred, w = card.positions, card.inv_mass
    scfg = cfg4.replace(self_collision_backend="sorted")
    spatial_hash.self_collision_project(pred, w, cfg4)
    spatial_hash.self_collision_project_sorted(
        pred, w, spatial_hash.morton_order(pred, scfg), scfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spatial_hash.self_collision_project(pred, w, cfg4)
        spatial_hash.self_collision_project_sorted(
            pred, w, spatial_hash.morton_order(pred, scfg), scfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"# example 4 (hash, route {step4.route}) on the card: "
          f"{EX4_FRAMES} frames before its first poke, "
          f"{t_card / EX4_FRAMES * 1e3:.3f} ms/frame (CPU "
          f"{t_cpu / EX4_FRAMES * 1e3:.3f}), max|dx| card vs CPU "
          f"{ex4_gap:.3e} (gate {EX4_GATE}), finite={is_finite(card)}; the "
          f"hash and sorted passes and the curve order ran under "
          f"sync_debug_mode('error')")
    if not (ex4_gap < EX4_GATE and is_finite(card)):
        raise RuntimeError(f"example 4 on the card parts from the CPU: "
                           f"{ex4_gap}")

    # 37. the twins: entry() once on the card against the CPU, and the
    # bench twin's main() (its JSON line)
    fn, (est,) = pentry.entry()
    fn_c, (est_c,) = pentry.entry("cpu")
    e_gap = float((fn(est).positions.cpu() - fn_c(est_c).positions)
                  .abs().max())
    print(f"# entry(): one res-16 frame on the card vs the CPU, max|dx| "
          f"{e_gap:.3e} (gate {DX_TOL})")
    if not e_gap < DX_TOL:
        raise RuntimeError(f"entry() on the card parts from the CPU: "
                           f"{e_gap}")
    if pbench.main(dataclasses.replace(settings, seconds=2.0)) != 0:
        raise RuntimeError("the bench twin failed")

    return {
        "lattice": {"approx_max_abs_err": approx_err,
                    "approx_ms": ms_approx, "approx_exact_ms": ms_exact,
                    "approx_launches": approx_launches,
                    "hybrid_ms": min(htimes["hybrid"]),
                    "hybrid_approx_ms": min(htimes["hybrid_approx"]),
                    "hybrid_plain_ms": min(htimes["plain"]),
                    "hybrid_launches_per_substep":
                        hyb_runs["hybrid"][1],
                    "hybrid_max_abs_err": hyb_gap},
        "mesh": {"approx_max_abs_err": mesh_approx_err,
                 "approx_ms": min(mtimes["approx"]),
                 "approx_exact_ms": min(mtimes["exact"])},
        "profile": [(lc.make_hybrid_contact_runner(spec, hcfg, dt_h, 64),
                     hstate)],
    }


# phase 39: the inflated ball of examples/config3_inflated_ball.py at full
# width, icosphere(5, 0.4): 10,242 particles, 30,720 edges, 20,480
# triangles
BALL_SUBDIV = 5
BALL_FRAMES = 240
# the pressurized farm: phase 30's farm with example 3's volume settings
VOLUME_FARM_ROWS = (0, FARM_BODIES - 1)
# phase 40: examples 1, 2, 3 and 9 at the JAX tests' cuts
# (tests/test_examples.py:18-45, :99-108), card against CPU, gated as
# tests/test_torch_examples.py gates the port against JAX: within
# EXAMPLE_TOL, or 3x the card's own spread under a one-ulp nudge of the
# positions before every frame where a scene amplifies rounding (example
# 3's ball rolls off the top of its collider: one ulp at the start grows
# to about 1e-3 by frame 200)
EXAMPLE_CUTS = {"config1_cube_drop": dict(res=4, steps=150),
                "config2_icosphere_pinned": dict(subdivisions=1, steps=150),
                "config3_inflated_ball": dict(subdivisions=1, steps=200),
                "config9_tet_solid": dict(res=4, steps=120)}
EXAMPLE_TOL = 1e-5
VOLUME_LEAVES = ("positions", "velocities", "lambda_dist", "lambda_bend",
                 "lambda_volume", "lambda_tet")


def volume_leaf_diffs(out, ref):
    return {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
            if getattr(ref, k) is not None and getattr(ref, k).numel()
            else 0.0 for k in VOLUME_LEAVES}


def volume_rows_differ(torch, out, rows):
    """The (body, leaf) pairs where the ensemble's ``out`` differs from
    ``rows`` (body -> the single-body kernel's result); a leaf the
    ensemble does not carry (``lambda_tet`` without tets) is skipped."""
    return [(b, k) for b, row in rows.items() for k in VOLUME_LEAVES
            if getattr(out, k) is not None
            and not torch.equal(getattr(out, k)[b], getattr(row, k))]


def body_volumes(torch, positions, triangles):
    """The enclosed volume of every body of a (B, N, 3) or (N, 3)
    tensor."""
    from softbodysimulation_tpu_torch.ops.volume import enclosed_volume

    p = positions if positions.ndim == 3 else positions[None]
    return torch.stack([enclosed_volume(b, triangles) for b in p])


def volume_phases(torch, np, smi, is_finite):
    """Phases 38-40: B-3's global volume constraint against its plain twin
    on every case of ``tests/test_torch_volume_cases.py``, the full-width
    inflated ball and the pressurized farm, and examples 1, 2, 3 and 9 on
    the card against the CPU.  Returns the kernels line's new fields of
    B-3 ("mesh") and the runs ``--profile`` traces ("profile")."""
    import test_torch_volume_cases as V

    from softbodysimulation_tpu_torch import (state_from_numpy,
                                              state_from_topology)
    from softbodysimulation_tpu_torch.core.state import body_of
    from softbodysimulation_tpu_torch.examples import (
        config1_cube_drop, config2_icosphere_pinned, config3_inflated_ball,
        config9_tet_solid)
    from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.solvers import general
    from softbodysimulation_tpu_torch.topology import build, mesh

    # 38. B-3 with the volume against its twin, one body and ensembles
    t0 = time.perf_counter()
    vol_err, n_exact = 0.0, 0
    for name in V.volume_cases():
        cfg, topo, fields, nb, frames = V.case_inputs(name)
        st = state_from_numpy(fields, device="cuda")
        one = mc.make_mesh_cuda_step(topo, cfg, V.DT, n_steps=frames)
        torch.cuda.synchronize()
        mc.launches = 0
        if nb == 1:
            out = one(st)
            ref = general.multi_step_fn(st, topo, cfg, V.DT, frames)
        else:
            out = general.make_batched_step(topo, cfg, V.DT, frames)(st)
            ref = general.run_substeps_plain_batched(
                st, topo, cfg, V.DT / cfg.substeps, frames * cfg.substeps,
                with_ext=True)
        torch.cuda.synchronize()
        launched = mc.launches
        d = volume_leaf_diffs(out, ref)
        bits = all(v == 0.0 for v in d.values())
        must = V.card_exact(cfg)
        n_exact += must
        lam_v = float(out.lambda_volume.abs().min())
        gate = V.dx_gate(cfg) if must else V.DX_CARD_CONTACT
        print(f"# B-3 volume {name} x {nb}: max|dx|={d['positions']:.3e} "
              f"max|dlam_v|={d['lambda_volume']:.3e} (min|lam_v| "
              f"{lam_v:.3e}) max|dlam|={d['lambda_dist']:.3e} max|dlam_t|="
              f"{d['lambda_tet']:.3e}; bit for bit {bits} (required: "
              f"{must}; else |dx| < {gate}); {launched} launches over "
              f"{frames * cfg.substeps} substeps")
        if not (is_finite(out) and d["positions"] < gate
                and d["lambda_volume"] < V.DLAM_VOLUME and lam_v > 0
                and launched > 0 and (bits or not must)):
            raise RuntimeError(f"B-3 volume {name} disagrees with plain: {d}")
        vol_err = max(vol_err, d["positions"])
        if nb > 1:
            mc.launches = 0
            rows = [one(body_of(st, b)) for b in range(nb)]
            bad = volume_rows_differ(torch, out, dict(enumerate(rows)))
            print(f"# B-3 volume {name}: rows equal to the single-body "
                  f"kernel to the bit: {not bad}; launches {launched} vs "
                  f"{mc.launches // nb} for one body")
            if bad or launched != mc.launches // nb:
                raise RuntimeError(f"B-3 volume ensemble {name}: rows {bad}")
            try:
                general.make_batched_step(topo, cfg, V.DT, 1)(
                    st.replace(lambda_volume=st.lambda_volume[0]))
            except ValueError as err:
                if "lambda_volume" not in str(err):
                    raise
            else:
                raise RuntimeError("a shared scalar lambda_volume ran in a "
                                   "volume ensemble")
    print(f"# phase 38: {len(V.volume_cases())} cases in "
          f"{time.perf_counter() - t0:.1f} s; the {n_exact} without dense "
          f"contact bit for bit")

    # 39. the inflated ball at full width: 240 frames through B-3
    m = mesh.icosphere(BALL_SUBDIV, radius=0.4)
    pos, btopo = build.topology_from_mesh(m, compliance=5e-4, bending=False)
    pos = pos + np.array([0.1, 2.0, 0.0], np.float32)
    bcfg = config3_inflated_ball.config()
    bstart = state_from_topology(btopo, pos, device="cuda")
    bstep = general.make_step(btopo, bcfg, 1 / 60)
    bdt_sub = 1 / 60 / bcfg.substeps
    n_sub = BALL_FRAMES * bcfg.substeps
    tri = btopo.triangles.to("cuda")
    v0 = float(btopo.rest_volume)

    def ball_rollout(st, step):
        at120 = None
        for frame in range(BALL_FRAMES):
            if frame == BALL_FRAMES // 2:
                at120 = st
            st = step(st)
        return st, at120

    torch.cuda.synchronize()
    mc.launches = 0
    t1 = time.perf_counter()
    ball, at120 = ball_rollout(bstart, bstep)
    torch.cuda.synchronize()
    ball_wall = time.perf_counter() - t1
    ball_launches = mc.launches
    ratio = float(body_volumes(torch, ball.positions, tri)[0]) / v0
    rmin = float(torch.linalg.norm(ball.positions, dim=1).min())
    print(f"# inflated ball: icosphere({BALL_SUBDIV}, 0.4), "
          f"{btopo.n_particles} particles, {btopo.n_edges} edges, "
          f"{btopo.triangles.shape[0]} triangles, {BALL_FRAMES} frames x "
          f"{bcfg.substeps} substeps in {ball_wall:.3f} s wall, "
          f"{ball_launches} launches ({ball_launches / n_sub:.3f} a "
          f"substep); finite={is_finite(ball)} V/V0={ratio:.4f} (target "
          f"{bcfg.pressure}) min distance to the collider centre "
          f"{rmin:.4f} (radius 0.8) lambda_volume "
          f"{float(ball.lambda_volume):.4e}")
    if not (is_finite(ball) and ratio > 1.05 and rmin > 0.75
            and ball_launches > 0):
        raise RuntimeError("the inflated ball failed its health gates")
    gates = (V.DX, 1e-6, 5e-6)
    d = volume_leaf_diffs(
        mc.make_mesh_cuda_substep_runner(btopo, bcfg, bdt_sub, 16)(at120),
        general.run_substeps_plain(at120, btopo, bcfg, bdt_sub, 16))
    print(f"# inflated ball parity from frame {BALL_FRAMES // 2}, 16 "
          f"substeps: max|dx|={d['positions']:.3e} max|dlam|="
          f"{d['lambda_dist']:.3e} max|dlam_v|={d['lambda_volume']:.3e}")
    if not (d["positions"] < gates[0] and d["lambda_dist"] < gates[1]
            and d["lambda_volume"] < V.DLAM_VOLUME):
        raise RuntimeError(f"inflated ball: kernel parts from plain: {d}")
    vol_err = max(vol_err, d["positions"])

    def plain_step(st):
        return general.step_fn(st, btopo, bcfg, 1 / 60)

    plain, _ = ball_rollout(bstart, plain_step)
    drift = float((ball.positions - plain.positions).abs().max())
    print(f"# inflated ball drift vs plain, {BALL_FRAMES} frames from the "
          f"same start: {drift:.3e} (gate {DRIFT_TOL})")
    if not drift < DRIFT_TOL:
        raise RuntimeError(f"inflated ball drifts from plain: {drift}")
    vol_err = max(vol_err, drift)
    n_k, n_p = 400, 20
    k_ball = mc.make_mesh_cuda_substep_runner(btopo, bcfg, bdt_sub, n_k)
    btimes, breps = timed_windows(torch, {
        "plain": (lambda: general.run_substeps_plain(
            at120, btopo, bcfg, bdt_sub, n_p), n_p),
        "kernel": (lambda: k_ball(at120), n_k)})
    ball_bound = bound_ms(*mesh_work(btopo, bcfg))
    b3_designs(torch, mc, cc, f"inflated ball ({btopo.n_particles})", at120,
               btopo, bcfg, bdt_sub, n_k, smi)
    nb_ = btopo.n_particles
    print(f"# inflated ball ({smi}): kernel "
          f"{min(btimes['kernel']):.5f} ms/substep = "
          f"{nb_ / min(btimes['kernel']) * 1e3:.4e} particle-substeps/s, "
          f"plain {min(btimes['plain']):.5f} ms/substep (windows in turn "
          f"order: kernel {btimes['kernel']}, plain {btimes['plain']}); "
          f"bound {ball_bound[0]:.5f} ms ({ball_bound[1]}), kernel at "
          f"{min(btimes['kernel']) / ball_bound[0]:.1f}x")

    # the pressurized farm: 32 x icosphere(4, 0.5), a (32,) lambda_volume
    ftopo, fcfg, fstate, _ = diff_scene(torch, "cuda")
    vcfg = fcfg.replace(enable_volume=True, pressure=bcfg.pressure,
                        volume_compliance=0.0)
    farm = farm_state(torch, np, fstate, FARM_BODIES, (4.0, 2.0)).replace(
        lambda_volume=torch.zeros(FARM_BODIES, device="cuda"))
    fdt_sub = 1 / 60 / vcfg.substeps
    f_sub = FARM_FRAMES * vcfg.substeps
    torch.cuda.synchronize()
    mc.launches = 0
    t1 = time.perf_counter()
    fout = general.make_batched_step(ftopo, vcfg, 1 / 60, FARM_FRAMES)(farm)
    torch.cuda.synchronize()
    farm_wall = time.perf_counter() - t1
    farm_launches = mc.launches
    ratios = body_volumes(torch, fout.positions,
                          ftopo.triangles.to("cuda")) / float(
                              ftopo.rest_volume)
    single = mc.make_mesh_cuda_step(ftopo, vcfg, 1 / 60, FARM_FRAMES)
    mc.launches = 0
    rows = {b: single(body_of(farm, b)) for b in VOLUME_FARM_ROWS}
    one_launches = mc.launches // len(rows)
    bad = volume_rows_differ(torch, fout, rows)
    drift = max(float((fout.positions[b] - general.run_substeps_plain(
        body_of(farm, b), ftopo, vcfg, fdt_sub, f_sub,
        with_ext=True).positions).abs().max()) for b in VOLUME_FARM_ROWS)
    print(f"# pressurized farm: {FARM_BODIES} x {ftopo.n_particles} "
          f"particles ({ftopo.triangles.shape[0]} triangles each), "
          f"{FARM_FRAMES} frames x {vcfg.substeps} substeps in "
          f"{farm_wall:.3f} s wall, {farm_launches} launches (one body: "
          f"{one_launches}); finite={is_finite(fout)} V/V0 "
          f"{float(ratios.min()):.4f}-{float(ratios.max()):.4f} min|lam_v| "
          f"{float(fout.lambda_volume.abs().min()):.4e}; rows "
          f"{list(VOLUME_FARM_ROWS)} equal to the single-body kernel to the "
          f"bit: {not bad}; drift vs plain on them {drift:.3e} (gate "
          f"{DRIFT_TOL})")
    if not (is_finite(fout) and float(ratios.min()) > 1.05 and not bad
            and farm_launches == one_launches and drift < DRIFT_TOL
            and float(fout.lambda_volume.abs().min()) > 0):
        raise RuntimeError("the pressurized farm failed its gates")
    vol_err = max(vol_err, drift)
    k_farm = mc.make_mesh_cuda_substep_runner(ftopo, vcfg, fdt_sub, 40,
                                              n_bodies=FARM_BODIES)
    ftimes, _ = timed_windows(torch, {
        "plain": (lambda: general.run_substeps_plain_batched(
            fout, ftopo, vcfg, fdt_sub, 2), 2),
        "ensemble": (lambda: k_farm(fout), 40)}, min_s=0.5)
    farm_bound = bound_ms(*mesh_work(ftopo, vcfg, bodies=FARM_BODIES))
    b3_designs(torch, mc, cc, f"pressurized farm ({FARM_BODIES} x "
               f"{ftopo.n_particles})", fout, ftopo, vcfg, fdt_sub, 40, smi,
               batched=True)
    print(f"# pressurized farm ({smi}): ensemble "
          f"{min(ftimes['ensemble']):.5f} ms/substep, plain twin "
          f"{min(ftimes['plain']):.5f} (windows in turn order: "
          f"{ftimes}); bound {farm_bound[0]:.5f} ms ({farm_bound[1]}), "
          f"{min(ftimes['ensemble']) / farm_bound[0]:.1f}x")

    # 40. examples 1, 2, 3 and 9 on the card against the CPU
    def nudged(make_step):
        """``make_step`` whose stepper moves every coordinate one ulp up
        before each frame."""
        def make(topo, cfg, dt, n_steps=1):
            step = make_step(topo, cfg, dt, n_steps=1)

            def fn(st):
                for _ in range(n_steps):
                    st = step(st.replace(positions=torch.nextafter(
                        st.positions, torch.full_like(st.positions,
                                                      math.inf))))
                return st
            return fn
        return make

    def positions(result):
        return (result[0] if isinstance(result, tuple) else result).positions

    for name, kw in EXAMPLE_CUTS.items():
        mod = {"config1_cube_drop": config1_cube_drop,
               "config2_icosphere_pinned": config2_icosphere_pinned,
               "config3_inflated_ball": config3_inflated_ball,
               "config9_tet_solid": config9_tet_solid}[name]
        t1 = time.perf_counter()
        card = mod.run(verbose=False, device="cuda", **kw)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t1
        t1 = time.perf_counter()
        cpu = mod.run(verbose=False, device="cpu", **kw)
        t_cpu = time.perf_counter() - t1
        engine = (mod.lat_engine if name == "config1_cube_drop"
                  else mod.general)
        make_step = engine.make_step
        engine.make_step = nudged(make_step)
        try:
            spread = float((positions(mod.run(verbose=False, device="cuda",
                                              **kw))
                            - positions(card)).abs().max())
        finally:
            engine.make_step = make_step
        gate = max(EXAMPLE_TOL, 3.0 * spread)
        card_pos = positions(card)
        gap = float((card_pos.cpu() - positions(cpu)).abs().max())
        y = card_pos[:, 1]
        print(f"# example {name} {kw}: card {t_card:.3f} s (CPU "
              f"{t_cpu:.3f} s), max|dx| card vs CPU {gap:.3e} (gate "
              f"{gate:.3e}: the card nudged one ulp a frame parts from "
              f"itself by {spread:.3e}), finite="
              f"{bool(torch.isfinite(card_pos).all())} ymin="
              f"{float(y.min()):.4f} ymax={float(y.max()):.4f}")
        if not (gap < gate and bool(torch.isfinite(card_pos).all())):
            raise RuntimeError(f"example {name} on the card parts from the "
                               f"CPU: {gap}")

    return {
        "mesh": {"volume_max_abs_err": vol_err,
                 "volume_ms": min(btimes["kernel"]),
                 "volume_plain_ms": min(btimes["plain"]),
                 "volume_bound_ms": ball_bound[0],
                 "volume_bound_by": ball_bound[1],
                 "volume_launches": ball_launches,
                 "volume_farm_ms": min(ftimes["ensemble"]),
                 "volume_farm_plain_ms": min(ftimes["plain"]),
                 "volume_farm_bound_ms": farm_bound[0]},
        "profile": [(k_ball, at120), (k_farm, fout)],
    }


def main() -> int:
    if "--f64-witness" in sys.argv[1:]:
        return f64_witness()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a "
              "GPU", file=sys.stderr)
        return 1
    if "--b3-profile" in sys.argv[1:]:
        return b3_profile(torch)
    # phase 19's float64 witness runs on the CPU, in a process of its own,
    # while the card works
    witness = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--f64-witness"],
        stdout=subprocess.PIPE, text=True)
    try:
        return smoke(torch, witness)
    finally:
        if witness.poll() is None:
            witness.kill()
        witness.wait()


def smoke(torch, witness) -> int:
    """Phases 1-41 (module docstring)."""
    sys.path.insert(0, HERE)
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_cases as lattice_cases
    import test_torch_contact_cases as contact_cases
    import test_torch_mesh_cases as mesh_cases

    from softbodysimulation_tpu_torch.core import config as C
    from softbodysimulation_tpu_torch.core import scenes
    from softbodysimulation_tpu_torch.interact import forces
    from softbodysimulation_tpu_torch.kernels import _build
    from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
    from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
    from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
    from softbodysimulation_tpu_torch.kernels import spatial_cuda as sc
    from softbodysimulation_tpu_torch.solvers import general
    from softbodysimulation_tpu_torch.solvers import lattice as lat
    from softbodysimulation_tpu_torch.topology import lattice as top
    from softbodysimulation_tpu_torch import is_finite, state_from_numpy

    # 1. the card
    t_run = time.perf_counter()

    def lap(phases):
        print(f"# time: phases {phases} done at "
              f"{time.perf_counter() - t_run:.1f} s")

    smi = smi_line()
    print(f"# gpu: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build: one nvcc per library, started together (the mesh library
    # holds the mesh, contact and B-5 sources)
    with ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(timed_build, _build, m.LIB_NAME, m.SOURCES,
                              m.NVCC_EXTRA) for m in (lc, mc, cc, sc)]
        lattice_build, mesh_build, contact_build, spatial_build = (
            b.result() for b in builds)
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
    if main_launches != 1:
        raise RuntimeError(f"the main path took {main_launches} launches "
                           f"for one call, not the persistent kernel's 1")
    plain = lat.run_substeps_plain(state, spec, cfg, dt_sub, MAIN_SUBSTEPS)
    # phase 33 holds B-1's approx_math to this exact rollout
    main_state, main_plain = state, plain
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
    for approx in (False, True):
        a, b = (lc.run_substeps_cuda(start, spec, cfg, dt_sub, n_cmp,
                                     approx_math=approx, design=d)
                for d in ("persistent", "per_pass"))
        same = all(torch.equal(getattr(a, k), getattr(b, k)) for k in
                   ("positions", "velocities", "lambda_dist"))
        print(f"# bench res {RES_MAIN}, approx_math={approx}: the "
              f"persistent kernel equals the per-pass loop to the bit over "
              f"{n_cmp} substeps: {same}")
        if not same:
            raise RuntimeError("B-1's persistent kernel parts from its "
                               "per-pass loop")

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
    entry_launches = lc.launches - before
    print(f"# entry: res 16 WARM_START, 60 frames x 4 substeps, "
          f"{entry_launches} launches ({entry_launches / 120:.3f} a call "
          f"of one frame), finite={ok_entry}, "
          f"poke moved the COM by {shift:.4f} vs the unpoked run")
    if entry_launches != 120:
        raise RuntimeError("the entry step is not one launch a call")
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

    b1_designs(torch, lc, "entry res 16 (one frame a call)", poked, espec,
               ecfg, 1 / 60 / ecfg.substeps, ecfg.substeps, smi,
               with_ext=True)

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

    bench_designs = b1_designs(torch, lc, f"bench res {RES_MAIN}", state,
                               spec, cfg, dt_sub, n_k, smi, min_s=1.0)

    lap("1-6")

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
    cloth_designs = b3_designs(torch, mc, cc, "cloth_xl", cstate, ctopo,
                               ccfg, cdt_sub, n_k, smi)

    lap("7-10")

    # 11-16. the multi-body contact path
    contact = contact_phases(torch, np, contact_build, contact_cases, cc, mc,
                             general, scenes, is_finite, state_from_numpy,
                             smi, mask_flips)

    lap("11-16")

    # 17-20. the differentiable path
    diff = diff_phases(torch, mesh_build, smi, witness)
    lap("17-20")

    # 21-25. the spatial path and the solid lattice
    spatial = spatial_phases(torch, np, spatial_build, lattice_build, smi,
                             is_finite, state_from_numpy, ms_k)
    lap("21-25")

    # 26-28. the kinematic rigid world in B-1, B-3 and B-5
    coll = collider_phases(torch, np, smi, is_finite)
    lap("26-28")

    # 29-32. ensembles in B-1 and B-3
    ensembles = ensemble_phases(torch, np, smi, is_finite)
    lap("29-32")

    # 33-37. approx_math, the lattice hybrid, hash on the card, the twins
    cadence = cadence_phases(torch, np, smi, is_finite, main_state,
                             main_plain)
    lap("33-37")

    # 38-40. the global volume constraint in B-3, examples 1, 2, 3 and 9
    volume = volume_phases(torch, np, smi, is_finite)
    lap("38-40")

    # 41. B-1's barriers: the block / grid crossover, grid sizes, and the
    # designs beyond L2
    barriers = barrier_phase(torch, lc, lat, top, cfg, smi)
    lap("41")

    # 42. B-3's persistent kernel against its per-pass loop, to the bit
    b3_checked = b3_phase(torch, mc, general, smi)
    lap("42")

    if "--profile" in sys.argv[1:]:
        profile_main_path(
            torch, lc.make_cuda_substep_runner(spec, cfg, dt_sub, 200),
            state)
        profile_main_path(
            torch, mc.make_mesh_cuda_substep_runner(ctopo, ccfg, cdt_sub,
                                                    200), cstate)
        for run, st in (contact["profile"] + diff["profile"]
                        + spatial["profile"] + ensembles["profile"]
                        + cadence["profile"] + volume["profile"]):
            profile_main_path(torch, run, st)
        for show in LATE_PROFILES:
            show()

    lat_bound = bound_ms(*lattice_work(spec, cfg))
    mesh_bound = bound_ms(*mesh_work(ctopo, ccfg))
    print(json.dumps({"kernels": [{
        "name": "lattice_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/lattice_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/lattice_pallas.py:501",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": lat_bound[0],
        "bound_by": lat_bound[1],
        "library_ms": None,
        # whether the main path (phase 4) ran the tet sweep; the sweep's own
        # launches (solid_lattice, phase 23) and parity (phases 22-23)
        "with_tets": cfg.enable_tet_volume,
        "tet_launches": spatial["tet_launches"],
        "tet_max_abs_err": spatial["tet_err"],
        # the rigid world (phase 26): parity with a ColliderSet and with
        # boxes, and ms per substep of the sweep config with and without
        "kin_max_abs_err": coll["lattice"]["kin_err"],
        "box_max_abs_err": coll["lattice"]["box_err"],
        "sweep_ms_poses": coll["lattice"]["ms_poses"],
        "sweep_ms_no_poses": coll["lattice"]["ms_bare"],
        # approx_math at the bench workload and the hybrid contact runner
        # at the 64k cadence config (phases 33, 35)
        **cadence["lattice"],
        # the persistent design (one launch a call) against the per-pass
        # loop it replaced, at phase 6's shape and every other timed shape,
        # and its barriers (phase 41)
        "design": "persistent",
        "barrier": bench_designs["barrier"],
        "per_pass_ms": bench_designs["per_pass_ms"],
        "persistent_ms": bench_designs["ms"],
        "designs": B1_DESIGNS,
        **barriers,
    }, {
        "name": "mesh_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/mesh_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/mesh_pallas.py:789",
        "launches": mesh_launches,
        "max_abs_err": mesh_err,
        "ms": ms_mk,
        "plain_ms": ms_mp,
        "bound_ms": mesh_bound[0],
        "bound_by": mesh_bound[1],
        "library_ms": None,
        # the rigid world (phase 27), and cloth_xl with a kinematic sphere
        "kin_max_abs_err": coll["mesh"]["kin_err"],
        "box_max_abs_err": coll["mesh"]["box_err"],
        "kin_sweep_ms": coll["mesh"]["ms"],
        "kin_sweep_plain_ms": coll["mesh"]["plain_ms"],
        # approx_math at cloth_xl (phase 34)
        **cadence["mesh"],
        # the global volume constraint (phases 38-39): parity, the
        # full-width inflated ball's ms per substep, launches and bound,
        # the pressurized farm's
        **volume["mesh"],
        # the persistent design (one launch a contact-free stretch) against
        # the per-pass loop it replaced, at cloth_xl (phase 10) and at every
        # other path timed in turns, with launches a call and a substep of
        # both; the 20k ball-on-cloth's particle passes (per-pass loop,
        # phase 16) by the rows they sum, us each; the configurations held
        # to the bit between the designs (phase 42)
        "design": "persistent",
        "per_pass_ms": cloth_designs["per_pass_ms"],
        "persistent_ms": cloth_designs["ms"],
        "launches_per_call": cloth_designs["launches_per_call"],
        "per_pass_launches_per_call":
            cloth_designs["per_pass_launches_per_call"],
        "particle_pass_us_20k": contact["particle_us"],
        "designs": B3_DESIGNS,
        "designs_bit_equal_configs": b3_checked,
    }, {
        "name": "contact_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/contact_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/contact_pallas.py:132",
        "launches": contact["launches"],
        "max_abs_err": contact["max_abs_err"],
        # the standalone call at the 20k frame-90 state (set-up, the pass
        # and its apply), as plain_ms is timed
        "ms": contact["ms"],
        "plain_ms": contact["plain_ms"],
        # the pair tests the warp cull keeps, the touching pairs, the bytes
        "bound_ms": contact["bound"][0],
        "bound_by": contact["bound"][1],
        "library_ms": None,
        # the culled design (the main path) against the serial one it
        # replaced: every state timed in turns, the 20k substep with each,
        # launches of one contact substep in the mesh loop; *_loop_pass_ms
        # the mesh loop's pass alone (no set-up, no apply)
        "design": "culled",
        "serial_ms": contact["rec90"]["serial_call_ms"],
        "loop_pass_ms": contact["rec90"]["loop_pass_ms"],
        "serial_loop_pass_ms": contact["rec90"]["serial_loop_pass_ms"],
        "bound_ms_all_candidates":
            contact["rec90"]["bound_ms_all_candidates"],
        "pair_tests_after_cull": contact["rec90"]["pair_tests_after_cull"],
        "substep": contact["substep"],
        "loop_launches": contact["loop_launches"],
        "designs": B4_DESIGNS,
    }, {
        "name": "mesh_diff_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/mesh_diff_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/mesh_diff_pallas.py:188",
        "launches": diff["launches"],
        "max_abs_err": diff["max_abs_err"],
        "ms": diff["ms"],
        "plain_ms": diff["plain_ms"],
        "bound_ms": diff["bound"][0],
        "bound_by": diff["bound"][1],
        "library_ms": None,
        # the pose cotangents (phase 28): vs backward_chunk_plain, and ms
        # per 40-substep chunk with and without them
        "kin_grad_rel_err": coll["diff"]["kin_grad_rel_err"],
        "kin_chunk_ms": coll["diff"]["ms_kin"],
        "no_kin_chunk_ms": coll["diff"]["ms_bare"],
    }, {
        "name": "spatial_xpbd",
        "route": "cuda",
        "source": "softbodysimulation_tpu_torch/csrc/spatial_xpbd.cu",
        "replaces": "softbodysimulation_tpu/kernels/spatial_pallas.py:68",
        "launches": spatial["launches"],
        "max_abs_err": spatial["max_abs_err"],
        "ms": spatial["ms"],
        "plain_ms": spatial["plain_ms"],
        "bound_ms": spatial["bound"][0],
        "bound_by": spatial["bound"][1],
        "library_ms": None,
        "exchange_bytes_per_substep": spatial["exchange_bytes"],
    }] + ensembles["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
