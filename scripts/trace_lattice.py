"""Trace the port's lattice runner at a benchmark cell's shape on the card:
where the device idles, by the runner's spans, the B-1 kernel's barrier
wait, and what counting costs.

    python scripts/trace_lattice.py --cell lattice64k --out lattice_traces

For the cell's shape (``lattice64k``: ``bench.py`` ``build()``, 2,000
substeps a call; ``ensemble1024``: example 5's 1,024 bodies, 120 frames a
call) it warms up, then:

1. profiles ``--calls`` calls (each a call, then a synchronise) under
   ``diag.profiling.trace``, writes ``<out>/<cell>.trace.json`` and
   reports the device's idle time inside the window by the innermost host
   span open over it: the runner's ``sbs.lattice.*`` spans, this script's
   ``dispatch`` (the rest of a call) and ``sync``, ``between_calls``
   elsewhere; ``runner_idle_pct`` is the idle inside ``sbs.lattice.call``
   over the window;
2. counts ``--count-calls`` calls inside ``profiling.counting()``:
   ``barrier_wait_pct`` = 100 x wait cycles / resident cycles, and the
   barriers a warp crosses a call;
3. times the kernel and its counted twin a call with CUDA events, in
   turns (off, counted, counted, off) ``--rounds`` times.

Prints one JSON line, with the card's name and power limit.  Needs a
card; imports the port and ``portbench.trace`` (its interval
arithmetic), never JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.trace import Trace  # noqa: E402
from softbodysimulation_tpu_torch.diag import profiling  # noqa: E402
from softbodysimulation_tpu_torch.kernels import lattice_cuda  # noqa: E402

OWN = "trace_lattice."


def build(cell: str):
    """(call, state, substeps a call) of the cell's shape on the card."""
    if cell == "lattice64k":
        from softbodysimulation_tpu_torch import bench

        spec, cfg, state = bench.build(bench.Settings(), device="cuda")
        return (lattice_cuda.make_cuda_substep_runner(
            spec, cfg, bench.DT / cfg.substeps, 2000), state, 2000)
    if cell == "ensemble1024":
        from softbodysimulation_tpu_torch.examples import config5_batch_1024

        spec, cfg, state = config5_batch_1024.make_ensemble(device="cuda")
        return (lattice_cuda.make_cuda_step(spec, cfg, 1 / 60, n_steps=120,
                                            n_bodies=1024), state,
                120 * cfg.substeps)
    raise SystemExit(f"trace_lattice: no cell {cell!r}")


def own_span(name):
    return torch._C._profiler._RecordFunctionFast(OWN + name)


def idle_by_span(prof, calls: int) -> dict:
    """The window (first call's start to last call's end), the device's
    busy union, and its idle seconds by innermost span."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            ops.append((e.name, s, t))
        elif e.name.startswith(profiling.SPAN_PREFIX):
            spans.append((e.name[len(profiling.SPAN_PREFIX):], s, t))
        elif e.name.startswith(OWN):
            spans.append((e.name[len(OWN):], s, t))
    own = [(s, t) for n, s, t in spans if n in ("dispatch", "sync")]
    window = (min(s for s, _ in own), max(t for _, t in own))
    tr = Trace(window, calls, ops, spans)
    gaps = dict(tr.idle_gaps(k=100))
    runner = sum(v for n, v in gaps.items() if n.startswith("lattice."))
    return {
        "window_s": tr.window_s, "busy_s": tr.busy_s,
        "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
        "idle_s": gaps,
        "runner_idle_pct": 100.0 * runner / tr.window_s,
        "dispatch_idle_pct": 100.0 * (runner + gaps.get("dispatch", 0.0))
        / tr.window_s,
        "kernel_s_per_call": tr.device_time("lattice_persistent_kernel")
        / calls,
        "device_span_events": sorted({n for n, _, _ in ops
                                      if n.startswith(profiling.SPAN_PREFIX)
                                      or n.startswith(OWN)}),
        "lattice_kernels": sorted({n for n, _, _ in ops if "lattice_" in n
                                   and "kernel" in n}),
    }


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(), "smi": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--count-calls", type=int, default=4)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default="lattice_traces")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_lattice: needs a CUDA device", file=sys.stderr)
        return 2
    call, state, subs = build(a.cell)
    for _ in range(2):
        state = call(state)
    torch.cuda.synchronize()

    out_dir = Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{a.cell}.trace.json"
    with profiling.trace(path) as prof:
        for _ in range(a.calls):
            with own_span("dispatch"):
                state = call(state)
            with own_span("sync"):
                torch.cuda.synchronize()
    traced = idle_by_span(prof, a.calls)

    profiling.counts()
    with profiling.counting():
        for _ in range(a.count_calls):
            state = call(state)
    got = profiling.counts()
    counted = dict(got, barrier_wait_pct=100.0 * got["wait_cycles"]
                   / got["resident_cycles"],
                   barriers_per_warp_call=got["barriers"] / got["warps"])

    def timed(count: bool) -> float:
        nonlocal state
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        if count:
            with profiling.counting():
                state = call(state)
        else:
            state = call(state)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    off_ms, on_ms = [], []
    for _ in range(a.rounds):
        off_ms.append(timed(False))
        on_ms.append(timed(True))
        on_ms.append(timed(True))
        off_ms.append(timed(False))
    profiling.counts()
    result = {"cell": a.cell, "card": card(), "substeps_per_call": subs,
              "trace_file": str(path), "traced": traced,
              "counted": counted,
              "call_ms": {"off": off_ms, "counted": on_ms,
                          "off_median": statistics.median(off_ms),
                          "counted_median": statistics.median(on_ms)}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
