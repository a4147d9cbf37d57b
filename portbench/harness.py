"""One run of one cell: set-up, the measured window, the traced slice, and
the comparison with the plain reference that decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in ``BENCHMARK.json``:
``<configs[].file>`` (sizes, solver settings, the pose, and the system
that drives it), ``traffic/<traffic>.json`` (the calls),
``limits/<cell>.json`` (the numbers compared and their limits),
``metrics/<metric>.py`` (the reader of one metric), and
``systems/<system>.py`` (the system's leaves, its inputs from the seed,
its health gate, its cut to a CPU test's size, how the program is built
and driven, and how the reference follows it: ``systems/lattice.py``
lists what a system file gives).

A call of a cell is the step (the timed path's entry), the system's
health gate queued behind it on the device, and a synchronise.  The
window runs calls, one caller in a closed loop, until ``seconds`` have
passed, and ends at the end of a call.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import check, generate
from .trace import SPAN_PREFIX, WINDOW, Trace, from_profiler

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(kind: str, name: str) -> Dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def _load(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded once as
    ``portbench.<kind>.<name>`` (dots in ``name`` become ``__``)."""
    mod_name = f"portbench.{kind}.{name.replace('.', '__')}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod_name, HERE / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def load_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def load_system(name: str):
    """The module ``systems/<name>.py``."""
    return _load("systems", name)


@dataclasses.dataclass
class Run:
    """What one run records, for the metric readers.  Times in seconds;
    ``call_s`` holds one entry a completed call of the window."""

    config: Dict
    particles: int
    substeps_per_call: int
    with_ext: bool
    setup_s: float = 0.0
    scene_build_s: float = 0.0
    window_s: float = 0.0
    call_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None


@dataclasses.dataclass
class Compared:
    """A call whose answer the reference checks: the leaves it started
    from (None: the generator's start) and those it produced."""

    inp: Optional[Dict[str, torch.Tensor]]
    out: Dict[str, torch.Tensor]


def cell_files(bench: Dict, cell_name: str):
    """(cell, configuration, traffic, limits) of ``cell_name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"portbench: no workload {cell_name!r} in "
                         f"BENCHMARK.json")
    cell = cells[cell_name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    return (cell, conf, load_json("traffic", cell["traffic"]),
            load_json("limits", cell["name"]))


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, started: float,
             program: Optional[Callable] = None) -> Dict:
    """Run ``cell_name`` once; returns the result line as a dict.
    ``started`` is when set-up began (``time.perf_counter``);
    ``program(conf, traffic, positions, device)`` replaces the system's
    ``Program`` (the control and the planted faults of the tests)."""
    return run_files(bench, *cell_files(bench, cell_name), seed, seconds,
                     trace, device, started, program)


def run_files(bench: Dict, cell: Dict, conf: Dict, traffic: Dict,
              limits: Dict, seed: int, seconds: float, trace: bool,
              device: str, started: float,
              program: Optional[Callable] = None) -> Dict:
    """``run_cell`` on a cell's files as given."""
    cell_name = cell["name"]
    system = load_system(conf["system"])
    n_sub, with_ext = system.call_shape(conf, traffic)
    run = Run(conf, system.particles(conf), n_sub, with_ext)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    positions = system.initial_positions(conf, seed)
    if cuda:   # the CUDA context, before the scene's span
        torch.zeros(1, device=device)
        sync()
    t = time.perf_counter()
    prog = (program or system.Program)(conf, traffic, positions, device)
    sync()
    run.scene_build_s = time.perf_counter() - t

    spans_on = [False]

    def span(name):
        return (torch.profiler.record_function(SPAN_PREFIX + name)
                if spans_on[0] else nullcontext())

    bad = torch.zeros((), dtype=torch.int32, device=device)

    def one(state):
        """One call from ``state``; the state it returns."""
        with span("dispatch"):
            out = prog.step(state)
        with span("health"):   # queued behind the step; read after the window
            bad.add_(system.unhealthy(prog.leaves(out)))
        with span("sync"):
            sync()
        return out

    state = prog.state
    compared: List[Compared] = []
    for k in range(traffic["warmup_calls"]):
        out = one(state)
        if k == 0:
            compared.append(Compared(None, prog.leaves(out)))
        state = out
    bad.zero_()
    run.setup_s = time.perf_counter() - started

    wanted = set(generate.compared_calls(traffic, seed))
    tr = traffic["trace"]
    tr_first, tr_last = tr["first_call"], tr["first_call"] + tr["calls"] - 1
    prof = window_span = None
    failed = attempted = 0
    w0 = time.perf_counter()
    t1 = w0
    while True:
        i = attempted
        if trace and i == tr_first:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            spans_on[0] = True
            window_span = torch.profiler.record_function(WINDOW)
            window_span.__enter__()
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = one(state)
        except Exception:  # a call that raises counts as failed
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        if out is not None:
            run.call_s.append(t1 - t0)
            if i in wanted:
                compared.append(Compared(prog.leaves(state),
                                         prog.leaves(out)))
            state = out
        if prof is not None and i == tr_last:
            window_span.__exit__(None, None, None)
            spans_on[0] = False
            prof.stop()
            run.trace = from_profiler(prof, tr["calls"])
            prof = None
        if t1 - w0 >= seconds and (not trace or run.trace is not None):
            break
    sync()
    run.window_s = t1 - w0
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed += int(bad)

    del prog, state, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = system.Reference(conf, traffic, device)
    pairs = []
    for c in compared:
        start = (reference.start(positions) if c.inp is None else c.inp)
        pairs.append((c.out, reference.call(start)))
    numbers = check.compare(limits, pairs)
    sync()

    key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[key]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    out = {"correct": check.passes(numbers),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = numbers
    return out
