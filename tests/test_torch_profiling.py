"""The port's tracing (``diag/profiling.py``) on the CPU: spans, the trace
exporter, the counting scope, and the count of barriers the lattice
kernel crosses.

A span builds nothing while no profiler records, and under one is a
CPU-op range named ``sbs.<name>``, nested as entered, in the exported
Chrome trace too; being no user annotation, the profiler puts nothing of
it on the device timeline, so the benchmark's reduction of a trace
(``portbench/trace.from_profiler``) reads the same with spans as without.
Without a card nothing is counted.  ``loop_barriers`` walks the
persistent kernel's loop (``csrc/lattice_xpbd.cu`` ``persistent_body``)
and counts its ``bar.sync()`` calls; the card tests hold the counted
kernel's tally to it (``test_torch_kernel_on_card.py``).
"""

import json

import pytest
import torch

from portbench import trace as bench_trace
from softbodysimulation_tpu_torch.core.config import (FloorMode, LambdaMode,
                                                      SolveMode, SolverConfig)
from softbodysimulation_tpu_torch.diag import profiling
from softbodysimulation_tpu_torch.kernels import lattice_cuda
from softbodysimulation_tpu_torch.solvers import lattice as lat
from softbodysimulation_tpu_torch.topology.lattice import lattice_spec

SPANS = ("lattice.call", "lattice.layout", "lattice.launch",
         "lattice.unlayout")


def loop_barriers(cfg: SolverConfig, spec, n_substeps: int,
                  colliders: int = 0) -> int:
    """Barriers a warp crosses in one call of the persistent kernel: its
    loop walked as the kernel walks it, one count a ``bar.sync()``
    (``colliders``: the call's spheres and boxes)."""
    has_contacts = (cfg.floor_mode == FloorMode.XPBD_INEQUALITY
                    or colliders > 0)
    nwarm = 1 if cfg.lambda_mode == LambdaMode.WARM_START else 0
    npass = 2 if cfg.solve_mode == SolveMode.COLORED else 1
    per_sub = nwarm + cfg.iterations * npass
    nfam, tets = spec.n_families, cfg.enable_tet_volume
    count = fb = 0
    for _ in range(n_substeps):
        count += 1 + nwarm * nfam          # after predict; the warm passes
        for it in range(cfg.iterations):
            last = it == cfg.iterations - 1
            tail = has_contacts or last
            for fi in range(nfam):
                for ps in range(npass):
                    fused = (tail and not tets and fi == nfam - 1
                             and ps == npass - 1)
                    count += not (fused and last)
            if tets:
                count += 1 + (not (tail and last))
            elif nfam == 0 and tail:
                count += not last
        fb ^= per_sub & 1
    return count + fb                      # the multipliers copied back


def bench_cfg():
    """``lattice64k``'s solver (``bench.py`` ``build()``)."""
    return SolverConfig(substeps=8, iterations=1, damping=0.02,
                        solve_mode=SolveMode.JACOBI,
                        lambda_mode=LambdaMode.RESET,
                        gravity_is_acceleration=True, fast_math=True,
                        ground_height=0.0, friction=0.3)


def ensemble_cfg():
    """``ensemble1024``'s solver (example 5's ``make_ensemble()``)."""
    return SolverConfig(substeps=4, iterations=1, damping=0.02,
                        solve_mode=SolveMode.JACOBI,
                        lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
                        ground_height=0.0, friction=0.3)


# (configuration, spec, substeps a call, barriers a warp crosses a call)
CELL_BARRIERS = {
    "lattice64k": (bench_cfg, 40, 2000, 26_000),      # 13 a substep
    "ensemble1024": (ensemble_cfg, 4, 480, 12_480),   # 26 a substep
}


@pytest.mark.parametrize("cell", list(CELL_BARRIERS))
def test_loop_barriers_of_the_benchmark_cells(cell):
    make, res, subs, want = CELL_BARRIERS[cell]
    spec = lattice_spec(res, braced=True)
    assert spec.n_families == 13
    # a substep: predict | 13 family passes, the last fused with the
    # contacts and the next predict (no barrier after it); WARM_START adds
    # 13 warm passes.  An even number of substeps ends with the
    # multipliers in place (RESET: one pass a family a substep; one more
    # barrier after an odd number)
    assert loop_barriers(make(), spec, 2) == 2 * want // subs
    assert loop_barriers(make(), spec, subs) == want
    odd = loop_barriers(make(), spec, 1) - want // subs
    assert odd == (1 if make().lambda_mode == LambdaMode.RESET else 0)


def test_loop_barriers_of_other_loops():
    spec = lattice_spec(4, braced=True)
    colored = SolverConfig(iterations=2, solve_mode=SolveMode.COLORED,
                           floor_mode=FloorMode.NONE)
    # 1 + iteration 1: 26 parity passes; iteration 2: 25 (the last fused)
    assert loop_barriers(colored, spec, 3) == 3 * (1 + 26 + 25)
    tets = colored.replace(enable_tet_volume=True)
    # the tet sweep ends each iteration: its cell pass and, but in the
    # last iteration, its apply pass
    assert loop_barriers(tets, spec, 1) == 1 + 2 * (26 + 1) + 1
    decay = bench_cfg().replace(lambda_mode=LambdaMode.DECAY)
    # one pass a family a substep: the multipliers end in the scratch
    # buffer after an odd number of substeps and are copied back
    assert loop_barriers(decay, spec, 3) == 3 * 13 + 1
    assert loop_barriers(decay, spec, 2) == 2 * 13


def test_span_builds_nothing_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was built")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("lattice.call") as a:
        with profiling.span("lattice.layout") as b:
            pass
    assert a is None and b is None
    assert profiling.span("x") is profiling.span("y")


def _events(prof):
    return {e.name: e for e in prof.events()}


def test_spans_nest_as_entered_under_the_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("lattice.call"):
            with profiling.span("lattice.layout"):
                torch.ones(4).add_(1)
            with profiling.span("lattice.launch"):
                pass
    ev = _events(prof)
    call, layout = ev["sbs.lattice.call"], ev["sbs.lattice.layout"]
    launch = ev["sbs.lattice.launch"]
    assert layout.cpu_parent is call and launch.cpu_parent is call
    assert call.time_range.start <= layout.time_range.start
    assert layout.time_range.end <= launch.time_range.start
    assert launch.time_range.end <= call.time_range.end
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for n, e in ev.items() if n.startswith(profiling.SPAN_PREFIX))


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    path = tmp_path / "lattice.json"
    with profiling.trace(path):
        with profiling.span("lattice.call"):
            torch.zeros(8).sum()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "sbs.lattice.call"]
    assert len(spans) == 1
    # a CPU op, not a user annotation: nothing mirrored on the device
    assert spans[0]["cat"] == "cpu_op"
    assert spans[0]["dur"] > 0


def test_the_benchmarks_trace_reduction_sees_no_program_span():
    """The same operations with and without the runner's spans around
    them: the benchmark's window, spans, device operations and idle gaps
    hold none of them."""
    spec = lattice_spec(3, braced=True)
    cfg = bench_cfg()
    state = lat.make_lattice_state(spec, mass=0.001, device="cpu")

    def traced(with_spans):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(bench_trace.WINDOW):
                with torch.profiler.record_function(
                        bench_trace.SPAN_PREFIX + "dispatch"):
                    if with_spans:
                        with profiling.span("lattice.call"):
                            with profiling.span("lattice.layout"):
                                lattice_cuda.advance(state, spec, cfg,
                                                     1 / 480, 2, False)
                    else:
                        lattice_cuda.advance(state, spec, cfg, 1 / 480, 2,
                                             False)
        return bench_trace.from_profiler(prof, 1)

    plain, spanned = traced(False), traced(True)
    assert [n for n, _, _ in spanned.spans] == ["dispatch"]
    assert not any(n.startswith(profiling.SPAN_PREFIX)
                   for n, _, _ in spanned.device_ops)
    assert [n for n, _, _ in spanned.device_ops] == [
        n for n, _, _ in plain.device_ops]
    assert [n for n, _ in spanned.idle_gaps()] == [
        n for n, _ in plain.idle_gaps()]


def test_nothing_is_counted_without_a_card():
    spec = lattice_spec(3, braced=True)
    state = lat.make_lattice_state(spec, mass=0.001, device="cpu")
    with profiling.counting():
        assert profiling.counting_open()
        with profiling.counting():
            pass
        assert profiling.counting_open()
        lattice_cuda.advance(state, spec, bench_cfg(), 1 / 480, 2, False)
    assert not profiling.counting_open()
    if not torch.cuda.is_available():
        assert profiling.counts() is None


def test_runner_spans_are_the_four_named():
    src = lattice_cuda.__file__
    text = open(src).read()
    named = sorted(set(
        s for s in SPANS if f'profiling.span("{s}")' in text))
    assert named == sorted(SPANS)
    assert text.count("profiling.span(") == len(SPANS)
