"""The benchmark's arithmetic on the CPU: the work count of the roofline
worked out by hand, the rate on synthetic timings, the idle share from
the union of device intervals, the program's spans kept apart from the
benchmark's and the runner's idle share read from them, and the readers
found by name."""

import json

import pytest
import torch
from softbodysimulation_tpu_torch.diag import profiling

from portbench import harness, trace
from portbench.trace import (SPAN_PREFIX, WINDOW, Trace, complement,
                             from_profiler, union)

ROOT = harness.ROOT


def conf(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def reader(name):
    return harness.load_reader(name)


def test_constraints_are_those_that_exist():
    work = harness.load_reader("lattice_roofline_pct").__globals__
    # res 4: 3 structural families of 4*4*3, 6 face diagonals of 4*3*3,
    # 4 cube diagonals of 3*3*3
    assert work["constraints"](4) == 3 * 48 + 6 * 36 + 4 * 27 == 468
    assert work["constraints"](40) == 789_516


def test_work_of_a_res4_warm_start_call_by_hand():
    work = harness.load_reader("lattice_roofline_pct").__globals__
    c = dict(conf("ensemble1024"), bodies=1)
    nbytes, ops = work["work"](c, 4, True)
    # read: x, v 24 B, w 4, ext 12 a particle; 468 multipliers (WARM_START
    # reads them); written: x, v 24 B a particle, 468 multipliers
    assert nbytes == 64 * (24 + 4 + 12) + 4 * 468 + 64 * 24 + 4 * 468 == 7840
    # a substep: 468 constraints x (1 iteration + the warm pass) x 30, and
    # 64 particles x (predict 15 + finalize 6 + floor 11)
    assert ops == 4 * (468 * 2 * 30 + 64 * (15 + 6 + 11)) == 120_512
    whole, whole_ops = work["work"](conf("ensemble1024"), 4, True)
    assert (whole, whole_ops) == (1024 * nbytes, 1024 * ops)


def test_work_of_the_64k_rollout_call():
    work = harness.load_reader("lattice_roofline_pct").__globals__
    nbytes, ops = work["work"](conf("lattice64k"), 2000, False)
    # RESET: the multipliers are written, never read; no external force
    assert nbytes == 64_000 * (24 + 4 + 24) + 4 * 789_516
    assert ops == 2000 * (789_516 * 30 + 64_000 * 32)
    bound = work["bound_s"](conf("lattice64k"), 2000, False)
    assert bound == pytest.approx(ops / 67e12)


def run_record(call_s, window_s, **kw):
    r = harness.Run(conf("lattice64k"), particles=64_000,
                    substeps_per_call=8, with_ext=True, window_s=window_s,
                    call_s=list(call_s))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_rate_is_all_the_work_over_all_the_window():
    # ten calls of 0.1 s in a window of 1.25 s (the loop's own time
    # between calls counts against the rate)
    r = run_record([0.1] * 10, 1.25)
    assert reader("particle_substeps_per_s")(r) == pytest.approx(
        64_000 * 8 * 10 / 1.25)
    assert reader("particle_substeps_per_s")(run_record([], 1.0)) is None


def test_idle_share_from_the_union_of_intervals():
    ops = [("k", 1.0, 3.0), ("copy", 2.0, 4.0), ("k", 6.0, 7.0),
           ("before", -1.0, 0.5), ("after", 9.5, 12.0)]
    tr = Trace(window=(0.0, 10.0), calls=2, device_ops=ops,
               spans=[("dispatch", 0.0, 5.0), ("sync", 4.5, 5.5)])
    assert union([(s, e) for _, s, e in ops], tr.window) == [
        (0.0, 0.5), (1.0, 4.0), (6.0, 7.0), (9.5, 10.0)]
    assert tr.busy_s == pytest.approx(5.0)
    assert complement(tr.busy(), tr.window) == [(0.5, 1.0), (4.0, 6.0),
                                                (7.0, 9.5)]
    r = run_record([], 1.0, trace=tr)
    assert reader("device_idle_pct.rollout")(r) == pytest.approx(50.0)
    # idle time goes to the innermost open span, else between calls
    gaps = dict((n, t) for n, t in tr.idle_gaps())
    assert gaps == pytest.approx({"dispatch": 0.5 + 0.5, "sync": 1.0,
                                  "between_calls": 0.5 + 2.5})
    assert tr.device_time("k") == pytest.approx(3.0)
    assert tr.top_ops()[0] == ["k", 3.0]


def test_roofline_reads_nothing_without_its_kernel():
    tr = Trace(window=(0.0, 1.0), calls=1, device_ops=[("other", 0, 1)],
               spans=[])
    r = run_record([], 1.0, trace=tr)
    assert reader("lattice_roofline_pct")(r) is None
    assert reader("lattice_roofline_pct")(run_record([], 1.0)) is None
    tr.device_ops.append(("void lattice_persistent_kernel<1>(...)", 0.0,
                          0.5))
    r = run_record([], 1.0, trace=tr, substeps_per_call=8)
    want = harness.load_reader("lattice_roofline_pct").__globals__[
        "bound_s"](conf("lattice64k"), 8, True) / 0.5 * 100
    assert reader("lattice_roofline_pct")(r) == pytest.approx(want)


def test_the_program_span_prefix_is_the_ports():
    """The benchmark keeps the port's span prefix as a literal and imports
    nothing of the program for it."""
    assert trace.PROGRAM_SPAN_PREFIX == profiling.SPAN_PREFIX == "sbs."
    assert "softbodysimulation_tpu" not in (harness.HERE / "trace.py"
                                            ).read_text()


def test_the_trace_keeps_the_programs_spans_apart():
    """The port's ``sbs.`` spans land in ``program_spans``; the benchmark's
    spans, the device's operations and the idle gaps read as they do with
    no program span."""

    def traced(with_spans):
        x = torch.arange(64.0)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(WINDOW):
                with torch.profiler.record_function(SPAN_PREFIX
                                                    + "dispatch"):
                    if with_spans:
                        with profiling.span("lattice.call"):
                            with profiling.span("lattice.layout"):
                                x = x * 2.0
                            x = x.sum()
                    else:
                        x = (x * 2.0).sum()
        return from_profiler(prof, 1)

    plain, spanned = traced(False), traced(True)
    assert [n for n, _, _ in spanned.program_spans] == [
        "lattice.call", "lattice.layout"]
    assert all(spanned.window[0] <= s <= e <= spanned.window[1]
               for _, s, e in spanned.program_spans)
    assert plain.program_spans == []
    assert [n for n, _, _ in spanned.spans] == ["dispatch"]
    assert [n for n, _, _ in spanned.device_ops] == [
        n for n, _, _ in plain.device_ops]
    assert sorted(n for n, _ in spanned.idle_gaps()) == sorted(
        n for n, _ in plain.idle_gaps())


def test_runner_idle_share_by_hand():
    """Idle time inside the union of ``<runner>.call`` spans, nested or
    disjoint, over the slice; idle time outside them, and spans of other
    names, do not count."""
    ops = [("k", 1.0, 3.0), ("k", 5.0, 6.0), ("k", 8.0, 9.0)]
    program = [("lattice.call", 0.5, 4.0),     # idle 0.5-1, 3-4: 1.5
               ("lattice.layout", 0.5, 1.0),   # inside the call
               ("lattice.call", 3.5, 4.5),     # overlaps: adds 4-4.5
               ("mesh.call", 6.5, 7.5),        # disjoint, all idle: 1.0
               ("lattice.launch", 9.0, 10.0)]  # no call: not counted
    tr = Trace(window=(0.0, 10.0), calls=2, device_ops=ops,
               spans=[("dispatch", 0.0, 9.5)], program_spans=program)
    r = run_record([], 1.0, trace=tr)
    assert reader("runner_idle_pct")(r) == pytest.approx(
        100.0 * (1.5 + 0.5 + 1.0) / 10.0)
    # the idle share of the whole slice counts the gaps outside the calls
    assert reader("device_idle_pct.rollout")(r) == pytest.approx(60.0)
    no_call = Trace(window=(0.0, 10.0), calls=2, device_ops=ops,
                    spans=[], program_spans=program[1:2] + program[4:])
    assert reader("runner_idle_pct")(run_record([], 1.0,
                                                trace=no_call)) is None
    assert reader("runner_idle_pct")(run_record([], 1.0)) is None
    # a Trace built positionally, as before, holds no program span
    assert Trace((0.0, 1.0), 1, [], []).program_spans == []
