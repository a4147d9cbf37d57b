"""The cells of ``BENCHMARK.json`` at a size a CPU test run can hold: each
cell's configuration and traffic cut by its system's ``cpu_cut``, two
warm-up calls, and two compared calls of the window's first three."""

import copy
import json
import time

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


def system(cell_name, bench=None):
    """The module ``systems/<system>.py`` of the cell's configuration."""
    conf = harness.cell_files(bench or BENCH, cell_name)[1]
    return harness.load_system(conf["system"])


def files(cell_name, bench=None, **traffic_kw):
    """(cell, configuration, traffic, limits) cut to a CPU test's size."""
    cell, conf, traffic, limits = harness.cell_files(bench or BENCH,
                                                     cell_name)
    conf, traffic = harness.load_system(conf["system"]).cpu_cut(
        copy.deepcopy(conf), dict(traffic))
    traffic = dict(traffic, warmup_calls=2,
                   check={"calls": 2, "drawn_from_first": 3})
    traffic.update(traffic_kw)
    return cell, conf, traffic, limits


def bodies(cell_name, bench=None):
    """Bodies of the cut cell: the first axis of its system's inputs."""
    conf = files(cell_name, bench)[1]
    return system(cell_name, bench).initial_positions(conf, 0).shape[0]


def run(cell_name, seed=2 ** 31 + 11, seconds=0.3, program=None,
        bench=None, **traffic_kw):
    """One CPU run of the cut cell; the result line as a dict."""
    return harness.run_files(bench or BENCH,
                             *files(cell_name, bench, **traffic_kw),
                             seed, seconds, False, "cpu",
                             time.perf_counter(), program)
