"""The cells of ``BENCHMARK.json`` at a size a CPU test run can hold: res 4
(or 3) bodies, at most four of them, short calls and few compared."""

import copy
import json
import time

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


def files(cell_name, **traffic_kw):
    """(cell, configuration, traffic, limits) cut to a CPU test's size."""
    cell, conf, traffic, limits = harness.cell_files(BENCH, cell_name)
    conf = copy.deepcopy(conf)
    conf["body"]["res"] = 4 if conf["bodies"] == 1 else 3
    conf["bodies"] = min(conf["bodies"], 4)
    traffic = dict(traffic, warmup_calls=2,
                   check={"calls": 2, "drawn_from_first": 3})
    if "substeps_per_call" in traffic:
        traffic["substeps_per_call"] = 16
    if traffic.get("frames_per_call", 1) > 3:
        traffic["frames_per_call"] = 3
    traffic.update(traffic_kw)
    return cell, conf, traffic, limits


def run(cell_name, seed=2 ** 31 + 11, seconds=0.3, program=None,
        bench=None, **traffic_kw):
    """One CPU run of the cut cell; the result line as a dict."""
    return harness.run_files(bench or BENCH, *files(cell_name, **traffic_kw),
                             seed, seconds, False, "cpu",
                             time.perf_counter(), program)
