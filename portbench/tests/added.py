"""A copy of the benchmark's tree with files added to it, as a later change
adds a cell: the benchmark's JSON with entries added, and a system that
is no lattice (flat sheets drifting over the floor) with its
configuration, traffic mix, limits and a metric, each a new file.  The
files already there are left as they are."""

import json
import shutil

from portbench import harness
from portbench.tests import tiny

SHEET = '''"""Flat sheets drifting over the floor under damping: a system that is
no lattice, with its own inputs, leaves, health gate and CPU cut."""
import numpy as np
import torch

from portbench import generate

LEAVES = ("positions", "velocities", "lambda_bend")


def call_shape(conf, traffic):
    return traffic["substeps_per_call"], False


def particles(conf):
    return conf["sheets"] * conf["side"] ** 2


def initial_positions(conf, seed):
    n, h, m = conf["side"], conf["spacing_m"], conf["sheets"]
    i, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    p = np.zeros((m, n * n, 3), np.float32)
    p[:, :, 0] = i.ravel() * h + generate.rng(seed, generate.POSE).uniform(
        size=(m, 1))
    p[:, :, 2] = k.ravel() * h
    return p


def unhealthy(leaves):
    return (~torch.isfinite(leaves["positions"]).all()).to(torch.int32)


def cpu_cut(conf, traffic):
    return (dict(conf, side=min(conf["side"], 8),
                 sheets=min(conf["sheets"], 2)),
            dict(traffic, substeps_per_call=min(traffic["substeps_per_call"],
                                                5)))


def advance(leaves, dt, substeps):
    x, v = leaves["positions"], leaves["velocities"]
    lam = leaves["lambda_bend"]
    for _ in range(substeps):
        v = v * 0.99
        x = x + dt * v
        lam = lam + dt * v[..., 0]
    return {"positions": x, "velocities": v, "lambda_bend": lam}


def start(positions, device, dtype=torch.float32):
    x = torch.as_tensor(positions, device=device).to(dtype)
    v = torch.zeros_like(x)
    v[..., 0] = 0.5
    return {"positions": x, "velocities": v,
            "lambda_bend": torch.zeros_like(x[..., 0])}


class Program:
    def __init__(self, conf, traffic, positions, device):
        self.state = start(positions, device)
        self.dt, self.n = conf["dt_s"], traffic["substeps_per_call"]

    def step(self, state):
        return advance(state, self.dt, self.n)

    def leaves(self, state):
        return dict(state)

    def with_leaves(self, state, **leaves):
        return dict(state, **leaves)


class Reference:
    def __init__(self, conf, traffic, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        self.dt, self.n = conf["dt_s"], traffic["substeps_per_call"]

    def start(self, positions):
        return start(positions, self.device, self.dtype)

    def call(self, leaves):
        return advance(leaves, self.dt, self.n)
'''
# no ``body`` or ``bodies`` key: nothing of the lattice's configuration
SHEET_CONF = {"system": "flat_sheet", "sheets": 3, "side": 16,
              "spacing_m": 0.05, "dt_s": 0.002}
SHEET_CELL = "sheet.drift"


def bench_with(config, cell, traffic, metric):
    """The benchmark's JSON with a configuration, a cell and an end-to-end
    metric added (entries only)."""
    bench = json.loads(json.dumps(tiny.BENCH))
    bench["configs"].append({"name": config[0], "source": "test",
                             "file": config[1], "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell, "config": config[0],
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": metric, "unit": "calls",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": [cell]})
    return bench


def new_tree(tmp_path):
    """A copy of the benchmark's data and code directories to add files
    to, with a metric added: ``calls_completed``."""
    here = tmp_path / "portbench"
    for kind in ("traffic", "limits", "metrics", "systems"):
        shutil.copytree(harness.HERE / kind, here / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (here / "metrics" / "calls_completed.py").write_text(
        "def read(run):\n    return float(len(run.call_s))\n")
    return here


def add_sheet(tmp_path, monkeypatch):
    """The flat-sheet system and its cell ``SHEET_CELL`` added as files
    alone to a new tree, which the harness then reads; the benchmark's
    JSON with their entries."""
    here = new_tree(tmp_path)
    (here / "systems" / "flat_sheet.py").write_text(SHEET)
    (tmp_path / "sheet.json").write_text(json.dumps(SHEET_CONF))
    traffic = {"entry": "advance", "substeps_per_call": 10,
               "warmup_calls": 1, "check": {"calls": 2,
                                            "drawn_from_first": 4},
               "trace": {"first_call": 1, "calls": 2}}
    (here / "traffic" / "drift.json").write_text(json.dumps(traffic))
    limits = {"numbers": {
        "dx": {"leaf": "positions", "measure": "max_abs", "limit": 0.0},
        "dlam": {"leaf": "lambda_bend", "measure": "max_abs",
                 "limit": 0.0}}}
    (here / "limits" / f"{SHEET_CELL}.json").write_text(json.dumps(limits))
    monkeypatch.setattr(harness, "HERE", here)
    return bench_with(("sheet", str(tmp_path / "sheet.json")), SHEET_CELL,
                      "drift", "calls_completed")
