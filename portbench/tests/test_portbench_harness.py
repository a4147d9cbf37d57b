"""The harness on the CPU: every cell runs through the port's CPU path and
compares correct, a configuration, a traffic mix and a metric added only
as files are found by name, the command refuses to run without a card,
and nothing it loads is JAX or the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import added, tiny

ROOT = harness.ROOT


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_each_cell_runs_and_is_correct_on_the_cpu(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in tiny.BENCH["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_a_cell_added_as_files_alone_is_found_by_name(tmp_path,
                                                      monkeypatch):
    """A new configuration, traffic mix, limits and metric, each a file of
    its own, with entries in the benchmark's JSON: no code edited."""
    here = added.new_tree(tmp_path)
    conf = json.loads((ROOT / "portbench/configs/lattice64k.json")
                      .read_text())
    conf["body"]["res"] = 3
    (tmp_path / "small.json").write_text(json.dumps(conf))
    cell, _, traffic, limits = tiny.files("lattice64k.rollout")
    traffic.update(substeps_per_call=8)
    (here / "traffic" / "eight_substeps.json").write_text(
        json.dumps(traffic))
    (here / "limits" / "small.eight_substeps.json").write_text(
        json.dumps(limits))
    bench = added.bench_with(("small", str(tmp_path / "small.json")),
                             "small.eight_substeps", "eight_substeps",
                             "calls_completed")
    monkeypatch.setattr(harness, "HERE", here)
    out = harness.run_cell(bench, "small.eight_substeps", 5, 0.2, False,
                           "cpu", 0.0)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["metrics"]["calls_completed"]["value"] == out["attempted"]
    assert out["metrics"]["particle_substeps_per_s"]["value"] > 0
    assert "calls_completed" not in tiny.run("lattice64k.rollout")["metrics"]


def test_a_system_added_as_files_alone_runs(tmp_path, monkeypatch):
    """A system that is no lattice (sheets lying flat, which the
    lattice's height gate would refuse, with a leaf the lattice lacks and
    no lattice key in its configuration) with its configuration, traffic
    mix, limits and a metric, each a new file: its own inputs and health
    gate, no existing file edited."""
    bench = added.add_sheet(tmp_path, monkeypatch)
    conf = added.SHEET_CONF
    out = harness.run_cell(bench, "sheet.drift", 2 ** 33 + 5, 0.2, False,
                           "cpu", 0.0)
    assert out["correct"] and out["failed"] == 0, out
    assert out["metrics"]["calls_completed"]["value"] == out["attempted"]
    assert out["metrics"]["particle_substeps_per_s"]["value"] > 0
    # the lattice's own gate would have counted every call as failed
    sheet = harness.load_system("flat_sheet")
    flat = torch.as_tensor(sheet.initial_positions(conf, 1))
    assert int(harness.load_system("lattice").unhealthy(
        {"positions": flat})) == 1


def run_module(args, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [
    ["-m", "portbench.run", "--workload", "lattice64k.rollout", "--seed",
     str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
    ["-m", "portbench.control", "--workload", "lattice64k.rollout",
     "--seeds", str(2 ** 31 + 3)],
], ids=["run", "control"])
def test_no_card_no_result(args):
    """The benchmark and its control print nothing without a card: a
    control read on the CPU would run the plain engine, not the kernel."""
    p = run_module(args)
    assert p.returncode == 2, p.stderr[-2000:]
    assert p.stdout.strip() == ""


FORBIDDEN_CHECK = """
import sys
from portbench import run
from portbench.tests import tiny
for cell in tiny.CELLS:
    tiny.run(cell, seconds=0.05)
from portbench import control
bad = run.forbidden_modules()
ref = [m for m in sys.modules if m.startswith("portbench.reference")]
print("FORBIDDEN", bad, "REFERENCE", sorted(ref))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    """Every cell's run loads the port and never JAX nor the JAX package
    (top-level names compared whole: the port's name begins with the JAX
    package's)."""
    p = run_module(["-c", FORBIDDEN_CHECK])
    assert p.returncode == 0, p.stderr[-2000:]
    line = p.stdout.strip().splitlines()[-1]
    assert line.startswith("FORBIDDEN [] REFERENCE"), line


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "softbodysimulation_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "softbodysimulation_tpu.core", sys)
    assert run.forbidden_modules() == ["jax.numpy",
                                       "softbodysimulation_tpu.core"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.lattice; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'softbodysimulation_tpu_torch', 'softbodysimulation_tpu', "
            "'jax'}))")
    p = run_module(["-c", code])
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
    for path in (harness.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "softbodysimulation_tpu" not in text, path
