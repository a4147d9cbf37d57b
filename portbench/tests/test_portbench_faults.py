"""The comparison that decides ``correct`` fails where it must, on the CPU
at a test's size: the control (the reference in bfloat16 in the
program's place) and each fault a cell can have, planted under the timed
path of the cell's own system: a step that returns its state unchanged,
half the bodies left unadvanced (where there are several), an answer
altered where it is produced.  (No cell runs across cards, so none can
lose an exchange between them.)  A state that fails the system's health
gate counts as failed.  A system added as files alone goes through all
of it."""

import pytest
import torch

from portbench import control
from portbench.control import Control
from portbench.systems import lattice as system
from portbench.tests import added, tiny


def faults(system):
    """The planted faults over ``system``'s own ``Program``, by name; each
    changes a leaf through ``Program.with_leaves``."""

    class Unchanged(system.Program):
        def step(self, state):
            return state

    class HalfLeftOut(system.Program):
        """Every body but the first half advances."""

        def step(self, state):
            out = super().step(state)
            before, after = self.leaves(state), self.leaves(out)
            h = after["positions"].shape[0] // 2
            return self.with_leaves(out, **{
                k: torch.cat([before[k][:h], after[k][h:]])
                for k in system.LEAVES})

    class Altered(system.Program):
        """One particle's position moved by 1 cm where the step produces
        it."""

        def step(self, state):
            out = super().step(state)
            x = self.leaves(out)["positions"].clone()
            x[..., 7, 1] += 1e-2
            return self.with_leaves(out, positions=x)

    class Diverged(system.Program):
        """One particle's position not finite after each step."""

        def step(self, state):
            out = super().step(state)
            x = self.leaves(out)["positions"].clone()
            x[..., 3, 0] = float("nan")
            return self.with_leaves(out, positions=x)

    return {f.__name__: f for f in (Unchanged, HalfLeftOut, Altered,
                                    Diverged)}


CELL_FAULTS = {c: faults(tiny.system(c)) for c in tiny.CELLS}
ENSEMBLES = [c for c in tiny.CELLS if tiny.bodies(c) > 1]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_is_not_correct(cell):
    out = tiny.run(cell, program=Control)
    assert not out["correct"], out["checks"]


FAULTS = ([(c, CELL_FAULTS[c]["Unchanged"]) for c in tiny.CELLS]
          + [(c, CELL_FAULTS[c]["Altered"]) for c in tiny.CELLS]
          + [(c, CELL_FAULTS[c]["HalfLeftOut"]) for c in ENSEMBLES])


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(cell, fault):
    out = tiny.run(cell, program=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_runs_are_correct_on_several_seeds(cell):
    for seed in (1, 2 ** 31 + 99, 2 ** 40):
        out = tiny.run(cell, seed=seed)
        assert out["correct"] and out["failed"] == 0, (seed, out["checks"])


def test_control_keeps_the_program_interface():
    cell, conf, traffic, _ = tiny.files("ensemble1024.rollout")
    ctl = Control(conf, traffic, system.initial_positions(conf, 3), "cpu")
    out = ctl.step(ctl.state)
    assert set(ctl.leaves(out)) == set(system.LEAVES)
    assert all(v.dtype == torch.float32 for v in ctl.leaves(out).values())


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_state_not_finite_counts_as_failed(cell):
    out = tiny.run(cell, program=CELL_FAULTS[cell]["Diverged"])
    assert out["failed"] == out["attempted"] and not out["correct"]


@pytest.fixture
def sheet(tmp_path, monkeypatch):
    """The benchmark's JSON with the flat-sheet system's cell added as
    files alone."""
    return added.add_sheet(tmp_path, monkeypatch)


def test_a_system_added_as_files_alone_is_cut_by_its_own_cut(sheet):
    _, conf, traffic, _ = tiny.files(added.SHEET_CELL, sheet)
    assert "body" not in conf and "bodies" not in conf
    assert (conf["side"], conf["sheets"]) == (8, 2)
    assert traffic["substeps_per_call"] == 5
    assert traffic["warmup_calls"] == 2
    assert tiny.bodies(added.SHEET_CELL, sheet) == 2


@pytest.mark.parametrize("fault", ["Control", "Unchanged", "HalfLeftOut",
                                   "Altered", "Diverged"])
def test_a_system_added_as_files_alone_fails_where_it_must(sheet, fault):
    sheet_system = tiny.system(added.SHEET_CELL, sheet)
    assert "lambda_bend" in sheet_system.LEAVES
    assert "lambda_bend" not in system.LEAVES
    prog = Control if fault == "Control" else faults(sheet_system)[fault]
    out = tiny.run(added.SHEET_CELL, program=prog, bench=sheet)
    assert not out["correct"], out["checks"]
    if fault == "Diverged":
        assert out["failed"] == out["attempted"]


def test_a_system_added_as_files_alone_is_correct_on_several_seeds(sheet):
    for seed in (1, 2 ** 31 + 99, 2 ** 40):
        out = tiny.run(added.SHEET_CELL, seed=seed, bench=sheet)
        assert out["correct"] and out["failed"] == 0, (seed, out["checks"])
        assert set(out["checks"]) == {"dx", "dlam"}


def test_approx_math_is_refused_where_the_system_has_none(sheet, capsys):
    assert control.program("approx_math", system) is system.approx_program
    rc = control.main(["--workload", added.SHEET_CELL, "--program",
                       "approx_math", "--seeds", "1"], bench=sheet)
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert len(err.strip().splitlines()) == 1 and "approx_program" in err
