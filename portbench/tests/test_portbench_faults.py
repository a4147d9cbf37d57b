"""The comparison that decides ``correct`` fails where it must, on the CPU
at a test's size: the control (the reference in bfloat16 in the
program's place) and each fault a cell can have, planted under the timed
path: a step that returns its state unchanged, half the ensemble left
unadvanced, an answer altered where it is produced.  (No cell runs
across cards, so none can lose an exchange between them.)  A state that
fails the system's health gate counts as failed."""

import dataclasses

import pytest
import torch

from portbench.control import Control
from portbench.systems import lattice as system
from portbench.tests import tiny

ENSEMBLES = [c for c in tiny.CELLS if c.startswith("ensemble")]


class Unchanged(system.Program):
    def step(self, state):
        return state


class HalfLeftOut(system.Program):
    """Every body but the first half advances."""

    def step(self, state):
        out = super().step(state)
        h = self.bodies // 2
        return out.replace(**{k: torch.cat([getattr(state, k)[:h],
                                            getattr(out, k)[h:]])
                              for k in system.LEAVES})


class Altered(system.Program):
    """One particle's position moved by 1 cm where the step produces
    it."""

    def step(self, state):
        out = super().step(state)
        x = out.positions.clone()
        x[..., 7, 1] += 1e-2
        return out.replace(positions=x)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_is_not_correct(cell):
    out = tiny.run(cell, program=Control)
    assert not out["correct"], out["checks"]


FAULTS = ([(c, Unchanged) for c in tiny.CELLS]
          + [(c, Altered) for c in tiny.CELLS]
          + [(c, HalfLeftOut) for c in ENSEMBLES])


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
    assert out.positions.dtype == torch.float32
    assert set(ctl.leaves(out)) == set(f.name for f in
                                      dataclasses.fields(out))


class Diverged(system.Program):
    """One particle's position not finite after each step."""

    def step(self, state):
        out = super().step(state)
        x = out.positions.clone()
        x[..., 3, 0] = float("nan")
        return out.replace(positions=x)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_state_not_finite_counts_as_failed(cell):
    out = tiny.run(cell, program=Diverged)
    assert out["failed"] == out["attempted"] and not out["correct"]
