"""On the card: every cell of ``BENCHMARK.json`` for a short window, the
program correct and the control (the reference in bfloat16 in its place)
not.  Skips on a host without CUDA; run on the card with
``python -m pytest portbench/tests -m gpu``."""

import time

import pytest
import torch

from portbench import harness
from portbench.control import Control
from portbench.tests import tiny


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in tiny.BENCH["workloads"]])
def test_cell_on_the_card(cell):
    card()
    out = harness.run_cell(tiny.BENCH, cell, 2 ** 31 + 77, 1.0, False,
                           "cuda", time.perf_counter())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu"
    ctl = harness.run_cell(tiny.BENCH, cell, 2 ** 31 + 77, 0.1, False,
                           "cuda", time.perf_counter(), program=Control)
    assert not ctl["correct"], ctl["checks"]
