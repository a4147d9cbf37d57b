"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in bfloat16, the
precision below the float32 that the configurations state.  A sound
comparison reads it as not correct.  The benchmark's own runs never run
it; this module runs it on the card, at a cell's own size:

    python -m portbench.control --workload <cell> --seconds 1 \\
        --seeds <n> <n> <n>

and prints, a seed a line, the device, the cell's numbers and whether they
passed.  ``--program approx_math`` runs the program's own approximate
path instead (the cell's system's ``approx_program``), a witness of
rounding; on a system without one it prints no result and exits 2.
Without a CUDA device it prints nothing and exits 2: its readings set the
limits of the cells, which run on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

Leaves = Dict[str, torch.Tensor]


class Control:
    """The reference in ``dtype`` with the program's interface, over the
    cell's system's ``LEAVES``: each call's leaves rounded to ``dtype``,
    computed there, handed back as float32."""

    def __init__(self, conf, traffic, positions, device,
                 dtype=torch.bfloat16):
        from .harness import load_system

        system = load_system(conf["system"])
        self.names, self.dtype = system.LEAVES, dtype
        self.ref = system.Reference(conf, traffic, device, dtype)
        self.state = self._float(self.ref.start(positions))

    def _float(self, d) -> Leaves:
        return {k: d[k].float() for k in self.names}

    def leaves(self, state: Leaves) -> Leaves:
        return dict(state)

    def step(self, state: Leaves) -> Leaves:
        return self._float(self.ref.call(
            {k: state[k].to(self.dtype) for k in self.names}))


def program(name: str, system):
    """What ``--program name`` puts in the program's place, or None where
    the system has no such path."""
    if name == "bfloat16":
        return Control
    return getattr(system, "approx_program", None)


def main(argv=None, bench=None) -> int:
    from .harness import ROOT, cell_files, load_system, run_cell

    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", choices=("approx_math", "bfloat16"),
                   default="bfloat16")
    args = p.parse_args(argv)
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    system_name = cell_files(bench, args.workload)[1]["system"]
    prog = program(args.program, load_system(system_name))
    if prog is None:
        print(f"portbench.control: system {system_name!r} has no "
              f"approx_program, so no {args.program} path", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       "cuda", time.perf_counter(), program=prog)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.program,
                          "device": out["device"]["kind"],
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
