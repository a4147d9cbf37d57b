"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in bfloat16, the
precision below the float32 that the configurations state.  A sound
comparison reads it as not correct.  The benchmark's own runs never run
it; this module runs it on the card, at a cell's own size:

    python -m portbench.control --workload <cell> --seconds 1 \\
        --seeds <n> <n> <n>

and prints, a seed a line, the device, the cell's numbers and whether they
passed.  ``--program approx_math`` runs the program's own ``approx_math``
path instead, a witness of rounding (below).  Without a CUDA device it
prints nothing and exits 2: its readings set the limits of the cells,
which run on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch


@dataclasses.dataclass(frozen=True)
class Leaves:
    """A state as the harness reads it: ``(bodies, N, 3)`` float32
    leaves."""

    positions: torch.Tensor
    velocities: torch.Tensor
    lambda_dist: torch.Tensor
    ext_force: torch.Tensor


class Control:
    """The reference in ``dtype`` with the program's interface: each call's
    leaves rounded to ``dtype``, computed there, handed back as float32."""

    def __init__(self, conf, traffic, positions, device,
                 dtype=torch.bfloat16):
        from .harness import load_system

        self.ref = load_system(conf["system"]).Reference(conf, traffic,
                                                         device, dtype)
        self.state = self._leaves(self.ref.start(positions))

    @staticmethod
    def _leaves(d) -> Leaves:
        return Leaves(*(d[k].float() for k in ("positions", "velocities",
                                              "lambda_dist", "ext_force")))

    def leaves(self, state: Leaves):
        return dataclasses.asdict(state)

    def step(self, state: Leaves) -> Leaves:
        return self._leaves(self.ref.call(self.leaves(state)))


def approx_math(conf, traffic, positions, device):
    """The program with its own ``approx_math`` path on (rsqrt and the
    approximate reciprocal in the kernel's passes): float32 rounded
    otherwise, a witness of how far rounding alone moves a call's
    answers, not a control."""
    from .systems import lattice as system

    prog = system.Program(conf, traffic, positions, device)
    n_sub, with_ext = system.call_shape(conf, traffic)
    prog._step = system.lattice_cuda.make_cuda_substep_runner(
        prog.spec, prog.cfg, conf["frame_s"] / conf["solver"]["substeps"],
        n_sub, with_ext=with_ext, approx_math=True, n_bodies=prog.bodies)
    return prog


PROGRAMS = {"bfloat16": Control, "approx_math": approx_math}


def main(argv=None) -> int:
    from .harness import ROOT, run_cell

    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", choices=sorted(PROGRAMS),
                   default="bfloat16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       "cuda", time.perf_counter(),
                       program=PROGRAMS[args.program])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.program,
                          "device": out["device"]["kind"],
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
