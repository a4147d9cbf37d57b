"""The port's benchmark: one cell of ``BENCHMARK.json`` a run, on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Drives ``softbodysimulation_tpu_torch`` and nothing else: it never imports
the JAX package or JAX, and refuses to print a result if either was
loaded.  With ``--trace 0`` the result line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a profiled
slice of the window.  The last line of standard output is the result, a
JSON object; the last lines of standard error are the numbers compared
with the reference, each beside its limit.  Without a CUDA device (or
with fewer than the cell asks for) it prints no result and exits 2; with a
forbidden module loaded it exits 3.  Builds of the program stay in its
checkout (``softbodysimulation_tpu_torch/_build/``).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .harness import ROOT  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "softbodysimulation_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (up to the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from .harness import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, n in result["checks"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
