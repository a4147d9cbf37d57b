#!/usr/bin/env python3
"""Where bench.py's body keeps its shape on the PyTorch port's lattice
kernels, on one NVIDIA GPU.

    python3 scripts/torch_spatial_cut.py [res ...]

For each resolution (default 64 to 128 in steps of 4), the braced res^3
lattice of ``bench.py`` (JACOBI, RESET, 1 iteration x 8 substeps, floor,
gravity as an acceleration, damping 0.02, 1 g particles, centre y 0.6;
``fast_math`` off) runs 2000 substeps through the lattice kernel (B-1) and
through the slab kernel (B-6, 4 slabs on the card) from the same start.
Prints bench.py's health (ymin, height; the gate is height > 0.5) of each,
their largest position difference (the smoke's drift gate is 1e-3) and
B-1's height after 2000 more substeps.  ``chip_smoke.py`` holds phase 24's
height and drift gates at the largest resolution passing both
(``SPATIAL_CUT_RES``).  Needs a CUDA device; imports no jax.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from softbodysimulation_tpu_torch.core import config as C  # noqa: E402
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc  # noqa
from softbodysimulation_tpu_torch.parallel import spatial as psp  # noqa: E402
from softbodysimulation_tpu_torch.solvers import lattice as lat  # noqa: E402
from softbodysimulation_tpu_torch.topology import lattice as top  # noqa: E402

SUBSTEPS = 2000


def height(state):
    y = state.positions[:, 1]
    return float(y.max() - y.min()), float(y.min())


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_spatial_cut: needs a CUDA device", file=sys.stderr)
        return 1
    cfg = C.SolverConfig(substeps=8, iterations=1, damping=0.02,
                         solve_mode=C.SolveMode.JACOBI,
                         lambda_mode=C.LambdaMode.RESET,
                         gravity_is_acceleration=True, ground_height=0.0,
                         friction=0.3)
    cuda = torch.device("cuda", torch.cuda.current_device())
    print(f"# {torch.cuda.get_device_name(0)}")
    for res in [int(a) for a in argv] or range(64, 129, 4):
        spec = top.lattice_spec(res, braced=True)
        st = lat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device=cuda)
        b1 = lc.make_cuda_substep_runner(spec, cfg, 1 / 480, SUBSTEPS)(st)
        b6 = psp.make_spatial_lattice_step(spec, cfg, 1 / 60, [cuda] * 4,
                                           n_steps=SUBSTEPS // 8)(st)
        later = lc.make_cuda_substep_runner(spec, cfg, 1 / 480,
                                            SUBSTEPS)(b1)
        (h1, y1), (h6, y6), (h2, _) = height(b1), height(b6), height(later)
        drift = float((b6.positions - b1.positions).abs().max())
        print(f"res {res} ({spec.n_particles} particles): B-1 height "
              f"{h1:.4f} ymin {y1:.2e}; B-6 height {h6:.4f} ymin {y6:.2e}; "
              f"drift {drift:.3e}; B-1 height after {2 * SUBSTEPS} "
              f"substeps {h2:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
