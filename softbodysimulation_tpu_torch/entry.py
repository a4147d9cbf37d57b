"""The port's twin of ``__graft_entry__.entry()``: the flagship forward
step, a warm-started Jacobi stencil XPBD step of a braced res-16 lattice,
through ``solvers.lattice.step_fn``.

    from softbodysimulation_tpu_torch.entry import entry
    fn, (state,) = entry()          # on the card; entry("cpu") on the CPU
    state = fn(state)
"""

from __future__ import annotations

from .core.config import LambdaMode, SolveMode, SolverConfig
from .solvers import lattice as lat
from .topology import lattice

RES = 16
DT = 1.0 / 60.0


def config() -> SolverConfig:
    """The entry configuration: WARM_START, JACOBI x 1, 4 substeps, floor
    with friction 0.3."""
    return SolverConfig(
        substeps=4,
        iterations=1,
        damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.WARM_START,
        lambda_decay=1.0,
        ground_height=0.0,
        friction=0.3,
    )


def entry(device="cuda"):
    """``(fn, (state,))``: ``fn(state)`` advances one frame of the res-16
    lattice centred at height 1 (``state`` on ``device``, the card unless
    the caller asks for the CPU)."""
    spec = lattice.lattice_spec(RES, braced=True)
    cfg = config()
    state = lat.make_lattice_state(spec, center=(0.0, 1.0, 0.0),
                                   device=device)

    def fn(s):
        return lat.step_fn(s, spec, cfg, DT)

    return fn, (state,)
