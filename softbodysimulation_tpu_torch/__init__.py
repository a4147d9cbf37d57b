"""softbodysimulation_tpu_torch — the PyTorch / CUDA port of
softbodysimulation_tpu, for NVIDIA Hopper (H100).

This slice carries the res^3 braced-lattice XPBD main path: the plain
PyTorch stencil engine (``solvers/lattice.py``) and the hand-written CUDA
lattice kernel that replaces the JAX package's fused Pallas lattice
kernels (``csrc/lattice_xpbd.cu``, bound in ``kernels/lattice_cuda.py``).
It imports torch and numpy, never jax.
"""

from .core.config import (
    DampingMode,
    FloorMode,
    LambdaMode,
    SolveMode,
    SolverConfig,
)
from .core.state import (
    SimState,
    is_finite,
    restore,
    snapshot,
    state_from_numpy,
    state_to_numpy,
)

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "SolveMode",
    "LambdaMode",
    "DampingMode",
    "FloorMode",
    "SimState",
    "is_finite",
    "snapshot",
    "restore",
    "state_from_numpy",
    "state_to_numpy",
]
