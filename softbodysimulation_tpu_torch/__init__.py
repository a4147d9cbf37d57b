"""softbodysimulation_tpu_torch — the PyTorch / CUDA port of
softbodysimulation_tpu, for NVIDIA Hopper (H100).

The package carries four paths, each a plain PyTorch engine beside
hand-written CUDA kernels that replace fused Pallas kernels of the JAX
package:

* the res^3 braced-lattice XPBD path: the stencil engine
  (``solvers/lattice.py``) and ``csrc/lattice_xpbd.cu`` (bound in
  ``kernels/lattice_cuda.py``);
* the general-mesh XPBD path (cloth, surface meshes and tet solids:
  distance, dihedral bending and per-tet volume constraints): the topology
  builders (``topology/``), the general engine (``solvers/general.py``)
  and ``csrc/mesh_xpbd.cu`` (bound in ``kernels/mesh_cuda.py``);
* the multi-body contact path (bodies merged by
  ``topology.build.merge_topologies``, self-collision in
  ``ops/spatial_hash.py``): the blocked contact kernel
  ``csrc/contact_xpbd.cu`` (bound in ``kernels/contact_cuda.py``), which
  the mesh kernel's substep loop runs too, and the mesh kernel's dense
  contact pass; ``diag/diagnostics.py`` checks the blocked pass's
  exactness;
* the differentiable path (``kernels/diff.py``): kernel forwards paired
  with autograd through the plain engines, traced materials, and the
  hand-written fused mesh backward ``csrc/mesh_diff_xpbd.cu`` (bound in
  ``kernels/mesh_diff.py``); ``examples/`` fits a launch velocity and
  rest lengths through them.

The lattice and mesh kernels take ``approx_math`` (rsqrt and the
approximate reciprocal, as ``bench.py``'s first engine); a self-colliding
lattice runs its contact cadence through the hybrid contact step
(``kernels/lattice_cuda.make_hybrid_contact_step``); ``entry.py`` and
``bench.py`` are the twins of the JAX package's entry point and bench.

A kinematic rigid world (``core/colliders.ColliderSet``: sphere and box
poses, their velocities and the ground height as state tensors) reaches
every engine and the lattice, mesh and fused-backward kernels;
``interact/animator.py`` scripts it and ``examples/`` steers a collider
trajectory by gradient descent.

Scenes (``core/scenes.py``) run on the card unless the caller asks for
the CPU.  It imports torch and numpy, never jax.
"""

from .core.config import (
    DampingMode,
    FloorMode,
    LambdaMode,
    SolveMode,
    SolverConfig,
)
from .core.colliders import (
    ColliderSet,
    colliders_from_config,
    make_colliders,
)
from .core.state import (
    SimState,
    Topology,
    is_finite,
    make_state,
    restore,
    snapshot,
    state_from_numpy,
    state_from_topology,
    state_to_numpy,
    topology_from_numpy,
)

from .kernels.diff import (
    make_differentiable_lattice_runner,
    make_differentiable_lattice_step,
    make_differentiable_material_runner,
    make_differentiable_mesh_runner,
    make_differentiable_mesh_step,
    pair_with_vjp,
    pair_with_vjp_params,
)

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "SolveMode",
    "LambdaMode",
    "DampingMode",
    "FloorMode",
    "SimState",
    "Topology",
    "ColliderSet",
    "make_colliders",
    "colliders_from_config",
    "make_state",
    "state_from_topology",
    "topology_from_numpy",
    "is_finite",
    "snapshot",
    "restore",
    "state_from_numpy",
    "state_to_numpy",
    "pair_with_vjp",
    "pair_with_vjp_params",
    "make_differentiable_lattice_runner",
    "make_differentiable_lattice_step",
    "make_differentiable_mesh_runner",
    "make_differentiable_mesh_step",
    "make_differentiable_material_runner",
]
