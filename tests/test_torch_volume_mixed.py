"""The global volume constraint beside dense self-collision and the per-tet
volume, through the port's plain general engine against the JAX package's
``general.make_step`` on the CPU, at ``test_torch_volume.py``'s gates.

In a solver iteration the volume is projected after the tets and before
the contacts (JAX ``solvers/general.py:591-627``); the CUDA kernel keeps
that order (``csrc/mesh_xpbd.cu``'s launch loop).  The cases are the
``contact_*`` and ``tets_*`` ones of ``test_torch_volume_cases.py``, in
JACOBI and COLORED; ``test_torch_kernel_on_card.py`` and ``chip_smoke.py``
(phase 38) hold the kernel against its plain twin on them.
"""

import pytest

import test_torch_volume as TV


@pytest.mark.parametrize("name", TV.MIXED)
def test_volume_beside_contact_and_tets_matches_jax(name):
    TV.check_plain_engine(name)
