"""The port's sharded lattice engine against JAX's XLA spatial engine for
the cases with tets, a sphere, an ext force, the bench config and the
res-16-over-8 shape, on the CPU (the gates and the other cases are in
``test_torch_spatial.py``; the split keeps each file within a test
worker's share of the suite)."""

import pytest
import torch

from test_torch_spatial import CASES, JAX_CASES_HERE, check_against_jax_spatial

torch.set_num_threads(1)

JAX_CASES_SOLIDS = tuple(n for n in CASES if n not in JAX_CASES_HERE)


def test_the_two_files_cover_every_case():
    assert set(JAX_CASES_SOLIDS) == {"ext_force", "tets", "tets_decay",
                                     "sphere", "bench", "res16_over_8"}


@pytest.mark.parametrize("name", JAX_CASES_SOLIDS)
def test_sharded_engine_matches_jax_spatial(name):
    check_against_jax_spatial(name)
