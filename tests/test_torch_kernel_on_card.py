"""The CUDA lattice and mesh kernels against their plain PyTorch versions,
on the card.

Imports torch, numpy and the port only (no jax), so it runs on a GPU host
that has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_on_card.py

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false.  Same inputs go through each kernel's runner and its plain
engine on the card: the lattice cases of ``test_torch_cases.py``
(``make_cuda_substep_runner`` vs ``solvers.lattice.run_substeps_plain``;
max |dx| < 1e-5, max |dlambda| < 1e-6, as the JAX suite's kernel-vs-engine
tests) and the mesh cases of ``test_torch_mesh_cases.py``
(``make_mesh_cuda_step`` vs ``solvers.general.multi_step_fn``, at that
module's gates).  Both also hold multipliers to 1 % of their largest
magnitude.
"""

import pytest
import torch

from softbodysimulation_tpu_torch import state_from_numpy
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_cases as lattice_cases
import test_torch_mesh_cases as mesh_cases

CASES = lattice_cases.parity_cases()
MESH_CASES = mesh_cases.mesh_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda, name):
    cfg, inputs, substeps = CASES[name]
    spec = ptop.lattice_spec(6, braced=inputs.get("braced", True))
    state = state_from_numpy(lattice_cases.seeded_inputs(6, **inputs),
                             device=cuda)
    dt_sub, n_sub, with_ext = lattice_cases.run_length(cfg, substeps)
    before = lc.launches
    out = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_sub,
                                      with_ext=with_ext)(state)
    torch.cuda.synchronize()
    assert lc.launches > before
    ref = plat.run_substeps_plain(state, spec, cfg, dt_sub, n_sub,
                                  with_ext=with_ext)
    dx = float((out.positions - ref.positions).abs().max())
    dlam = float((out.lambda_dist - ref.lambda_dist).abs().max())
    lam = float(ref.lambda_dist.abs().max())
    # 1 g multipliers are ~1e-7 in size: they must also agree to 1 % of it
    assert dx < 1e-5 and dlam < 1e-6 and dlam <= 1e-2 * lam, (name, dx,
                                                              dlam, lam)
    assert float((out.positions - state.positions).abs().max()) > 1e-4


@pytest.mark.gpu
def test_wrapper_refuses_bad_tensors_on_card(cuda):
    """On a CUDA state the wrapper checks dtype and shape and raises."""
    cfg, inputs, _ = CASES["bench"]
    spec = ptop.lattice_spec(4, braced=True)
    state = state_from_numpy(lattice_cases.seeded_inputs(4, **inputs),
                             device=cuda)
    run = lc.make_cuda_substep_runner(spec, cfg, 1 / 480, 2)
    with pytest.raises(ValueError):
        run(state.replace(inv_mass=state.inv_mass.double()))
    with pytest.raises(ValueError):
        run(state.replace(lambda_dist=state.lambda_dist[:-1]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_kernel_matches_plain_on_card(cuda, name):
    cfg, kind, kw, frames = MESH_CASES[name]
    topo, fields = mesh_cases.case_inputs(kind, **kw)
    state = state_from_numpy(fields, device=cuda)
    before = mc.launches
    out = mc.make_mesh_cuda_step(topo, cfg, 1 / 60, n_steps=frames)(state)
    torch.cuda.synchronize()
    assert mc.launches > before
    ref = pgeneral.multi_step_fn(state, topo, cfg, 1 / 60, frames)
    dx = float((out.positions - ref.positions).abs().max())
    assert dx < mesh_cases.dx_gate(cfg), (name, dx)
    for k, gate in (("lambda_dist", mesh_cases.DLAM_DIST),
                    ("lambda_bend", mesh_cases.DLAM_BEND)):
        r = getattr(ref, k)
        if r.numel():
            d = float((getattr(out, k) - r).abs().max())
            lam = float(r.abs().max())
            assert d < gate and d <= 1e-2 * lam, (name, k, d, lam)
    assert float(out.ext_force.abs().max()) == 0.0
    assert float((out.positions - state.positions).abs().max()) > 1e-3


@pytest.mark.gpu
def test_mesh_wrapper_refuses_bad_tensors_on_card(cuda):
    cfg, kind, kw, _ = MESH_CASES["jacobi_reset_rho0"]
    topo, fields = mesh_cases.case_inputs(kind, **kw)
    state = state_from_numpy(fields, device=cuda)
    run = mc.make_mesh_cuda_substep_runner(topo, cfg, 1 / 240, 2)
    with pytest.raises(ValueError):
        run(state.replace(inv_mass=state.inv_mass.double()))
    with pytest.raises(ValueError):
        run(state.replace(lambda_dist=state.lambda_dist[:-1]))
