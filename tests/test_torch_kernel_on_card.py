"""The CUDA lattice, mesh and contact kernels against their plain PyTorch
versions, on the card.

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
module's gates), and the tet and contact cases of
``test_torch_contact_cases.py``: the B-4 pass
(``self_collision_project_blocked_cuda`` vs the plain blocked pass, max
|dx| < 1e-5), the library's curve order and candidate selection (equal to
the plain ones), and the mesh kernel on the tet cases (|dx| < 2e-5,
|dlambda_tet| < 1e-5) and the contact cases (|dx| < 2e-4).  All also hold
multipliers to 1 % of their largest magnitude.  The fused mesh backward
(B-5, ``kernels/mesh_diff.py``) on every case of ``test_torch_diff_cases.py``:
``backward_chunk_cuda`` against ``backward_chunk_plain`` (max |dg| / max
|g| < 1e-5 for every cotangent) and against autograd through the plain
engine (< 1e-4, the JAX suite's gradient gate), and the mesh kernel's
traced materials against its static path (bit for bit), and the plain
engine's hub-row sum on the card against the column-order fold.  The
slab kernel (B-6, ``kernels/spatial_cuda.py``) against the sharded torch
engine for every case of ``test_torch_spatial_cases.py`` it carries (up
to four slabs on one card; |dx| < 1e-5, |dlambda| < 1e-6), run again to
the bit; and the lattice kernel's tet sweep against the plain stencil
engine on that module's tet cases (|dx| < 2e-5, |dlambda_tet| < 1e-5).
The rigid world of ``test_torch_collider_cases.py``: the lattice and mesh
kernels with config boxes and kinematic spheres, boxes and grounds
(moved once on the same runner) against their plain versions (to the bit,
under the gates above), and B-5's pose cotangents against
``backward_chunk_plain`` (max |dg| / max |g| < 1e-5 on one scale across
the pose leaves) and autograd through the plain engine (< 1e-4).  The
two repairs: ``restore`` of a card state's snapshot re-uploads to the
card, and ``add_force`` / ``drag_force`` / ``squeeze_impulse`` on a CUDA
state equal the CPU result to the bit.  The ensembles of
``test_torch_ensemble_cases.py``: every row of the B-1 and B-3 ensembles
equal to the single-body kernel on that body to the bit, in as many
launches as one body takes, and the ensemble against its plain twin
(lattice: |dx| < 1e-5, |dlambda| < 1e-6; mesh: that module's gates).
``approx_math``: the lattice kernel against its approx twin on every
lattice case (|dx| < 1e-4, multipliers within 1 %; rcp.approx is not
IEEE) and the mesh kernel on every mesh case (JAX's band, 5e-3 and
5e-4); the hybrid contact runner against the plain cadence (< 1e-5); the
``hash`` and ``sorted`` backends through ``general.make_step`` on a CUDA
state against the CPU (< 1e-4), and their passes under
``torch.cuda.set_sync_debug_mode("error")``.  The global volume
constraint in B-3 on every case of ``test_torch_volume_cases.py``: the
kernel against its plain twin (positions, velocities and every multiplier
to the bit, ``lambda_volume`` included; beside dense contact at the
contact cases' gates), ensemble rows against the
single-body kernel to the bit in one body's launches, and a shared scalar
``lambda_volume`` refused in a volume ensemble.  B-4's two designs
(``contact_cuda.DESIGNS``): the culled pass against the plain pass on
every cloud (|dx| < 1e-5, no pair classified differently) and against
the serial design it replaced (the same touching bits and candidates,
|dx| < 1e-6, two runs equal to the bit, 4 launches against 6) at block
sizes from 8 to 1,024, M from 1 to nb, on a cloud whose blocks touch none
but themselves and one where every candidate touches, and through the
mesh loop (within 1e-5 of the serial design, 3 launches a pass).  B-3's
two designs (``mesh_cuda.DESIGNS``): the persistent kernel against the
per-pass loop to the bit on every mesh case (exact and ``approx_math``),
tet, contact, volume, ensemble and collider case, at the 20k
ball-on-cloth's frame-30/60/90 states (19 launches a 6-substep call with
blocked contact), each barrier forced, five repeats, one launch a
contact-free call, a grid beyond the card refused; the hub warps against
the plain engine to the bit; the dense pass a warp a row within 1e-5 of
the plain pass.  B-1's counted twin (``diag/profiling.counting()``): at
the two benchmark cells' shapes and a COLORED tet loop, the same state to
the bit as the kernel it twins, its barriers a warp equal to the count
along the kernel's loop (``test_torch_profiling.loop_barriers``; 26,000
and 12,480 a call), a wait shorter than the residence, and under the
profiler only ``lattice_persistent_kernel`` outside the counting scope,
with the runner's spans on the host's timeline alone.  B-1's block kind,
its tiles in shared memory for the whole call: ensembles of res-2 to
res-6 bodies, a last block with fewer bodies, WARM_START with the ext
force, COLORED with tets, a ColliderSet, ``fast_math`` and
``approx_math``, and a res-12 body forced into one block, each equal to
the per-pass loop and (exact) to the plain engine to the bit, twice, one
shared-memory launch a call (``lattice_cuda.resident_launches``); a tile
beyond the block's shared memory refused with ``ValueError`` before any
launch.
"""

import pytest
import torch

from softbodysimulation_tpu_torch import state_from_numpy
from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.kernels import mesh_diff as md
from softbodysimulation_tpu_torch.kernels import spatial_cuda as sc
from softbodysimulation_tpu_torch.parallel import spatial as psp
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.ops import incidence
from softbodysimulation_tpu_torch.ops import spatial_hash as psh
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_cases as lattice_cases
import test_torch_collider_cases as collider_cases
import test_torch_contact_cases as contact_cases
import test_torch_diff_cases as diff_cases
import test_torch_ensemble_cases as ensemble_cases
import test_torch_mesh_cases as mesh_cases
import test_torch_spatial_cases as spatial_cases
import test_torch_volume_cases as volume_cases

CASES = lattice_cases.parity_cases()
MESH_CASES = mesh_cases.mesh_cases()
TET_CASES = contact_cases.tet_cases()
CONTACT_CASES = contact_cases.contact_cases()
DIFF_CASES = diff_cases.diff_cases()
VOLUME_CASES = volume_cases.volume_cases()


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


def _lam_gates(out, ref, gates):
    """Each multiplier within its absolute gate and 1 % of its largest."""
    for k, gate in gates:
        r = getattr(ref, k)
        if r is not None and r.numel():
            d = float((getattr(out, k) - r).abs().max())
            lam = float(r.abs().max())
            assert d < gate and d <= 1e-2 * lam, (k, d, lam)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(contact_cases.CLOUDS))
def test_b4_pass_matches_plain_on_card(cuda, name):
    x, w = contact_cases.cloud(name)
    cfg = contact_cases.cloud_config(name, "blocked_pallas")
    pred = torch.as_tensor(x, device=cuda)
    inv = torch.as_tensor(w, device=cuda)
    order = psh.morton_order(pred, cfg)
    assert torch.equal(cc.curve_order_cuda(pred, cfg).long(), order)
    _, _, _, touch, d2ab, _, _, nb = psh._blocked_layout(pred, inv, order,
                                                         cfg)
    nbr, ok = psh.select_candidates(touch, d2ab, min(cfg.block_neighbors,
                                                     nb))
    knbr, kok = cc.candidates_cuda(pred, inv, order, cfg)
    assert torch.equal(knbr.long(), nbr) and torch.equal(kok, ok)
    before = cc.launches
    out = cc.self_collision_project_blocked_cuda(pred, inv, order, cfg)
    torch.cuda.synchronize()
    assert cc.launches > before
    ref = psh.self_collision_project_blocked(pred, inv, order, cfg)
    assert float((out - ref).abs().max()) < contact_cases.DX_PASS
    assert float((ref - pred).abs().max()) > 1e-4
    flips = (cc.touching_pairs_cuda(pred, inv, order, cfg)
             != psh.blocked_touching_pairs(pred, inv, order, cfg))
    assert int(flips.sum()) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TET_CASES))
def test_mesh_kernel_tets_match_plain_on_card(cuda, name):
    cfg, kind, kw, frames = TET_CASES[name]
    topo, fields = contact_cases.tet_inputs(kind, contact_cases.modules(),
                                            **kw)
    state = state_from_numpy(fields, device=cuda)
    out = mc.make_mesh_cuda_step(topo, cfg, 1 / 60, n_steps=frames)(state)
    ref = pgeneral.multi_step_fn(state, topo, cfg, 1 / 60, frames)
    assert float((out.positions - ref.positions).abs().max()) < \
        contact_cases.DX_TET
    _lam_gates(out, ref, (("lambda_tet", contact_cases.DLAM_TET),
                          ("lambda_dist", mesh_cases.DLAM_DIST)))


# the blocked cases also under their other name, blocked_pallas
CONTACT_RUNS = [(name, backend) for name, (cfg, _) in CONTACT_CASES.items()
                for backend in ((cfg.self_collision_backend, "blocked_pallas")
                                if cfg.self_collision_backend == "blocked"
                                else (cfg.self_collision_backend,))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,backend", CONTACT_RUNS)
def test_mesh_kernel_contact_matches_plain_on_card(cuda, name, backend):
    cfg, frames = CONTACT_CASES[name]
    cfg = cfg.replace(self_collision_backend=backend)
    topo, fields, _ = contact_cases.contact_scene(contact_cases.modules())
    state = state_from_numpy(fields, device=cuda)
    before = (mc.launches, cc.launches)
    out = mc.make_mesh_cuda_step(topo, cfg, 1 / 60, n_steps=frames)(state)
    torch.cuda.synchronize()
    assert mc.launches > before[0]
    assert (cc.launches > before[1]) == (cfg.self_collision_backend != "dense")
    ref = pgeneral.multi_step_fn(state, topo, cfg, 1 / 60, frames)
    assert float((out.positions - ref.positions).abs().max()) < \
        contact_cases.DX_CONTACT
    _lam_gates(out, ref, (("lambda_tet", 1.0), ("lambda_dist", 1.0),
                          ("lambda_bend", 1.0)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DIFF_CASES))
def test_b5_matches_plain_on_card(cuda, name):
    cfg, n_sub, _, kw = DIFF_CASES[name]
    topo, fields = diff_cases.case_inputs(kw)
    state, cot, mats = diff_cases.port_inputs(fields, cuda)
    before = md.launches
    got = diff_cases.chunk_vjp(md.backward_chunk_cuda, topo, cfg, n_sub,
                               state, cot, mats)
    torch.cuda.synchronize()
    assert md.launches > before
    plain = diff_cases.chunk_vjp(md.backward_chunk_plain, topo, cfg, n_sub,
                                 state, cot, mats)
    auto = diff_cases.autograd_vjp(topo, cfg, n_sub, state, cot, mats)
    err = diff_cases.normalized_errors(
        {k: v.cpu() for k, v in got.items()},
        {k: v.cpu() for k, v in plain.items()})
    assert max(err.values()) < diff_cases.KERNEL_TOL, (name, err)
    for g in (got, plain):
        err = diff_cases.normalized_errors(
            {k: v.cpu() for k, v in g.items()},
            {k: v.cpu() for k, v in auto.items()})
        assert max(err.values()) < diff_cases.GRAD_TOL, (name, err)
    assert float(auto["gx"].abs().max()) > 1e-3


@pytest.mark.gpu
def test_traced_materials_match_static_on_card(cuda):
    """The topology's own rest lengths and compliances as traced materials
    reproduce the kernel's static path bit for bit."""
    cfg, n_sub, _, kw = DIFF_CASES["clamps"]
    cfg = cfg.replace(min_alpha_tilde=0.0576, max_dlambda_rel=0.05)
    topo, fields = diff_cases.case_inputs(kw)
    state, _, _ = diff_cases.port_inputs(fields, cuda)
    run = mc.make_mesh_cuda_substep_runner(topo, cfg, diff_cases.DT, n_sub)
    a = run(state)
    b = run(state, {"rest_lengths": topo.rest_lengths.to(cuda),
                    "compliance": topo.compliance.to(cuda)})
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.lambda_dist, b.lambda_dist)
    assert torch.equal(a.positions, pgeneral.run_substeps_plain(
        state, topo, cfg, diff_cases.DT, n_sub).positions)


@pytest.mark.gpu
def test_hub_row_sum_on_card_is_the_column_order_fold(cuda):
    """The plain engine's hub rows on a CUDA tensor (one scan) equal the
    float32 fold over the columns in order, the sum of the kernel's
    particle passes, bit for bit, and the CPU path's sum."""
    gen = torch.Generator().manual_seed(0)
    head = torch.randn((2, 3), generator=gen)
    cols = (torch.randn((2, 1300, 3), generator=gen)
            * torch.exp(3.0 * torch.randn((2, 1300, 1), generator=gen)))
    run = head.to(cuda)
    for k in range(cols.shape[1]):
        run = run + cols[:, k].to(cuda)
    got = incidence._HubRowSum.apply(head.to(cuda), cols.to(cuda))
    assert torch.equal(got, run)
    assert torch.equal(incidence._HubRowSum.apply(head, cols), run.cpu())


# ---- the spatial slab kernel (B-6) and B-1's tet sweep ---------------------

SPATIAL_CASES = spatial_cases.spatial_cases()
SLAB_CASES = [n for n, (c, _, d, r, _) in SPATIAL_CASES.items()
              if spatial_cases.kernel_carries(c, d, r)]
LATTICE_TET_CASES = [n for n, (c, _, _, _, _) in SPATIAL_CASES.items()
                     if c.enable_tet_volume]


def _slab_run(cuda, name, n_slabs=None):
    cfg, inputs, d, res, frames = SPATIAL_CASES[name]
    spec = ptop.lattice_spec(res, braced=True)
    state = state_from_numpy(spatial_cases.case_inputs(res, **inputs),
                             device=cuda)
    devices = [cuda] * (n_slabs or d)
    before = sc.launches
    out = sc.make_spatial_cuda_substep(spec, cfg, spatial_cases.DT, devices,
                                       n_steps=frames)(state)
    torch.cuda.synchronize()
    assert sc.launches > before
    ref = psp.make_spatial_lattice_step(spec, cfg, spatial_cases.DT, devices,
                                        n_steps=frames, backend="xla")(state)
    return state, out, ref


@pytest.mark.gpu
@pytest.mark.parametrize("name", SLAB_CASES)
def test_slab_kernel_matches_sharded_engine_on_card(cuda, name):
    """B-6 (D slabs on one card, each on its own stream) against the
    sharded torch engine on the card, at B-1's gates."""
    state, out, ref = _slab_run(cuda, name)
    dx = float((out.positions - ref.positions).abs().max())
    assert dx < 1e-5, (name, dx)
    _lam_gates(out, ref, (("lambda_dist", 1e-6),))
    assert float(out.ext_force.abs().max()) == 0.0
    assert float((out.positions - state.positions).abs().max()) > 1e-3


@pytest.mark.gpu
def test_slab_kernel_is_race_free_on_card(cuda):
    """Four slabs on four streams, run several times: equal to the bit each
    time."""
    _, first, _ = _slab_run(cuda, "colored_reset")
    for _ in range(4):
        _, again, _ = _slab_run(cuda, "colored_reset")
        assert torch.equal(again.positions, first.positions)
        assert torch.equal(again.lambda_dist, first.lambda_dist)


@pytest.mark.gpu
@pytest.mark.parametrize("name", LATTICE_TET_CASES)
def test_lattice_kernel_tets_match_plain_on_card(cuda, name):
    """B-1 with the per-cell tet sweep against the plain stencil engine on
    one device: |dx| < 2e-5, |dlambda_tet| < 1e-5, every multiplier within
    1 % of its largest."""
    cfg, inputs, _, res, frames = SPATIAL_CASES[name]
    spec = ptop.lattice_spec(res, braced=True)
    state = state_from_numpy(spatial_cases.case_inputs(res, **inputs),
                             device=cuda)
    before = lc.launches
    out = lc.make_cuda_step(spec, cfg, spatial_cases.DT,
                            n_steps=frames)(state)
    torch.cuda.synchronize()
    assert lc.launches > before
    ref = plat.multi_step_fn(state, spec, cfg, spatial_cases.DT, frames)
    dx = float((out.positions - ref.positions).abs().max())
    assert dx < 2e-5, (name, dx)
    _lam_gates(out, ref, (("lambda_dist", 1e-6), ("lambda_tet", 1e-5)))


@pytest.mark.gpu
def test_slab_kernel_refuses_what_it_does_not_carry_on_card(cuda):
    """On CUDA slabs ``backend="auto"`` routes to B-6, which refuses tets
    and names ``backend="xla"``; that backend runs them on the card."""
    cfg, inputs, d, res, frames = SPATIAL_CASES["tets"]
    spec = ptop.lattice_spec(res, braced=True)
    with pytest.raises(NotImplementedError, match='backend="xla"'):
        psp.make_spatial_lattice_step(spec, cfg, spatial_cases.DT,
                                      [cuda] * d)
    state = state_from_numpy(spatial_cases.case_inputs(res, **inputs),
                             device=cuda)
    out = psp.make_spatial_lattice_step(spec, cfg, spatial_cases.DT,
                                        [cuda] * d, backend="xla")(state)
    assert out.device.type == "cuda" and out.lambda_tet is not None


LATTICE_COLLIDER_CASES = list(collider_cases.lattice_collider_cases())
MESH_COLLIDER_CASES = list(collider_cases.mesh_collider_cases())


@pytest.mark.gpu
@pytest.mark.parametrize("name", LATTICE_COLLIDER_CASES)
def test_lattice_kernel_colliders_match_plain_on_card(cuda, name):
    """B-1 with config boxes or a ColliderSet (its poses moved once on the
    same runner) equals the plain engine to the bit."""
    before = lc.launches
    runs = collider_cases.lattice_runs(
        name, cuda, lambda spec, cfg, dt, n, kin: lc.make_cuda_substep_runner(
            spec, cfg, dt, n, kin_colliders=kin), plat.run_substeps_plain)
    torch.cuda.synchronize()
    assert lc.launches > before
    for out, ref, start in runs:
        assert torch.equal(out.positions, ref.positions), name
        assert torch.equal(out.lambda_dist, ref.lambda_dist), name
        assert float((out.positions - start.positions).abs().max()) > 1e-4
    if len(runs) == 2:
        assert not torch.equal(runs[0][0].positions, runs[1][0].positions)


@pytest.mark.gpu
@pytest.mark.parametrize("name", MESH_COLLIDER_CASES)
def test_mesh_kernel_colliders_match_plain_on_card(cuda, name):
    """B-3 with config boxes or a ColliderSet (moved once on the same
    step) equals the plain engine to the bit."""
    before = mc.launches
    runs = collider_cases.mesh_runs(
        name, cuda, lambda topo, cfg, dt, frames, kin: mc.make_mesh_cuda_step(
            topo, cfg, dt, n_steps=frames, kin_colliders=kin),
        pgeneral.multi_step_fn)
    torch.cuda.synchronize()
    assert mc.launches > before
    for out, ref, start in runs:
        assert torch.equal(out.positions, ref.positions), name
        assert torch.equal(out.lambda_dist, ref.lambda_dist), name
        assert float((out.positions - start.positions).abs().max()) > 1e-3
    if len(runs) == 2:
        assert not torch.equal(runs[0][0].positions, runs[1][0].positions)


@pytest.mark.gpu
@pytest.mark.parametrize("n_sub,iters,rho,_",
                         collider_cases.KIN_DIFF_RUNS)
def test_b5_pose_cotangents_match_plain_on_card(cuda, n_sub, iters, rho, _):
    """B-5's pose cotangents (sphere center, radius, velocity; ground)
    against ``backward_chunk_plain`` (< 1e-5) and autograd through the
    plain engine (< 1e-4), on one scale across the pose leaves."""
    topo, cfg, st, coll, wts = collider_cases.kin_diff_inputs(
        cuda, iterations=iters, jacobi_rho=rho)
    before = md.launches
    got = collider_cases.chunk_pose_grads(md.backward_chunk_cuda, topo, cfg,
                                          n_sub, st, coll, wts)
    torch.cuda.synchronize()
    assert md.launches > before
    plain = collider_cases.chunk_pose_grads(md.backward_chunk_plain, topo,
                                            cfg, n_sub, st, coll, wts)
    auto = collider_cases.autograd_pose_grads(topo, cfg, n_sub, st, coll,
                                              wts)
    err, scale = collider_cases.pose_error(got, plain)
    assert err < diff_cases.KERNEL_TOL and scale > 1e-3, err
    assert collider_cases.pose_error(got, auto)[0] < diff_cases.GRAD_TOL


@pytest.mark.gpu
def test_restore_of_a_card_state_stays_on_the_card(cuda):
    """A card state's snapshot lies on the host; ``restore`` re-uploads it
    to the card (ColliderSet included), so the restarted state runs the
    kernel, not the plain engine on the CPU."""
    import softbodysimulation_tpu_torch as port

    spec = ptop.lattice_spec(4, braced=True)
    st = plat.make_lattice_state(spec, device=cuda).replace(
        colliders=port.make_colliders(ground_height=0.0, device=cuda))
    snap = port.snapshot(st)
    assert snap.positions.device.type == "cpu"
    rec = port.restore(snap)
    assert rec.positions.device.type == "cuda"
    assert rec.colliders.device.type == "cuda"
    assert torch.equal(rec.positions.cpu(), st.positions.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("verb", ["add_force", "drag_force",
                                  "squeeze_impulse"])
def test_pokes_on_the_card_equal_the_cpu(cuda, verb):
    """A poke on a CUDA state writes the CPU's ext_force to the bit (the
    verbs divide by tensors: a Python-float divisor becomes a reciprocal
    multiply on CUDA)."""
    from softbodysimulation_tpu_torch.interact import forces as pforces

    fields = lattice_cases.seeded_inputs(6, center=(0.0, 1.0, 0.0))
    calls = {
        "add_force": lambda s: pforces.add_force(
            s, (3.0, -1.0, 2.0), (0.2, 1.1, 0.0), radius=0.6),
        "drag_force": lambda s: pforces.drag_force(
            s, (1.0, 1.5, -0.5), strength=4.0, radius=0.7),
        "squeeze_impulse": lambda s: pforces.squeeze_impulse(
            s, (0.1, 1.0, 0.0), intensity=0.7, radius=0.45),
    }
    on_card = calls[verb](state_from_numpy(fields, device=cuda))
    on_cpu = calls[verb](state_from_numpy(fields, device="cpu"))
    assert torch.equal(on_card.ext_force.cpu(), on_cpu.ext_force)
    assert float(on_cpu.ext_force.abs().max()) > 0.1


def _lam_close(out, ref, key, gate):
    d = float((getattr(out, key) - getattr(ref, key)).abs().max())
    big = float(getattr(ref, key).abs().max())
    return d < gate and d <= 1e-2 * big + 1e-12, (key, d, big)


@pytest.mark.gpu
@pytest.mark.parametrize("name",
                         list(ensemble_cases.lattice_ensemble_cases()))
def test_lattice_ensemble_rows_match_one_body_on_card(cuda, name):
    from softbodysimulation_tpu_torch.core.state import body_of

    spec, cfg, st, frames, kin, batched = ensemble_cases.lattice_case(
        name, 6, cuda)
    nb = st.positions.shape[0]
    lc.launches = 0
    out = lc.make_cuda_step(spec, cfg, ensemble_cases.DT, frames,
                            kin_colliders=kin, n_bodies=nb,
                            batched=batched)(st)
    ens_launches = lc.launches
    single = lc.make_cuda_step(spec, cfg, ensemble_cases.DT, frames,
                               kin_colliders=kin)
    lc.launches = 0
    singles = [single(body_of(st, i)) for i in range(nb)]
    assert ens_launches == lc.launches // nb
    assert not ensemble_cases.row_mismatches(
        out, singles, ("positions", "velocities", "lambda_dist",
                       "lambda_tet"))
    ref = plat.run_substeps_plain_batched(
        st, spec, cfg, ensemble_cases.DT / cfg.substeps,
        frames * cfg.substeps, with_ext=True)
    assert float((out.positions - ref.positions).abs().max()) < 1e-5
    ok, info = _lam_close(out, ref, "lambda_dist", 1e-6)
    assert ok, info
    assert float(out.ext_force.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ensemble_cases.mesh_ensemble_cases()))
def test_mesh_ensemble_rows_match_one_body_on_card(cuda, name):
    from softbodysimulation_tpu_torch.core.state import body_of

    topo, cfg, st, mats, frames, opts = ensemble_cases.mesh_case(name, cuda)
    nb = st.positions.shape[0]
    kin = opts.get("kin")
    mc.launches = 0
    out = mc.make_mesh_cuda_step(
        topo, cfg, ensemble_cases.DT, frames, kin_colliders=kin,
        n_bodies=nb, per_body_mass=bool(opts.get("per_body_mass")))(
            st, mats)
    ens_launches = mc.launches
    single = mc.make_mesh_cuda_step(topo, cfg, ensemble_cases.DT, frames,
                                    kin_colliders=kin)
    mc.launches = 0
    singles = [single(body_of(st, i), None if mats is None
                      else {k: v[i] for k, v in mats.items()})
               for i in range(nb)]
    assert ens_launches == mc.launches // nb
    assert not ensemble_cases.row_mismatches(
        out, singles, ("positions", "velocities", "lambda_dist",
                       "lambda_bend", "lambda_tet"))
    ref = pgeneral.run_substeps_plain_batched(
        st, topo, cfg, ensemble_cases.DT / cfg.substeps,
        frames * cfg.substeps, with_ext=True, materials=mats)
    dx = float((out.positions - ref.positions).abs().max())
    assert dx < ensemble_cases.dx_gate(cfg), dx
    ok, info = _lam_close(out, ref, "lambda_dist", mesh_cases.DLAM_DIST)
    assert ok or cfg.enable_self_collision, info


# ---- approx_math, the lattice hybrid, hash and sorted on the card ---------

@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_lattice_approx_kernel_tracks_twin_on_card(cuda, name):
    """B-1 with ``approx_math`` against its plain twin (``torch.rsqrt``,
    ``torch.reciprocal``): rcp.approx is not IEEE, so a tolerance, the
    smoke's res-40 gate 1e-4 on positions; multipliers within 1 % of their
    largest."""
    cfg, inputs, substeps = CASES[name]
    spec = ptop.lattice_spec(6, braced=inputs.get("braced", True))
    state = state_from_numpy(lattice_cases.seeded_inputs(6, **inputs),
                             device=cuda)
    dt_sub, n_sub, with_ext = lattice_cases.run_length(cfg, substeps)
    out = lc.make_cuda_substep_runner(spec, cfg, dt_sub, n_sub,
                                      with_ext=with_ext,
                                      approx_math=True)(state)
    ref = plat.run_substeps_plain(state, spec, cfg, dt_sub, n_sub,
                                  with_ext=with_ext, approx_math=True)
    dx = float((out.positions - ref.positions).abs().max())
    dlam = float((out.lambda_dist - ref.lambda_dist).abs().max())
    lam = float(ref.lambda_dist.abs().max())
    assert dx < 1e-4 and dlam <= 1e-2 * lam, (name, dx, dlam, lam)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_approx_kernel_tracks_twin_on_card(cuda, name):
    """B-3 with ``approx_math`` against its plain twin, within JAX's own
    band for its approx kernel (5e-3 on positions, 5e-4 on multipliers:
    ``tests/test_mesh_pallas.py:111-118``)."""
    cfg, kind, kw, frames = MESH_CASES[name]
    topo, fields = mesh_cases.case_inputs(kind, **kw)
    state = state_from_numpy(fields, device=cuda)
    n = frames * cfg.substeps
    out = mc.make_mesh_cuda_substep_runner(topo, cfg, 1 / 60 / cfg.substeps,
                                           n, with_ext=True,
                                           approx_math=True)(state)
    ref = pgeneral.run_substeps_plain(state, topo, cfg, 1 / 60 / cfg.substeps,
                                      n, with_ext=True, approx_math=True)
    assert float((out.positions - ref.positions).abs().max()) < 5e-3
    for k in ("lambda_dist", "lambda_bend"):
        r = getattr(ref, k)
        if r.numel():
            assert float((getattr(out, k) - r).abs().max()) < 5e-4, (name, k)


@pytest.mark.gpu
def test_lattice_hybrid_matches_plain_cadence_on_card(cuda):
    """The hybrid contact runner (kernel chunks, plain stencil contact
    substeps) against the plain engine's cadence on the card, for the
    blocked pass of the plain engine and of B-4: the kernel chunks are the
    plain engine's bits, so within 1e-5 (the smoke holds the 64k config
    and prints the gap)."""
    for backend in ("blocked", "blocked_pallas"):
        cfg = CASES["bench"][0].replace(
            substeps=6, enable_self_collision=True, particle_radius=0.09,
            self_collision_backend=backend, collision_block_size=128,
            block_neighbors=2, self_collision_every=3)
        spec = ptop.lattice_spec(6, braced=True)
        state = plat.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                        mass=0.001, device=cuda)
        run = lc.make_hybrid_contact_runner(spec, cfg, 1 / 360, 8)
        before = lc.launches
        out = run(state)
        torch.cuda.synchronize()
        assert lc.launches > before
        ref = plat.run_substeps_plain(state, spec, cfg, 1 / 360, 8)
        assert float((out.positions - ref.positions).abs().max()) < 1e-5


@pytest.mark.gpu
def test_hash_and_sorted_on_a_cuda_state(cuda):
    """``general.make_step`` takes ``hash`` and ``sorted`` on a CUDA state
    (the plain engine on the card, ``route``) and tracks the CPU within
    1e-4 over 5 frames; their passes make no host sync there."""
    from softbodysimulation_tpu_torch.examples import config4_interactive_poke
    from softbodysimulation_tpu_torch.ops import spatial_hash

    topo, cfg, st = config4_interactive_poke.scene(device="cpu")
    for c in (cfg, cfg.replace(self_collision_backend="sorted"),
              cfg.replace(self_collision_every=2)):
        step = pgeneral.make_step(topo, c, 1 / 60, n_steps=5)
        card = step(st.to(cuda))
        assert float((card.positions.cpu() - step(st).positions).abs()
                     .max()) < 1e-4, (c.self_collision_backend,
                                      c.self_collision_every, step.route)
    pred, w = st.positions.to(cuda) + 0.01, st.inv_mass.to(cuda)
    scfg = cfg.replace(self_collision_backend="sorted")
    spatial_hash.self_collision_project(pred, w, cfg)    # constants copied
    spatial_hash.self_collision_project_sorted(
        pred, w, spatial_hash.morton_order(pred, scfg), scfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spatial_hash.self_collision_project(pred, w, cfg)
        order = spatial_hash.morton_order(pred, scfg)
        spatial_hash.self_collision_project_sorted(pred, w, order, scfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---- the global volume constraint in B-3 ------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VOLUME_CASES))
def test_mesh_kernel_volume_matches_plain_on_card(cuda, name):
    """B-3 with the volume against its plain twin, one body through the
    step and ensembles through ``general.make_batched_step``: every leaf
    to the bit (beside dense contact: positions within 2e-4,
    ``lambda_volume`` within 1e-4, the other multipliers within 1 % of
    their largest, ``test_torch_volume_cases.card_exact``); an ensemble's
    rows equal the single-body kernel's in as many launches as one body
    takes."""
    from softbodysimulation_tpu_torch.core.state import body_of

    cfg, topo, fields, nb, frames = volume_cases.case_inputs(name)
    st = state_from_numpy(fields, device=cuda)
    one = mc.make_mesh_cuda_step(topo, cfg, volume_cases.DT, n_steps=frames)
    mc.launches = 0
    if nb == 1:
        out = one(st)
        ref = pgeneral.multi_step_fn(st, topo, cfg, volume_cases.DT, frames)
    else:
        out = pgeneral.make_batched_step(topo, cfg, volume_cases.DT,
                                         frames)(st)
        ref = pgeneral.run_substeps_plain_batched(
            st, topo, cfg, volume_cases.DT / cfg.substeps,
            frames * cfg.substeps, with_ext=True)
    torch.cuda.synchronize()
    launched, mc.launches = mc.launches, 0
    assert launched > 0
    keys = ("positions", "velocities", "lambda_dist", "lambda_bend",
            "lambda_volume") + (("lambda_tet",) if topo.n_tets else ())
    diffs = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
             if getattr(ref, k).numel() else 0.0 for k in keys}
    print(f"B-3 volume {name}: {diffs}")
    if volume_cases.card_exact(cfg):
        for k in keys:
            assert torch.equal(getattr(out, k), getattr(ref, k)), (name, k)
    else:
        assert diffs["positions"] < volume_cases.DX_CARD_CONTACT
        assert diffs["lambda_volume"] < volume_cases.DLAM_VOLUME
        _lam_gates(out, ref, [(k, 1.0) for k in keys if k.startswith(
            "lambda_") and k != "lambda_volume"])
    assert float(out.lambda_volume.abs().min()) > 0.0
    if nb > 1:
        rows = [one(body_of(st, b)) for b in range(nb)]
        assert launched == mc.launches // nb
        for b, row in enumerate(rows):
            for k in keys:
                assert torch.equal(getattr(out, k)[b], getattr(row, k)), (
                    name, b, k)
        with pytest.raises(ValueError, match="lambda_volume"):
            pgeneral.make_batched_step(topo, cfg, volume_cases.DT, 1)(
                st.replace(lambda_volume=st.lambda_volume[0]))


# ---- B-1's persistent kernel against its per-pass loop -------------------

B1_LEAVES = ("positions", "velocities", "lambda_dist", "lambda_tet",
             "ext_force")


def _b1_designs(state, spec, cfg, dt_sub, n_sub, with_ext=False,
                batched=False, approx_math=False, schedule=None):
    """(persistent result, per-pass result, persistent launches) of one
    call from the same state."""
    run = lambda **kw: lc.run_substeps_cuda(    # noqa: E731
        state, spec, cfg, dt_sub, n_sub, with_ext, batched, approx_math,
        **kw)
    before = lc.launches
    new = run(schedule=schedule)
    n_new = lc.launches - before
    old = run(design="per_pass")
    torch.cuda.synchronize()
    return new, old, n_new


def _bits_equal(a, b):
    """Leaves of two results that differ in any bit (NaN-aware)."""
    bad = []
    for k in B1_LEAVES:
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (x is not None and not torch.equal(
                x.view(torch.int32), y.view(torch.int32))):
            bad.append(k)
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("approx", [False, True])
def test_persistent_b1_equals_per_pass_and_plain_on_card(cuda, name, approx):
    """Every lattice parity case at res 6: the persistent kernel (one
    launch) equals the per-pass loop to the bit, and, exact, the plain
    twin too; with ``approx_math`` the twin is held at the approx gates."""
    cfg, inputs, substeps = CASES[name]
    spec = ptop.lattice_spec(6, braced=inputs.get("braced", True))
    state = state_from_numpy(lattice_cases.seeded_inputs(6, **inputs),
                             device=cuda)
    dt_sub, n_sub, with_ext = lattice_cases.run_length(cfg, substeps)
    new, old, n_new = _b1_designs(state, spec, cfg, dt_sub, n_sub, with_ext,
                                  approx_math=approx)
    assert n_new == 1
    assert not _bits_equal(new, old), (name, _bits_equal(new, old))
    ref = plat.run_substeps_plain(state, spec, cfg, dt_sub, n_sub,
                                  with_ext=with_ext, approx_math=approx)
    if approx:
        assert float((new.positions - ref.positions).abs().max()) < 1e-4
    else:
        assert not _bits_equal(new, ref), (name, _bits_equal(new, ref))


@pytest.mark.gpu
def test_persistent_b1_equals_per_pass_at_res_40_on_card(cuda):
    """The bench configuration at res 40 (the main path's shapes), from a
    seeded jittered start, exact and approx: bit for bit."""
    import numpy as np

    cfg, inputs, _ = CASES["bench"]
    spec = ptop.lattice_spec(40, braced=True)
    state = plat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device=cuda)
    jitter = np.random.default_rng(3).normal(0.0, 0.05,
                                             (spec.n_particles, 3))
    state = state.replace(velocities=torch.as_tensor(
        jitter, dtype=torch.float32, device=cuda))
    for approx in (False, True):
        new, old, n_new = _b1_designs(state, spec, cfg, 1 / 480, 16,
                                      approx_math=approx)
        assert n_new == 1 and not _bits_equal(new, old), approx
        assert float((new.positions - state.positions).abs().max()) > 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", LATTICE_TET_CASES)
def test_persistent_b1_tets_equal_per_pass_on_card(cuda, name):
    cfg, inputs, _, res, frames = SPATIAL_CASES[name]
    spec = ptop.lattice_spec(res, braced=True)
    state = state_from_numpy(spatial_cases.case_inputs(res, **inputs),
                             device=cuda)
    new, old, n_new = _b1_designs(state, spec, cfg,
                                  spatial_cases.DT / cfg.substeps,
                                  frames * cfg.substeps, with_ext=True)
    assert n_new == 1 and new.lambda_tet is not None
    assert not _bits_equal(new, old), (name, _bits_equal(new, old))


@pytest.mark.gpu
@pytest.mark.parametrize("name", LATTICE_COLLIDER_CASES)
def test_persistent_b1_colliders_equal_per_pass_on_card(cuda, name):
    """Config boxes and a ColliderSet's traced table (its poses moved once
    on the same runner): the persistent kernel equals the per-pass loop."""
    def runner(design):
        return lambda spec, cfg, dt, n, kin: (
            lambda st: lc.run_substeps_cuda(st, spec, cfg, dt, n,
                                            design=design))

    new = collider_cases.lattice_runs(name, cuda, runner("persistent"),
                                      plat.run_substeps_plain)
    old = collider_cases.lattice_runs(name, cuda, runner("per_pass"),
                                      plat.run_substeps_plain)
    for (a, ref, _), (b, _, _) in zip(new, old):
        assert not _bits_equal(a, b), name
        assert not _bits_equal(a, ref), name


@pytest.mark.gpu
@pytest.mark.parametrize("name",
                         list(ensemble_cases.lattice_ensemble_cases()))
def test_persistent_b1_ensembles_equal_per_pass_on_card(cuda, name):
    from softbodysimulation_tpu_torch.core.state import body_contract

    spec, cfg, st, frames, kin, batched = ensemble_cases.lattice_case(
        name, 6, cuda)
    nb = st.positions.shape[0]
    new, old, n_new = _b1_designs(
        st, spec, cfg, ensemble_cases.DT / cfg.substeps,
        frames * cfg.substeps, with_ext=True,
        batched=body_contract(nb, batched))
    assert n_new == 1
    assert not _bits_equal(new, old), (name, _bits_equal(new, old))


def _barrier_shapes(cuda):
    """(spec, config, state, substeps, batched): one res-10 body with tets
    and WARM_START COLORED, and an ensemble of five res-6 bodies."""
    from softbodysimulation_tpu_torch.core import config as C

    cfg = CASES["bench"][0].replace(
        solve_mode=C.SolveMode.COLORED, iterations=2,
        lambda_mode=C.LambdaMode.WARM_START, lambda_decay=1.0,
        enable_tet_volume=True, tet_compliance=1e-6)
    spec = ptop.lattice_spec(10, braced=True)
    one = plat.make_lattice_state(spec, center=(0.0, 0.55, 0.0), mass=0.01,
                                  tet_volume=True, device=cuda)
    espec, ecfg, est, frames, _, _ = ensemble_cases.lattice_case(
        "warm_jacobi_ext", 6, cuda)
    return [(spec, cfg, one, 12, False),
            (espec, ecfg, est, frames * ecfg.substeps, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("barrier", list(lc.BARRIERS))
def test_each_barrier_kind_equals_per_pass_on_card(cuda, barrier):
    """Each barrier (``__syncthreads`` with whole bodies a block, and the
    counting grid barrier), forced on a single body and on an ensemble,
    equals the per-pass loop to the bit in one launch; run again, the same
    bits."""
    for spec, cfg, st, n_sub, batched in _barrier_shapes(cuda):
        nb = st.positions.shape[0] if batched else 1
        sched = lc.schedule_for(spec, nb, cuda, barrier=barrier)
        assert sched.barrier == barrier
        new, old, n_new = _b1_designs(st, spec, cfg, 1 / 240, n_sub,
                                      with_ext=True, batched=batched,
                                      schedule=sched)
        assert n_new == 1
        assert not _bits_equal(new, old), (barrier, _bits_equal(new, old))
        again, _, _ = _b1_designs(st, spec, cfg, 1 / 240, n_sub,
                                  with_ext=True, batched=batched,
                                  schedule=sched)
        assert not _bits_equal(again, new), barrier


@pytest.mark.gpu
def test_persistent_b1_is_race_free_on_card(cuda):
    """A res-24 body over 40 substeps on many blocks, the counting grid
    barrier, run five times: equal to the bit each time and to the
    per-pass loop."""
    cfg = CASES["bench"][0]
    spec = ptop.lattice_spec(24, braced=True)
    state = plat.make_lattice_state(spec, center=(0.0, 0.52, 0.0),
                                    mass=0.001, device=cuda)
    ref = lc.run_substeps_cuda(state, spec, cfg, 1 / 480, 40,
                               design="per_pass")
    sched = lc.schedule_for(spec, 1, cuda, barrier="counter")
    assert sched.grid > 1
    for _ in range(5):
        out = lc.run_substeps_cuda(state, spec, cfg, 1 / 480, 40,
                                   schedule=sched)
        assert not _bits_equal(out, ref)


@pytest.mark.gpu
def test_persistent_b1_launches_once_a_call_on_card(cuda):
    """One launch a call on every lattice route: the runner (any number of
    substeps), ``make_cuda_step`` over several frames, an ensemble, and
    each contact-free chunk of the hybrid runner; none for no substep."""
    cfg, inputs, _ = CASES["bench"]
    spec = ptop.lattice_spec(6, braced=True)
    state = state_from_numpy(lattice_cases.seeded_inputs(6, **inputs),
                             device=cuda)

    def count(fn):
        before = lc.launches
        fn()
        return lc.launches - before

    for n in (1, 7, 64):
        assert count(lambda: lc.make_cuda_substep_runner(
            spec, cfg, 1 / 480, n)(state)) == 1
    assert count(lambda: lc.make_cuda_step(spec, cfg, 1 / 60,
                                           n_steps=3)(state)) == 1
    assert count(lambda: lc.make_cuda_substep_runner(
        spec, cfg, 1 / 480, 0)(state)) == 0
    # the per-pass loop: predict, 13 family passes and contacts a substep
    assert count(lambda: lc.run_substeps_cuda(
        state, spec, cfg, 1 / 480, 2, design="per_pass")) == 2 * 15
    espec, ecfg, est, frames, kin, batched = ensemble_cases.lattice_case(
        "warm_jacobi_ext", 6, cuda)
    assert count(lambda: lc.make_cuda_step(
        espec, ecfg, ensemble_cases.DT, frames, kin_colliders=kin,
        n_bodies=est.positions.shape[0], batched=batched)(est)) == 1
    hcfg = cfg.replace(substeps=6, enable_self_collision=True,
                       particle_radius=0.09, self_collision_backend="blocked",
                       collision_block_size=128, block_neighbors=2,
                       self_collision_every=3)
    hstate = plat.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                     mass=0.001, device=cuda)
    # 9 substeps every 3rd: three chunks of two contact-free substeps
    assert count(lambda: lc.make_hybrid_contact_runner(
        spec, hcfg, 1 / 360, 9)(hstate)) == 3


# The block kind's tests run before the refused cooperative launch below:
# the per-pass loop they hold it against checks each launch with
# cudaGetLastError(), which also reports an earlier call's refusal.  Their
# fixture clears that error first, so they pass in any order.
@pytest.fixture
def clear_cuda_error(cuda):
    """The thread's last CUDA error, read and cleared."""
    torch.cuda.synchronize()
    lc._library().lattice_xpbd_last_error()


def _resident_cases():
    """``{name: (res, bodies, config, input kwargs, approx_math, forced)}``
    of the block kind, whose tiles live in shared memory: ensembles of
    res-2 to res-6 bodies (res 2's 300 put three bodies in a block), 133
    res-4 bodies (two a block, the last block one: the ext force on it),
    COLORED with tets, a ColliderSet's sphere and box, ``approx_math``,
    ``fast_math``, and a res-12 body forced whole into one block (1,728
    particles, 228,096 bytes of tile: the largest that fits)."""
    from softbodysimulation_tpu_torch.core import config as C

    ens = {k: v[0] for k, v in ensemble_cases.lattice_ensemble_cases().items()}
    kin = collider_cases.lattice_collider_cases()["kin_spheres_boxes"][0]
    bench = CASES["bench"][0]
    warm_colored = bench.replace(solve_mode=C.SolveMode.COLORED, iterations=2,
                                 lambda_mode=C.LambdaMode.WARM_START,
                                 lambda_decay=1.0)
    tets = ens["solid_tets"].replace(solve_mode=C.SolveMode.COLORED)
    return {
        "res2_reset": (2, 300, ens["reset"], {}, False, False),
        "res3_colored_decay": (3, 20, ens["colored_decay"], {}, False,
                               False),
        "res4_warm_ext_last_block": (4, 133, ens["warm_jacobi_ext"],
                                     dict(ext_body=132), False, False),
        "res5_fast_math": (5, 9, bench, {}, False, False),
        "res6_warm_ext": (6, 5, ens["warm_jacobi_ext"], dict(ext_body=2),
                          False, False),
        "res4_colored_tets": (4, 6, tets, dict(tets=True), False, False),
        "res6_collider_set": (6, 3, kin, "kin", False, False),
        "res4_approx": (4, 133, ens["warm_jacobi_ext"], dict(ext_body=0),
                        True, False),
        "res12_forced_one_body": (12, 1, warm_colored, {}, False, True),
    }


RESIDENT_CASES = list(_resident_cases())
RESIDENT_FRAMES = 2


@pytest.mark.gpu
@pytest.mark.usefixtures("clear_cuda_error")
@pytest.mark.parametrize("name", RESIDENT_CASES)
def test_resident_block_kind_equals_per_pass_and_plain_on_card(cuda, name):
    """The block kind, its tiles in shared memory for the whole call,
    equals the per-pass loop to the bit on every body and, exact, the
    plain engine on the first, a middle and the last body; run twice, the
    same bits, each call one launch that took the shared-memory kind."""
    from softbodysimulation_tpu_torch import make_colliders
    from softbodysimulation_tpu_torch.core.state import body_of

    res, nb, cfg, kw, approx, forced = _resident_cases()[name]
    spec = ptop.lattice_spec(res, braced=True)
    st = state_from_numpy(ensemble_cases.lattice_inputs(
        res, nb, **({} if kw == "kin" else kw)), device=cuda)
    if kw == "kin":
        st = st.replace(colliders=make_colliders(
            device=cuda, **collider_cases.LATTICE_KIN))
    sched = (lc.schedule_for(spec, nb, cuda, barrier="block") if forced
             else lc.schedule_for(spec, nb, cuda))
    assert sched.kind == "block"
    dt_sub = ensemble_cases.DT / cfg.substeps
    n_sub = RESIDENT_FRAMES * cfg.substeps
    runs = []
    for _ in range(2):
        resident = lc.resident_launches
        new, old, n_new = _b1_designs(st, spec, cfg, dt_sub, n_sub,
                                      with_ext=True, batched=True,
                                      approx_math=approx, schedule=sched)
        # one launch, the shared-memory kind (the per-pass loop's are not)
        assert (n_new, lc.resident_launches - resident) == (1, 1), name
        runs.append(new)
        assert not _bits_equal(new, old), (name, _bits_equal(new, old))
    assert not _bits_equal(runs[1], runs[0]), name
    assert float((new.positions - st.positions).abs().max()) > 1e-4
    if approx:
        return
    for b in sorted({0, nb // 2, nb - 1}):
        ref = plat.run_substeps_plain(body_of(st, b), spec, cfg, dt_sub,
                                      n_sub, with_ext=True)
        for k in ("positions", "velocities", "lambda_dist", "lambda_tet"):
            x, y = getattr(new, k), getattr(ref, k)
            assert (x is None) == (y is None), (name, k)
            if x is not None:
                assert torch.equal(x[b].view(torch.int32),
                                   y.view(torch.int32)), (name, b, k)


@pytest.mark.gpu
@pytest.mark.usefixtures("clear_cuda_error")
def test_block_tile_beyond_shared_memory_raises_on_card(cuda):
    """A forced block plan whose tile does not fit the shared memory a
    block may hold (one res-16 body: 540,672 bytes) raises ValueError
    before any launch; a block-kind call right after it runs."""
    cfg = CASES["bench"][0]
    spec = ptop.lattice_spec(16, braced=True)
    state = plat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device=cuda)
    sched = lc.schedule_for(spec, 1, cuda, barrier="block")
    assert lc.tile_bytes(sched, spec.n_families) == 540672
    before = (lc.launches, lc.resident_launches)
    with pytest.raises(ValueError, match="shared memory"):
        lc.run_substeps_cuda(state, spec, cfg, 1 / 480, 4, schedule=sched)
    assert (lc.launches, lc.resident_launches) == before
    small = ptop.lattice_spec(4, braced=True)
    st4 = plat.make_lattice_state(small, center=(0.0, 0.6, 0.0),
                                  mass=0.001, device=cuda)
    out = lc.run_substeps_cuda(st4, small, cfg, 1 / 480, 4)
    torch.cuda.synchronize()
    assert (lc.launches, lc.resident_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert bool(torch.isfinite(out.positions).all())


@pytest.mark.gpu
def test_grid_that_cannot_be_resident_raises_on_card(cuda):
    """A grid barrier's grid beyond what the card holds at once is refused
    by the cooperative launch and raises; nothing runs on another path,
    and the next launch is not failed for the refusal."""
    import dataclasses

    cfg, inputs, _ = CASES["bench"]
    spec = ptop.lattice_spec(12, braced=True)
    state = plat.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                    mass=0.001, device=cuda)
    sms, per_sm = lc.device_occupancy(torch.cuda.current_device(),
                                      "counter")
    big = dataclasses.replace(lc.schedule_for(spec, 1, cuda, "counter"),
                              grid=sms * per_sm + 1, chunk=32)
    before = lc.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        lc.run_substeps_cuda(state, spec, cfg, 1 / 480, 4, schedule=big)
    assert lc.launches == before
    # the refusal is that call's alone: the next launch, whole bodies a
    # block, runs
    small = ptop.lattice_spec(4, braced=True)
    st4 = plat.make_lattice_state(small, center=(0.0, 0.6, 0.0),
                                  mass=0.001, device=cuda)
    assert lc.schedule_for(small, 1, cuda).barrier == "block"
    lc.run_substeps_cuda(st4, small, cfg, 1 / 480, 4)
    assert lc.launches == before + 1
    with pytest.raises(ValueError, match="co-resident"):
        lc.plan_schedule(spec, 1, sms, per_sm, barrier="counter",
                         grid=sms * per_sm + 1)


def _b4_designs(pred, inv, cfg):
    """The standalone B-4 pass in both designs on one state: (order, {design:
    (positions, launches, touching bits, (nbr, ok))})."""
    order = psh.morton_order(pred, cfg)
    out = {}
    for design in cc.DESIGNS:
        before = cc.launches
        x = cc.self_collision_project_blocked_cuda(pred, inv, order, cfg,
                                                   design=design)
        torch.cuda.synchronize()
        out[design] = (x, cc.launches - before,
                       cc.touching_pairs_cuda(pred, inv, order, cfg, design),
                       cc.candidates_cuda(pred, inv, order, cfg, design))
    return order, out


def _b4_culled_equals_serial(pred, inv, cfg):
    """The culled pass against the serial one: the same candidates and
    touching bits, |dx| < 1e-6, and the same bits in a second run; returns
    (order, culled positions, touching bits)."""
    order, d = _b4_designs(pred, inv, cfg)
    (x, n_new, bits, (nbr, ok)), (xo, n_old, bits_o, (nbr_o, ok_o)) = (
        d["culled"], d["serial"])
    assert (n_new, n_old) == (4, 6)
    assert torch.equal(nbr, nbr_o) and torch.equal(ok, ok_o)
    assert torch.equal(bits, bits_o)
    assert float((x - xo).abs().max()) < 1e-6
    again = cc.self_collision_project_blocked_cuda(pred, inv, order, cfg)
    assert torch.equal(again.view(torch.int32), x.view(torch.int32))
    return order, x, bits


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(contact_cases.CLOUDS))
def test_culled_b4_matches_plain_and_serial_on_card(cuda, name):
    x, w = contact_cases.cloud(name)
    cfg = contact_cases.cloud_config(name, "blocked_pallas")
    pred = torch.as_tensor(x, device=cuda)
    inv = torch.as_tensor(w, device=cuda)
    order, out, bits = _b4_culled_equals_serial(pred, inv, cfg)
    ref = psh.self_collision_project_blocked(pred, inv, order, cfg)
    assert float((out - ref).abs().max()) < contact_cases.DX_PASS
    touch = psh.blocked_touching_pairs(pred, inv, order, cfg)
    assert int(touch.sum()) > 0 and torch.equal(bits, touch)


def _b4_shape_cloud(kind, n, seed=0):
    """(positions, inverse masses, radius): a seeded uniform cloud of n;
    ``isolated``: n / 64 jittered 4^3 lattices (spacing 0.045, diameter
    0.05, so neighbours overlap by about 0.005), each inside an aligned
    cube of 4^3 cells of the curve's grid (the cell is the diameter), which
    the Hilbert curve visits in one run, with an empty cube between two
    lattices: with B = 64 each block is one lattice and no block's AABB
    touches another's; ``dense``: one jittered 8^3 lattice at spacing
    0.025, diameter 0.05, whose octants (the blocks at B = 64) all touch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind in ("isolated", "dense"):
        side = 4 if kind == "isolated" else 8
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        if kind == "isolated":
            cubes = rng.choice(6 ** 3, n // 64, replace=False)
            cubes[0] = 0
            origin = 0.4 * np.stack(np.unravel_index(cubes, (6, 6, 6)), 1)
            x = (origin[:, None, :] + 0.02 + 0.045 * g[None]).reshape(-1, 3)
        else:
            x = 0.025 * g
        x = x + rng.uniform(-5e-4, 5e-4, x.shape)
        x[0] = 0.0          # the grid's corner: cells start at 0
        radius = 0.025
    else:
        x = rng.uniform(-0.5, 0.5, (n, 3))
        radius = 0.04
    w = np.where(np.arange(len(x)) % 7 == 0, 0.0, 1.0)
    return (torch.as_tensor(x, dtype=torch.float32, device="cuda"),
            torch.as_tensor(w, dtype=torch.float32, device="cuda"), radius)


@pytest.mark.gpu
@pytest.mark.parametrize("m_nbr", [1, 4, 32, "nb"])
@pytest.mark.parametrize("block", [8, 64, 128, 256, 1024])
def test_culled_b4_shapes_on_card(cuda, block, m_nbr):
    """Block sizes from 8 to 1,024 (n = 1,500: never whole blocks) and M
    from 1 to nb: the culled pass equals the serial one and is within
    1e-5 of the plain pass with the plain candidates."""
    pred, inv, radius = _b4_shape_cloud("uniform", 1500, seed=block)
    nb = -(-1500 // block)
    cfg = contact_cases.cloud_config(
        "cloud1000", "blocked_pallas", particle_radius=radius,
        collision_block_size=block,
        block_neighbors=nb if m_nbr == "nb" else m_nbr)
    order, out, _ = _b4_culled_equals_serial(pred, inv, cfg)
    ref = psh.self_collision_project_blocked(pred, inv, order, cfg)
    assert float((out - ref).abs().max()) < contact_cases.DX_PASS
    _, _, _, touch, d2ab, _, _, nb = psh._blocked_layout(pred, inv, order,
                                                         cfg)
    nbr, ok = psh.select_candidates(touch, d2ab,
                                    min(cfg.block_neighbors, nb))
    knbr, kok = cc.candidates_cuda(pred, inv, order, cfg)
    assert torch.equal(knbr.long(), nbr) and torch.equal(kok, ok)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["isolated", "dense"])
def test_culled_b4_extremes_on_card(cuda, kind):
    """No block touches another (each row block tests itself alone, every
    other candidate filled in index order), and every candidate touches."""
    pred, inv, radius = _b4_shape_cloud(kind, 1024)
    cfg = contact_cases.cloud_config(
        "cloud1000", "blocked_pallas", particle_radius=radius,
        collision_block_size=64, block_neighbors=8)
    order, out, _ = _b4_culled_equals_serial(pred, inv, cfg)
    nbr, ok = cc.candidates_cuda(pred, inv, order, cfg)
    ref = psh.self_collision_project_blocked(pred, inv, order, cfg)
    assert float((out - ref).abs().max()) < contact_cases.DX_PASS
    assert float((out - pred).abs().max()) > 1e-4
    if kind == "isolated":
        nb = nbr.shape[0]
        fill = torch.stack([torch.cat([torch.arange(i), torch.arange(
            i + 1, nb)])[:7] for i in range(nb)]).to(nbr)
        assert torch.equal(nbr[:, 0], torch.arange(nb).to(nbr))
        assert torch.equal(nbr[:, 1:], fill)
        assert bool(ok[:, 0].all()) and not bool(ok[:, 1:].any())
    else:
        assert bool(ok.all())


@pytest.mark.gpu
def test_mesh_loop_takes_the_culled_pass_on_card(cuda):
    """The mesh library's blocked contact: the culled pass in 3 launches
    (the serial 5) a pass, within 1e-5 of the serial design over a few
    contact substeps on the contact scene."""
    topo, fields, _ = contact_cases.contact_scene(contact_cases.modules())
    cfg, _ = CONTACT_CASES["blocked_every3"]
    cfg = cfg.replace(self_collision_backend="blocked_pallas",
                      self_collision_every=1)
    state = state_from_numpy(fields, device=cuda)
    dt_sub = 1 / 60 / cfg.substeps
    runs = {}
    for design in cc.DESIGNS:
        before = cc.launches
        runs[design] = (mc.run_substeps_cuda(state, topo, cfg, dt_sub, 3,
                                             contact_design=design),
                        cc.launches - before)
        torch.cuda.synchronize()
    (new, n_new), (old, n_old) = runs["culled"], runs["serial"]
    # a contact substep's curve order is 3 launches; each pass 3 (or 5)
    passes = (n_old - n_new) // 2
    assert passes >= 3 and n_new == 3 * 3 + 3 * passes
    assert float((new.positions - old.positions).abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("block,m_nbr", [(256, 4), (128, 6)])
def test_culled_b4_first_launch_in_a_fresh_process_on_card(cuda, block,
                                                           m_nbr):
    """The pair kernel's static and dynamic shared memory together pass
    48 KB at these shapes though the dynamic part alone does not: the
    first launch of a process must opt in all the same."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import test_torch_contact_cases as K\n"
        "from softbodysimulation_tpu_torch.kernels import contact_cuda as cc\n"
        "from softbodysimulation_tpu_torch.ops import spatial_hash as sh\n"
        "x, w = K.cloud('cloud1000')\n"
        "cfg = K.cloud_config('cloud1000', 'blocked_pallas',\n"
        f"    collision_block_size={block}, block_neighbors={m_nbr})\n"
        "p = torch.as_tensor(x, device='cuda')\n"
        "w = torch.as_tensor(w, device='cuda')\n"
        "o = sh.morton_order(p, cfg)\n"
        "out = cc.self_collision_project_blocked_cuda(p, w, o, cfg)\n"
        "ref = sh.self_collision_project_blocked(p, w, o, cfg)\n"
        "print(float((out - ref).abs().max()))\n")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", code, os.path.dirname(here),
                           here], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert float(proc.stdout.split()[-1]) < contact_cases.DX_PASS


# ---- B-3's persistent kernel against its per-pass loop -------------------

B3_LEAVES = ("positions", "velocities", "lambda_dist", "lambda_bend",
             "lambda_tet", "lambda_volume", "ext_force")


def _b3_bits(a, b):
    """Leaves of two mesh results that differ in any bit (NaN-aware)."""
    bad = []
    for k in B3_LEAVES:
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (x is not None and not torch.equal(
                x.reshape(-1).view(torch.int32),
                y.reshape(-1).view(torch.int32))):
            bad.append(k)
    return bad


def _b3_designs(state, topo, cfg, dt_sub, n_sub, **kw):
    """{design: (result, launches)} of one call from the same state."""
    out = {}
    for design in mc.DESIGNS:
        before = mc.launches
        out[design] = (mc.run_substeps_cuda(state, topo, cfg, dt_sub, n_sub,
                                            design=design, **kw),
                       mc.launches - before)
    torch.cuda.synchronize()
    return out


def _b3_equal(state, topo, cfg, dt_sub, n_sub, launches=1, **kw):
    """The persistent design equals the per-pass loop to the bit, in
    ``launches`` launches (None: not checked); returns its result."""
    runs = _b3_designs(state, topo, cfg, dt_sub, n_sub, **kw)
    (new, n_new), (old, _) = runs["persistent"], runs["per_pass"]
    assert not _b3_bits(new, old), _b3_bits(new, old)
    assert launches is None or n_new == launches, n_new
    return new


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MESH_CASES))
@pytest.mark.parametrize("approx", [False, True])
def test_persistent_b3_equals_per_pass_on_card(cuda, name, approx):
    """Every mesh case (JACOBI and COLORED, every lambda mode, Chebyshev,
    bending, pins), exact and ``approx_math``: one launch, every leaf equal
    to the per-pass loop to the bit."""
    cfg, kind, kw, frames = MESH_CASES[name]
    topo, fields = mesh_cases.case_inputs(kind, **kw)
    state = state_from_numpy(fields, device=cuda)
    new = _b3_equal(state, topo, cfg, 1 / 60 / cfg.substeps,
                    frames * cfg.substeps, with_ext=True,
                    approx_math=approx)
    assert float((new.positions - state.positions).abs().max()) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TET_CASES))
def test_persistent_b3_tets_equal_per_pass_on_card(cuda, name):
    cfg, kind, kw, frames = TET_CASES[name]
    topo, fields = contact_cases.tet_inputs(kind, contact_cases.modules(),
                                            **kw)
    state = state_from_numpy(fields, device=cuda)
    _b3_equal(state, topo, cfg, 1 / 60 / cfg.substeps,
              frames * cfg.substeps, with_ext=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONTACT_CASES))
def test_persistent_b3_contact_equals_per_pass_on_card(cuda, name):
    """Dense and blocked self-collision: dense runs inside the persistent
    kernel (one launch), blocked splits it around each B-4 pass; both to
    the bit."""
    cfg, frames = CONTACT_CASES[name]
    topo, fields, _ = contact_cases.contact_scene(contact_cases.modules())
    state = state_from_numpy(fields, device=cuda)
    dense = cfg.self_collision_backend == "dense"
    _b3_equal(state, topo, cfg, 1 / 60 / cfg.substeps,
              frames * cfg.substeps, launches=1 if dense else None,
              with_ext=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VOLUME_CASES))
def test_persistent_b3_volume_equals_per_pass_on_card(cuda, name):
    """The global volume, one body and ensembles (the reduction a phase
    between two barriers, one block a body): to the bit."""
    cfg, topo, fields, nb, frames = volume_cases.case_inputs(name)
    st = state_from_numpy(fields, device=cuda)
    launches = 1 if cfg.self_collision_backend == "dense" or not \
        cfg.enable_self_collision else None
    new = _b3_equal(st, topo, cfg, volume_cases.DT / cfg.substeps,
                    frames * cfg.substeps, launches=launches, with_ext=True,
                    batched=nb > 1)
    assert float(new.lambda_volume.abs().min()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ensemble_cases.mesh_ensemble_cases()))
def test_persistent_b3_ensembles_equal_per_pass_on_card(cuda, name):
    """Shared and per-body masses, per-body materials, a shared kinematic
    sphere, dense contact: every body in one launch, to the bit."""
    topo, cfg, st, mats, frames, opts = ensemble_cases.mesh_case(name, cuda)
    _b3_equal(st, topo, cfg, ensemble_cases.DT / cfg.substeps,
              frames * cfg.substeps, with_ext=True, materials=mats,
              batched=True, per_body_mass=bool(opts.get("per_body_mass")))


@pytest.mark.gpu
@pytest.mark.parametrize("name", MESH_COLLIDER_CASES)
def test_persistent_b3_colliders_equal_per_pass_on_card(cuda, name):
    """Config boxes and a ColliderSet's traced table (its poses moved once
    on the same runner): the persistent kernel equals the per-pass loop
    and the plain engine."""
    def runner(design):
        return lambda topo, cfg, dt, frames, kin: (
            lambda st: mc.run_substeps_cuda(
                st, topo, cfg, dt / cfg.substeps, frames * cfg.substeps,
                with_ext=True, design=design))

    new = collider_cases.mesh_runs(name, cuda, runner("persistent"),
                                   pgeneral.multi_step_fn)
    old = collider_cases.mesh_runs(name, cuda, runner("per_pass"),
                                   pgeneral.multi_step_fn)
    for (a, ref, _), (b, _, _) in zip(new, old):
        assert not _b3_bits(a, b), name
        assert torch.equal(a.positions, ref.positions), name


def _ball_on_cloth_20k(cuda):
    """(topology, config, {frame: state}) of the 20k ball-on-cloth at
    frames 30, 60 and 90 of its step."""
    topo, fields, cfg, _ = contact_cases.scaled_ball_on_cloth(
        contact_cases.modules())
    st = state_from_numpy(fields, device=cuda)
    step = mc.make_mesh_cuda_step(topo, cfg, 1 / 60)
    states = {}
    for frame in range(1, 91):
        st = step(st)
        if frame % 30 == 0:
            states[frame] = st
    return topo, cfg, states


@pytest.mark.gpu
def test_persistent_b3_blocked_contact_at_20k_on_card(cuda):
    """The 20k ball-on-cloth at frames 30, 60 and 90 (blocked contact every
    3rd substep, Chebyshev, tets, bending, the hub rows): a frame's 6
    substeps equal the per-pass loop to the bit in 19 persistent launches
    (one a stretch up to each B-4 pass -- the curve order and two passes
    an iteration at each of the two contact substeps -- and the last
    stretch), run twice to the bit."""
    topo, cfg, states = _ball_on_cloth_20k(cuda)
    dt_sub = 1 / 60 / cfg.substeps
    for frame, st in states.items():
        new = _b3_equal(st, topo, cfg, dt_sub, 6, launches=19)
        again = mc.run_substeps_cuda(st, topo, cfg, dt_sub, 6)
        assert not _b3_bits(new, again), frame
        assert float((new.positions - st.positions).abs().max()) > 1e-5


@pytest.mark.gpu
def test_hub_warps_keep_the_twins_bits_on_card(cuda):
    """A tet fan whose centroid's rows are hubs (642 edges, 1,280 tets: the
    20k ball), without contact: both designs equal the plain engine, whose
    hub rows are ``incidence.gather_sum``'s column-order sums, to the
    bit."""
    topo, fields, cfg, nc = contact_cases.scaled_ball_on_cloth(
        contact_cases.modules())
    cfg = cfg.replace(enable_self_collision=False, enable_bending=False)
    assert mc.hub_rows(mc.incidence_csr(topo.tet_incidence,
                                        4 * topo.n_tets)[0]).size == 1
    st = state_from_numpy(fields, device=cuda)
    dt_sub = 1 / 60 / cfg.substeps
    new = _b3_equal(st, topo, cfg, dt_sub, 3)
    ref = pgeneral.run_substeps_plain(st, topo, cfg, dt_sub, 3)
    for k in ("positions", "velocities", "lambda_dist", "lambda_tet"):
        assert torch.equal(getattr(new, k), getattr(ref, k)), k


@pytest.mark.gpu
def test_dense_pass_split_across_warps_holds_its_gates_on_card(cuda):
    """The catalogued ball_on_cloth in contact: one substep of one
    iteration (one dense pass) within 1e-5 of the plain engine, where one
    pair classified differently would move its particles by their overlap
    (about 1e-3 here), and 3 frames within 2e-4."""
    from softbodysimulation_tpu_torch.core import scenes

    st, step, info = scenes.ball_on_cloth(device=cuda)
    topo, cfg = info["topology"], info["config"]
    for _ in range(60):
        st = step(st)
    one = cfg.replace(iterations=1)
    dt_sub = 1 / 60 / cfg.substeps
    new = _b3_equal(st, topo, one, dt_sub, 1)
    ref = pgeneral.run_substeps_plain(st, topo, one, dt_sub, 1)
    assert float((new.positions - ref.positions).abs().max()) < 1e-5
    new = mc.make_mesh_cuda_step(topo, cfg, 1 / 60, n_steps=3)(st)
    ref = pgeneral.multi_step_fn(st, topo, cfg, 1 / 60, 3)
    assert float((new.positions - ref.positions).abs().max()) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("barrier", list(mc.BARRIERS))
def test_each_b3_barrier_kind_equals_per_pass_on_card(cuda, barrier):
    """Each barrier forced on a small COLORED body and a dense-contact
    ensemble equals the per-pass loop to the bit in one launch."""
    for name in ("colored", "dense_contact"):
        topo, cfg, st, mats, frames, opts = ensemble_cases.mesh_case(name,
                                                                     cuda)
        nb = st.positions.shape[0]
        p = mc.make_params(topo, cfg, 1 / 240)
        if st.lambda_tet is None:
            p.n_tets = 0
        sched = mc.schedule_for(mc.tile_counts(p), nb, cuda, barrier=barrier)
        assert sched.barrier == barrier
        _b3_equal(st, topo, cfg, ensemble_cases.DT / cfg.substeps,
                  frames * cfg.substeps, with_ext=True, materials=mats,
                  batched=True, per_body_mass=bool(opts.get("per_body_mass")),
                  schedule=sched)


@pytest.mark.gpu
def test_persistent_b3_is_race_free_on_card(cuda):
    """cloth_xl-like cloth on many blocks, 40 substeps, run five times:
    equal to the bit each time and to the per-pass loop."""
    from softbodysimulation_tpu_torch.core import scenes

    st, _, info = scenes.cloth(res=48, device=cuda)
    topo, cfg = info["topology"], info["config"]
    ref = mc.run_substeps_cuda(st, topo, cfg, 1 / 240, 40, with_ext=True,
                               design="per_pass")
    for _ in range(5):
        out = mc.run_substeps_cuda(st, topo, cfg, 1 / 240, 40, with_ext=True)
        assert not _b3_bits(out, ref)


@pytest.mark.gpu
def test_persistent_b3_launches_once_a_contact_free_call_on_card(cuda):
    """One launch a call on every contact-free mesh route (any number of
    substeps, several frames, an ensemble); none for no substep; the
    per-pass loop's count for comparison."""
    cfg, kind, kw, _ = MESH_CASES["jacobi_reset_rho0"]
    topo, fields = mesh_cases.case_inputs(kind, **kw)
    state = state_from_numpy(fields, device=cuda)

    def count(fn):
        before = mc.launches
        fn()
        return mc.launches - before

    for n in (1, 7, 64):
        assert count(lambda: mc.make_mesh_cuda_substep_runner(
            topo, cfg, 1 / 240, n)(state)) == 1
    assert count(lambda: mc.make_mesh_cuda_step(topo, cfg, 1 / 60,
                                                n_steps=3)(state)) == 1
    assert count(lambda: mc.make_mesh_cuda_substep_runner(
        topo, cfg, 1 / 240, 0)(state)) == 0
    assert count(lambda: mc.run_substeps_cuda(
        state, topo, cfg, 1 / 240, 2, design="per_pass")) > 2


@pytest.mark.gpu
def test_b3_grid_that_cannot_be_resident_raises_on_card(cuda):
    import dataclasses

    st, _, info = scenes_cloth(cuda)
    topo, cfg = info["topology"], info["config"]
    counts = mc.tile_counts(mc.make_params(topo, cfg, 1 / 240))
    sms, per_sm = mc.device_occupancy(torch.cuda.current_device(), "counter")
    big = dataclasses.replace(mc.schedule_for(counts, 1, cuda, "counter"),
                              grid=sms * per_sm + 1)
    before = mc.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        mc.run_substeps_cuda(st, topo, cfg, 1 / 240, 4, schedule=big)
    assert mc.launches == before


def scenes_cloth(cuda):
    from softbodysimulation_tpu_torch.core import scenes

    return scenes.cloth(res=24, device=cuda)


# ---- the counted twin of the persistent lattice kernel (diag/profiling) --


def _cell_call(cuda, cell):
    """(spec, cfg, state, call, substeps a call) of a benchmark cell's
    shape: ``lattice64k`` (``bench.py`` ``build()``, one res-40 body
    across the grid, 2,000 substeps a call) or ``ensemble1024`` (example
    5's 1,024 res-4 bodies, whole bodies a block, 120 frames a call), or
    ``colored_tets`` (a res-8 body across the grid, COLORED x 2 with the
    tet sweep and DECAY, 5 substeps: another loop for the count)."""
    if cell == "lattice64k":
        from softbodysimulation_tpu_torch import bench as pbench

        spec, cfg, state = pbench.build(pbench.Settings(), device=cuda)
        return (spec, cfg, state, lc.make_cuda_substep_runner(
            spec, cfg, pbench.DT / cfg.substeps, 2000), 2000)
    if cell == "ensemble1024":
        from softbodysimulation_tpu_torch.examples import config5_batch_1024

        spec, cfg, state = config5_batch_1024.make_ensemble(device=cuda)
        return (spec, cfg, state, lc.make_cuda_step(
            spec, cfg, 1 / 60, n_steps=120, n_bodies=1024), 480)
    from softbodysimulation_tpu_torch.core.config import (LambdaMode,
                                                          SolveMode,
                                                          SolverConfig)

    spec = ptop.lattice_spec(8, braced=True)
    cfg = SolverConfig(substeps=5, iterations=2, solve_mode=SolveMode.COLORED,
                       lambda_mode=LambdaMode.DECAY, enable_tet_volume=True,
                       ground_height=0.0, friction=0.3)
    state = plat.make_lattice_state(spec, center=(0.0, 0.3, 0.0),
                                    device=cuda, tet_volume=True)
    return spec, cfg, state, lc.make_cuda_substep_runner(spec, cfg, 1 / 300,
                                                         5), 5


COUNTED_CELLS = ["lattice64k", "ensemble1024", "colored_tets"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", COUNTED_CELLS)
def test_counted_lattice_kernel_equals_the_off_kernel_on_card(cuda, cell):
    from softbodysimulation_tpu_torch.diag import profiling

    _, _, state, call, _ = _cell_call(cuda, cell)
    state = call(state)          # from a state in motion, on its floor
    off = call(state)
    with profiling.counting():
        on = call(state)
    assert profiling.counts() is not None
    for k in ("positions", "velocities", "lambda_dist", "ext_force",
              "lambda_tet"):
        a, b = getattr(off, k), getattr(on, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a, b), k


@pytest.mark.gpu
@pytest.mark.parametrize("cell", COUNTED_CELLS)
def test_counted_barriers_follow_the_kernels_loop_on_card(cuda, cell):
    import test_torch_profiling as tp
    from softbodysimulation_tpu_torch.diag import profiling

    spec, cfg, state, call, subs = _cell_call(cuda, cell)
    want = tp.loop_barriers(cfg, spec, subs)
    if cell in tp.CELL_BARRIERS:
        assert want == tp.CELL_BARRIERS[cell][3]
    profiling.counts()           # nothing left from another test
    with profiling.counting():
        state = call(state)
        state = call(state)
    got = profiling.counts()
    b = state.positions.shape[0] if state.positions.dim() == 3 else 1
    sched = lc.schedule_for(spec, b, state.device)
    assert got["warps"] == 2 * sched.grid * lc.THREADS // 32
    assert got["barriers"] == want * got["warps"]
    assert 0 < got["wait_cycles"] < got["resident_cycles"]
    assert profiling.counts()["warps"] == 0    # read once, reset


@pytest.mark.gpu
def test_profiled_calls_name_only_the_off_kernel_on_card(cuda):
    """Under the profiler a call launches ``lattice_persistent_kernel``
    (``lattice_counted_kernel`` only inside ``counting()``), the runner's
    spans lie on the host's timeline, nested in the call, and none is on
    the device's.  One profiler session for every call: a later session
    in the same process may record no device operation."""
    from torch.autograd import DeviceType

    from softbodysimulation_tpu_torch.diag import profiling

    calls = [_cell_call(cuda, cell)[2:4]
             for cell in ("lattice64k", "ensemble1024")]
    for state, call in calls:
        call(state)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for state, call in calls:
            call(state)
            with profiling.counting():
                call(state)
        torch.cuda.synchronize()
    profiling.counts()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    dev = [e.name for e in events if e.device_type == DeviceType.CUDA]
    lattice = [n for n in dev if "lattice_" in n and "kernel" in n]
    assert [n.split("(")[0].split()[-1] for n in lattice] == [
        "lattice_persistent_kernel<1>", "lattice_counted_kernel<1>",
        "lattice_persistent_kernel<0>", "lattice_counted_kernel<0>"], lattice
    assert not any(n.startswith(profiling.SPAN_PREFIX) for n in dev)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith(profiling.SPAN_PREFIX)]
    whole = [e for e in host if e.name == "sbs.lattice.call"]
    assert len(whole) == 4
    for part in ("layout", "launch", "unlayout"):
        parts = [e for e in host if e.name == f"sbs.lattice.{part}"]
        assert [e.cpu_parent for e in parts] == whole
