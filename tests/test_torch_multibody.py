"""The multi-body contact path of the port against the JAX package's, on the
CPU: ``merge_topologies``, the ``tet_cube`` / ``tet_ball`` /
``ball_on_cloth`` scenes, the contact cases of
``test_torch_contact_cases.py`` through the plain engine and through the
kernel's step on a CPU state (both vs JAX ``general.make_step``, at 2e-4
over <= 3 frames, ``tests/test_mesh_pallas.py:889-894``), the catalogued
scene without contact, what the slice refuses, the ctypes mirrors of the
contact kernel's structs, and the scenes' refusal to leave the card
silently.  The catalogued scene's contact physics is in
``test_torch_ball_on_cloth.py``.
"""

import ctypes
import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysimulation_tpu.core import config as jconfig
from softbodysimulation_tpu.core import scenes as jscenes
from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.solvers import general as jgeneral

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core import scenes as pscenes
from softbodysimulation_tpu_torch.kernels import _build
from softbodysimulation_tpu_torch.kernels import contact_cuda as cc
from softbodysimulation_tpu_torch.kernels import lattice_cuda as lc
from softbodysimulation_tpu_torch.kernels import mesh_cuda as mc
from softbodysimulation_tpu_torch.solvers import general as pgeneral
from softbodysimulation_tpu_torch.solvers import lattice as plat
from softbodysimulation_tpu_torch.topology import lattice as ptop

import test_torch_contact_cases as cases
from test_torch_mesh_topology import assert_same_topology
from test_torch_state import FIELDS, port_config

torch.set_num_threads(1)

DT = 1 / 60
CONTACT_CASES = cases.contact_cases(jconfig)


@pytest.mark.parametrize("windowed", [False, True])
def test_merge_topologies_matches_jax(windowed):
    """The ball-on-cloth merge gives the JAX package's positions, topology
    field for field, and body slices."""
    out = []
    for pkg in ("softbodysimulation_tpu", "softbodysimulation_tpu_torch"):
        mods = cases.modules(pkg)
        cm = mods.mesh.grid_plane(1.2, 8)
        bm = mods.mesh.icosphere(1, radius=0.18)
        bverts, btets = mods.tets.tets_from_surface_centroid(bm.vertices,
                                                             bm.triangles)
        out.append(mods.build.merge_topologies([
            mods.build.BodySpec(cm.vertices,
                                mods.edges.unique_edges(cm.triangles), 1e-5,
                                hinges=mods.edges.hinges(cm.triangles),
                                bend_compliance=1e-3,
                                triangles=cm.triangles),
            dict(positions=bverts + 1.0, edges=mods.tets.tet_edges(btets),
                 compliance=1e-4, triangles=mods.tets.boundary_faces(btets),
                 tets=btets, tet_compliance=0.0),
        ], windowed=windowed))
    (jpos, jtopo, jsl), (ppos, ptopo, psl) = out
    np.testing.assert_array_equal(ppos, jpos)
    assert ppos.dtype == np.float32
    assert_same_topology(ptopo, jtopo)
    assert [repr(s) for s in psl] == [repr(s) for s in jsl]
    assert psl[1].particles == slice(64, 107) and psl[1].tets == slice(0, 80)


def test_merge_topologies_refusals():
    mods = cases.modules()
    with pytest.raises(NotImplementedError):
        mods.build.merge_topologies([dict(positions=np.zeros((4, 3)))],
                                    windowed=True, colored=True)
    with pytest.raises(ValueError):
        mods.build.merge_topologies([])
    with pytest.raises(ValueError, match="out of range"):
        mods.build.BodySpec(np.zeros((3, 3)), edges=[[0, 3]])


@pytest.mark.parametrize("scene,kw,gate", [
    ("tet_cube", dict(res=3), cases.DX_TET),
    ("tet_ball", dict(subdiv=1), cases.DX_TET),
    ("ball_on_cloth", {}, cases.DX_CONTACT)])
def test_scenes_match_jax(scene, kw, gate):
    """The three scenes build the JAX scene's state, pins, topology and
    config, and their steppers agree over one frame."""
    jstate, jstep, jinfo = getattr(jscenes, scene)(**kw)
    pstate, pstep, pinfo = getattr(pscenes, scene)(device="cpu", **kw)
    assert pinfo["config"] == port_config(jinfo["config"])
    assert_same_topology(pinfo["topology"], jinfo["topology"])
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(pstate, k).numpy(),
                                      np.asarray(getattr(jstate, k)))
    if scene == "ball_on_cloth":
        assert pinfo["n_cloth"] == jinfo["n_cloth"] == 576
        assert (pstate.inv_mass.numpy() == 0).sum() == len(pinfo["pinned"])
    jstate, pstate = jstep(jstate), pstep(pstate)
    d = np.abs(np.asarray(jstate.positions) - pstate.positions.numpy()).max()
    assert d < gate and port.is_finite(pstate), d


@functools.lru_cache(maxsize=None)
def _jax_run(name, contact=True):
    cfg, frames = CONTACT_CASES[name]
    if not contact:
        cfg = dataclasses.replace(cfg, enable_self_collision=False)
    jtopo, fields, _ = cases.contact_scene(
        cases.modules("softbodysimulation_tpu"))
    js = jstate_mod.SimState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return np.asarray(jgeneral.make_step(jtopo, cfg, DT,
                                         n_steps=frames)(js).positions)


@pytest.mark.parametrize("engine", ["plain", "kernel_step"])
@pytest.mark.parametrize("name", list(CONTACT_CASES))
def test_contact_cases_match_jax(name, engine):
    """Dense contact (every substep, every 2nd) and blocked contact every
    3rd substep, through the plain engine's frames and through
    ``make_mesh_cuda_step`` on a CPU state; the contact fired: without it
    the rollout lands more than 10x further away."""
    cfg, frames = CONTACT_CASES[name]
    ptopo, fields, nc = cases.contact_scene(cases.modules())
    ps = port.state_from_numpy(fields, device="cpu")
    pcfg = port_config(cfg)
    if engine == "plain":
        out = pgeneral.multi_step_fn(ps, ptopo, pcfg, DT, frames)
    else:
        out = mc.make_mesh_cuda_step(ptopo, pcfg, DT, n_steps=frames)(ps)
    assert port.is_finite(out)
    dpos = np.abs(out.positions.numpy() - _jax_run(name)).max()
    assert dpos < cases.DX_CONTACT, dpos
    dcontact = np.abs(_jax_run(name) - _jax_run(name, contact=False)).max()
    assert dcontact > 10 * max(dpos, 1e-6), (dpos, dcontact)
    pins = fields["inv_mass"] == 0
    np.testing.assert_array_equal(out.positions.numpy()[pins],
                                  fields["positions"][pins])


def test_without_contact_ball_falls_through():
    """The catalogued ``ball_on_cloth`` with contact off: after 120 frames
    the ball has passed through the cloth (``tests/test_multibody.py``)."""
    state, _, info = pscenes.ball_on_cloth(device="cpu")
    cfg = dataclasses.replace(info["config"], enable_self_collision=False)
    step = pgeneral.make_step(info["topology"], cfg, info["dt"])
    for _ in range(120):
        state = step(state)
    p = state.positions.numpy()
    assert np.isfinite(p).all()
    assert p[info["n_cloth"]:, 1].min() < 0.25, p[info["n_cloth"]:, 1].min()


REFUSED = ["hash_on_card", "sorted_on_card", "volume", "box_colliders",
           "kin_colliders", "ensembles", "approx_math", "dense_cadence",
           "blocked_cadence", "lattice_self_collision", "lattice_tets"]


@pytest.mark.parametrize("what", REFUSED)
def test_slice_refusals_at_build(what):
    """What the slice refuses raises NotImplementedError at build time, in
    the order ROADMAP.md lists it.  Since carried, and held here: the mesh
    kernel's ``approx_math`` (its runner builds; on the CPU it is the
    approx twin to the bit); lattice self-collision at every substep (the
    kernel's step still refuses it, as ``make_pallas_step`` does, and the
    solver's step takes it through the stencil engine, route ``"plain"``);
    ``hash`` and ``sorted`` (the kernel's step for the card still refuses
    them, and ``general.make_step`` takes them through the plain engine)."""
    topo, fields, _ = cases.contact_scene(cases.modules())
    cfg = port_config(CONTACT_CASES["dense_every1"][0])
    if what == "approx_math":
        st = port.state_from_numpy(fields, device="cpu")
        out = mc.make_mesh_cuda_substep_runner(topo, cfg, DT / 4, 1,
                                               approx_math=True)(st)
        twin = pgeneral.run_substeps_plain(st, topo, cfg, DT / 4, 1,
                                           approx_math=True)
        assert torch.equal(out.positions, twin.positions)
        assert torch.equal(out.lambda_dist, twin.lambda_dist)
        return
    if what in ("lattice_self_collision", "lattice_tets"):
        spec = ptop.lattice_spec(3, braced=True)
        flag = ("enable_self_collision" if what.endswith("collision")
                else "enable_tet_volume")
        bad = cfg.replace(**{flag: True})
        with pytest.raises(NotImplementedError):
            lc.make_cuda_step(spec, bad, DT)
        assert plat.make_step(spec, bad, DT).route == "plain"
        return
    with pytest.raises(NotImplementedError):
        if what in ("hash_on_card", "sorted_on_card"):
            backend = what.split("_")[0]
            mc.make_mesh_cuda_step(
                topo, cfg.replace(self_collision_backend=backend), DT,
                device="cuda")
        elif what == "volume":
            mc.make_mesh_cuda_step(topo, cfg.replace(enable_volume=True), DT)
        elif what == "box_colliders":
            # carried up to the kernel's table size
            mc.make_mesh_cuda_step(topo, cfg.replace(
                box_colliders=((0.0, 0.3, 0.0, 0.5, 0.3, 0.5),)
                * (mc.MAX_BOXES + 1)), DT)
        elif what == "kin_colliders":
            mc.make_mesh_cuda_substep_runner(
                topo, cfg, DT / 4, 4, kin_colliders=(0, mc.MAX_BOXES + 1))
        elif what == "ensembles":
            # dense contact runs in ensembles; blocked (B-4) takes one body
            mc.make_mesh_cuda_substep_runner(topo, cfg, DT / 4, 4,
                                             n_bodies=2)
            mc.make_mesh_cuda_substep_runner(
                topo, cfg.replace(self_collision_backend="blocked"), DT / 4,
                4, n_bodies=2)
        elif what in ("dense_cadence", "blocked_cadence"):
            backend = what.split("_")[0]
            mc.make_mesh_cuda_step(topo, cfg.replace(
                self_collision_backend=backend, self_collision_every=3), DT)
    if what in ("hash_on_card", "sorted_on_card"):
        # the plain engine runs them, for a CPU state and on the card
        backend = what.split("_")[0]
        mc.make_mesh_cuda_step(topo, cfg.replace(
            self_collision_backend=backend), DT)
        assert pgeneral.make_step(topo, cfg.replace(
            self_collision_backend=backend), DT).route == "plain"
    with pytest.raises(ValueError):
        mc.make_mesh_hybrid_contact_step(topo, cfg, DT)


def _header_fields(src, name):
    """(field, width in bytes) of ``struct name`` in a C header."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        m = re.match(r"\s*(?:const\s+)?(int|float|unsigned|void|long long)"
                     r"\s*(\*?)\s*(\w+)\s*$", decl)
        if m:
            width = 8 if m.group(2) or m.group(1) == "long long" else 4
            out.append((m.group(3), width))
    return out


def test_contact_structs_mirror_the_cuda_header():
    """The ctypes ``ContactParams`` / ``ContactBuffers`` list the fields of
    the structs in ``csrc/contact_xpbd.cuh`` in order with their widths,
    and the mesh library is built from the contact source too."""
    src = (_build.CSRC_DIR / "contact_xpbd.cuh").read_text()
    for struct, cls in (("ContactParams", cc.ContactParams),
                        ("ContactBuffers", cc.ContactBuffers)):
        fields = _header_fields(src, struct)
        assert [f for f, _ in fields] == [f[0] for f in cls._fields_]
        assert ctypes.sizeof(cls) == sum(w for _, w in fields)
    assert "contact_xpbd.cu" in mc.SOURCES and cc.SOURCES == (
        "contact_xpbd.cu",)
    p = cc.make_params(20243, port_config(jconfig.SolverConfig(
        collision_block_size=128, block_neighbors=32, particle_radius=0.0114,
        self_collision_omega=0.5)), 1, 20243)
    assert (p.block, p.nb, p.m_nbr, p.si, p.sc) == (128, 159, 32, 1, 20243)
    assert p.diam == np.float32(0.0228) and p.omega == 0.5
    assert p.diam2 == np.float32(0.0228 ** 2)


def test_scenes_default_to_the_card(monkeypatch):
    """Without a CUDA device a scene called without ``device`` raises; with
    ``device="cpu"`` it builds on the CPU.  Nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scene in ("flagship", "flagship_perf", "solid_lattice", "cpu_mesh",
                  "cloth", "cloth_xl", "tet_cube", "tet_ball",
                  "ball_on_cloth"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(pscenes, scene)()
    state, _, _ = pscenes.tet_cube(res=2, device="cpu")
    assert state.device.type == "cpu"


def _constructor_calls():
    """Each state constructor of the port, called with keyword overrides."""
    spec = ptop.lattice_spec(3)
    pos = ptop.lattice_points(3, spec.size, (0.0, 0.0, 0.0))
    edges, comp = ptop.lattice_edges(3)
    from softbodysimulation_tpu_torch.topology import build as pbuild
    topo = pbuild.build_topology(pos, edges, comp)
    fields = port.state_to_numpy(port.state_from_topology(topo, pos,
                                                          device="cpu"))
    tfields = {f.name: (getattr(topo, f.name).numpy()
                        if isinstance(getattr(topo, f.name), torch.Tensor)
                        else getattr(topo, f.name))
               for f in dataclasses.fields(topo)}
    return {
        "make_lattice_state": lambda **kw: plat.make_lattice_state(spec,
                                                                   **kw),
        "make_state": lambda **kw: port.make_state(
            pos, n_edges=topo.n_edges, **kw),
        "state_from_topology": lambda **kw: port.state_from_topology(
            topo, pos, **kw),
        "state_from_numpy": lambda **kw: port.state_from_numpy(fields, **kw),
        "topology_from_numpy": lambda **kw: port.topology_from_numpy(
            tfields, **kw),
        # restore re-uploads a (host) snapshot, to the card by default
        "restore": lambda **kw: port.restore(port.snapshot(
            port.state_from_numpy(fields, device="cpu")), **kw),
    }


@pytest.mark.parametrize("name", ["make_lattice_state", "make_state",
                                  "state_from_topology", "state_from_numpy",
                                  "topology_from_numpy", "restore"])
def test_state_constructors_default_to_the_card(monkeypatch, name):
    """Without a CUDA device a state constructor called without ``device``
    raises, naming ``device='cpu'``; with ``device="cpu"`` it builds on the
    CPU.  Nothing falls back to the CPU silently: ``restore`` of a snapshot
    (which lies on the host) re-uploads to the card, as the JAX package's
    re-uploads to its default device, so a card state's restart does not
    quietly run the plain engine on the CPU."""
    make = _constructor_calls()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    out = make(device="cpu")
    t = out.positions if hasattr(out, "positions") else out.edges
    assert t.device.type == "cpu"


def test_interaction_verbs_divide_by_tensors():
    """``add_force``, ``drag_force`` and ``squeeze_impulse`` divide by a
    tensor, never by a Python float: on CUDA, PyTorch turns a division by a
    Python float into a multiply by its reciprocal, which rounds otherwise
    than the true division of the JAX package and of the CPU, so a poke on
    the card would part from one on the CPU by an ulp.  Every division
    the verbs make is recorded and its divisor checked."""
    from torch.overrides import TorchFunctionMode

    from softbodysimulation_tpu_torch.interact import forces as pforces

    divs = {torch.Tensor.__truediv__, torch.Tensor.div, torch.div,
            torch.true_divide, torch.Tensor.__rtruediv__}
    scalar_divisors = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in divs and len(args) > 1 and not isinstance(
                    args[1], torch.Tensor):
                scalar_divisors.append((func.__name__, args[1]))
            return func(*args, **(kwargs or {}))

    state = plat.make_lattice_state(ptop.lattice_spec(3), device="cpu")
    with Record():
        pforces.add_force(state, (1.0, 2.0, 3.0), (0.1, 0.0, 0.0),
                          radius=0.6)
    assert scalar_divisors == [], scalar_divisors
    with Record():
        pforces.drag_force(state, (1.0, 1.0, 0.0), radius=0.7)
        pforces.squeeze_impulse(state, (0.0, 0.1, 0.0), radius=0.9)
    assert scalar_divisors == [], scalar_divisors
