"""The port's mesh ensemble path as the benchmark drives it, and the plain
reference that follows it: B bodies of one closed triangle mesh under
distance constraints and the global volume constraint (one multiplier a
body), on the floor.

The interface is the one ``systems/lattice.py`` lists.  ``Program`` builds
what a user of ``softbodysimulation_tpu_torch`` builds for a farm of
pressurized bodies: the icosphere (``topology.mesh.icosphere``), its
windowed topology (``topology.build.topology_from_mesh(...,
windowed=True)``, which renumbers the particles by reverse Cuthill-McKee),
the solver config, the state (``state_from_topology``,
``parallel.batch.replicate_state``) and the traffic's call through the
general engine's ensemble step (``solvers.general.make_batched_step``),
which on a CUDA state runs the B-3 mesh kernel
(``kernels.mesh_cuda.make_mesh_cuda_step(..., batched=True)``).

Leaves are compared in the program's numbering: particles in the reverse
Cuthill-McKee order of the windowed topology, ``lambda_dist`` in its edge
order (edges stable-sorted by their lower endpoint there); the reference
rebuilds that numbering from the configuration (``reference/mesh.Mesh``).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
from softbodysimulation_tpu_torch.core import config as C
from softbodysimulation_tpu_torch.core.state import state_from_topology
from softbodysimulation_tpu_torch.kernels import mesh_cuda
from softbodysimulation_tpu_torch.parallel import batch
from softbodysimulation_tpu_torch.solvers import general
from softbodysimulation_tpu_torch.topology import build, mesh

from .. import generate
from ..reference import mesh as ref

LEAVES = ("positions", "velocities", "lambda_dist", "lambda_volume",
          "ext_force")
# the health gate's band on a body's enclosed volume over its rest volume
# at its size (``unhealthy``)
VOLUME_BAND = (0.5, 2.0)


def call_shape(conf: Dict, traffic: Dict):
    """(substeps a call, whether the call applies and clears the external
    force): the traffic's frames through the step."""
    if traffic["entry"] != "step":
        raise ValueError(f"portbench: no entry {traffic['entry']!r} for a "
                         f"mesh")
    return traffic["frames_per_call"] * conf["solver"]["substeps"], True


def particles(conf: Dict) -> int:
    """Particles of every body: an icosphere of s subdivisions has
    10 * 4^s + 2 vertices."""
    return conf["bodies"] * (10 * 4 ** conf["body"]["subdivisions"] + 2)


def initial_positions(conf: Dict, seed: int) -> np.ndarray:
    """``(bodies, N, 3)`` float32 positions at the start: the mesh at rest
    about the origin, lifted by ``lift_m``, moved by a float32 offset a
    body (x, y, z drawn in that order from the pose's ranges, as the
    farm's ``batch_states`` draws them)."""
    g = generate.rng(seed, generate.POSE)
    pose, bodies = conf["pose"], conf["bodies"]
    off = np.stack([g.uniform(*pose["offset_x_m"], bodies),
                    g.uniform(*pose["offset_y_m"], bodies),
                    g.uniform(*pose["offset_z_m"], bodies)],
                   axis=1).astype(np.float32)
    rest = _mesh(conf).positions + np.array(
        [0.0, conf["body"]["lift_m"], 0.0], np.float32)
    return rest[None] + off[:, None, :]


def _mesh(conf: Dict) -> ref.Mesh:
    body = conf["body"]
    return _mesh_of(body["mesh"], body["subdivisions"], body["radius_m"],
                    body["compliance"])


@functools.lru_cache(maxsize=8)
def _mesh_of(kind, subdivisions, radius, compliance) -> ref.Mesh:
    conf = {"body": {"mesh": kind, "subdivisions": subdivisions,
                     "radius_m": radius, "compliance": compliance}}
    return ref.Mesh.of(conf)


@functools.lru_cache(maxsize=8)
def _shape_gate(n: int, device: str):
    """(triangles on ``device``, rest volume over the cube of the mean
    distance from the centroid) of the unit icosphere of ``n``
    vertices."""
    s = int(round(np.log((n - 2) / 10) / np.log(4)))
    unit = _mesh_of("icosphere", s, 1.0, 1.0)
    p = unit.positions.astype(np.float64)
    r = np.linalg.norm(p - p.mean(axis=0), axis=1).mean()
    return (torch.as_tensor(unit.triangles, device=device),
            float(unit.rest_volume) / r ** 3)


def unhealthy(leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
    """1 where any leaf is not finite, or where a body's enclosed volume
    over its rest volume leaves ``VOLUME_BAND``, else 0: an int32 scalar on
    the leaves' device, read by no host.  The rest volume is taken at the
    body's own size (the unit icosphere's volume times the cube of the
    body's mean distance from its centroid), so the gate needs no more
    than the leaves: a body inverted, flattened or blown apart leaves the
    band; one inflated by its pressure or resting on the floor does
    not."""
    ok = torch.ones((), dtype=torch.bool,
                    device=leaves["positions"].device)
    for k in LEAVES:
        ok = ok & torch.isfinite(leaves[k].detach()).all()
    p = leaves["positions"].detach()
    tris, ratio = _shape_gate(p.shape[1], str(p.device))
    a, b, c = (p[:, tris[:, k]] for k in range(3))
    volume = (a * torch.cross(b, c, dim=-1)).sum(dim=(-1, -2)) / 6.0
    r = (p - p.mean(dim=1, keepdim=True)).norm(dim=-1).mean(dim=1)
    share = volume / (ratio * r ** 3)
    ok = ok & ((share > VOLUME_BAND[0]) & (share < VOLUME_BAND[1])).all()
    return (~ok).to(torch.int32)


def cpu_cut(conf: Dict, traffic: Dict):
    """(configuration, traffic) cut to a CPU test's size: two bodies of
    ``icosphere(2)`` (162 particles), at most 2 frames a call."""
    conf = dict(conf, body=dict(conf["body"],
                                subdivisions=min(conf["body"]["subdivisions"],
                                                 2)),
                bodies=min(conf["bodies"], 2))
    traffic = dict(traffic,
                   frames_per_call=min(traffic["frames_per_call"], 2))
    return conf, traffic


def solver_config(s: Dict) -> C.SolverConfig:
    """The configuration's ``solver`` as a ``SolverConfig``."""
    s = dict(s)
    for key, enum in (("damping_mode", C.DampingMode),
                      ("solve_mode", C.SolveMode),
                      ("lambda_mode", C.LambdaMode),
                      ("floor_mode", C.FloorMode)):
        s[key] = enum(s[key])
    s["gravity"] = tuple(s["gravity"])
    return C.SolverConfig(**s)


class Program:
    """The system under test, built as its users build it."""

    def __init__(self, conf: Dict, traffic: Dict, positions: np.ndarray,
                 device):
        body = conf["body"]
        self.bodies = conf["bodies"]
        _, self.topo = build.topology_from_mesh(
            mesh.icosphere(body["subdivisions"], radius=body["radius_m"]),
            compliance=body["compliance"], windowed=True)
        self.cfg = solver_config(conf["solver"])
        state = state_from_topology(self.topo, positions[0],
                                    mass=conf["mass_kg"], device=device)
        state = batch.replicate_state(state, self.bodies)
        self.state = state.replace(positions=torch.as_tensor(
            positions, device=state.device).contiguous())
        self._step = general.make_batched_step(
            self.topo, self.cfg, conf["frame_s"], traffic["frames_per_call"])

    def step(self, state):
        """The timed path's entry: one call of the traffic's step."""
        return self._step(state)

    def leaves(self, state) -> Dict[str, torch.Tensor]:
        """The state's leaves, each with its body axis first."""
        return {k: getattr(state, k) for k in LEAVES}

    def with_leaves(self, state, **leaves):
        """``state`` with the given leaves in place."""
        return state.replace(**leaves)


def approx_program(conf: Dict, traffic: Dict, positions: np.ndarray,
                   device) -> Program:
    """The program with its own ``approx_math`` path on (rsqrt in the
    kernel's distance passes; the volume stays exact): float32 rounded
    otherwise, a witness of how far rounding alone moves a call's
    answers, not a control."""
    prog = Program(conf, traffic, positions, device)
    n_sub, with_ext = call_shape(conf, traffic)
    prog._step = mesh_cuda.make_mesh_cuda_substep_runner(
        prog.topo, prog.cfg, conf["frame_s"] / conf["solver"]["substeps"],
        n_sub, with_ext=with_ext, approx_math=True, n_bodies=prog.bodies,
        per_body_mass=True)
    return prog


class Reference:
    """The frozen reference for one configuration and traffic mix, in
    ``dtype`` on ``device``."""

    def __init__(self, conf: Dict, traffic: Dict, device,
                 dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        m = ref.Mesh.of(conf)
        self.engine = ref.Engine(m, conf["solver"], conf["bodies"], device,
                                 dtype)
        self.n_sub, self.with_ext = call_shape(conf, traffic)
        self.dt = conf["frame_s"] / conf["solver"]["substeps"]
        self.n_edges = m.edges.shape[0]
        self.inv_mass = torch.full(
            (conf["bodies"], m.n),
            0.0 if conf["mass_kg"] <= 1e-4 else 1.0 / conf["mass_kg"],
            dtype=dtype, device=device)

    def start(self, positions: np.ndarray) -> Dict[str, torch.Tensor]:
        """The leaves at rest at the generator's positions."""
        x = torch.as_tensor(positions, device=self.device).to(self.dtype)
        b = x.shape[0]
        return {"positions": x, "velocities": torch.zeros_like(x),
                "ext_force": torch.zeros_like(x),
                "lambda_dist": x.new_zeros(b, self.n_edges),
                "lambda_volume": x.new_zeros(b)}

    def call(self, leaves: Dict[str, torch.Tensor]) -> Dict:
        """One call of the traffic from ``leaves`` (the program's, or
        ``start``'s), as the reference computes it."""
        inp = {k: leaves[k].to(self.device, self.dtype) for k in LEAVES}
        inp["inv_mass"] = self.inv_mass
        if self.device.type != "cuda" or self.n_sub < 3:
            return self.engine.run(inp, self.dt, self.n_sub, self.with_ext)
        return self._run_graphed(inp)

    def _run_graphed(self, inp):
        """``Engine.run`` with every substep after the first replayed from
        one CUDA graph of the reference's own ops: the same kernels in
        the same order, so the same bits, without a host launch each."""
        eng, dt = self.engine, self.dt
        w, f = inp["inv_mass"], inp["ext_force"]
        x, v, lam, lam_v = eng.substep(
            inp["positions"], inp["velocities"], w, f, inp["lambda_dist"],
            inp["lambda_volume"], dt, self.with_ext)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # load every kernel before capture
            eng.substep(x.clone(), v.clone(), w, f, lam.clone(),
                        lam_v.clone(), dt, False)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = eng.substep(x, v, w, f, lam, lam_v, dt, False)
            for dst, src in zip((x, v, lam, lam_v), out):
                dst.copy_(src)
        for _ in range(self.n_sub - 1):
            graph.replay()
        result = {"positions": x.clone(), "velocities": v.clone(),
                  "lambda_dist": lam.clone(), "lambda_volume": lam_v.clone(),
                  "ext_force": (torch.zeros_like(f) if self.with_ext else f)}
        del graph
        return result
