"""The port's lattice path as the benchmark drives it, and the plain
reference that follows it.

A system file holds what the harness, the control and the tests need of
one kind of configuration: ``LEAVES`` (the state's leaves that
``Program.leaves`` gives and ``Reference.call`` takes, each with a body
axis first), ``call_shape``, ``particles``, ``initial_positions`` (the
inputs, from the seed), ``unhealthy`` (the health gate that counts a call
as failed), ``cpu_cut`` (the configuration and traffic at a CPU test's
size), ``Program`` (with ``with_leaves``, through which a planted fault
changes a leaf) and ``Reference``; optionally ``approx_program``, the
program's own path of approximate arithmetic, a witness of rounding for
``python -m portbench.control --program approx_math``.  Here: braced
res^3 lattices, one body or an ensemble.

``Program`` builds, from a configuration and the initial positions, what
a user of ``softbodysimulation_tpu_torch`` builds: the lattice spec, the
solver config, the state (``solvers.lattice.make_lattice_state``,
``parallel.batch.replicate_state`` for an ensemble) and the traffic's
entry into the B-1 lattice kernel
(``kernels.lattice_cuda.make_cuda_substep_runner`` or ``make_cuda_step``).
``Reference`` runs the same calls in the frozen reference
(``portbench/reference``), from the inputs the benchmark made or from a
state the program handed back, working out every constant again from the
configuration.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from softbodysimulation_tpu_torch.core import config as C
from softbodysimulation_tpu_torch.kernels import lattice_cuda
from softbodysimulation_tpu_torch.parallel import batch
from softbodysimulation_tpu_torch.solvers import lattice as lat
from softbodysimulation_tpu_torch.topology import lattice as top

from .. import generate
from ..reference import lattice as ref

LEAVES = ("positions", "velocities", "lambda_dist", "ext_force")


def call_shape(conf: Dict, traffic: Dict):
    """(substeps a call, whether the call applies and clears the external
    force)."""
    if traffic["entry"] == "substep_runner":
        return traffic["substeps_per_call"], False
    if traffic["entry"] == "step":
        return traffic["frames_per_call"] * conf["solver"]["substeps"], True
    raise ValueError(f"portbench: no entry {traffic['entry']!r}")


def particles(conf: Dict) -> int:
    return conf["bodies"] * conf["body"]["res"] ** 3


def initial_positions(conf: Dict, seed: int) -> np.ndarray:
    """``(bodies, N, 3)`` float32 positions at the start.  One body: the
    rest lattice turned by a yaw and a tilt of up to ``tilt_deg_max``
    about a horizontal axis, its lowest particle ``drop_m`` above the
    floor.  Several: the rest lattice about the origin moved by a
    float32 offset a body (x, y, z drawn in that order, as the
    ensemble example draws them)."""
    g = generate.rng(seed, generate.POSE)
    body, pose, bodies = conf["body"], conf["pose"], conf["bodies"]
    pts = ref.lattice_points(body["res"], body["size_m"])
    if bodies > 1:
        off = np.stack([g.uniform(*pose["offset_x_m"], bodies),
                        g.uniform(*pose["offset_y_m"], bodies),
                        g.uniform(*pose["offset_z_m"], bodies)],
                       axis=1).astype(np.float32)
        return pts[None] + off[:, None, :]
    yaw = g.uniform(0.0, 2.0 * np.pi)
    axis = g.uniform(0.0, 2.0 * np.pi)
    tilt = np.radians(g.uniform(0.0, pose["tilt_deg_max"]))
    drop = g.uniform(*pose["drop_m"])
    rot = _axis_angle((np.cos(axis), 0.0, np.sin(axis)), tilt) @ _axis_angle(
        (0.0, 1.0, 0.0), yaw)
    p = pts.astype(np.float64) @ rot.T
    p[:, 1] += drop - p[:, 1].min()
    return p.astype(np.float32)[None]


def _axis_angle(axis, angle) -> np.ndarray:
    """The rotation matrix of ``angle`` about the unit ``axis``."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def unhealthy(leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
    """1 where the ``(bodies, N, 3)`` positions fail ``bench.py``'s gates,
    each body on its own (finite, lowest particle above -1e-2, height
    above 0.5), else 0: an int32 scalar on their device, read by no
    host."""
    p = leaves["positions"].detach()
    y = p[..., 1]
    ymin, ymax = y.amin(dim=-1), y.amax(dim=-1)
    ok = (torch.isfinite(p).all() & (ymin > -1e-2).all()
          & ((ymax - ymin) > 0.5).all())
    return (~ok).to(torch.int32)


def cpu_cut(conf: Dict, traffic: Dict):
    """(configuration, traffic) cut to a CPU test's size: res 4 bodies
    (res 3 in an ensemble), at most four of them, 16 substeps a call or at
    most 3 frames a call."""
    conf = dict(conf, body=dict(conf["body"],
                                res=4 if conf["bodies"] == 1 else 3),
                bodies=min(conf["bodies"], 4))
    traffic = dict(traffic)
    if "substeps_per_call" in traffic:
        traffic["substeps_per_call"] = 16
    if traffic.get("frames_per_call", 1) > 3:
        traffic["frames_per_call"] = 3
    return conf, traffic


class Program:
    """The system under test, built as its users build it."""

    def __init__(self, conf: Dict, traffic: Dict, positions: np.ndarray,
                 device):
        body, s = conf["body"], dict(conf["solver"])
        self.bodies = conf["bodies"]
        self.spec = top.lattice_spec(
            body["res"], size=tuple(body["size_m"]), braced=body["braced"],
            structural_compliance=body["structural_compliance"],
            shear_compliance=body["shear_compliance"],
            bend_compliance=body["bend_compliance"])
        for key, enum in (("damping_mode", C.DampingMode),
                          ("solve_mode", C.SolveMode),
                          ("lambda_mode", C.LambdaMode),
                          ("floor_mode", C.FloorMode)):
            s[key] = enum(s[key])
        s["gravity"] = tuple(s["gravity"])
        self.cfg = C.SolverConfig(**s)
        state = lat.make_lattice_state(self.spec, mass=conf["mass_kg"],
                                       device=device)
        pos = torch.as_tensor(positions, device=state.device)
        if self.bodies > 1:
            state = batch.replicate_state(state, self.bodies)
        else:
            pos = pos[0]
        self.state = state.replace(positions=pos.contiguous())
        if traffic["entry"] == "substep_runner":
            self._step = lattice_cuda.make_cuda_substep_runner(
                self.spec, self.cfg, conf["frame_s"] / s["substeps"],
                traffic["substeps_per_call"], n_bodies=self.bodies)
        else:
            self._step = lattice_cuda.make_cuda_step(
                self.spec, self.cfg, conf["frame_s"],
                n_steps=traffic["frames_per_call"], n_bodies=self.bodies)

    def step(self, state):
        """The timed path's entry: one call of the traffic's runner."""
        return self._step(state)

    def leaves(self, state) -> Dict[str, torch.Tensor]:
        """The state's leaves with a body axis, as the reference takes
        them."""
        out = {k: getattr(state, k) for k in LEAVES}
        if self.bodies == 1:
            out = {k: v[None] for k, v in out.items()}
        return out

    def with_leaves(self, state, **leaves):
        """``state`` with the given leaves (as ``leaves`` gives them, a
        body axis first) in place."""
        if self.bodies == 1:
            leaves = {k: v[0] for k, v in leaves.items()}
        return state.replace(**leaves)


def approx_program(conf: Dict, traffic: Dict, positions: np.ndarray,
                   device) -> Program:
    """The program with its own ``approx_math`` path on (rsqrt and the
    approximate reciprocal in the kernel's passes): float32 rounded
    otherwise, a witness of how far rounding alone moves a call's
    answers, not a control."""
    prog = Program(conf, traffic, positions, device)
    n_sub, with_ext = call_shape(conf, traffic)
    prog._step = lattice_cuda.make_cuda_substep_runner(
        prog.spec, prog.cfg, conf["frame_s"] / conf["solver"]["substeps"],
        n_sub, with_ext=with_ext, approx_math=True, n_bodies=prog.bodies)
    return prog


class Reference:
    """The frozen reference for one configuration and traffic mix, in
    ``dtype`` on ``device``."""

    def __init__(self, conf: Dict, traffic: Dict, device,
                 dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        self.engine = ref.Engine(ref.Lattice.of(conf), conf["solver"],
                                 conf["bodies"], device, dtype)
        self.n_sub, self.with_ext = call_shape(conf, traffic)
        self.dt = conf["frame_s"] / conf["solver"]["substeps"]
        n = conf["body"]["res"] ** 3
        self.inv_mass = torch.full((conf["bodies"], n),
                                   ref.inverse_mass(conf["mass_kg"]),
                                   dtype=dtype, device=device)

    def start(self, positions: np.ndarray) -> Dict[str, torch.Tensor]:
        """The leaves at rest at the generator's positions."""
        x = torch.as_tensor(positions, device=self.device).to(self.dtype)
        b, n = x.shape[:2]
        return {"positions": x, "velocities": torch.zeros_like(x),
                "ext_force": torch.zeros_like(x),
                "lambda_dist": torch.zeros((b, 13 * n), dtype=self.dtype,
                                           device=self.device)}

    def call(self, leaves: Dict[str, torch.Tensor]) -> Dict:
        """One call of the traffic from ``leaves`` (the program's, or
        ``start``'s), as the reference computes it."""
        inp = {k: leaves[k].to(self.device, self.dtype) for k in LEAVES}
        inp["inv_mass"] = self.inv_mass
        return self._run(inp)

    def _run(self, inp):
        if self.device.type != "cuda" or self.n_sub < 3:
            return self.engine.run(inp, self.dt, self.n_sub, self.with_ext)
        return self._run_graphed(inp)

    def _run_graphed(self, inp):
        """``Engine.run`` with every substep after the first replayed from
        one CUDA graph of the reference's own ops: the same kernels in
        the same order, so the same bits, without a host launch each."""
        eng = self.engine
        k = len(ref.BRACED_FAMILIES)
        w = eng.wide_mass(inp["inv_mass"])
        f = eng.to_wide(inp["ext_force"])
        x, v, lam = eng.substep(eng.to_wide(inp["positions"]),
                                eng.to_wide(inp["velocities"]), w, f,
                                eng.to_wide(inp["lambda_dist"], k), self.dt,
                                self.with_ext)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # load every kernel before capture
            eng.substep(x.clone(), v.clone(), w, f, lam.clone(), self.dt,
                        False)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            nx, nv, nlam = eng.substep(x, v, w, f, lam, self.dt, False)
            x.copy_(nx)
            v.copy_(nv)
            lam.copy_(nlam)
        for _ in range(self.n_sub - 1):
            graph.replay()
        out = {"positions": eng.from_wide(x).clone(),
               "velocities": eng.from_wide(v).clone(),
               "lambda_dist": eng.from_wide(lam, k).clone(),
               "ext_force": (torch.zeros_like(inp["ext_force"])
                             if self.with_ext else inp["ext_force"])}
        del graph
        return out
