"""The port's twins of the JAX package's entry points, on the CPU:
``softbodysimulation_tpu_torch.entry.entry()`` against
``__graft_entry__.entry()``, the bench twin
(``softbodysimulation_tpu_torch/bench.py``) against ``bench.py``'s
workload and gates at a tiny ``BENCH_RES``, and examples 4 (``hash``
self-collision through the general engine) and 8 (the fused lattice step)
against the JAX package's over a few frames.
"""

import json

import numpy as np
import pytest
import torch

import __graft_entry__
import bench as jbench
from softbodysimulation_tpu.examples import config4_interactive_poke as jex4
from softbodysimulation_tpu.examples import config8_fused_kernel as jex8

from softbodysimulation_tpu_torch import bench as pbench
from softbodysimulation_tpu_torch import entry as pentry
from softbodysimulation_tpu_torch.examples import config4_interactive_poke as ex4
from softbodysimulation_tpu_torch.examples import config8_fused_kernel as ex8

from test_torch_state import max_diffs, port_config, to_port

torch.set_num_threads(1)


def dx(jstate, pstate):
    return float(np.abs(np.asarray(jstate.positions)
                        - pstate.positions.numpy()).max())


def test_entry_matches_graft_entry():
    """One call of each ``fn`` from each ``state`` (a res-16 WARM_START
    JACOBI frame of 4 substeps) within 1e-6; the twin's state is the
    JAX one's, and it defaults to the card."""
    jfn, (js,) = __graft_entry__.entry()
    pfn, (ps,) = pentry.entry(device="cpu")
    np.testing.assert_array_equal(np.asarray(js.positions),
                                  ps.positions.numpy())
    d = max_diffs(jfn(js), pfn(ps))
    assert d["dx"] < 1e-6 and d["dv"] < 1e-4 and d["dlam"] < 1e-6, d
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pentry.entry()


def test_bench_twin_builds_bench_workload():
    """``build()`` is ``bench.py``'s: the same config and start state."""
    jspec, jcfg, js = jbench.build()
    settings = pbench.Settings(res=jbench.RES, substeps=jbench.SUBSTEPS)
    spec, cfg, st = pbench.build(settings, device="cpu")
    assert cfg == port_config(jcfg)
    assert spec.n_particles == jspec.n_particles
    np.testing.assert_array_equal(np.asarray(js.positions),
                                  st.positions.numpy())
    np.testing.assert_array_equal(np.asarray(js.inv_mass),
                                  st.inv_mass.numpy())


def test_bench_twin_gates(monkeypatch, capsys):
    """At ``BENCH_RES`` 4: every engine passes the drift and health gates
    and has a rate, the best one names the metric; each gate raises on a
    state that breaks it; without a card ``main`` prints nothing and
    exits nonzero."""
    settings = pbench.Settings(res=4, substeps=8, substeps_per_call=40,
                               seconds=0.01)
    # the reference is the plain stencil engine itself, whatever the
    # device (the solver's runner would launch the kernel on the card)
    calls = []
    plain = pbench.lat.run_substeps_plain

    def spy(state, spec, cfg, dt_sub, n, *a, **k):
        calls.append((n, bool(a or k)))
        return plain(state, spec, cfg, dt_sub, n, *a, **k)

    monkeypatch.setattr(pbench.lat, "run_substeps_plain", spy)
    engines = pbench.run(settings, device="cpu")
    monkeypatch.undo()
    assert calls[0] == (40, False), calls
    assert set(engines) == {"plain", "cuda_approx", "cuda"}
    assert all(e["rate"] > 0 and e["drift"] < pbench.DRIFT_GATE
               for e in engines.values())
    line = pbench.result_line(engines, 64, "a card")
    best = max(engines, key=lambda k: engines[k]["rate"])
    assert line["metric"] == f"particle_substeps_per_sec_0k_1gpu_{best}"
    assert line["unit"] == "particle-substeps/s"
    assert set(line["engines"]) == set(engines)

    spec, cfg, st = pbench.build(settings, device="cpu")
    for bad, what in ((float("nan"), "non-finite"), (-0.5, "floor"),
                      (None, "degenerated")):
        p = st.positions.clone()
        if bad is None:
            p[:, 1] = 0.2
        else:
            p[0, 1] = bad
        with pytest.raises(RuntimeError, match=what):
            pbench.health(p)
    with pytest.raises(RuntimeError, match="diverges"):
        pbench.drift("cuda", st.replace(positions=st.positions + 2e-3), st)
    monkeypatch.setenv("BENCH_RES", "4")
    monkeypatch.setenv("BENCH_SUBSTEPS_PER_CALL", "40")
    assert pbench.Settings.from_env().res == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pbench.main() == 1
    assert capsys.readouterr().out == ""
    json.dumps(line)


def test_example4_matches_jax():
    """Example 4 (two cubes, ``hash`` self-collision, the general engine's
    ``"plain"`` route) over 8 frames with its two pokes (frames 4 and 6),
    against the JAX example (gate 2e-5, the mesh cases' Jacobi gate)."""
    jstate, _ = jex4.run(steps=8, verbose=False)
    pstate, _ = ex4.run(steps=8, verbose=False, device="cpu")
    assert dx(jstate, pstate) < 2e-5, dx(jstate, pstate)
    assert float(pstate.ext_force.abs().max()) == 0.0


def test_example8_matches_jax():
    """Example 8 (the fused lattice step, here its plain version) over 6
    frames with the poke at frame 3, against the JAX example (its fused
    kernel in interpret mode), at the kernel gates 1e-5 / 1e-6."""
    jstate = jex8.run(steps=6, poke_at=3, verbose=False)
    pstate = ex8.run(steps=6, poke_at=3, verbose=False, device="cpu")
    d = max_diffs(jstate, pstate)
    assert d["dx"] < 1e-5 and d["dlam"] < 1e-6, d
