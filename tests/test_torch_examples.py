"""The port's examples 1, 2 and 3 (BASELINE configs 1-3) against the JAX
package's, on the CPU, at the JAX tests' cuts (``tests/test_examples.py:
18-45``) and gates; example 9 is in ``test_torch_example_solid.py``.

Each example runs through its ``run(..., device="cpu")`` (the plain
engines) and through the JAX example's ``run``.  The port's end state
meets the JAX test's gates and lies within 1e-5 of JAX's, or, where
contact makes the scene amplify rounding, within a band calibrated on
JAX itself: 3x the spread between JAX's run and JAX's run with its
positions moved one ulp before every frame (``nudged``: rounding-sized
noise each frame, as another order of the same operations injects it).
Example 3's ball rolls off the top of its sphere collider, so one ulp at
the start alone grows to about 1e-3 by frame 200 in JAX; example 2 hangs
from pins through 150 frames of WARM_START sweeps.
"""

import jax.numpy as jnp
import numpy as np
import torch

from softbodysimulation_tpu.examples import config1_cube_drop as j1
from softbodysimulation_tpu.examples import config2_icosphere_pinned as j2
from softbodysimulation_tpu.examples import config3_inflated_ball as j3

from softbodysimulation_tpu_torch.examples import config1_cube_drop as p1
from softbodysimulation_tpu_torch.examples import config2_icosphere_pinned as p2
from softbodysimulation_tpu_torch.examples import config3_inflated_ball as p3
from softbodysimulation_tpu_torch.ops.volume import enclosed_volume

torch.set_num_threads(1)

# a band where the scene does not amplify rounding
TOL = 1e-5


def nudged(make_step):
    """``make_step`` whose stepper moves every coordinate one ulp up before
    each frame: rounding-sized noise injected frame by frame, as another
    order of the same float32 operations injects it."""
    def make(topo, cfg, dt, n_steps=1):
        step = make_step(topo, cfg, dt, n_steps=1)

        def fn(st):
            for _ in range(n_steps):
                st = step(st.replace(
                    positions=jnp.nextafter(st.positions, jnp.inf)))
            return st
        return fn
    return make


def positions(out):
    st = out[0] if isinstance(out, tuple) else out
    return np.asarray(st.positions)


def hold_to_jax(monkeypatch, jrun, engine, port_pos, **kw):
    """Port end positions against JAX's: within max(TOL, 3x the spread
    between JAX's run and JAX's run nudged one ulp every frame through its
    ``engine.make_step``).  Returns (difference, band)."""
    ref = positions(jrun(verbose=False, **kw))
    monkeypatch.setattr(engine, "make_step", nudged(engine.make_step))
    spread = float(np.abs(positions(jrun(verbose=False, **kw)) - ref).max())
    band = max(TOL, 3.0 * spread)
    diff = float(np.abs(port_pos - ref).max())
    assert diff < band, (diff, spread)
    return diff, band


def test_config1_cube_drop(monkeypatch):
    state = p1.run(res=4, steps=150, verbose=False, device="cpu")
    p = state.positions.numpy()
    assert np.isfinite(p).all()
    assert p[:, 1].min() > -5e-3
    assert p[:, 1].max() - p[:, 1].min() > 0.9
    hold_to_jax(monkeypatch, j1.run, j1.lat_engine, p, res=4, steps=150)


def test_config2_icosphere_pinned(monkeypatch):
    state, topo = p2.run(subdivisions=1, steps=150, verbose=False,
                         device="cpu")
    p = state.positions.numpy()
    assert np.isfinite(p).all()
    # hangs from its pinned cap: the top stays near 2.0, nothing below 0
    assert p[:, 1].max() > 1.8
    assert p[:, 1].min() > -1e-3
    pins = state.inv_mass.numpy() == 0
    assert pins.any() and np.abs(p[pins, 1] - 2.0).max() < 1e-6
    hold_to_jax(monkeypatch, j2.run, j2.general, p, subdivisions=1,
                steps=150)


def test_config3_inflated_ball(monkeypatch):
    state, topo = p3.run(subdivisions=1, steps=200, pressure=1.15,
                         verbose=False, device="cpu")
    p = state.positions.numpy()
    assert np.isfinite(p).all()
    v0 = float(topo.rest_volume)
    v = float(enclosed_volume(state.positions, topo.triangles))
    assert v > 1.05 * v0              # actually inflated
    r = np.linalg.norm(p, axis=1)
    assert r.min() > 0.75             # resting on the sphere collider
    assert float(state.lambda_volume) != 0.0
    hold_to_jax(monkeypatch, j3.run, j3.general, p, subdivisions=1,
                steps=200, pressure=1.15)
