"""The PyTorch port's state, interaction verbs and import hygiene, held
against the JAX package on the CPU.

Also the home of the helpers the other ``test_torch_*`` files share: the
same ``SolverConfig`` in both packages, a JAX lattice state whose inputs
are made by numpy from a seed, and its copy in the port.
"""

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbodysimulation_tpu.core import state as jstate_mod
from softbodysimulation_tpu.interact import forces as jforces
from softbodysimulation_tpu.topology import lattice as jtop

import softbodysimulation_tpu_torch as port
from softbodysimulation_tpu_torch.core import config as pconfig
from softbodysimulation_tpu_torch.interact import forces as pforces

import test_torch_cases as lattice_cases

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("positions", "velocities", "inv_mass", "ext_force", "lambda_dist",
          "lambda_bend", "lambda_volume", "lambda_tet")


# ---- helpers shared by the test_torch_* files -----------------------------

def port_config(cfg):
    """The same SolverConfig in the port's config module (a copy of the
    JAX package's): every field carried over, enums by value."""
    kw = {}
    for fld in dataclasses.fields(cfg):
        val = getattr(cfg, fld.name)
        if isinstance(val, enum.Enum):
            val = getattr(pconfig, type(val).__name__)(val.value)
        kw[fld.name] = val
    return pconfig.SolverConfig(**kw)


def jax_lattice_state(res, braced=True, **kw):
    """(spec, JAX SimState) of a res^3 lattice whose inputs are made by
    numpy from a seed (``lattice_cases.seeded_inputs``: velocity jitter,
    pinned particles, an ext-force patch)."""
    fields = lattice_cases.seeded_inputs(res, braced=braced, **kw)
    return (jtop.lattice_spec(res, braced=braced),
            jstate_mod.SimState(**{k: jnp.asarray(v)
                                   for k, v in fields.items()}))


def to_port(jstate, device="cpu"):
    return port.state_from_numpy(
        {k: (None if getattr(jstate, k) is None
             else np.asarray(getattr(jstate, k))) for k in FIELDS},
        device=device)


def max_diffs(jstate, pstate):
    """max |difference| of positions, velocities, multipliers, ext force."""
    out = {}
    for k, name in (("positions", "dx"), ("velocities", "dv"),
                    ("lambda_dist", "dlam"), ("ext_force", "dext")):
        out[name] = float(np.abs(np.asarray(getattr(jstate, k))
                                 - getattr(pstate, k).cpu().numpy()).max())
    return out


# ---- state ------------------------------------------------------------------

@pytest.mark.parametrize("with_tet", [False, True])
def test_state_numpy_round_trip(with_tet):
    """A JAX SimState crosses into the port and back bit for bit."""
    rng = np.random.default_rng(3)
    n, e = 27, 40
    js = jstate_mod.SimState(
        positions=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        velocities=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        inv_mass=jnp.asarray(rng.uniform(size=n), jnp.float32),
        ext_force=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        lambda_dist=jnp.asarray(rng.normal(size=e), jnp.float32),
        lambda_bend=jnp.zeros((0,), jnp.float32),
        lambda_volume=jnp.asarray(0.25, jnp.float32),
        lambda_tet=(jnp.asarray(rng.normal(size=6), jnp.float32)
                    if with_tet else None))
    ps = to_port(js)
    assert ps.positions.shape == (n, 3) and ps.positions.dtype == torch.float32
    assert ps.lambda_volume.shape == ()
    back = port.state_to_numpy(ps)
    for k in FIELDS:
        a = getattr(js, k)
        if a is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], np.asarray(a))


def test_state_from_numpy_refuses_colliders_and_missing_fields():
    _, js = jax_lattice_state(3)
    fields = {k: np.asarray(getattr(js, k)) for k in FIELDS[:-1]}
    # colliders are carried as a mapping of the ColliderSet's five fields
    # (test_torch_colliders.py); anything else is refused
    with pytest.raises(ValueError, match="collider fields"):
        port.state_from_numpy(dict(fields, colliders={"planes": [0.0]}),
                              device="cpu")
    del fields["inv_mass"]
    with pytest.raises(ValueError):
        port.state_from_numpy(fields, device="cpu")


def test_is_finite_snapshot_restore():
    """NaN injection is caught; restore(snapshot) recovers the snapshot's
    positions with zeroed multipliers and force accumulator, as the JAX
    package's restore does."""
    _, js = jax_lattice_state(3, ext_patch=(4, (1.0, 2.0, 3.0)))
    js = js.replace(lambda_dist=js.lambda_dist + 0.5)
    ps = to_port(js)
    assert port.is_finite(ps) and bool(jstate_mod.is_finite(js))
    snap = port.snapshot(ps)
    bad = ps.replace(positions=ps.positions.clone())
    bad.positions[5, 1] = float("nan")
    assert not port.is_finite(bad)
    assert not bool(jstate_mod.is_finite(
        js.replace(positions=js.positions.at[5, 1].set(jnp.nan))))
    rec = port.restore(snap, device="cpu")
    ref = jstate_mod.restore(jstate_mod.snapshot(js))
    assert port.is_finite(rec)
    for k in FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(rec, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    # the restored state owns its tensors
    rec.positions[0, 0] = 123.0
    assert snap.positions[0, 0] != 123.0


# ---- interaction verbs ------------------------------------------------------

@pytest.mark.parametrize("verb", ["add_force", "add_uniform_force",
                                  "set_pinned", "unpin", "pin_indices"])
def test_forces_match_jax(verb):
    _, js = jax_lattice_state(4, center=(0.0, 1.0, 0.0), seed=1)
    ps = to_port(js)
    calls = {
        "add_force": lambda m, s: m.add_force(s, (3.0, -1.0, 2.0),
                                              (0.2, 1.1, 0.0), radius=0.6),
        "add_uniform_force": lambda m, s: m.add_uniform_force(
            s, (0.5, 0.0, -0.25)),
        "set_pinned": lambda m, s: m.set_pinned(s, (0.5, 1.5, 0.5),
                                                radius=0.5),
        "unpin": lambda m, s: m.set_pinned(
            m.set_pinned(s, (0.5, 1.5, 0.5), radius=0.5),
            (0.5, 1.5, 0.5), radius=0.3, pinned=False, mass=0.5),
        "pin_indices": lambda m, s: m.pin_indices(s, [0, 7, 63]),
    }
    jout = calls[verb](jforces, js)
    pout = calls[verb](pforces, ps)
    for k in ("positions", "velocities", "inv_mass", "ext_force"):
        np.testing.assert_allclose(getattr(pout, k).numpy(),
                                   np.asarray(getattr(jout, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the input state is left as it was
    np.testing.assert_array_equal(ps.inv_mass.numpy(),
                                  np.asarray(js.inv_mass))


# ---- import hygiene ---------------------------------------------------------

def test_port_imports_without_jax():
    """Every module of the port imports with jax (and the JAX package)
    never loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import softbodysimulation_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 38, mods\n"
        "assert {p.__name__ + '.' + m for m in ('solvers.general', "
        "'kernels.mesh_cuda', 'topology.build', 'ops.bending', "
        "'topology.tets', 'ops.tet_volume', 'ops.spatial_hash', "
        "'diag', 'diag.diagnostics', 'kernels.contact_cuda', "
        "'kernels.diff', 'kernels.mesh_diff', 'examples', "
        "'examples.config6_diffsim', 'examples.config10_material_fit')} "
        "<= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'softbodysimulation_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
