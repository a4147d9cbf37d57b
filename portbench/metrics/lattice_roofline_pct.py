"""lattice_roofline_pct: the least time the card could take for a call's
lattice work, over the lattice kernel's device time a call, in percent.

The least time is the larger of the call's bytes over the HBM bandwidth
and its float32 operations over the float32 rate outside the tensor
cores: the published peaks of one H100 SXM at its 700 W limit.  The work
is counted from the configuration's shapes, never from what the program
built:

- bytes, once a call: each input read once (positions and velocities,
  inverse masses, the external force where the call applies it, the
  multipliers unless RESET zeroes them unread) and each output written
  once (positions, velocities, multipliers), a multiplier for each
  constraint that exists;
- operations: ``PROJECTION_OPS`` a constraint a pass (one pass a family
  each iteration, and under WARM_START one pre-apply pass a family a
  substep), and a particle's predict, floor (each iteration) and
  finalize.

The kernel's time is that of the device operations named
``lattice_persistent_kernel`` in the traced slice, over the calls traced;
a slice with none reads nothing.
"""

from portbench.reference.lattice import BRACED_FAMILIES

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL = "lattice_persistent_kernel"
# a constraint's projection: the difference and length (9), the XPBD
# multiplier step (9), the two endpoint corrections (12)
PROJECTION_OPS = 30
# a particle's predict (velocity update 6, damping 3, prediction 6), floor
# (penetration, step and correction 5, friction 6) and finalize (6)
PREDICT_OPS = 15
FLOOR_OPS = 11
FINALIZE_OPS = 6


def constraints(res: int) -> int:
    """Distance constraints of one braced res^3 lattice: each family's
    anchors that have their partner in bounds."""
    total = 0
    for dx, dy, dz, _ in BRACED_FAMILIES:
        total += (res - abs(dx)) * (res - abs(dy)) * (res - abs(dz))
    return total


def work(conf, substeps: int, with_ext: bool):
    """(bytes, operations) of one call of ``substeps`` substeps."""
    s = conf["solver"]
    n = conf["bodies"] * conf["body"]["res"] ** 3
    c = conf["bodies"] * constraints(conf["body"]["res"])
    lam_reads = 0 if s["lambda_mode"] == "reset" else 1
    nbytes = (n * (24 + 4 + (12 if with_ext else 0)) + 4 * c * lam_reads
              + n * 24 + 4 * c)
    passes = s["iterations"] + (1 if s["lambda_mode"] == "warm_start" else 0)
    floor = FLOOR_OPS if s["floor_mode"] == "xpbd_inequality" else 0
    ops = substeps * (c * passes * PROJECTION_OPS
                      + n * (PREDICT_OPS + FINALIZE_OPS
                             + s["iterations"] * floor))
    return nbytes, ops


def bound_s(conf, substeps: int, with_ext: bool) -> float:
    nbytes, ops = work(conf, substeps, with_ext)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.device_time(KERNEL)
    if kernel_s <= 0:
        return None
    return (100.0 * bound_s(run.config, run.substeps_per_call, run.with_ext)
            * run.trace.calls / kernel_s)
