"""mesh_roofline_pct: the least time the card could take for a call's
mesh work, over the mesh kernel's device time a call, in percent.

The least time is the larger of the call's bytes over the HBM bandwidth
and its float32 operations over the float32 rate outside the tensor
cores: the published peaks of one H100 SXM at its 700 W limit.  The work
is counted from the configuration's shapes (an icosphere of s
subdivisions has 10 * 4^s + 2 particles, 30 * 4^s edges and 20 * 4^s
triangles), never from what the program built:

- bytes, once a call: each input read once (positions and velocities,
  inverse masses, the external force where the call applies it, the
  multipliers unless RESET zeroes them unread) and each output written
  once (positions, velocities, a distance multiplier an edge and, with the
  volume, one a body), every body; and the mesh's tables, which the bodies
  share, once (edges, rest lengths, compliances, relaxations, the edge and
  triangle-corner incidence rows, the triangles);
- operations, from the kernel's bodies (``csrc/mesh_xpbd.cu``): each
  iteration an edge's projection (``EDGE_OPS``) and, a particle, the sum
  of its rows (3 a column) and the correction; with the volume, a
  triangle's corner gradients and term (``TRI_OPS``), a particle's corner
  sum and ``w |g|^2`` (``VGRAD_OPS``), a body's reduction (one addition a
  term, a lane tree of 2 x 255, ``VREDUCE_OPS`` for the multiplier) and a
  particle's apply (``APPLY_OPS``); the floor's test and normal step
  (``FLOOR_OPS``; the friction of the particles in contact is left out),
  under Chebyshev acceleration the momentum step (``CHEBY_OPS``) and the
  floor again; a substep's predict and finalize a particle.

The kernel's time is that of the device operations named
``mesh_persistent_kernel`` in the traced slice, over the calls traced; a
slice with none reads nothing.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL = "mesh_persistent_kernel"
# an edge's projection: the difference 3, the length 4 (dot, max, sqrt),
# the violation, denominator and its magnitude 4, the multiplier step 5
# (-c - alpha * lambda, the division, the relaxation), the multiplier 1, and
# a coordinate's unit, step and two corrections 5 each
EDGE_OPS = 35
# a triangle's three cross products (9 each), its volume term (5) and its
# nine gradient coordinates over 6
TRI_OPS = 41
# a particle's w |g|^2 (a dot and a product)
VGRAD_OPS = 6
# a body's multiplier: V / 6 - target, the denominator, -C - alpha * lambda,
# the division, the multiplier
VREDUCE_OPS = 8
# a particle's volume apply: w * dlambda, and a product and a sum a coordinate
APPLY_OPS = 7
# the floor's penetration, denominator and its magnitude, the step, its
# product and the sum
FLOOR_OPS = 6
# the momentum step: two differences, two products and two sums a coordinate
CHEBY_OPS = 18
# predict (gravity or force, the velocity, damping, the prediction: 7 a
# coordinate) and finalize (a difference and a division a coordinate)
PREDICT_OPS = 21
FINALIZE_OPS = 6


def shape(conf):
    """(particles, edges, triangles) of one body."""
    k = 4 ** conf["body"]["subdivisions"]
    return 10 * k + 2, 30 * k, 20 * k


def accelerated(s) -> bool:
    return (s["solve_mode"] == "jacobi" and s["jacobi_rho"] > 0
            and s["iterations"] > s["jacobi_cheby_delay"])


def work(conf, substeps: int, with_ext: bool):
    """(bytes, operations) of one call of ``substeps`` substeps."""
    s, b = conf["solver"], conf["bodies"]
    n, e, t = shape(conf)
    volume = bool(s["enable_volume"])
    lam = e + (1 if volume else 0)
    lam_reads = 0 if s["lambda_mode"] == "reset" else 1
    tables = (e * (8 + 4 + 4 + 4) + 4 * (n + 1) + 4 * 2 * e
              + (12 * t + 4 * (n + 1) + 4 * 3 * t if volume else 0))
    nbytes = (b * (n * (24 + 4 + (12 if with_ext else 0)) + 4 * lam * lam_reads
                   + n * 24 + 4 * lam) + tables)
    floor = FLOOR_OPS if s["floor_mode"] == "xpbd_inequality" else 0
    it = e * EDGE_OPS + 3 * 2 * e + 3 * n + n * floor
    if volume:
        it += (t * TRI_OPS + 3 * 3 * t + n * VGRAD_OPS
               + t + n + 2 * 255 + VREDUCE_OPS + n * APPLY_OPS)
    if accelerated(s):
        it += n * (CHEBY_OPS + floor)
    ops = substeps * b * (s["iterations"] * it
                          + n * (PREDICT_OPS + FINALIZE_OPS))
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
