// General-mesh XPBD substep loop for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel softbodysimulation_tpu/kernels/mesh_pallas.py
// make_mesh_substep_runner (:789, kernel body :990, pallas_call :1794) for
// the distance, dihedral-bending and per-tet volume families with contact:
// predict, the lambda lifecycle (RESET, DECAY, WARM_START with its
// pre-apply pass), JACOBI sweeps (distance and bending with the
// per-constraint omega / max(degree) relaxation, tets at full strength with
// mass splitting) with optional Chebyshev acceleration, or COLORED exact
// Gauss-Seidel sweeps of all three families, self-collision (the in-kernel
// dense all-pairs pass of mesh_pallas.py:1390-1494, or the blocked pass of
// TPU kernel B-4, contact_xpbd.cu, linked into this library), the XPBD
// floor, sphere and box SDFs, finalize and the VELOCITY_REFLECT floor.  It
// ports WHAT that kernel computes -- the semantics of
// solvers/general.py::_substep -- and none of its TPU machinery: no signed
// one-hot gather/scatter matrices, no bf16 split compensation, no window
// bases, no VMEM budget, and acosf in place of the polynomial Mosaic
// needed.  Traced materials are per-call rest and alpha buffers; the
// spheres and boxes (the config's, or a ColliderSet's traced poses,
// velocities and ground: mesh_pallas.py:881-898,
// :1566-1590) come from the collider table of colliders.cuh, read by every
// pass, so a new pose rebuilds nothing.  The structs and the
// arithmetic the fused backward (mesh_diff_xpbd.cu, built into the same
// library) shares live in mesh_xpbd.cuh.
//
// The global volume constraint (mesh_pallas.py volume_sweep, :1259-1313,
// the math of ops/volume.py) after the tets and before the contacts of
// every iteration, one multiplier a body: a triangle pass writes each
// triangle's three corner gradients and its volume term; a particle pass
// sums each particle's corner rows (CSR, column order) into a gradient
// plane and w |g|^2; one block a body adds the volume terms and the
// w |g|^2 in a fixed order (strided per thread, then a halving tree: the
// plain twin's ops/volume.block_sum), forms dlambda and updates the
// multiplier; the apply pred += w dlambda g rides in the particle pass that
// carries the iteration's tail (contacts, Chebyshev, finalize).  No
// atomics, so the sums are the same every run.
//
// Layout: x, v, pred (and the Chebyshev planes cur, prev) are (3, N)
// float32 structure-of-arrays planes; lambda_dist (E), lambda_bend (H),
// lambda_tet (T); the topology's int32 tables and per-constraint constants
// are uploaded once per device by the wrapper, the incidence tables as CSR
// rows (the topology's padded rows without their pads, in the same column
// order, so the sums are unchanged).
//
// Ensembles (mesh_pallas.py n_bodies > 1, :814-861, :1405-1422,
// :1921-2001): B instances of one topology lie one after another in every
// per-body buffer (x, v, pred, ext, the multipliers, the contribution
// buffers, the dense pass's scratch; the inverse masses with per_body_mass,
// rest and alpha with (B, E) materials).  Each item of a pass first takes
// its body's view (body_buffers_of), so each body's arithmetic, sums in CSR
// column order and dense-contact mean included, is the single-body
// kernel's to the bit.  The per-edge, per-hinge and per-tet tables are
// shared.  Dense self-collision is body-local: one mean and one Gram sweep
// per body, so no pair crosses bodies.  The blocked pass (B-4) takes one
// body only.  The TPU kernel's 8-sublane padding of the body axis has no
// counterpart.
//
// A substep's passes, in order (each reads what the one before wrote):
//   predict (+ the lambda lifecycle of all four families);
//   WARM_START: an edge pass and a particle pass;
//   on a contact substep with the blocked backend, the curve order (stats,
//     Hilbert codes, a radix sort), once, after the warm start;
//   per iteration, JACOBI: for each family, a constraint pass writing each
//     endpoint's contribution into a (2E | 4H | 4T, 3) buffer and a
//     particle pass adding the particle's incidence row of it (the
//     gather-and-sum of general.py:109-113, in column order, no atomics;
//     tets divide it by max(tet degree, 1));
//   per iteration, COLORED: one pass per colour of each family (a thread
//     updates its constraint's lambda and endpoints in place; a colour
//     shares no particle, so this is exact);
//   per iteration, with the volume on: the triangle pass, the gradient
//     pass, the reduction (one block a body) and the apply;
//   then the contacts: without self-collision the last particle pass also
//     projects floor and spheres, takes the Chebyshev step and, after the
//     last iteration, finalizes; on a contact substep (i % every == 0) the
//     self-collision pass comes first -- dense: the all-pairs pass writing
//     a correction plane; blocked: the B-4 pass -- and a particle pass
//     applies omega * correction, then floor and spheres; accelerated, the
//     Chebyshev step is followed by a second self-collision pass and apply
//     (general.py:654-655).
//
// Two designs run those passes, with the same item functions, so they
// agree to the bit:
//   - mesh_xpbd_run (every route): one persistent launch a contact-free
//     stretch of passes (mesh_persistent_kernel).  Each block owns fixed
//     tiles of particles, edges, hinges, tets, triangles, colour slots and
//     dense rows for the whole call (kernels/mesh_cuda.py plan_schedule,
//     from the shape alone), and the passes are separated by the counting
//     grid barrier of grid_barrier.cuh in a cooperative launch, or by
//     __syncthreads() where a block holds whole bodies.  Fusions that keep
//     every bit: the next substep's predict runs in the thread that
//     finalizes the previous one, on the values it just wrote, and the
//     multipliers' lifecycle in the same phase; the volume's reduction is a
//     phase between two barriers, one block a body.  With the blocked
//     backend the call splits around each B-4 pass (its curve order and
//     each correction): a persistent segment, B-4's launches, the next
//     segment (stages, MX_STAGE_*).  Dense contact runs inside as phases.
//   - mesh_xpbd_run_per_pass: one launch a pass, the design the persistent
//     kernel replaced, kept as its yardstick (no route takes it).
//
// What bounds it on the card: at cloth_xl (16,641 particles, 49,408 edges,
// 48,896 hinges) the state, the contribution buffers and the tables are a
// few MB and live in the 50 MB L2, and a pass is a few hundred flops per
// constraint.  One launch a pass (11 a substep) cost the 3-5 us of a
// launch each; a phase of the persistent kernel costs a pass's latency and
// the barrier.  The particle passes walk CSR rows; the 20,243-particle
// ball-on-cloth's hub (the centroid of its tet fan: 642 spoke edges, 1,280
// tets) walked its rows in one thread, a dependent load and add a column,
// 45.8 and 92.9 us a pass (PERF.md, PR 12).  So a row longer than
// MX_HUB_WIDTH is summed by a warp (warp_row_sum): the lanes load 128
// columns at a time (indices one round ahead of the contributions), stage
// them in shared memory, and three lanes, one a coordinate, add them in
// column order -- the one-thread sum's order, so every bit is kept (the
// plain twin ops/incidence.gather_sum and B-5's replay, which sums every
// row in one thread, stay equal to it).  The hub warps run in extra warps
// of the same launch (per-pass) or in warps of the last blocks, whose
// particle tiles are empty (persistent).  The dense self-collision pass
// gives each row a warp: the lanes take the columns j = lane, lane + 32,
// ... in order from a shared-memory tile of the body's centred positions,
// and their sums meet in a fixed shuffle tree (offsets 16, 8, 4, 2, 1 onto
// lane 0); every block recomputes its bodies' mean with the one-block
// tree, so no launch or phase is spent on it.  What bounds the persistent
// kernel now: a phase costs a pass's latency and the barrier, a few us
// (PERF.md, PR 12), and with every pass in one function (run_phase) it
// needs 128 registers a thread, so two blocks an SM: where a tile holds
// several items a thread (ensembles of large bodies) the per-pass loop's
// fuller SMs win.
//
// approx_math (mesh_pallas.py:810-811; its sites :1072-1075, :1103 and
// :1193-1195): every distance projection (JACOBI, COLORED and the warm
// pre-apply) takes the edge's length as |d|^2 * rsqrtf(|d|^2) and its unit
// direction as d times that rsqrt, and the bending pass normalises the
// hinge normals (and scales its a / b vectors) by rsqrtf of their squared
// lengths in place of dividing by their lengths.  The TPU kernel's switch
// to single-pass bf16 one-hot products under approx_math
// (mesh_pallas.py:874-876) is an artifact of its matrix unit and has no
// counterpart here.  The plain twin (solvers/general.py, approx_math=True)
// takes torch.rsqrt.
//
// Floats: built without --use_fast_math and with -fmad=false, so every
// product and sum is rounded as written, in the operation order of the plain
// PyTorch engine (cross products component by component, dot products
// x + y + z); near-flat hinges turn one ulp of cos into ~3e-4 rad of angle,
// and the sin masks of the bending bands must see the same bits.  The
// self-collision passes take their two matrix-product sums with explicit
// fused multiply-adds, as contact_xpbd.cu explains.

#include "grid_barrier.cuh"
#include "mesh_xpbd.cuh"

// ops/bending.py::bending_delta_lambda for one hinge (a, b, c, d): returns
// dlambda and writes the four gradients (zero when the hinge is invalid).
__device__ __forceinline__ float bending_dl(const MeshParams& p,
                                            float pp[4][3], const float w[4],
                                            float rest, float alpha0,
                                            float lam, float g[4][3]) {
  float e0[3], e1[3], e2[3];
  for (int c = 0; c < 3; ++c) {
    e0[c] = pp[1][c] - pp[0][c];
    e1[c] = pp[2][c] - pp[0][c];
    e2[c] = pp[3][c] - pp[0][c];
  }
  float n1[3], n2[3];
  cross3(e0, e1, n1);
  cross3(e2, e0, n2);
  const float l1sq = dot3(n1, n1);
  const float l2sq = dot3(n2, n2);
  const bool geom_ok = l1sq >= 1e-9f && l2sq >= 1e-9f;
  // l1, l2: the normals' lengths, or with approx_math the rsqrt of their
  // squares (mesh_pallas.py:1193-1195), by which the normals and the a / b
  // vectors below are multiplied in place of a division (unit_coord)
  const float l1 = p.approx_math ? rsqrtf(fmaxf(l1sq, 1e-24f))
                                 : sqrtf(fmaxf(l1sq, 1e-24f));
  const float l2 = p.approx_math ? rsqrtf(fmaxf(l2sq, 1e-24f))
                                 : sqrtf(fmaxf(l2sq, 1e-24f));
  float n1n[3], n2n[3];
  for (int c = 0; c < 3; ++c) {
    n1n[c] = unit_coord(p, n1[c], l1, l1);
    n2n[c] = unit_coord(p, n2[c], l2, l2);
  }
  const float cs = clampf(dot3(n1n, n2n), -1.f, 1.f);
  const float angle = acosf(cs);
  const float cerr = angle - rest;
  const float sn = sinf(angle);
  const bool sin_ok = fabsf(sn) >= p.skip_sin_eps;
  const bool soften = fabsf(sn) < p.soften_sin_eps;
  const float alpha = soften ? alpha0 * p.soften_factor : alpha0;
  const float inv_sin = 1.f / (sin_ok ? sn : 1.f);

  float av[3], bv[3];
  for (int c = 0; c < 3; ++c) {
    av[c] = unit_coord(p, n2n[c] - cs * n1n[c], l1, l1);
    bv[c] = unit_coord(p, n1n[c] - cs * n2n[c], l2, l2);
  }
  const float scale = -inv_sin;
  float t1[3], t2[3];
  cross3(e1, av, t1);
  cross3(bv, e2, t2);
  for (int c = 0; c < 3; ++c) g[1][c] = scale * (t1[c] + t2[c]);
  cross3(av, e0, t1);
  for (int c = 0; c < 3; ++c) g[2][c] = scale * t1[c];
  cross3(e0, bv, t1);
  for (int c = 0; c < 3; ++c) g[3][c] = scale * t1[c];
  for (int c = 0; c < 3; ++c) g[0][c] = -g[1][c] - g[2][c] - g[3][c];

  const float s = w[0] * dot3(g[0], g[0]) + w[1] * dot3(g[1], g[1]) +
                  w[2] * dot3(g[2], g[2]) + w[3] * dot3(g[3], g[3]);
  const float denom = s + alpha;
  const float eps = p.static_eps;
  const bool any_dynamic =
      w[0] >= eps || w[1] >= eps || w[2] >= eps || w[3] >= eps;
  const bool valid = geom_ok && sin_ok && denom >= 1e-9f && any_dynamic;
  float dl = (-cerr - alpha * lam) / (valid ? denom : 1.f);
  if (p.max_dlambda > 0.f) dl = clampf(dl, -p.max_dlambda, p.max_dlambda);
  if (!valid) {
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c) g[k][c] = 0.f;
    return 0.f;
  }
  return dl;
}

// ops/tet_volume.py::tet_delta_lambda for one tet (p0..p3): returns
// dlambda (0 when the denominator is at most eps_denominator) and writes
// the four gradients of 6V.
__device__ __forceinline__ float tet_dl(const MeshParams& p, float pp[4][3],
                                        const float w[4], float rest,
                                        float alpha, float lam,
                                        float g[4][3]) {
  float e1[3], e2[3], e3[3];
  for (int c = 0; c < 3; ++c) {
    e1[c] = pp[1][c] - pp[0][c];
    e2[c] = pp[2][c] - pp[0][c];
    e3[c] = pp[3][c] - pp[0][c];
  }
  cross3(e2, e3, g[1]);
  cross3(e3, e1, g[2]);
  cross3(e1, e2, g[3]);
  for (int c = 0; c < 3; ++c) g[0][c] = -(g[1][c] + g[2][c] + g[3][c]);
  const float vol6 = dot3(e1, g[1]);
  const float cerr = vol6 - p.tet_pressure * rest;
  const float denom = w[0] * dot3(g[0], g[0]) + w[1] * dot3(g[1], g[1]) +
                      w[2] * dot3(g[2], g[2]) + w[3] * dot3(g[3], g[3]) +
                      alpha;
  const bool valid = denom > p.eps_denominator;
  const float dl = (-cerr - alpha * lam) / (valid ? denom : 1.f);
  return valid ? dl : 0.f;
}

// ---- one item of each pass, shared by both designs -----------------------

// The lambda lifecycle at a substep's start: distance multipliers reset
// (RESET) or decayed; bending, tet and volume ones decayed (DECAY) or reset.
__device__ __forceinline__ void lifecycle_edge(const MeshParams& p,
                                               const MeshBuffers& b, int e) {
  b.lam[e] = p.lambda_mode == 0 ? 0.f : b.lam[e] * p.lambda_decay;
}

__device__ __forceinline__ float lifecycle_other(const MeshParams& p,
                                                 float lam) {
  return p.lambda_mode == 1 ? lam * p.lambda_decay : 0.f;
}

// Predict particle i from its position xc and velocity vin (gravity, the
// ext force when use_ext, damping, clamps); save: cur = prev = pred.
__device__ __forceinline__ void predict_one(const MeshParams& p,
                                            const MeshBuffers& b, int i,
                                            const float xc[3],
                                            const float vin[3],
                                            bool use_ext, bool save) {
  const int n = p.n;
  const float wa = __ldg(&b.w[i]);
  float e[3] = {0.f, 0.f, 0.f};
  if (use_ext) load3(b.f, n, i, e);
  float vo[3], po[3];
  for (int c = 0; c < 3; ++c) {
    float v_raw, p_raw;
    predict_coord(p, c, wa, xc[c], vin[c], e[c], &v_raw, &vo[c], &p_raw,
                  &po[c]);
  }
  store3(b.v, n, i, vo);
  store3(b.pred, n, i, po);
  if (save) {
    store3(b.cur, n, i, po);
    store3(b.prev, n, i, po);
  }
}

// The JACOBI projection (warm = 0) or the WARM_START pre-apply (warm = 1)
// of edge e, its lambda updated in place and its two position
// contributions written to contrib rows e (a side) and E + e.
__device__ __forceinline__ void edge_one(const MeshParams& p,
                                         const MeshBuffers& b, int e,
                                         int warm) {
  const int n = p.n, ne = p.n_edges;
  const int ia = __ldg(&b.edges[2 * e]), ib = __ldg(&b.edges[2 * e + 1]);
  const float wa = __ldg(&b.w[ia]), wb = __ldg(&b.w[ib]);
  float pa[3], pb[3], d[3];
  load3(b.pred, n, ia, pa);
  load3(b.pred, n, ib, pb);
  for (int c = 0; c < 3; ++c) d[c] = pb[c] - pa[c];
  float inv;
  const float len = edge_length(p, d, &inv);
  float s;
  if (warm) {
    s = b.lam[e] * __ldg(&b.warm_scale[e]);
    if (p.warm_clamp > 0.f) {
      const float lim =
          p.warm_clamp * __ldg(&b.rest[e]) / fmaxf(fmaxf(wa, wb), 1e-12f);
      s = clampf(s, -lim, lim);
    }
    b.lam[e] = s;
  } else {
    s = distance_dl(p, len, __ldg(&b.rest[e]), __ldg(&b.alpha[e]), wa, wb,
                    b.lam[e]) *
        __ldg(&b.relax[e]);
    float lam = b.lam[e] + s;
    if (p.lambda_clamp > 0.f) lam = clampf(lam, -p.lambda_clamp,
                                           p.lambda_clamp);
    b.lam[e] = lam;
  }
  for (int c = 0; c < 3; ++c) {
    const float dp = s * unit_coord(p, d[c], len, inv);
    b.contrib[3 * e + c] = -wa * dp;
    b.contrib[3 * (ne + e) + c] = wb * dp;
  }
}

// The JACOBI projection of hinge h; contributions in rows k*H + h for
// endpoint k.
__device__ __forceinline__ void hinge_one(const MeshParams& p,
                                          const MeshBuffers& b, int h) {
  const int n = p.n, nh = p.n_hinges;
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    const int i = __ldg(&b.hinges[4 * h + k]);
    load3(b.pred, n, i, pp[k]);
    w[k] = __ldg(&b.w[i]);
  }
  const float dl = bending_dl(p, pp, w, __ldg(&b.brest[h]),
                              __ldg(&b.balpha[h]), b.blam[h], g) *
                   __ldg(&b.brelax[h]);
  b.blam[h] = b.blam[h] + dl;
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c)
      b.bcontrib[3 * (k * nh + h) + c] = w[k] * dl * g[k][c];
}

// The mass-splitting JACOBI projection of tet t at full strength times
// omega; contributions in rows k*T + t for endpoint k.
__device__ __forceinline__ void tet_one(const MeshParams& p,
                                        const MeshBuffers& b, int t) {
  const int n = p.n, nt = p.n_tets;
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    const int i = __ldg(&b.tets[4 * t + k]);
    load3(b.pred, n, i, pp[k]);
    w[k] = __ldg(&b.w[i]);
  }
  const float dl =
      tet_dl(p, pp, w, __ldg(&b.trest[t]), __ldg(&b.talpha[t]), b.tlam[t],
             g) *
      p.omega;
  b.tlam[t] = b.tlam[t] + dl;
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c)
      b.tcontrib[3 * (k * nt + t) + c] = w[k] * dl * g[k][c];
}

// COLORED: slot s of edge colour `color`, exact in place.  clamp_in: the
// multiplier entering the update was clamped by an earlier colour pass
// (every pass but the first of a substep's first iteration), as
// general._solve_distance_colored clamps the whole array after each
// colour.
__device__ __forceinline__ void edge_color_one(const MeshParams& p,
                                               const MeshBuffers& b,
                                               int color, int clamp_in,
                                               int s) {
  const size_t slot = (size_t)color * p.col_width + s;
  if (!(__ldg(&b.col_valid[slot]) > 0.f)) return;
  const int n = p.n;
  const int e = __ldg(&b.col_ids[slot]);
  const int ia = __ldg(&b.edges[2 * e]), ib = __ldg(&b.edges[2 * e + 1]);
  const float wa = __ldg(&b.w[ia]), wb = __ldg(&b.w[ib]);
  float pa[3], pb[3], d[3];
  load3(b.pred, n, ia, pa);
  load3(b.pred, n, ib, pb);
  for (int c = 0; c < 3; ++c) d[c] = pb[c] - pa[c];
  float inv;
  const float len = edge_length(p, d, &inv);
  float lam = b.lam[e];
  if (clamp_in && p.lambda_clamp > 0.f)
    lam = clampf(lam, -p.lambda_clamp, p.lambda_clamp);
  const float dl = distance_dl(p, len, __ldg(&b.rest[e]),
                               __ldg(&b.alpha[e]), wa, wb, lam);
  lam = lam + dl;
  if (p.lambda_clamp > 0.f)
    lam = clampf(lam, -p.lambda_clamp, p.lambda_clamp);
  b.lam[e] = lam;
  for (int c = 0; c < 3; ++c) {
    const float dp = dl * unit_coord(p, d[c], len, inv);
    pa[c] = pa[c] + -wa * dp;
    pb[c] = pb[c] + wb * dp;
  }
  store3(b.pred, n, ia, pa);
  store3(b.pred, n, ib, pb);
}

// COLORED: slot s of hinge colour `color`, exact in place.
__device__ __forceinline__ void hinge_color_one(const MeshParams& p,
                                                const MeshBuffers& b,
                                                int color, int s) {
  const size_t slot = (size_t)color * p.bcol_width + s;
  if (!(__ldg(&b.bcol_valid[slot]) > 0.f)) return;
  const int n = p.n;
  const int h = __ldg(&b.bcol_ids[slot]);
  int idx[4];
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    idx[k] = __ldg(&b.hinges[4 * h + k]);
    load3(b.pred, n, idx[k], pp[k]);
    w[k] = b.w[idx[k]];
  }
  const float dl = bending_dl(p, pp, w, __ldg(&b.brest[h]),
                              __ldg(&b.balpha[h]), b.blam[h], g);
  b.blam[h] = b.blam[h] + dl;
  for (int k = 0; k < 4; ++k) {
    float o[3];
    for (int c = 0; c < 3; ++c) o[c] = pp[k][c] + w[k] * dl * g[k][c];
    store3(b.pred, n, idx[k], o);
  }
}

// COLORED: slot s of tet colour `color`, exact in place.
__device__ __forceinline__ void tet_color_one(const MeshParams& p,
                                              const MeshBuffers& b,
                                              int color, int s) {
  const size_t slot = (size_t)color * p.tcol_width + s;
  if (!(__ldg(&b.tcol_valid[slot]) > 0.f)) return;
  const int n = p.n;
  const int t = __ldg(&b.tcol_ids[slot]);
  int idx[4];
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    idx[k] = __ldg(&b.tets[4 * t + k]);
    load3(b.pred, n, idx[k], pp[k]);
    w[k] = b.w[idx[k]];
  }
  const float dl = tet_dl(p, pp, w, __ldg(&b.trest[t]), __ldg(&b.talpha[t]),
                          b.tlam[t], g);
  b.tlam[t] = b.tlam[t] + dl;
  for (int k = 0; k < 4; ++k) {
    float o[3];
    for (int c = 0; c < 3; ++c) o[c] = pp[k][c] + w[k] * dl * g[k][c];
    store3(b.pred, n, idx[k], o);
  }
}

// The global volume constraint, pass 1 of 3: triangle t (p1, p2, p3)
// writes its corner gradients cross(p2, p3) / 6, cross(p3, p1) / 6 and
// cross(p1, p2) / 6 to vcontrib rows t, T + t and 2T + t, and its volume
// term p1 . (p2 x p3) to vterm[t].
__device__ __forceinline__ void tri_one(const MeshParams& p,
                                        const MeshBuffers& b, int t) {
  const int n = p.n, nt = p.n_tris;
  float q[3][3], g[3][3];
  for (int k = 0; k < 3; ++k) load3(b.pred, n, __ldg(&b.tris[3 * t + k]), q[k]);
  cross3(q[1], q[2], g[0]);
  cross3(q[2], q[0], g[1]);
  cross3(q[0], q[1], g[2]);
  b.vterm[t] = dot3(q[0], g[0]);
  for (int k = 0; k < 3; ++k)
    for (int c = 0; c < 3; ++c)
      b.vcontrib[3 * (k * nt + t) + c] = g[k][c] / 6.f;
}

// One thread's sum of CSR columns [k0, k1): s = contrib rows added in
// column order, from 0.
__device__ __forceinline__ void row_sum(const float* contrib,
                                        const int* cols, int k0, int k1,
                                        float s[3]) {
  s[0] = s[1] = s[2] = 0.f;
  for (int k = k0; k < k1; ++k) {
    const int j = __ldg(&cols[k]);
    for (int c = 0; c < 3; ++c) s[c] = s[c] + contrib[3 * j + c];
  }
}

// The hub warp's stage: 128 columns a round, each lane 4 of them; one
// coordinate's 128 values in a row of MX_HUB_LD floats (the pad puts the
// three reading lanes on three banks).
#define MX_HUB_G 4
#define MX_HUB_ROUND (32 * MX_HUB_G)
#define MX_HUB_LD (MX_HUB_ROUND + 1)
#define MX_HUB_STAGE (3 * MX_HUB_LD)
#define MX_HUB_BYTES (MX_WARPS * MX_HUB_STAGE * (int)sizeof(float))

// A warp's sum of CSR columns [k0, k1), in column order from 0, the bits of
// row_sum: the lanes load a round of 128 columns' contributions (their
// indices loaded one round earlier, so both loads of a column are in
// flight while the previous round is added) and stage them in `stage`
// (MX_HUB_STAGE floats of shared memory, this warp's own); lane c < 3 adds
// coordinate c's 128 values in order.  Every lane returns the three sums.
// Called by all 32 lanes of a warp.
__device__ __forceinline__ void warp_row_sum(const float* contrib,
                                             const int* cols, int k0, int k1,
                                             float* stage, float s[3]) {
  const int lane = threadIdx.x & 31;
  int col[MX_HUB_G];
  float v[MX_HUB_G][3];
  for (int g = 0; g < MX_HUB_G; ++g) {
    const int k = k0 + 32 * g + lane;
    col[g] = k < k1 ? __ldg(&cols[k]) : -1;
  }
  for (int g = 0; g < MX_HUB_G; ++g)
    for (int c = 0; c < 3; ++c)
      v[g][c] = col[g] >= 0 ? contrib[3 * col[g] + c] : 0.f;
  for (int g = 0; g < MX_HUB_G; ++g) {
    const int k = k0 + MX_HUB_ROUND + 32 * g + lane;
    col[g] = k < k1 ? __ldg(&cols[k]) : -1;
  }
  float acc = 0.f;
  for (int base = k0; base < k1; base += MX_HUB_ROUND) {
    for (int g = 0; g < MX_HUB_G; ++g)
      for (int c = 0; c < 3; ++c)
        stage[c * MX_HUB_LD + 32 * g + lane] = v[g][c];
    __syncwarp();
    // the next round's contributions and the round after's indices
    for (int g = 0; g < MX_HUB_G; ++g)
      for (int c = 0; c < 3; ++c)
        v[g][c] = col[g] >= 0 ? contrib[3 * col[g] + c] : 0.f;
    for (int g = 0; g < MX_HUB_G; ++g) {
      const int k = base + 2 * MX_HUB_ROUND + 32 * g + lane;
      col[g] = k < k1 ? __ldg(&cols[k]) : -1;
    }
    if (lane < 3) {
      const float* row = stage + lane * MX_HUB_LD;
      const int m = min(MX_HUB_ROUND, k1 - base);
      if (m == MX_HUB_ROUND) {
#pragma unroll
        for (int j = 0; j < MX_HUB_ROUND; ++j) acc = acc + row[j];
      } else {
        for (int j = 0; j < m; ++j) acc = acc + row[j];
      }
    }
    __syncwarp();
  }
  for (int c = 0; c < 3; ++c) s[c] = __shfl_sync(0xffffffffu, acc, c);
}

// Pass 2 of 3 for particle i, given its corner rows' sum s: the gradient
// plane vgrad and w |g|^2 into vwg.
__device__ __forceinline__ void vol_grad_store(const MeshParams& p,
                                               const MeshBuffers& b, int i,
                                               const float s[3]) {
  store3(b.vgrad, p.n, i, s);
  b.vwg[i] = __ldg(&b.w[i]) * dot3(s, s);
}

// One thread's pass 2 for particle i; a hub row (p.n_vinc_hubs > 0) is
// left to its warp (vol_grad_hub).
__device__ __forceinline__ void vol_grad_one(const MeshParams& p,
                                             const MeshBuffers& b, int i) {
  const int k0 = __ldg(&b.vinc_ptr[i]), k1 = __ldg(&b.vinc_ptr[i + 1]);
  if (p.n_vinc_hubs > 0 && k1 - k0 > MX_HUB_WIDTH) return;
  float s[3];
  row_sum(b.vcontrib, b.vinc_cols, k0, k1, s);
  vol_grad_store(p, b, i, s);
}

// A warp's pass 2 for hub row `hub` of the corner table.
__device__ __forceinline__ void vol_grad_hub(const MeshParams& p,
                                             const MeshBuffers& b, int hub,
                                             float* stage) {
  const int i = __ldg(&b.vinc_hubs[hub]);
  float s[3];
  warp_row_sum(b.vcontrib, b.vinc_cols, __ldg(&b.vinc_ptr[i]),
               __ldg(&b.vinc_ptr[i + 1]), stage, s);
  if ((threadIdx.x & 31) == 0) vol_grad_store(p, b, i, s);
}

// Pass 3 of 3 for one body, by the whole block of MX_THREADS: V and
// sum_i w_i |g_i|^2 (thread t adds elements t, t + MX_THREADS, ... in
// order, then a halving tree), then ops/volume.py's dlambda with its safe
// divisor (denominator > 1e-12), lambda += dlambda; the apply reads vdl.
// s_v, s_w: 2 x MX_THREADS floats of shared memory.
__device__ __forceinline__ void vol_reduce_body(const MeshParams& p,
                                                const MeshBuffers& b,
                                                float* s_v, float* s_w) {
  const int t = threadIdx.x;
  float sv = 0.f, sw = 0.f;
  for (int k = t; k < p.n_tris; k += MX_THREADS) sv = sv + b.vterm[k];
  for (int k = t; k < p.n; k += MX_THREADS) sw = sw + b.vwg[k];
  s_v[t] = sv;
  s_w[t] = sw;
  __syncthreads();
  for (int half = MX_THREADS / 2; half > 0; half >>= 1) {
    if (t < half) {
      s_v[t] = s_v[t] + s_v[t + half];
      s_w[t] = s_w[t] + s_w[t + half];
    }
    __syncthreads();
  }
  if (t == 0) {
    const float cerr = s_v[0] / 6.f - p.vol_target;
    const float lam = *b.vlam;
    const float denom = s_w[0] + p.vol_alpha;
    const bool valid = denom > 1e-12f;
    const float dl = (-cerr - p.vol_alpha * lam) / (valid ? denom : 1.f);
    *b.vdl = valid ? dl : 0.f;
    *b.vlam = lam + (valid ? dl : 0.f);
  }
  __syncthreads();  // s_v, s_w free again
}

// Dense self-collision: the mean of one body's pred, by the whole block of
// MX_THREADS (thread t adds particles t, t + MX_THREADS, ... in order, then
// a halving tree), into mean[] of every thread.  s_sum: 3 x MX_THREADS
// floats of shared memory.
__device__ __forceinline__ void body_mean(const MeshParams& p,
                                          const float* pred, float* s_sum,
                                          float mean[3]) {
  const int t = threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    float sum = 0.f;
    for (int i = t; i < p.n; i += MX_THREADS)
      sum = sum + pred[(size_t)c * p.n + i];
    s_sum[c * MX_THREADS + t] = sum;
  }
  __syncthreads();
  for (int half = MX_THREADS / 2; half > 0; half >>= 1) {
    if (t < half)
      for (int c = 0; c < 3; ++c)
        s_sum[c * MX_THREADS + t] =
            s_sum[c * MX_THREADS + t] + s_sum[c * MX_THREADS + t + half];
    __syncthreads();
  }
  for (int c = 0; c < 3; ++c) mean[c] = s_sum[c * MX_THREADS] / (float)p.n;
  __syncthreads();  // s_sum free again
}

// Dense self-collision's columns, staged by a block in tiles of
// MX_DENSE_TILE (a multiple of 32): each particle's position centred by its
// body's mean, its |x|^2 and its inverse mass, in five rows of the tile.
#define MX_DENSE_TILE 1024
#define MX_DENSE_FLOATS (5 * MX_DENSE_TILE)

// Stage columns [t0, t0 + MX_DENSE_TILE) of body b into `tile`, by the
// whole block (a barrier before, so the tile is free, and after).
__device__ __forceinline__ void dense_stage(const MeshParams& p,
                                            const MeshBuffers& b,
                                            const float mean[3], int t0,
                                            float* tile) {
  __syncthreads();
  const int m = min(MX_DENSE_TILE, p.n - t0);
  for (int k = threadIdx.x; k < m; k += MX_THREADS) {
    const int j = t0 + k;
    float xj[3];
    for (int c = 0; c < 3; ++c) xj[c] = b.pred[(size_t)c * p.n + j] - mean[c];
    for (int c = 0; c < 3; ++c) tile[c * MX_DENSE_TILE + k] = xj[c];
    tile[3 * MX_DENSE_TILE + k] = dot3(xj, xj);
    tile[4 * MX_DENSE_TILE + k] = __ldg(&b.w[j]);
  }
  __syncthreads();
}

// Dense self-collision (mesh_pallas.py:1390-1494), rows [r0, r1) of body b
// by the whole block: the body's mean (body_mean), the columns staged in
// tiles (once, for a body of at most MX_DENSE_TILE particles), and one warp
// a row.  Lane l tests the columns j = l, l + 32, ... in order with the
// pair arithmetic of the blocked pass (contact_xpbd.cu) on positions
// centred by the mean, and the lanes' sums meet in a fixed shuffle tree
// (offsets 16, 8, 4, 2, 1 onto lane 0), which writes the row's correction
// to sc_corr.  s_sum: 3 x MX_THREADS floats of shared memory; tile:
// MX_DENSE_FLOATS.
__device__ __forceinline__ void dense_rows(const MeshParams& p,
                                           const MeshBuffers& b,
                                           float* s_sum, float* tile,
                                           int r0, int r1) {
  const int n = p.n;
  const int lane = threadIdx.x & 31;
  const bool one_tile = n <= MX_DENSE_TILE;
  float mean[3];
  body_mean(p, b.pred, s_sum, mean);
  if (one_tile) dense_stage(p, b, mean, 0, tile);
  for (int base = r0; base < r1; base += MX_WARPS) {
    const int i = base + (int)threadIdx.x / 32;
    const bool row = i < r1;  // the same for the whole warp
    float xi[3] = {0.f, 0.f, 0.f};
    float wi = 0.f;
    if (row) {
      for (int c = 0; c < 3; ++c)
        xi[c] = b.pred[(size_t)c * n + i] - mean[c];
      wi = __ldg(&b.w[i]);
    }
    const float sqi = dot3(xi, xi);
    float msum = 0.f, mx[3] = {0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < n; t0 += MX_DENSE_TILE) {
      if (!one_tile) dense_stage(p, b, mean, t0, tile);
      if (!row) continue;
      const int m = min(MX_DENSE_TILE, n - t0);
      for (int k = lane; k < m; k += 32) {
        const float xj[3] = {tile[k], tile[MX_DENSE_TILE + k],
                             tile[2 * MX_DENSE_TILE + k]};
        const float sqj = tile[3 * MX_DENSE_TILE + k];
        const float wj = tile[4 * MX_DENSE_TILE + k];
        // the Gram product as contact_xpbd.cu takes it (fused, index order)
        const float g =
            fmaf(xi[2], xj[2], fmaf(xi[1], xj[1], xi[0] * xj[0]));
        const float d2 = (sqi + sqj) - 2.f * g;
        const float dist = sqrtf(fmaxf(d2, 1e-18f));
        const float overlap = p.sc_diam - dist;
        const float wsum = wi + wj;
        if (i != t0 + k && overlap > 0.f && dist > 1e-9f && wsum > 1e-12f) {
          const float mm =
              overlap / (fmaxf(dist, 1e-12f) * fmaxf(wsum, 1e-12f));
          msum = msum + mm;
          for (int c = 0; c < 3; ++c) mx[c] = fmaf(mm, xj[c], mx[c]);
        }
      }
    }
    if (!row) continue;
    for (int off = 16; off > 0; off >>= 1) {
      msum = msum + __shfl_down_sync(0xffffffffu, msum, off);
      for (int c = 0; c < 3; ++c)
        mx[c] = mx[c] + __shfl_down_sync(0xffffffffu, mx[c], off);
    }
    if (lane == 0)
      for (int c = 0; c < 3; ++c)
        b.sc_corr[(size_t)c * n + i] = wi * (xi[c] * msum - mx[c]);
  }
}

// Particle i's pass (slot t of a permuted correction): add its constraint
// sum s (when given; divided by max(deg, 1) when the source has degrees)
// or the self-collision correction (when given), then, as `flags` asks,
// contacts, the Chebyshev step with weight om, saving the iteration's
// start, finalize, and the next substep's predict.  Every read of the
// particle comes before its first write.
__device__ __forceinline__ void particle_one(const MeshParams& p,
                                             const MeshBuffers& b,
                                             const SumSource& src,
                                             const CorrSource& sc, int t,
                                             int i, const float* s,
                                             int flags, float om) {
  const int n = p.n;
  const float wa = __ldg(&b.w[i]);
  float pc[3], xc[3], cu[3], pv[3];
  load3(b.pred, n, i, pc);
  load3(b.x, n, i, xc);
  if (flags & (PF_CHEBY | PF_CHEBY_SPLIT)) {
    load3(b.cur, n, i, cu);
    load3(b.prev, n, i, pv);
  }
  if (s) {
    const float d = src.deg ? fmaxf(__ldg(&src.deg[i]), 1.f) : 1.f;
    for (int c = 0; c < 3; ++c) pc[c] = pc[c] + (src.deg ? s[c] / d : s[c]);
  }
  if (flags & PF_VOLUME) {
    const float sv = wa * *b.vdl;
    for (int c = 0; c < 3; ++c) pc[c] = pc[c] + sv * b.vgrad[c * n + i];
  }
  if (sc.corr)
    for (int c = 0; c < 3; ++c)
      pc[c] = pc[c] + p.sc_omega * sc.corr[(size_t)c * sc.ld + t];
  if (flags & PF_CONTACTS) project_contacts(p, b.colliders, wa, xc, pc);
  if (flags & (PF_CHEBY | PF_CHEBY_SPLIT)) {
    for (int c = 0; c < 3; ++c)
      pc[c] = om * (p.gamma * (pc[c] - cu[c]) + cu[c] - pv[c]) + pv[c];
    store3(b.prev, n, i, cu);
    if (flags & PF_CHEBY) {
      if (flags & PF_CONTACTS) project_contacts(p, b.colliders, wa, xc, pc);
      store3(b.cur, n, i, pc);
    }
  }
  if (flags & PF_SETCUR) store3(b.cur, n, i, pc);
  if (flags & PF_SAVE) {
    store3(b.cur, n, i, pc);
    store3(b.prev, n, i, pc);
  }
  if (!(flags & PF_FINALIZE)) {
    store3(b.pred, n, i, pc);
    return;
  }
  const bool pinned = wa == 0.f;
  float vc[3];
  for (int c = 0; c < 3; ++c) {
    vc[c] = pinned ? 0.f : (pc[c] - xc[c]) / p.dt;
    xc[c] = pinned ? xc[c] : pc[c];
  }
  if (p.floor_mode == 2) {
    const float gh = b.colliders[0];
    const float pen = gh - xc[1];
    const bool hit = pen > 0.f && wa > 0.f;
    if (hit) xc[1] = gh + p.floor_offset;
    const bool falling = hit && vc[1] < 0.f;
    const float vy = fabsf(vc[1]) * p.restitution + pen * p.penetration_kick;
    const float vel_y = falling ? vy : vc[1];
    const float normal_force = fabsf(vel_y) + pen * p.normal_force_scale;
    const float h_speed = sqrtf(vc[0] * vc[0] + vc[2] * vc[2]);
    const bool slide = falling && h_speed > 1e-3f;
    const float hs = fmaxf(h_speed, 1e-12f);
    const float fmag =
        fminf(h_speed, normal_force * p.floor_friction_coeff * p.dt);
    const float dv0 = slide ? vc[0] / hs * fmag : 0.f;
    const float dv2 = slide ? vc[2] / hs * fmag : 0.f;
    vc[0] = vc[0] - dv0;
    vc[1] = vel_y;
    vc[2] = vc[2] - dv2;
  }
  store3(b.x, n, i, xc);
  if (flags & PF_PREDICT)
    predict_one(p, b, i, xc, vc, false,
                p.accelerate && p.lambda_mode != 2);
  else
    store3(b.v, n, i, vc);
}

// One thread's particle pass for slot t of one body (views src, sc, b):
// the particle's row sum unless its row is a hub's (left to its warp).
__device__ __forceinline__ void particle_thread(const MeshParams& p,
                                                const MeshBuffers& b,
                                                const SumSource& src,
                                                const CorrSource& sc, int t,
                                                int flags, float om) {
  const int i = sc.perm ? sc.perm[t] : t;
  if (!src.contrib) {
    particle_one(p, b, src, sc, t, i, nullptr, flags, om);
    return;
  }
  const int k0 = __ldg(&src.ptr[i]), k1 = __ldg(&src.ptr[i + 1]);
  if (src.n_hubs > 0 && k1 - k0 > MX_HUB_WIDTH) return;
  float s[3];
  row_sum(src.contrib, src.cols, k0, k1, s);
  particle_one(p, b, src, sc, t, i, s, flags, om);
}

// A warp's particle pass for hub row `hub` of src (a sum pass: no
// correction, no permutation).
__device__ __forceinline__ void particle_hub(const MeshParams& p,
                                             const MeshBuffers& b,
                                             const SumSource& src,
                                             const CorrSource& sc, int hub,
                                             int flags, float om,
                                             float* stage) {
  const int i = __ldg(&src.hubs[hub]);
  float s[3];
  warp_row_sum(src.contrib, src.cols, __ldg(&src.ptr[i]),
               __ldg(&src.ptr[i + 1]), stage, s);
  if ((threadIdx.x & 31) == 0) particle_one(p, b, src, sc, i, i, s, flags, om);
}

// Body `body`'s views of a sum and a correction source.
__device__ __forceinline__ SumSource body_sum(SumSource src, size_t body) {
  src.contrib = body_ptr(src.contrib, body * src.stride);
  return src;
}

__device__ __forceinline__ CorrSource body_corr(CorrSource sc, size_t body) {
  sc.corr = body_ptr(sc.corr, body * sc.stride);
  return sc;
}

// ---- the per-pass loop: one launch a pass (the yardstick) ----------------

// The lambda lifecycle of the four families and predict.  Grid: max(N, E,
// H, T) threads.
__global__ void predict_kernel(MeshParams p, MeshBuffers bb, int use_ext,
                               int save) {
  const MeshBuffers b = body_buffers(p, bb);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n_edges) lifecycle_edge(p, b, i);
  if (i < p.n_hinges) b.blam[i] = lifecycle_other(p, b.blam[i]);
  if (i < p.n_tets) b.tlam[i] = lifecycle_other(p, b.tlam[i]);
  if (i == 0 && p.n_tris > 0) *b.vlam = lifecycle_other(p, *b.vlam);
  if (i >= p.n) return;
  float xc[3], vc[3];
  load3(b.x, p.n, i, xc);
  load3(b.v, p.n, i, vc);
  predict_one(p, b, i, xc, vc, use_ext, save);
}

__global__ void edge_kernel(MeshParams p, MeshBuffers bb, int warm) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < p.n_edges) edge_one(p, body_buffers(p, bb), e, warm);
}

__global__ void hinge_kernel(MeshParams p, MeshBuffers bb) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h < p.n_hinges) hinge_one(p, body_buffers(p, bb), h);
}

__global__ void tet_kernel(MeshParams p, MeshBuffers bb) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.n_tets) tet_one(p, body_buffers(p, bb), t);
}

__global__ void edge_color_kernel(MeshParams p, MeshBuffers bb, int color,
                                  int clamp_in) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < p.col_width)
    edge_color_one(p, body_buffers(p, bb), color, clamp_in, s);
}

__global__ void hinge_color_kernel(MeshParams p, MeshBuffers bb, int color) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < p.bcol_width) hinge_color_one(p, body_buffers(p, bb), color, s);
}

__global__ void tet_color_kernel(MeshParams p, MeshBuffers bb, int color) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < p.tcol_width) tet_color_one(p, body_buffers(p, bb), color, s);
}

__global__ void tri_kernel(MeshParams p, MeshBuffers bb) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.n_tris) tri_one(p, body_buffers(p, bb), t);
}

// One thread a particle, then one warp a hub row (particle_threads).
// Launched with MX_HUB_BYTES of dynamic shared memory when there are hubs.
__global__ void vol_grad_kernel(MeshParams p, MeshBuffers bb) {
  extern __shared__ float stage[];
  const MeshBuffers b = body_buffers(p, bb);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.n) vol_grad_one(p, b, t);
  const int first = (p.n + 31) / 32 * 32;
  if (t >= first && (t - first) / 32 < p.n_vinc_hubs)
    vol_grad_hub(p, b, (t - first) / 32,
                 stage + (threadIdx.x / 32) * MX_HUB_STAGE);
}

// One block of MX_THREADS a body.
__global__ void vol_reduce_kernel(MeshParams p, MeshBuffers bb) {
  __shared__ float s_v[MX_THREADS], s_w[MX_THREADS];
  vol_reduce_body(p, body_buffers(p, bb), s_v, s_w);
}

// One warp a row, MX_WARPS rows a block (dense_rows).
__global__ void dense_pair_kernel(MeshParams p, MeshBuffers bb) {
  __shared__ float s_sum[3 * MX_THREADS];
  __shared__ float tile[MX_DENSE_FLOATS];
  const int r0 = blockIdx.x * MX_WARPS;
  dense_rows(p, body_buffers(p, bb), s_sum, tile, r0,
             min(r0 + MX_WARPS, p.n));
}

// One thread a particle (slot), then one warp a hub row of src
// (particle_threads), with MX_HUB_BYTES of dynamic shared memory.
__global__ void particle_kernel(MeshParams p, MeshBuffers bb, SumSource src,
                                CorrSource sc, int flags, float om) {
  extern __shared__ float stage[];
  const MeshBuffers b = body_buffers(p, bb);
  src = body_sum(src, blockIdx.y);
  sc = body_corr(sc, blockIdx.y);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.n) particle_thread(p, b, src, sc, t, flags, om);
  const int first = (p.n + 31) / 32 * 32;
  if (src.contrib && t >= first && (t - first) / 32 < src.n_hubs)
    particle_hub(p, b, src, sc, (t - first) / 32, flags, om,
                 stage + (threadIdx.x / 32) * MX_HUB_STAGE);
}

// ---- the persistent kernel: one launch a contact-free stretch ------------

// A launch's segment of a call and its plan (mesh_xpbd_run).  Substeps
// [i0, i1): substep i0 from stage s0, substep i1 - 1 up to (not including)
// stage s1.  Block j owns items [j * chunk[k], (j + 1) * chunk[k]) of each
// tile kind k (MX_TILE_*), counted over every body, body after body.  No
// pointer is __restrict__: the kernel writes, between barriers, what it
// reads later.
struct MeshRun {
  int i0, i1, s0, s1;
  int ext_first;
  int chunk[MX_TILES];
  unsigned long long* counter;  // the grid barrier's, zeroed once a call
  const float* om;              // the Chebyshev weight of each iteration
  CorrSource blocked;           // the B-4 pass's correction (sc_mode 2)
};

// The stages of a substep, where a launch may start or stop: the blocked
// contact pass (B-4) runs between two launches, its curve order before
// stage MX_STAGE_ITER and its corrections before each apply stage.
#define MX_STAGE_PREDICT 0
#define MX_STAGE_ITER(it) (1 + 3 * (it))
#define MX_STAGE_SPLIT(it) (2 + 3 * (it))
#define MX_STAGE_APPLY(it) (3 + 3 * (it))
#define MX_STAGE_END 0x7fffffff

// This block's items of tile kind `kind` (count a body), each as (body,
// index in the body): f(body, k).
template <typename F>
__device__ __forceinline__ void for_items(const MeshParams& p,
                                          const MeshRun& r, int kind,
                                          int count, F f) {
  const int total = count * p.n_bodies;
  const int lo = min(blockIdx.x * r.chunk[kind], total);
  const int hi = min(lo + r.chunk[kind], total);
  for (int g = lo + threadIdx.x; g < hi; g += MX_THREADS) {
    const int body = p.n_bodies == 1 ? 0 : g / count;
    f(body, g - body * count);
  }
}

// The bodies whose one-block work (the volume's reduction, the
// multiplier's lifecycle) this block does: a block of whole bodies its
// own; across the grid, body k by block k mod gridDim.x.  f(body), called
// by every thread of the block.
template <int KIND, typename F>
__device__ __forceinline__ void for_owned_bodies(const MeshParams& p,
                                                 const MeshRun& r, F f) {
  if constexpr (KIND == BARRIER_BLOCK) {
    const int per = r.chunk[MX_TILE_PART] / p.n;
    for (int body = blockIdx.x * per;
         body < min((int)(blockIdx.x + 1) * per, p.n_bodies); ++body)
      f(body);
  } else {
    for (int body = blockIdx.x; body < p.n_bodies; body += gridDim.x)
      f(body);
  }
}

// This block's warps' hub rows (n_hubs a body) as (body, hub): a block of
// whole bodies takes its own bodies' hubs; across the grid, hub rows go to
// the warps of the last blocks first, whose particle tiles are empty or
// short.  f(body, hub), called by all 32 lanes of a warp.
template <int KIND, typename F>
__device__ __forceinline__ void for_hubs(const MeshParams& p,
                                         const MeshRun& r, int n_hubs, F f) {
  if (n_hubs <= 0) return;
  const int warp = threadIdx.x / 32;
  int lo, hi, h0, step;
  if constexpr (KIND == BARRIER_BLOCK) {
    const int per = r.chunk[MX_TILE_PART] / p.n;
    lo = blockIdx.x * per * n_hubs;
    hi = min((int)(blockIdx.x + 1) * per, p.n_bodies) * n_hubs;
    h0 = lo + warp;
    step = MX_WARPS;
  } else {
    lo = 0;
    hi = p.n_bodies * n_hubs;
    h0 = (gridDim.x - 1 - blockIdx.x) * MX_WARPS + warp;
    step = gridDim.x * MX_WARPS;
  }
  for (int h = h0; h < hi; h += step) {
    const int body = h / n_hubs;
    f(body, h - body * n_hubs);
  }
}

// The sources a particle pass sums or applies (mesh_xpbd_run_per_pass
// builds them on the host, run_phase on the device).
enum { SRC_NONE, SRC_EDGE, SRC_BEND, SRC_TET };
enum { CORR_NONE, CORR_DENSE, CORR_BLOCKED };

__host__ __device__ __forceinline__ SumSource sum_source(const MeshParams& p,
                                                         const MeshBuffers& b,
                                                         int which) {
  // each body's contributions follow the previous body's (body_buffers)
  if (which == SRC_EDGE)
    return {b.contrib, b.inc_cols, b.inc_ptr, nullptr,
            (size_t)6 * p.n_edges, b.inc_hubs, p.n_inc_hubs};
  if (which == SRC_BEND)
    return {b.bcontrib, b.binc_cols, b.binc_ptr, nullptr,
            (size_t)3 * (p.n_hinges > 0 ? 4 * p.n_hinges : 1), b.binc_hubs,
            p.n_binc_hubs};
  if (which == SRC_TET)
    return {b.tcontrib, b.tinc_cols, b.tinc_ptr, b.tdeg,
            (size_t)12 * p.n_tets, b.tinc_hubs, p.n_tinc_hubs};
  return {nullptr, nullptr, nullptr, nullptr, 0, nullptr, 0};
}

// The persistent kernel's phases: each one pass over the block's tiles
// (run_phase), a barrier between two (mesh_persistent_kernel).
enum {
  PH_PREDICT,   // a0: the ext force, a1: save (cur = prev = pred)
  PH_EDGE,      // a0: warm
  PH_HINGE,
  PH_TET,
  PH_ECOL,      // a0: colour, a1: clamp_in
  PH_HCOL,      // a0: colour
  PH_TCOL,      // a0: colour
  PH_TRI,
  PH_VGRAD,
  PH_VREDUCE,
  PH_DENSE,
  PH_PARTICLE,  // a0: SRC_*, a1: CORR_*, flags, om
};

// A launch's parameters in each block's shared memory, where run_phase
// (one copy of every pass's code) reads them.
__shared__ MeshParams s_params;
__shared__ MeshBuffers s_buffers;
__shared__ MeshRun s_run;
__shared__ float s_buf[MX_WARPS * MX_HUB_STAGE];
__shared__ float s_tile[MX_DENSE_FLOATS];

// The next substep's multipliers, after this substep's last reads of them.
template <int KIND>
__device__ __forceinline__ void lifecycles(const MeshParams& p,
                                           const MeshBuffers& bb,
                                           const MeshRun& r) {
  for_items(p, r, MX_TILE_EDGE, p.n_edges, [&](int body, int e) {
    lifecycle_edge(p, body_buffers_of(p, bb, body), e);
  });
  for_items(p, r, MX_TILE_HINGE, p.n_hinges, [&](int body, int h) {
    float* lam = body_buffers_of(p, bb, body).blam;
    lam[h] = lifecycle_other(p, lam[h]);
  });
  for_items(p, r, MX_TILE_TET, p.n_tets, [&](int body, int t) {
    float* lam = body_buffers_of(p, bb, body).tlam;
    lam[t] = lifecycle_other(p, lam[t]);
  });
  if (p.n_tris > 0 && threadIdx.x == 0)
    for_owned_bodies<KIND>(p, r, [&](int body) {
      float* lam = body_buffers_of(p, bb, body).vlam;
      *lam = lifecycle_other(p, *lam);
    });
}

// One phase of the persistent kernel, called by every thread of the block.
template <int KIND>
__device__ __noinline__ void run_phase(int kind, int a0, int a1, int flags,
                                       float om) {
  const MeshParams& p = s_params;
  const MeshBuffers& bb = s_buffers;
  const MeshRun& r = s_run;
  float* stage = s_buf + (threadIdx.x / 32) * MX_HUB_STAGE;
  auto view = [&](int body) { return body_buffers_of(p, bb, body); };
  switch (kind) {
    case PH_PREDICT:
      for_items(p, r, MX_TILE_PART, p.n, [&](int body, int i) {
        const MeshBuffers b = view(body);
        float xc[3], vc[3];
        load3(b.x, p.n, i, xc);
        load3(b.v, p.n, i, vc);
        predict_one(p, b, i, xc, vc, a0, a1);
      });
      lifecycles<KIND>(p, bb, r);
      break;
    case PH_EDGE:
      for_items(p, r, MX_TILE_EDGE, p.n_edges,
                [&](int body, int e) { edge_one(p, view(body), e, a0); });
      break;
    case PH_HINGE:
      for_items(p, r, MX_TILE_HINGE, p.n_hinges,
                [&](int body, int h) { hinge_one(p, view(body), h); });
      break;
    case PH_TET:
      for_items(p, r, MX_TILE_TET, p.n_tets,
                [&](int body, int t) { tet_one(p, view(body), t); });
      break;
    case PH_ECOL:
      for_items(p, r, MX_TILE_ECOL, p.col_width, [&](int body, int s) {
        edge_color_one(p, view(body), a0, a1, s);
      });
      break;
    case PH_HCOL:
      for_items(p, r, MX_TILE_HCOL, p.bcol_width, [&](int body, int s) {
        hinge_color_one(p, view(body), a0, s);
      });
      break;
    case PH_TCOL:
      for_items(p, r, MX_TILE_TCOL, p.tcol_width, [&](int body, int s) {
        tet_color_one(p, view(body), a0, s);
      });
      break;
    case PH_TRI:
      for_items(p, r, MX_TILE_TRI, p.n_tris,
                [&](int body, int t) { tri_one(p, view(body), t); });
      break;
    case PH_VGRAD:
      for_hubs<KIND>(p, r, p.n_vinc_hubs, [&](int body, int h) {
        vol_grad_hub(p, view(body), h, stage);
      });
      for_items(p, r, MX_TILE_PART, p.n,
                [&](int body, int i) { vol_grad_one(p, view(body), i); });
      break;
    case PH_VREDUCE:
      for_owned_bodies<KIND>(p, r, [&](int body) {
        vol_reduce_body(p, view(body), s_buf, s_buf + MX_THREADS);
      });
      break;
    case PH_DENSE: {
      // the block's rows, body by body (every block takes a body's mean
      // with the one-block tree)
      const int total = p.n * p.n_bodies;
      const int lo = min((int)blockIdx.x * r.chunk[MX_TILE_ROW], total);
      const int hi = min(lo + r.chunk[MX_TILE_ROW], total);
      for (int body = lo / p.n; body * p.n < hi; ++body)
        dense_rows(p, view(body), s_buf, s_tile, max(lo - body * p.n, 0),
                   min(hi - body * p.n, p.n));
      break;
    }
    case PH_PARTICLE: {
      const SumSource src = sum_source(p, bb, a0);
      const CorrSource sc =
          a1 == CORR_DENSE ? CorrSource{bb.sc_corr, nullptr, p.n,
                                        (size_t)3 * p.n}
          : a1 == CORR_BLOCKED ? r.blocked
                               : CorrSource{nullptr, nullptr, 0, 0};
      if (src.contrib)
        for_hubs<KIND>(p, r, src.n_hubs, [&](int body, int h) {
          particle_hub(p, view(body), body_sum(src, body),
                       body_corr(sc, body), h, flags, om, stage);
        });
      for_items(p, r, MX_TILE_PART, p.n, [&](int body, int t) {
        particle_thread(p, view(body), body_sum(src, body),
                        body_corr(sc, body), t, flags, om);
      });
      if (flags & PF_PREDICT) lifecycles<KIND>(p, bb, r);
      break;
    }
  }
}

// Substeps [r.i0, r.i1) of the call (MeshRun), every pass a phase of
// run_phase in the per-pass loop's order, a barrier between two phases.
// Two blocks an SM, so 128 registers a thread: run_phase holds every pass
// without spilling.  Capped lower (three or four blocks an SM) it spills,
// and every main path ran slower; so did 512-thread blocks, two edges a
// turn, and polling the barrier with relaxed loads and one fence.
template <int KIND>
__global__ void __launch_bounds__(MX_THREADS, 2)
    mesh_persistent_kernel(MeshParams p, MeshBuffers bb, MeshRun r) {
  // the counting barrier's word is zeroed once a call and only grows, by
  // gridDim.x a barrier: a launch starts from the multiple of gridDim.x
  // below the value its block reads first (before its first barrier, so
  // fewer than gridDim.x arrivals of this launch can be in it)
  __shared__ unsigned long long s_base;
  if (threadIdx.x == 0) {
    s_params = p;
    s_buffers = bb;
    s_run = r;
    if constexpr (KIND == BARRIER_GRID_CTR)
      s_base = ld_acquire(r.counter) / gridDim.x * gridDim.x;
    else
      s_base = 0;
  }
  __syncthreads();
  Barrier<KIND> bar{r.counter, s_base};
  bool pending = false;  // a phase ran since the last barrier
  auto run = [&](int kind, int a0 = 0, int a1 = 0, int flags = 0,
                 float om = 0.f) {
    if (pending) bar.sync();
    pending = true;
    run_phase<KIND>(kind, a0, a1, flags, om);
  };

  const bool warm = p.lambda_mode == 2;
  const bool bending = p.bending && p.n_hinges > 0;
  const bool tets = p.tets_on && p.n_tets > 0;
  const bool volume = p.n_tris > 0;
  const int contacts =
      (p.floor_mode == 1 || p.n_spheres > 0 || p.n_boxes > 0) ? PF_CONTACTS
                                                               : 0;
  const int save = p.accelerate ? PF_SAVE : 0;
  const bool split = !p.colored && p.accelerate;  // two contact passes
  // the global volume constraint; its apply carries the iteration's tail
  auto volume_pass = [&](int flags, float om) {
    run(PH_TRI);
    run(PH_VGRAD);
    run(PH_VREDUCE);
    run(PH_PARTICLE, SRC_NONE, CORR_NONE, PF_VOLUME | flags, om);
  };

  bool predicted = false;
  for (int i = r.i0; i < r.i1; ++i) {
    const int s_lo = i == r.i0 ? r.s0 : 0;
    const int s_hi = i == r.i1 - 1 ? r.s1 : MX_STAGE_END;
#define ON(s) ((s) >= s_lo && (s) < s_hi)
    const bool contact = p.sc_mode != 0 && i % p.sc_every == 0;
    // the next substep runs in this launch: its predict in finalize
    const int next = i + 1 < r.i1 ? PF_PREDICT : 0;
    if (ON(MX_STAGE_PREDICT)) {
      if (!predicted)
        run(PH_PREDICT, r.ext_first && i == 0, save && !warm);
      if (warm) {
        run(PH_EDGE, 1);
        run(PH_PARTICLE, SRC_EDGE, CORR_NONE, save);
      }
    }
    for (int it = 0; it < p.iterations; ++it) {
      const int fin = it == p.iterations - 1 ? PF_FINALIZE | next : 0;
      const float om = r.om[it];
      if (ON(MX_STAGE_ITER(it))) {
        // without self-collision, the iteration's last particle pass also
        // does the contacts, the Chebyshev step and finalize
        const int tail = p.colored
            ? contacts | fin
            : contacts | fin | (p.accelerate ? PF_CHEBY : 0);
        const int last = contact ? 0 : tail;
        if (p.colored) {
          for (int c = 0; c < p.n_colors; ++c)
            run(PH_ECOL, c, it > 0 || c > 0);
          if (bending)
            for (int c = 0; c < p.n_bend_colors; ++c) run(PH_HCOL, c);
          if (tets)
            for (int c = 0; c < p.n_tet_colors; ++c) run(PH_TCOL, c);
          if (volume)
            volume_pass(last, 0.f);
          else if (last)
            run(PH_PARTICLE, SRC_NONE, CORR_NONE, last);
        } else {
          run(PH_EDGE, 0);
          run(PH_PARTICLE, SRC_EDGE, CORR_NONE,
              bending || tets || volume ? 0 : last, om);
          if (bending) {
            run(PH_HINGE);
            run(PH_PARTICLE, SRC_BEND, CORR_NONE, tets || volume ? 0 : last,
                om);
          }
          if (tets) {
            run(PH_TET);
            run(PH_PARTICLE, SRC_TET, CORR_NONE, volume ? 0 : last, om);
          }
          if (volume) volume_pass(last, om);
        }
        if (contact && p.sc_mode == 1) {
          // self-collision first among the contacts (general.py:568-585)
          run(PH_DENSE);
          if (split) {
            // the momentum step may re-penetrate: contacts once more
            // after it, self-collision included (general.py:654-655)
            run(PH_PARTICLE, SRC_NONE, CORR_DENSE,
                PF_CONTACTS | PF_CHEBY_SPLIT, om);
            run(PH_DENSE);
            run(PH_PARTICLE, SRC_NONE, CORR_DENSE,
                PF_CONTACTS | PF_SETCUR | fin);
          } else {
            run(PH_PARTICLE, SRC_NONE, CORR_DENSE, PF_CONTACTS | fin);
          }
        }
      }
      if (contact && p.sc_mode == 2) {
        // B-4 ran between the launches: its correction, permuted
        if (split && ON(MX_STAGE_SPLIT(it)))
          run(PH_PARTICLE, SRC_NONE, CORR_BLOCKED,
              PF_CONTACTS | PF_CHEBY_SPLIT, om);
        if (ON(MX_STAGE_APPLY(it)))
          run(PH_PARTICLE, SRC_NONE, CORR_BLOCKED,
              PF_CONTACTS | (split ? PF_SETCUR : 0) | fin);
      }
    }
#undef ON
    predicted = next && p.iterations > 0;
  }
}

static const void* persistent_fn(int kind) {
  if (kind == BARRIER_BLOCK)
    return (const void*)mesh_persistent_kernel<BARRIER_BLOCK>;
  if (kind == BARRIER_GRID_CTR)
    return (const void*)mesh_persistent_kernel<BARRIER_GRID_CTR>;
  return nullptr;
}

static bool bad_params(const MeshParams& p, const MeshBuffers& b,
                       const ContactParams* cp, const ContactBuffers* cb) {
  return p.n_spheres > MX_MAX_SPHERES || p.n_boxes > MX_MAX_BOXES ||
         !b.colliders || p.n <= 0 || p.n_edges <= 0 || p.sc_every < 1 ||
         p.n_bodies < 1 || p.n_bodies > 65535 ||
         (p.sc_mode == 2 && (!(cp && cb) || p.n_bodies != 1));
}

extern "C" {

int mesh_xpbd_params_size(void) { return (int)sizeof(MeshParams); }

int mesh_xpbd_buffers_size(void) { return (int)sizeof(MeshBuffers); }

const char* mesh_xpbd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The persistent kernel of barrier `kind` on `device`: its threads a block
// (MX_THREADS), the blocks of it one SM holds at once, the SMs, and
// whether the device launches cooperatively.  Returns a cudaError_t.
int mesh_xpbd_occupancy(int device, int kind, int* threads,
                        int* blocks_per_sm, int* n_sms, int* coop) {
  const void* fn = persistent_fn(kind);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        MX_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, device);
  *threads = MX_THREADS;
  return (int)err;
}

// Advance n_substeps substeps on `stream` with the persistent kernel:
// one launch a stretch of passes between two B-4 passes, so one launch a
// call without blocked contact.  Buffers as MeshBuffers says; the ext force
// is read on the first substep when ext_first.  om: the Chebyshev weight of
// each iteration, on the device.  kind: BARRIER_BLOCK (`grid` blocks, each
// holding whole bodies) or BARRIER_GRID_CTR (a cooperative launch of `grid`
// blocks, planned by kernels/mesh_cuda.py to fit the device at once;
// counter: one 64-bit word of scratch, zeroed here once a call);
// chunk: the items of each tile kind a block owns (MeshRun).  With the
// blocked self-collision backend (sc_mode 2), cp / cb describe the B-4
// pass over pred; otherwise they may be null.  *n_launched counts the
// kernels this library launched, *n_contact those of the B-4 passes.
// Returns a cudaError_t: the cooperative launch itself refuses a grid that
// cannot be co-resident; nothing is synchronised.
int mesh_xpbd_run(const MeshParams* hp, const MeshBuffers* hb,
                  const ContactParams* cp, const ContactBuffers* cb,
                  int device, int n_substeps, int ext_first, const float* om,
                  int kind, int grid, const int* chunk,
                  unsigned long long* counter, long long* n_launched,
                  long long* n_contact, void* stream_handle) {
  const MeshParams p = *hp;
  const MeshBuffers b = *hb;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  *n_contact = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = persistent_fn(kind);
  if (!fn || bad_params(p, b, cp, cb) || grid <= 0 || !om ||
      (kind == BARRIER_GRID_CTR && !counter))
    return (int)cudaErrorInvalidValue;
  MeshRun r{};
  r.ext_first = ext_first;
  for (int k = 0; k < MX_TILES; ++k) {
    if (chunk[k] < 0) return (int)cudaErrorInvalidValue;
    r.chunk[k] = chunk[k];
  }
  if (kind == BARRIER_BLOCK && (r.chunk[MX_TILE_PART] <= 0 ||
                                r.chunk[MX_TILE_PART] % p.n != 0))
    return (int)cudaErrorInvalidValue;
  r.counter = counter;
  r.om = om;
  if (p.sc_mode == 2) r.blocked = {cb->corr, cb->order, cp->nb * cp->block, 0};

  // one launch of substeps [i0, i1) from stage s0 of i0 to stage s1 of
  // i1 - 1
  auto launch = [&](int i0, int s0, int i1, int s1) -> int {
    r.i0 = i0;
    r.s0 = s0;
    r.i1 = i1;
    r.s1 = s1;
    cudaError_t e;
    if (kind == BARRIER_BLOCK) {
      mesh_persistent_kernel<BARRIER_BLOCK><<<grid, MX_THREADS, 0,
                                              stream>>>(p, b, r);
      e = cudaGetLastError();
    } else {
      void* args[] = {(void*)&p, (void*)&b, (void*)&r};
      e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(MX_THREADS),
                                      args, 0, stream);
    }
    if (e == cudaSuccess) ++launched;
    return (int)e;
  };
  const bool split = !p.colored && p.accelerate;
  int ci = 0, cs = 0;  // where the next launch starts
  int rc = 0;
  if (kind == BARRIER_GRID_CTR && n_substeps > 0)
    rc = (int)cudaMemsetAsync(counter, 0, sizeof(unsigned long long),
                              stream);
  for (int i = 0; i < n_substeps && !rc; ++i) {
    if (p.sc_mode != 2 || i % p.sc_every != 0) continue;
    // a blocked contact substep: a launch up to each B-4 pass, the next
    // from the stage after it
    rc = launch(ci, cs, i + 1, MX_STAGE_ITER(0));
    if (!rc) rc = contact_xpbd_order(cp, cb, n_contact, stream);
    ci = i;
    cs = MX_STAGE_ITER(0);
    for (int it = 0; it < p.iterations && !rc; ++it) {
      const int stops[2] = {MX_STAGE_SPLIT(it), MX_STAGE_APPLY(it)};
      for (int k = split ? 0 : 1; k < 2 && !rc; ++k) {
        rc = launch(ci, cs, i + 1, stops[k]);
        if (!rc) rc = contact_xpbd_corr(cp, cb, n_contact, stream);
        cs = stops[k];
      }
    }
  }
  if (!rc && n_substeps > 0) rc = launch(ci, cs, n_substeps, MX_STAGE_END);
  *n_launched = launched;
  return rc;
}

// The yardstick: the same substeps as mesh_xpbd_run, one launch a pass
// (MX_THREADS threads a block, one row of blocks a body), the design the
// persistent kernel replaced.  No route reaches it; chip_smoke.py and the
// card tests time and check the persistent kernel against it.  om: host
// memory, `iterations` floats.  Otherwise as mesh_xpbd_run.
int mesh_xpbd_run_per_pass(const MeshParams* hp, const MeshBuffers* hb,
                           const ContactParams* cp, const ContactBuffers* cb,
                           int device, int n_substeps, int ext_first,
                           const float* om, long long* n_launched,
                           long long* n_contact, void* stream_handle) {
  const MeshParams p = *hp;
  const MeshBuffers b = *hb;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  *n_contact = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_params(p, b, cp, cb)) return (int)cudaErrorInvalidValue;

#define MX_CHECK()            \
  do {                        \
    err = cudaGetLastError(); \
    if (err != cudaSuccess) { \
      *n_launched = launched; \
      return (int)err;        \
    }                         \
    ++launched;               \
  } while (0)

  const dim3 block(MX_THREADS);
  const int nb = p.n_bodies;
  int g_all = p.n > p.n_edges ? p.n : p.n_edges;
  if (p.n_hinges > g_all) g_all = p.n_hinges;
  if (p.n_tets > g_all) g_all = p.n_tets;
  const bool warm = p.lambda_mode == 2;
  const bool bending = p.bending && p.n_hinges > 0;
  const bool tets = p.tets_on && p.n_tets > 0;
  const bool volume = p.n_tris > 0;
  const int contacts =
      (p.floor_mode == 1 || p.n_spheres > 0 || p.n_boxes > 0) ? PF_CONTACTS
                                                               : 0;
  const int save = p.accelerate ? PF_SAVE : 0;
  const CorrSource no_corr = {nullptr, nullptr, 0, 0};
  const SumSource no_sum = sum_source(p, b, SRC_NONE);
  const SumSource edge_sum = sum_source(p, b, SRC_EDGE);
  const SumSource bend_sum = sum_source(p, b, SRC_BEND);
  const SumSource tet_sum = sum_source(p, b, SRC_TET);
  // hub warps take their stage in dynamic shared memory
  auto particles = [&](SumSource src, CorrSource sc, int flags, float w) {
    const int hubs = src.contrib ? src.n_hubs : 0;
    particle_kernel<<<grid_for(particle_threads(p.n, hubs), nb), block,
                      hubs ? MX_HUB_BYTES : 0, stream>>>(p, b, src, sc,
                                                         flags, w);
  };
  // one self-collision pass over pred: its correction, and where it lies
  auto self_collision = [&](CorrSource* out) -> int {
    if (p.sc_mode == 1) {
      // body-local: one row a warp, each block taking its body's mean
      dense_pair_kernel<<<dim3((p.n + MX_WARPS - 1) / MX_WARPS, nb),
                          MX_THREADS, 0, stream>>>(p, b);
      MX_CHECK();
      *out = {b.sc_corr, nullptr, p.n, (size_t)3 * p.n};
      return 0;
    }
    const int rc = contact_xpbd_corr(cp, cb, n_contact, stream);
    *out = {cb->corr, cb->order, cp->nb * cp->block, 0};
    return rc;
  };
  // the global volume constraint; its apply carries the iteration's tail
  auto volume_pass = [&](int flags, float w) -> int {
    tri_kernel<<<grid_for(p.n_tris, nb), block, 0, stream>>>(p, b);
    MX_CHECK();
    vol_grad_kernel<<<grid_for(particle_threads(p.n, p.n_vinc_hubs), nb),
                      block, p.n_vinc_hubs ? MX_HUB_BYTES : 0, stream>>>(p,
                                                                        b);
    MX_CHECK();
    vol_reduce_kernel<<<dim3(1, nb), MX_THREADS, 0, stream>>>(p, b);
    MX_CHECK();
    particles(no_sum, no_corr, PF_VOLUME | flags, w);
    MX_CHECK();
    return 0;
  };

  for (int i = 0; i < n_substeps; ++i) {
    const bool contact = p.sc_mode != 0 && i % p.sc_every == 0;
    predict_kernel<<<grid_for(g_all, nb), block, 0, stream>>>(
        p, b, ext_first && i == 0, save && !warm);
    MX_CHECK();
    if (warm) {
      edge_kernel<<<grid_for(p.n_edges, nb), block, 0, stream>>>(p, b, 1);
      MX_CHECK();
      particles(edge_sum, no_corr, save, 0.f);
      MX_CHECK();
    }
    if (contact && p.sc_mode == 2) {
      // the curve order, once per contact substep, after the warm start
      if (int rc = contact_xpbd_order(cp, cb, n_contact, stream)) {
        *n_launched = launched;
        return rc;
      }
    }
    for (int it = 0; it < p.iterations; ++it) {
      const int fin = it == p.iterations - 1 ? PF_FINALIZE : 0;
      // without self-collision, the iteration's last particle pass also
      // does the contacts, the Chebyshev step and finalize
      const int tail = p.colored
          ? contacts | fin
          : contacts | fin | (p.accelerate ? PF_CHEBY : 0);
      const int last = contact ? 0 : tail;
      if (p.colored) {
        for (int c = 0; c < p.n_colors; ++c) {
          edge_color_kernel<<<grid_for(p.col_width, nb), block, 0, stream>>>(
              p, b, c, it > 0 || c > 0);
          MX_CHECK();
        }
        if (bending) {
          for (int c = 0; c < p.n_bend_colors; ++c) {
            hinge_color_kernel<<<grid_for(p.bcol_width, nb), block, 0,
                                 stream>>>(p, b, c);
            MX_CHECK();
          }
        }
        if (tets) {
          for (int c = 0; c < p.n_tet_colors; ++c) {
            tet_color_kernel<<<grid_for(p.tcol_width, nb), block, 0, stream>>>(
                p, b, c);
            MX_CHECK();
          }
        }
        if (volume) {
          if (int rc = volume_pass(last, 0.f)) return rc;
        } else if (last) {
          particles(no_sum, no_corr, last, 0.f);
          MX_CHECK();
        }
      } else {
        edge_kernel<<<grid_for(p.n_edges, nb), block, 0, stream>>>(p, b, 0);
        MX_CHECK();
        particles(edge_sum, no_corr, bending || tets || volume ? 0 : last,
                  om[it]);
        MX_CHECK();
        if (bending) {
          hinge_kernel<<<grid_for(p.n_hinges, nb), block, 0, stream>>>(p, b);
          MX_CHECK();
          particles(bend_sum, no_corr, tets || volume ? 0 : last, om[it]);
          MX_CHECK();
        }
        if (tets) {
          tet_kernel<<<grid_for(p.n_tets, nb), block, 0, stream>>>(p, b);
          MX_CHECK();
          particles(tet_sum, no_corr, volume ? 0 : last, om[it]);
          MX_CHECK();
        }
        if (volume) {
          if (int rc = volume_pass(last, om[it])) return rc;
        }
      }
      if (!contact) continue;
      // self-collision first among the contacts (general.py:568-585)
      CorrSource corr;
      if (int rc = self_collision(&corr)) {
        *n_launched = launched;
        return rc;
      }
      if (!p.colored && p.accelerate) {
        // the momentum step may re-penetrate: contacts once more after it,
        // self-collision included (general.py:654-655)
        particles(no_sum, corr, PF_CONTACTS | PF_CHEBY_SPLIT, om[it]);
        MX_CHECK();
        if (int rc = self_collision(&corr)) {
          *n_launched = launched;
          return rc;
        }
        particles(no_sum, corr, PF_CONTACTS | PF_SETCUR | fin, 0.f);
        MX_CHECK();
      } else {
        particles(no_sum, corr, PF_CONTACTS | fin, 0.f);
        MX_CHECK();
      }
    }
  }
#undef MX_CHECK
  *n_launched = launched;
  return (int)cudaSuccess;
}

}  // extern "C"
