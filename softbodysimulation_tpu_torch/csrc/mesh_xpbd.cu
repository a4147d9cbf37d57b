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
// needed.  The global volume constraint is refused by the wrapper
// (kernels/mesh_cuda.py); traced materials are per-call rest and
// alpha buffers; the spheres and boxes (the config's, or a ColliderSet's
// traced poses, velocities and ground: mesh_pallas.py:881-898,
// :1566-1590) come from the collider table of colliders.cuh, read by every
// launch, so a new pose rebuilds nothing.  The structs and the
// arithmetic the fused backward (mesh_diff_xpbd.cu, built into the same
// library) shares live in mesh_xpbd.cuh.
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
// rest and alpha with (B, E) materials).  Every launch carries one row of
// blocks per body (blockIdx.y), and each kernel first takes its body's
// view (body_buffers), so a substep costs the launches of one body and each
// body's arithmetic, sums in CSR column order and dense-contact mean
// included, is the single-body kernel's to the bit.  The per-edge,
// per-hinge and per-tet tables are shared.  Dense self-collision is
// body-local: one mean and one Gram sweep per body, so no pair crosses
// bodies.  The blocked pass (B-4) takes one body only.  The TPU kernel's
// 8-sublane padding of the body axis has no counterpart.
//
// One launch per pass on the caller's stream, no host sync in the loop:
//   predict (+ the lambda lifecycle of all three families);
//   WARM_START: an edge pass and a particle pass;
//   on a contact substep with the blocked backend, the curve order (stats,
//     Hilbert codes, a radix sort), once, after the warm start;
//   per iteration, JACOBI: for each family, a constraint pass writing each
//     endpoint's contribution into a (2E | 4H | 4T, 3) buffer and a
//     particle pass adding the particle's incidence row of it (the
//     gather-and-sum of general.py:109-113, in column order, no atomics;
//     tets divide it by max(tet degree, 1));
//   per iteration, COLORED: one launch per colour of each family (a thread
//     updates its constraint's lambda and endpoints in place; a colour
//     shares no particle, so this is exact);
//   then the contacts: without self-collision the last particle pass also
//     projects floor and spheres, takes the Chebyshev step and, after the
//     last iteration, finalizes; on a contact substep (i % every == 0) the
//     self-collision pass comes first -- dense: a mean pass and an
//     all-pairs pass writing a correction plane; blocked: the B-4 pass --
//     and a particle pass applies omega * correction, then floor and
//     spheres; accelerated, the Chebyshev step is followed by a second
//     self-collision pass and apply (general.py:654-655).
//
// What bounds it on the card: at cloth_xl (16,641 particles, 49,408 edges,
// 48,896 hinges) the state, the contribution buffers and the tables are a
// few MB and live in the 50 MB L2, and a pass is a few hundred flops per
// constraint, so with about 11-14 launches of small grids per substep the
// launch overhead, not HBM or the ALUs, should set the pace.  In the
// 20,243-particle ball-on-cloth (6 substeps x 4 iterations, bending, tets,
// blocked contact every 3rd substep) a contact-free substep takes 25
// launches and a contact substep about 80 (8 self-collision passes of 5
// launches, 8 applies, the order); the pair passes (up to 8.3e7 pair tests
// each, contact_xpbd.cu) and the particle passes are the heavy ones, the
// latter because the ball's hub (the centroid of the tet fan: 642 spoke
// edges, 1,280 tets) sums its long row in one thread; the rows are CSR, so
// no other particle walks the hub's width.  The dense pass gives each row
// one thread that walks every particle, a chain of N dependent sums, so at
// a few hundred particles its time is that chain's latency.  The design
// does nothing more yet, by choice: fusing passes, CUDA graphs, splitting
// the hub's and the dense rows' sums across threads come later.
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

#include "mesh_xpbd.cuh"

// ops/bending.py::bending_delta_lambda for one hinge (a, b, c, d): returns
// dlambda and writes the four gradients (zero when the hinge is invalid).
__device__ float bending_dl(const MeshParams& p, float pp[4][3],
                            const float w[4], float rest, float alpha0,
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

// The lambda lifecycle of the three families, and predict (gravity, the
// first substep's ext force, damping, clamps).  Grid: max(N, E, H, T)
// threads.
__global__ void predict_kernel(MeshParams p, MeshBuffers bb, int use_ext,
                               int save) {
  const MeshBuffers b = body_buffers(p, bb);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n_edges)
    b.lam[i] = p.lambda_mode == 0 ? 0.f : b.lam[i] * p.lambda_decay;
  if (i < p.n_hinges)
    b.blam[i] = p.lambda_mode == 1 ? b.blam[i] * p.lambda_decay : 0.f;
  if (i < p.n_tets)
    b.tlam[i] = p.lambda_mode == 1 ? b.tlam[i] * p.lambda_decay : 0.f;
  if (i >= p.n) return;
  const int n = p.n;
  const float wa = b.w[i];
  for (int c = 0; c < 3; ++c) {
    float v_raw, vc, p_raw, pc;
    predict_coord(p, c, wa, b.x[c * n + i], b.v[c * n + i],
                  use_ext ? b.f[c * n + i] : 0.f, &v_raw, &vc, &p_raw, &pc);
    b.v[c * n + i] = vc;
    b.pred[c * n + i] = pc;
    if (save) {
      b.cur[c * n + i] = pc;
      b.prev[c * n + i] = pc;
    }
  }
}

// One thread per edge: the JACOBI projection (warm = 0) or the WARM_START
// pre-apply (warm = 1) of the edge, its lambda updated in place and its two
// position contributions written to contrib rows e (a side) and E + e.
__global__ void edge_kernel(MeshParams p, MeshBuffers bb, int warm) {
  const MeshBuffers b = body_buffers(p, bb);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.n_edges) return;
  const int n = p.n, ne = p.n_edges;
  const int ia = b.edges[2 * e], ib = b.edges[2 * e + 1];
  const float wa = b.w[ia], wb = b.w[ib];
  float pa[3], pb[3], d[3];
  load3(b.pred, n, ia, pa);
  load3(b.pred, n, ib, pb);
  for (int c = 0; c < 3; ++c) d[c] = pb[c] - pa[c];
  float inv;
  const float len = edge_length(p, d, &inv);
  float s;
  if (warm) {
    s = b.lam[e] * b.warm_scale[e];
    if (p.warm_clamp > 0.f) {
      const float lim = p.warm_clamp * b.rest[e] / fmaxf(fmaxf(wa, wb),
                                                          1e-12f);
      s = clampf(s, -lim, lim);
    }
    b.lam[e] = s;
  } else {
    s = distance_dl(p, len, b.rest[e], b.alpha[e], wa, wb, b.lam[e]) *
        b.relax[e];
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

// One thread per hinge: the JACOBI projection; contributions in rows
// k*H + h for endpoint k.
__global__ void hinge_kernel(MeshParams p, MeshBuffers bb) {
  const MeshBuffers b = body_buffers(p, bb);
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.n_hinges) return;
  const int n = p.n, nh = p.n_hinges;
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    const int i = b.hinges[4 * h + k];
    load3(b.pred, n, i, pp[k]);
    w[k] = b.w[i];
  }
  const float dl = bending_dl(p, pp, w, b.brest[h], b.balpha[h], b.blam[h],
                              g) * b.brelax[h];
  b.blam[h] = b.blam[h] + dl;
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c)
      b.bcontrib[3 * (k * nh + h) + c] = w[k] * dl * g[k][c];
}

// COLORED: one thread per slot of edge colour `color`; exact in place.
// clamp_in: the multiplier entering the update was clamped by an earlier
// colour pass (every pass but the first of a substep's first iteration),
// as general._solve_distance_colored clamps the whole array after each
// colour.
__global__ void edge_color_kernel(MeshParams p, MeshBuffers bb, int color,
                                  int clamp_in) {
  const MeshBuffers b = body_buffers(p, bb);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.col_width) return;
  const size_t slot = (size_t)color * p.col_width + s;
  if (!(b.col_valid[slot] > 0.f)) return;
  const int n = p.n;
  const int e = b.col_ids[slot];
  const int ia = b.edges[2 * e], ib = b.edges[2 * e + 1];
  const float wa = b.w[ia], wb = b.w[ib];
  float pa[3], pb[3], d[3];
  load3(b.pred, n, ia, pa);
  load3(b.pred, n, ib, pb);
  for (int c = 0; c < 3; ++c) d[c] = pb[c] - pa[c];
  float inv;
  const float len = edge_length(p, d, &inv);
  float lam = b.lam[e];
  if (clamp_in && p.lambda_clamp > 0.f)
    lam = clampf(lam, -p.lambda_clamp, p.lambda_clamp);
  const float dl = distance_dl(p, len, b.rest[e], b.alpha[e], wa, wb, lam);
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

// COLORED: one thread per slot of hinge colour `color`; exact in place.
__global__ void hinge_color_kernel(MeshParams p, MeshBuffers bb, int color) {
  const MeshBuffers b = body_buffers(p, bb);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.bcol_width) return;
  const size_t slot = (size_t)color * p.bcol_width + s;
  if (!(b.bcol_valid[slot] > 0.f)) return;
  const int n = p.n;
  const int h = b.bcol_ids[slot];
  int idx[4];
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    idx[k] = b.hinges[4 * h + k];
    load3(b.pred, n, idx[k], pp[k]);
    w[k] = b.w[idx[k]];
  }
  const float dl = bending_dl(p, pp, w, b.brest[h], b.balpha[h], b.blam[h],
                              g);
  b.blam[h] = b.blam[h] + dl;
  for (int k = 0; k < 4; ++k) {
    float o[3];
    for (int c = 0; c < 3; ++c) o[c] = pp[k][c] + w[k] * dl * g[k][c];
    store3(b.pred, n, idx[k], o);
  }
}

// ops/tet_volume.py::tet_delta_lambda for one tet (p0..p3): returns
// dlambda (0 when the denominator is at most eps_denominator) and writes
// the four gradients of 6V.
__device__ float tet_dl(const MeshParams& p, float pp[4][3], const float w[4],
                        float rest, float alpha, float lam, float g[4][3]) {
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

// One thread per tet: the mass-splitting JACOBI projection at full strength
// times omega; contributions in rows k*T + t for endpoint k.
__global__ void tet_kernel(MeshParams p, MeshBuffers bb) {
  const MeshBuffers b = body_buffers(p, bb);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.n_tets) return;
  const int n = p.n, nt = p.n_tets;
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    const int i = b.tets[4 * t + k];
    load3(b.pred, n, i, pp[k]);
    w[k] = b.w[i];
  }
  const float dl =
      tet_dl(p, pp, w, b.trest[t], b.talpha[t], b.tlam[t], g) * p.omega;
  b.tlam[t] = b.tlam[t] + dl;
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c)
      b.tcontrib[3 * (k * nt + t) + c] = w[k] * dl * g[k][c];
}

// COLORED: one thread per slot of tet colour `color`; exact in place.
__global__ void tet_color_kernel(MeshParams p, MeshBuffers bb, int color) {
  const MeshBuffers b = body_buffers(p, bb);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.tcol_width) return;
  const size_t slot = (size_t)color * p.tcol_width + s;
  if (!(b.tcol_valid[slot] > 0.f)) return;
  const int n = p.n;
  const int t = b.tcol_ids[slot];
  int idx[4];
  float pp[4][3], w[4], g[4][3];
  for (int k = 0; k < 4; ++k) {
    idx[k] = b.tets[4 * t + k];
    load3(b.pred, n, idx[k], pp[k]);
    w[k] = b.w[idx[k]];
  }
  const float dl = tet_dl(p, pp, w, b.trest[t], b.talpha[t], b.tlam[t], g);
  b.tlam[t] = b.tlam[t] + dl;
  for (int k = 0; k < 4; ++k) {
    float o[3];
    for (int c = 0; c < 3; ++c) o[c] = pp[k][c] + w[k] * dl * g[k][c];
    store3(b.pred, n, idx[k], o);
  }
}

// Dense self-collision, pass 1 of 2: the mean of pred, in one block.
__global__ void sc_mean_kernel(MeshParams p, MeshBuffers bb) {
  const MeshBuffers b = body_buffers(p, bb);
  __shared__ float s_sum[3][MX_THREADS];
  const int t = threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    float sum = 0.f;
    for (int i = t; i < p.n; i += MX_THREADS)
      sum = sum + b.pred[(size_t)c * p.n + i];
    s_sum[c][t] = sum;
  }
  __syncthreads();
  for (int half = MX_THREADS / 2; half > 0; half >>= 1) {
    if (t < half)
      for (int c = 0; c < 3; ++c)
        s_sum[c][t] = s_sum[c][t] + s_sum[c][t + half];
    __syncthreads();
  }
  if (t == 0)
    for (int c = 0; c < 3; ++c) b.sc_stats[c] = s_sum[c][0] / (float)p.n;
}

// Dense self-collision, pass 2 of 2 (mesh_pallas.py:1390-1494): one thread
// per row particle against all N particles, staged in shared memory tiles;
// the pair arithmetic of the blocked pass (contact_xpbd.cu) on positions
// centred by the mean; the correction goes to sc_corr.
__global__ void dense_pair_kernel(MeshParams p, MeshBuffers bb) {
  const MeshBuffers b = body_buffers(p, bb);
  __shared__ float sx[MX_THREADS], sy[MX_THREADS], sz[MX_THREADS];
  __shared__ float ssq[MX_THREADS], sw[MX_THREADS];
  const int n = p.n;
  const int t = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + t;
  const bool row = i < n;
  float xi[3] = {0.f, 0.f, 0.f};
  float wi = 0.f;
  if (row) {
    for (int c = 0; c < 3; ++c)
      xi[c] = b.pred[(size_t)c * n + i] - b.sc_stats[c];
    wi = b.w[i];
  }
  const float sqi = dot3(xi, xi);
  float msum = 0.f, mx[3] = {0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < n; j0 += MX_THREADS) {
    const int j = j0 + t;
    __syncthreads();
    if (j < n) {
      float xj[3];
      for (int c = 0; c < 3; ++c)
        xj[c] = b.pred[(size_t)c * n + j] - b.sc_stats[c];
      sx[t] = xj[0];
      sy[t] = xj[1];
      sz[t] = xj[2];
      ssq[t] = dot3(xj, xj);
      sw[t] = b.w[j];
    }
    __syncthreads();
    if (!row) continue;
    const int kmax = min(MX_THREADS, n - j0);
    for (int k = 0; k < kmax; ++k) {
      // the Gram product as contact_xpbd.cu takes it (fused, index order)
      const float g = fmaf(xi[2], sz[k], fmaf(xi[1], sy[k], xi[0] * sx[k]));
      const float d2 = (sqi + ssq[k]) - 2.f * g;
      const float dist = sqrtf(fmaxf(d2, 1e-18f));
      const float overlap = p.sc_diam - dist;
      const float wsum = wi + sw[k];
      if (i != j0 + k && overlap > 0.f && dist > 1e-9f && wsum > 1e-12f) {
        const float mm =
            overlap / (fmaxf(dist, 1e-12f) * fmaxf(wsum, 1e-12f));
        msum = msum + mm;
        mx[0] = fmaf(mm, sx[k], mx[0]);
        mx[1] = fmaf(mm, sy[k], mx[1]);
        mx[2] = fmaf(mm, sz[k], mx[2]);
      }
    }
  }
  if (row)
    for (int c = 0; c < 3; ++c)
      b.sc_corr[(size_t)c * n + i] = wi * (xi[c] * msum - mx[c]);
}

// One thread per particle: add the particle's constraint sum (when given)
// or the self-collision correction (when given), then, as `flags` asks,
// contacts, the Chebyshev step with weight om, saving the iteration's
// start, and finalize.
__global__ void particle_kernel(MeshParams p, MeshBuffers bb, SumSource src,
                                CorrSource sc, int flags, float om) {
  const MeshBuffers b = body_buffers(p, bb);
  src.contrib = body_ptr(src.contrib, blockIdx.y * src.stride);
  sc.corr = body_ptr(sc.corr, blockIdx.y * sc.stride);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (t >= n) return;
  const int i = sc.perm ? sc.perm[t] : t;
  const float wa = b.w[i];
  float pc[3], xc[3];
  load3(b.pred, n, i, pc);
  load3(b.x, n, i, xc);
  if (src.contrib) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int k = src.ptr[i]; k < src.ptr[i + 1]; ++k) {
      const int j = src.cols[k];
      for (int c = 0; c < 3; ++c) s[c] = s[c] + src.contrib[3 * j + c];
    }
    if (src.deg) {
      const float d = fmaxf(src.deg[i], 1.f);
      for (int c = 0; c < 3; ++c) s[c] = s[c] / d;
    }
    for (int c = 0; c < 3; ++c) pc[c] = pc[c] + s[c];
  }
  if (sc.corr)
    for (int c = 0; c < 3; ++c)
      pc[c] = pc[c] + p.sc_omega * sc.corr[(size_t)c * sc.ld + t];
  if (flags & PF_CONTACTS) project_contacts(p, b.colliders, wa, xc, pc);
  if (flags & (PF_CHEBY | PF_CHEBY_SPLIT)) {
    float cu[3], pv[3];
    load3(b.cur, n, i, cu);
    load3(b.prev, n, i, pv);
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
  store3(b.v, n, i, vc);
}

extern "C" {

int mesh_xpbd_params_size(void) { return (int)sizeof(MeshParams); }

int mesh_xpbd_buffers_size(void) { return (int)sizeof(MeshBuffers); }

const char* mesh_xpbd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Advance n_substeps substeps on `stream`.  Buffers as MeshBuffers says;
// the ext force is read on the first substep when ext_first.  om holds the
// Chebyshev weight of each iteration (host memory, `iterations` floats).
// With the blocked self-collision backend (sc_mode 2), cp / cb describe the
// B-4 pass over pred (its scratch allocated by the caller); otherwise they
// may be null.  *n_launched counts the kernels launched by this library's
// own passes, *n_contact those of the B-4 pass.  Returns a cudaError_t;
// nothing is synchronised.
int mesh_xpbd_run(const MeshParams* hp, const MeshBuffers* hb,
                  const ContactParams* cp, const ContactBuffers* cb,
                  int device, int n_substeps, int ext_first, const float* om,
                  long long* n_launched, long long* n_contact,
                  void* stream_handle) {
  const MeshParams p = *hp;
  const MeshBuffers b = *hb;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  *n_contact = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.n_spheres > MX_MAX_SPHERES || p.n_boxes > MX_MAX_BOXES ||
      !b.colliders || p.n <= 0 || p.n_edges <= 0 || p.sc_every < 1 ||
      p.n_bodies < 1 || p.n_bodies > 65535 ||
      (p.sc_mode == 2 && (!(cp && cb) || p.n_bodies != 1)))
    return (int)cudaErrorInvalidValue;

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
  const dim3 g_part = grid_for(p.n, nb);
  int g_all = p.n > p.n_edges ? p.n : p.n_edges;
  if (p.n_hinges > g_all) g_all = p.n_hinges;
  if (p.n_tets > g_all) g_all = p.n_tets;
  const bool warm = p.lambda_mode == 2;
  const bool bending = p.bending && p.n_hinges > 0;
  const bool tets = p.tets_on && p.n_tets > 0;
  const int contacts =
      (p.floor_mode == 1 || p.n_spheres > 0 || p.n_boxes > 0) ? PF_CONTACTS
                                                               : 0;
  const int save = p.accelerate ? PF_SAVE : 0;
  const CorrSource no_corr = {nullptr, nullptr, 0, 0};
  const SumSource no_sum = {nullptr, nullptr, nullptr, nullptr, 0};
  // each body's contributions follow the previous body's (body_buffers)
  const SumSource edge_sum = {b.contrib, b.inc_cols, b.inc_ptr, nullptr,
                              (size_t)6 * p.n_edges};
  const SumSource bend_sum = {b.bcontrib, b.binc_cols, b.binc_ptr, nullptr,
                              (size_t)3 * (p.n_hinges > 0 ? 4 * p.n_hinges
                                                          : 1)};
  const SumSource tet_sum = {b.tcontrib, b.tinc_cols, b.tinc_ptr, b.tdeg,
                             (size_t)12 * p.n_tets};
  auto particles = [&](SumSource src, CorrSource sc, int flags, float w) {
    particle_kernel<<<g_part, block, 0, stream>>>(p, b, src, sc, flags, w);
  };
  // one self-collision pass over pred: its correction, and where it lies
  auto self_collision = [&](CorrSource* out) -> int {
    if (p.sc_mode == 1) {
      // body-local: one mean block and one Gram sweep per body
      sc_mean_kernel<<<dim3(1, nb), MX_THREADS, 0, stream>>>(p, b);
      MX_CHECK();
      dense_pair_kernel<<<g_part, block, 0, stream>>>(p, b);
      MX_CHECK();
      *out = {b.sc_corr, nullptr, p.n, (size_t)3 * p.n};
      return 0;
    }
    const int rc = contact_xpbd_corr(cp, cb, n_contact, stream);
    *out = {cb->corr, cb->order, cp->nb * cp->block, 0};
    return rc;
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
        if (last) {
          particles(no_sum, no_corr, last, 0.f);
          MX_CHECK();
        }
      } else {
        edge_kernel<<<grid_for(p.n_edges, nb), block, 0, stream>>>(p, b, 0);
        MX_CHECK();
        particles(edge_sum, no_corr, bending || tets ? 0 : last, om[it]);
        MX_CHECK();
        if (bending) {
          hinge_kernel<<<grid_for(p.n_hinges, nb), block, 0, stream>>>(p, b);
          MX_CHECK();
          particles(bend_sum, no_corr, tets ? 0 : last, om[it]);
          MX_CHECK();
        }
        if (tets) {
          tet_kernel<<<grid_for(p.n_tets, nb), block, 0, stream>>>(p, b);
          MX_CHECK();
          particles(tet_sum, no_corr, last, om[it]);
          MX_CHECK();
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
