// General-mesh XPBD substep loop for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel softbodysimulation_tpu/kernels/mesh_pallas.py
// make_mesh_substep_runner (:789, kernel body :990, pallas_call :1794) for
// the distance + dihedral-bending family: predict, the lambda lifecycle
// (RESET, DECAY, WARM_START with its pre-apply pass), JACOBI sweeps with
// the per-constraint omega / max(degree) relaxation and optional Chebyshev
// acceleration, or COLORED exact Gauss-Seidel sweeps, the XPBD floor and
// static spheres, finalize and the VELOCITY_REFLECT floor.  It ports WHAT
// that kernel computes -- the semantics of solvers/general.py::_substep --
// and none of its TPU machinery: no signed one-hot gather/scatter matrices,
// no bf16 split compensation, no window bases, no VMEM budget, and acosf in
// place of the polynomial Mosaic needed.  Volume, per-tet volume, box and
// kinematic colliders, dense self-contact, ensembles and traced materials
// are refused by the wrapper (kernels/mesh_cuda.py).
//
// Layout: x, v, pred (and the Chebyshev planes cur, prev) are (3, N)
// float32 structure-of-arrays planes; lambda_dist (E), lambda_bend (H); the
// topology's int32 tables and per-constraint constants are uploaded once
// per device by the wrapper.
//
// One launch per pass on the caller's stream, no host sync in the loop:
//   predict (+ the lambda lifecycle of both families);
//   WARM_START: an edge pass and a particle pass;
//   per iteration, JACOBI: an edge pass writing the two contributions
//     -w_a dp and +w_b dp of each edge into a (2E, 3) buffer, a particle
//     pass adding the particle's incidence row of it (the gather-and-sum of
//     general.py:109-113, in column order, no atomics); then the same for
//     hinges with a (4H, 3) buffer; the last particle pass also projects
//     the contacts, takes the Chebyshev step and, after the last iteration,
//     finalizes;
//   per iteration, COLORED: one launch per edge colour and per hinge colour
//     (a thread updates its constraint's lambda and endpoints in place; a
//     colour shares no particle, so this is exact), then one particle pass
//     for contacts (and finalize).
//
// What bounds it on the card: at cloth_xl (16,641 particles, 49,408 edges,
// 48,896 hinges) the state, the contribution buffers and the tables are a
// few MB and live in the 50 MB L2, and a pass is a few hundred flops per
// constraint, so with about 11-14 launches of small grids per substep the
// launch overhead, not HBM or the ALUs, should set the pace.  The design
// does nothing about that yet, by choice: fusing passes, CUDA graphs or a
// shared-memory design come later.
//
// Floats: built without --use_fast_math and with -fmad=false, so every
// product and sum is rounded as written, in the operation order of the plain
// PyTorch engine (cross products component by component, dot products
// x + y + z); near-flat hinges turn one ulp of cos into ~3e-4 rad of angle,
// and the sin masks of the bending bands must see the same bits.

#include <cuda_runtime.h>

#define MX_MAX_SPHERES 16
#define MX_THREADS 256

// Every field is 4 bytes wide, so the ctypes mirror has no padding.
struct MeshParams {
  int n;               // particles
  int n_edges;
  int n_hinges;
  int inc_width;       // columns of incidence (pad index 2E)
  int binc_width;      // columns of bend_incidence (pad index 4H)
  int iterations;
  int colored;         // SolveMode.COLORED (else JACOBI)
  int lambda_mode;     // 0 RESET, 1 DECAY, 2 WARM_START
  int bending;         // bending family active
  int gravity_acc;     // gravity_is_acceleration
  int floor_mode;      // 0 NONE, 1 XPBD_INEQUALITY, 2 VELOCITY_REFLECT
  int n_spheres;
  int accelerate;      // Chebyshev
  int n_colors;
  int col_width;
  int n_bend_colors;
  int bcol_width;
  float dt;
  float gravity[3];
  float max_force;
  float damp_factor;   // per-substep velocity multiplier
  float max_velocity;
  float world_bounds;
  float lambda_decay;
  float max_dlambda;
  float max_dlambda_rel;
  float lambda_clamp;
  float warm_clamp;    // warm_start_clamp (0 = off)
  float eps_length;
  float eps_denominator;
  float static_eps;    // static_inv_mass_eps
  float skip_sin_eps;
  float soften_sin_eps;
  float soften_factor;
  float ground_height;
  float floor_alpha;   // collision_compliance / dt^2
  float friction_dt;   // dt * clip(friction, 0, 1)
  float floor_rest;    // ground_height + floor_offset
  float restitution;
  float penetration_kick;
  float normal_force_scale;
  float floor_friction_coeff;
  float gamma;         // jacobi_gamma
  float spheres[MX_MAX_SPHERES][4];
};

// Device pointers, all 8 bytes wide.
struct MeshBuffers {
  float* x;            // (3, N)
  float* v;            // (3, N)
  const float* w;      // (N)
  const float* f;      // (3, N) ext force, read on the first substep
  float* pred;         // (3, N)
  float* cur;          // (3, N) Chebyshev: the iteration's start
  float* prev;         // (3, N) Chebyshev: the previous iteration's start
  float* lam;          // (E)
  float* blam;         // (H)
  float* contrib;      // (2E, 3)
  float* bcontrib;     // (4H, 3)
  const int* edges;    // (E, 2)
  const float* rest;   // (E)
  const float* alpha;  // (E) compliance / dt^2, floored at min_alpha_tilde
  const float* relax;  // (E) omega / max(deg_a, deg_b, 1)
  const float* warm_scale;  // (E) fraction / max(deg_a, deg_b, 1)
  const int* incidence;     // (N, inc_width)
  const int* col_ids;       // (n_colors, col_width)
  const float* col_valid;
  const int* hinges;        // (H, 4)
  const float* brest;       // (H)
  const float* balpha;      // (H) compliance / dt^2
  const float* brelax;      // (H) omega / max(bend degree, 1)
  const int* bend_incidence;  // (N, binc_width)
  const int* bcol_ids;        // (n_bend_colors, bcol_width)
  const float* bcol_valid;
};

enum {
  PF_CONTACTS = 1,   // project floor and spheres
  PF_CHEBY = 2,      // Chebyshev step (then contacts again)
  PF_SAVE = 4,       // cur = prev = pred (the first iteration's start)
  PF_FINALIZE = 8,   // velocities and positions from pred
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void load3(const float* plane, int n, int i,
                                      float o[3]) {
  o[0] = plane[i];
  o[1] = plane[n + i];
  o[2] = plane[2 * n + i];
}

__device__ __forceinline__ void store3(float* plane, int n, int i,
                                       const float o[3]) {
  plane[i] = o[0];
  plane[n + i] = o[1];
  plane[2 * n + i] = o[2];
}

// ops/distance.py::distance_delta_lambda for one edge of length len.
__device__ __forceinline__ float distance_dl(const MeshParams& p, float len,
                                             float rest, float alpha,
                                             float wa, float wb, float lam) {
  const float c = len - rest;
  const float denom = wa + wb + alpha;
  const bool valid = len >= p.eps_length &&
                     fabsf(denom) >= p.eps_denominator &&
                     (wa >= p.static_eps || wb >= p.static_eps);
  float dl = (-c - alpha * lam) / (valid ? denom : 1.f);
  if (p.max_dlambda > 0.f) dl = clampf(dl, -p.max_dlambda, p.max_dlambda);
  if (p.max_dlambda_rel > 0.f) {
    const float m = p.max_dlambda_rel * rest;
    dl = clampf(dl, -m, m);
  }
  return valid ? dl : 0.f;
}

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
  const float l1 = sqrtf(fmaxf(l1sq, 1e-24f));
  const float l2 = sqrtf(fmaxf(l2sq, 1e-24f));
  float n1n[3], n2n[3];
  for (int c = 0; c < 3; ++c) {
    n1n[c] = n1[c] / l1;
    n2n[c] = n2[c] / l2;
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
    av[c] = (n2n[c] - cs * n1n[c]) / l1;
    bv[c] = (n1n[c] - cs * n2n[c]) / l2;
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

// The lambda lifecycle of both families, and predict (gravity, the first
// substep's ext force, damping, clamps).  Grid: max(N, E, H) threads.
__global__ void predict_kernel(MeshParams p, MeshBuffers b, int use_ext,
                               int save) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n_edges)
    b.lam[i] = p.lambda_mode == 0 ? 0.f : b.lam[i] * p.lambda_decay;
  if (i < p.n_hinges)
    b.blam[i] = p.lambda_mode == 1 ? b.blam[i] * p.lambda_decay : 0.f;
  if (i >= p.n) return;
  const int n = p.n;
  const float wa = b.w[i];
  for (int c = 0; c < 3; ++c) {
    const float g = p.gravity[c];
    float e = use_ext ? b.f[c * n + i] : 0.f;
    float dv;
    if (p.gravity_acc) {
      if (p.max_force > 0.f) e = clampf(e, -p.max_force, p.max_force);
      dv = p.dt * ((wa > 0.f ? g : 0.f) + wa * e);
    } else {
      float force = g + e;
      if (p.max_force > 0.f)
        force = clampf(force, -p.max_force, p.max_force);
      dv = p.dt * wa * force;
    }
    float vc = (b.v[c * n + i] + dv) * p.damp_factor;
    if (p.max_velocity > 0.f)
      vc = clampf(vc, -p.max_velocity, p.max_velocity);
    float pc = b.x[c * n + i] + p.dt * vc;
    if (p.world_bounds > 0.f)
      pc = clampf(pc, -p.world_bounds, p.world_bounds);
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
__global__ void edge_kernel(MeshParams p, MeshBuffers b, int warm) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.n_edges) return;
  const int n = p.n, ne = p.n_edges;
  const int ia = b.edges[2 * e], ib = b.edges[2 * e + 1];
  const float wa = b.w[ia], wb = b.w[ib];
  float pa[3], pb[3], d[3];
  load3(b.pred, n, ia, pa);
  load3(b.pred, n, ib, pb);
  for (int c = 0; c < 3; ++c) d[c] = pb[c] - pa[c];
  const float len = sqrtf(fmaxf(dot3(d, d), 1e-24f));
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
    const float dp = s * (d[c] / len);
    b.contrib[3 * e + c] = -wa * dp;
    b.contrib[3 * (ne + e) + c] = wb * dp;
  }
}

// One thread per hinge: the JACOBI projection; contributions in rows
// k*H + h for endpoint k.
__global__ void hinge_kernel(MeshParams p, MeshBuffers b) {
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
__global__ void edge_color_kernel(MeshParams p, MeshBuffers b, int color,
                                  int clamp_in) {
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
  const float len = sqrtf(fmaxf(dot3(d, d), 1e-24f));
  float lam = b.lam[e];
  if (clamp_in && p.lambda_clamp > 0.f)
    lam = clampf(lam, -p.lambda_clamp, p.lambda_clamp);
  const float dl = distance_dl(p, len, b.rest[e], b.alpha[e], wa, wb, lam);
  lam = lam + dl;
  if (p.lambda_clamp > 0.f)
    lam = clampf(lam, -p.lambda_clamp, p.lambda_clamp);
  b.lam[e] = lam;
  for (int c = 0; c < 3; ++c) {
    const float dp = dl * (d[c] / len);
    pa[c] = pa[c] + -wa * dp;
    pb[c] = pb[c] + wb * dp;
  }
  store3(b.pred, n, ia, pa);
  store3(b.pred, n, ib, pb);
}

// COLORED: one thread per slot of hinge colour `color`; exact in place.
__global__ void hinge_color_kernel(MeshParams p, MeshBuffers b, int color) {
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

// The XPBD floor with positional friction, then each static sphere
// (ops/collision.py), on one particle's predicted position.
__device__ void project_contacts(const MeshParams& p, float wa,
                                 const float xc[3], float pc[3]) {
  if (p.floor_mode == 1) {
    const float pen = p.ground_height - pc[1];
    const float denom = wa + p.floor_alpha;
    const bool active = pen > 0.f && wa >= p.static_eps &&
                        fabsf(denom) >= p.eps_denominator;
    const float dl = pen / (active ? denom : 1.f);
    pc[1] = pc[1] + (active ? wa * dl : 0.f);
    if (active) {
      pc[0] = pc[0] - (pc[0] - xc[0]) / p.dt * p.friction_dt;
      pc[2] = pc[2] - (pc[2] - xc[2]) / p.dt * p.friction_dt;
    }
  }
  for (int s = 0; s < p.n_spheres; ++s) {
    float d[3], nrm[3], vel[3];
    for (int c = 0; c < 3; ++c) d[c] = pc[c] - p.spheres[s][c];
    const float dist = sqrtf(dot3(d, d));
    for (int c = 0; c < 3; ++c) nrm[c] = d[c] / fmaxf(dist, 1e-12f);
    const float pen = p.spheres[s][3] - dist;
    const bool active = pen > 0.f && wa >= p.static_eps;
    if (active)
      for (int c = 0; c < 3; ++c) pc[c] = pc[c] + nrm[c] * pen;
    for (int c = 0; c < 3; ++c) vel[c] = (pc[c] - xc[c]) / p.dt;
    const float vn = dot3(vel, nrm);
    if (active)
      for (int c = 0; c < 3; ++c)
        pc[c] = pc[c] - (vel[c] - vn * nrm[c]) * p.friction_dt;
  }
}

// One thread per particle: add the particle's incidence row of `contrib`
// (when given), then, as `flags` asks, contacts, the Chebyshev step with
// weight om, saving the iteration's start, and finalize.
__global__ void particle_kernel(MeshParams p, MeshBuffers b,
                                const float* __restrict__ contrib,
                                const int* __restrict__ incidence, int width,
                                int pad, int flags, float om) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (i >= n) return;
  const float wa = b.w[i];
  float pc[3], xc[3];
  load3(b.pred, n, i, pc);
  load3(b.x, n, i, xc);
  if (incidence) {
    float s[3] = {0.f, 0.f, 0.f};
    const int* row = incidence + (size_t)i * width;
    for (int k = 0; k < width; ++k) {
      const int j = row[k];
      if (j < pad)
        for (int c = 0; c < 3; ++c) s[c] = s[c] + contrib[3 * j + c];
    }
    for (int c = 0; c < 3; ++c) pc[c] = pc[c] + s[c];
  }
  if (flags & PF_CONTACTS) project_contacts(p, wa, xc, pc);
  if (flags & PF_CHEBY) {
    float cu[3], pv[3];
    load3(b.cur, n, i, cu);
    load3(b.prev, n, i, pv);
    for (int c = 0; c < 3; ++c)
      pc[c] = om * (p.gamma * (pc[c] - cu[c]) + cu[c] - pv[c]) + pv[c];
    if (flags & PF_CONTACTS) project_contacts(p, wa, xc, pc);
    store3(b.prev, n, i, cu);
    store3(b.cur, n, i, pc);
  }
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
    const float pen = p.ground_height - xc[1];
    const bool hit = pen > 0.f && wa > 0.f;
    if (hit) xc[1] = p.floor_rest;
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

static inline dim3 grid_for(int count) {
  return dim3((count + MX_THREADS - 1) / MX_THREADS);
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
// *n_launched counts the kernels launched.  Returns a cudaError_t; nothing
// is synchronised.
int mesh_xpbd_run(const MeshParams* hp, const MeshBuffers* hb, int device,
                  int n_substeps, int ext_first, const float* om,
                  long long* n_launched, void* stream_handle) {
  const MeshParams p = *hp;
  const MeshBuffers b = *hb;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.n_spheres > MX_MAX_SPHERES || p.n <= 0 || p.n_edges <= 0)
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
  const dim3 g_part = grid_for(p.n);
  const dim3 g_edge = grid_for(p.n_edges);
  const dim3 g_hinge = grid_for(p.n_hinges);
  int g_all = p.n > p.n_edges ? p.n : p.n_edges;
  if (p.n_hinges > g_all) g_all = p.n_hinges;
  const bool warm = p.lambda_mode == 2;
  const bool bending = p.bending && p.n_hinges > 0;
  const int contacts = (p.floor_mode == 1 || p.n_spheres > 0)
                           ? PF_CONTACTS : 0;
  const int save = p.accelerate ? PF_SAVE : 0;
  const int e_pad = 2 * p.n_edges, h_pad = 4 * p.n_hinges;

  for (int i = 0; i < n_substeps; ++i) {
    predict_kernel<<<grid_for(g_all), block, 0, stream>>>(
        p, b, ext_first && i == 0, save && !warm);
    MX_CHECK();
    if (warm) {
      edge_kernel<<<g_edge, block, 0, stream>>>(p, b, 1);
      MX_CHECK();
      particle_kernel<<<g_part, block, 0, stream>>>(
          p, b, b.contrib, b.incidence, p.inc_width, e_pad, save, 0.f);
      MX_CHECK();
    }
    for (int it = 0; it < p.iterations; ++it) {
      const int fin = it == p.iterations - 1 ? PF_FINALIZE : 0;
      if (p.colored) {
        for (int c = 0; c < p.n_colors; ++c) {
          edge_color_kernel<<<grid_for(p.col_width), block, 0, stream>>>(
              p, b, c, it > 0 || c > 0);
          MX_CHECK();
        }
        if (bending) {
          for (int c = 0; c < p.n_bend_colors; ++c) {
            hinge_color_kernel<<<grid_for(p.bcol_width), block, 0,
                                 stream>>>(p, b, c);
            MX_CHECK();
          }
        }
        if (contacts || fin) {
          particle_kernel<<<g_part, block, 0, stream>>>(
              p, b, nullptr, nullptr, 0, 0, contacts | fin, 0.f);
          MX_CHECK();
        }
        continue;
      }
      const int last =
          contacts | fin | (p.accelerate ? PF_CHEBY : 0);
      edge_kernel<<<g_edge, block, 0, stream>>>(p, b, 0);
      MX_CHECK();
      particle_kernel<<<g_part, block, 0, stream>>>(
          p, b, b.contrib, b.incidence, p.inc_width, e_pad,
          bending ? 0 : last, om[it]);
      MX_CHECK();
      if (bending) {
        hinge_kernel<<<g_hinge, block, 0, stream>>>(p, b);
        MX_CHECK();
        particle_kernel<<<g_part, block, 0, stream>>>(
            p, b, b.bcontrib, b.bend_incidence, p.binc_width, h_pad, last,
            om[it]);
        MX_CHECK();
      }
    }
  }
#undef MX_CHECK
  *n_launched = launched;
  return (int)cudaSuccess;
}

}  // extern "C"
