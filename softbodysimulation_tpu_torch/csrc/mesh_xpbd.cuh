// Shared part of the mesh library (mesh_xpbd.cu) and of the fused mesh
// backward (mesh_diff_xpbd.cu): the parameter and buffer structs (mirrored
// by ctypes in kernels/mesh_cuda.py), the per-constraint and per-particle
// arithmetic both sides must round identically, and the forward passes the
// backward launches to replay a chunk.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "colliders.cuh"
#include "contact_xpbd.cuh"

#define MX_MAX_SPHERES 16
#define MX_MAX_BOXES 16
#define MX_THREADS 256

// Every field is 4 bytes wide, so the ctypes mirror has no padding.
struct MeshParams {
  int n;               // particles
  int n_edges;
  int n_hinges;
  int iterations;
  int colored;         // SolveMode.COLORED (else JACOBI)
  int lambda_mode;     // 0 RESET, 1 DECAY, 2 WARM_START
  int bending;         // bending family active
  int gravity_acc;     // gravity_is_acceleration
  int floor_mode;      // 0 NONE, 1 XPBD_INEQUALITY, 2 VELOCITY_REFLECT
  int n_spheres;       // sphere rows of the collider table
  int n_boxes;         // box rows of the collider table
  int accelerate;      // Chebyshev
  int n_colors;
  int col_width;
  int n_bend_colors;
  int bcol_width;
  int n_tets;          // tets carried by the state (lambda_tet), else 0
  int tets_on;         // per-tet volume sweep active
  int n_tet_colors;
  int tcol_width;
  int sc_mode;         // self-collision: 0 off, 1 dense, 2 blocked
  int sc_every;        // contact on substep i iff i % sc_every == 0
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
  float floor_alpha;   // collision_compliance / dt^2
  float friction_dt;   // dt * clip(friction, 0, 1)
  float floor_offset;
  float restitution;
  float penetration_kick;
  float normal_force_scale;
  float floor_friction_coeff;
  float gamma;         // jacobi_gamma
  float omega;         // omega (0 => 1): the tets' Jacobi scale
  float tet_pressure;
  float sc_omega;      // self_collision_omega
  float sc_diam;       // 2 * particle_radius
  int n_bodies;        // bodies of an ensemble (blockIdx.y), 1 for one
  int w_stride;        // floats between two bodies' inverse masses: 0 for
                       // a shared (N) leaf, N for per-body masses
  int mat_stride;      // floats between two bodies' rest and alpha: 0 for
                       // shared materials, E for per-body (B, E) ones
  int approx_math;     // rsqrt in the distance and bending passes
};

// Device pointers, all 8 bytes wide.  In an ensemble every per-body buffer
// holds the bodies one after another (body_buffers gives one body's view);
// the topology's tables are shared.
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
  const int* inc_ptr;       // (N + 1) CSR rows into inc_cols
  const int* inc_cols;      // edge incidence: rows into contrib
  const int* col_ids;       // (n_colors, col_width)
  const float* col_valid;
  const int* hinges;        // (H, 4)
  const float* brest;       // (H)
  const float* balpha;      // (H) compliance / dt^2
  const float* brelax;      // (H) omega / max(bend degree, 1)
  const int* binc_ptr;        // (N + 1) CSR rows into binc_cols
  const int* binc_cols;       // hinge incidence: rows into bcontrib
  const int* bcol_ids;        // (n_bend_colors, bcol_width)
  const float* bcol_valid;
  float* tlam;                // (T)
  float* tcontrib;            // (4T, 3)
  const int* tets;            // (T, 4)
  const float* trest;         // (T) 6 x rest volume
  const float* talpha;        // (T) compliance / dt^2
  const float* tdeg;          // (N) tets per particle
  const int* tinc_ptr;        // (N + 1) CSR rows into tinc_cols
  const int* tinc_cols;       // tet incidence without its pads
  const int* tcol_ids;        // (n_tet_colors, tcol_width)
  const float* tcol_valid;
  float* sc_corr;             // (3, N) dense self-collision correction
  float* sc_stats;            // (3) mean of pred (dense pass)
  const float* colliders;     // (1 + S + B, KIN_W) collider table
};

enum {
  PF_CONTACTS = 1,   // project floor, spheres and boxes
  PF_CHEBY = 2,      // Chebyshev step (then contacts again)
  PF_SAVE = 4,       // cur = prev = pred (the first iteration's start)
  PF_FINALIZE = 8,   // velocities and positions from pred
  PF_CHEBY_SPLIT = 16,  // Chebyshev step, prev = cur; contacts follow in a
                        // later pass (self-collision needs the whole plane)
  PF_SETCUR = 32,    // cur = pred (the split step's second half)
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

// An edge's length and the factor by which its unit direction is taken:
// sqrt(max(|d|^2, 1e-24)) and a division by it, or with approx_math
// |d|^2 * rsqrtf(max(|d|^2, 1e-24)) and a product with that rsqrt
// (mesh_pallas.py:1072-1075, :1103); *inv is 0 on the exact path.
__device__ __forceinline__ float edge_length(const MeshParams& p,
                                             const float d[3], float* inv) {
  const float len_sq = dot3(d, d);
  if (p.approx_math) {
    *inv = rsqrtf(fmaxf(len_sq, 1e-24f));
    return len_sq * *inv;
  }
  *inv = 0.f;
  return sqrtf(fmaxf(len_sq, 1e-24f));
}

// d[c] / len, or d[c] * inv with approx_math (edge_length).
__device__ __forceinline__ float unit_coord(const MeshParams& p, float dc,
                                            float len, float inv) {
  return p.approx_math ? dc * inv : dc / len;
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

// ops/integrate.py::predict for coordinate c of one particle of inverse
// mass wa: the velocity before (*v_raw) and after (*vc) the max_velocity
// clamp, and the predicted position before (*p_raw) and after (*pc) the
// world_bounds clamp.  e is the coordinate's ext force (0 without).
__device__ __forceinline__ void predict_coord(const MeshParams& p, int c,
                                              float wa, float xc, float vin,
                                              float e, float* v_raw,
                                              float* vc, float* p_raw,
                                              float* pc) {
  const float g = p.gravity[c];
  float dv;
  if (p.gravity_acc) {
    if (p.max_force > 0.f) e = clampf(e, -p.max_force, p.max_force);
    dv = p.dt * ((wa > 0.f ? g : 0.f) + wa * e);
  } else {
    float force = g + e;
    if (p.max_force > 0.f) force = clampf(force, -p.max_force, p.max_force);
    dv = p.dt * wa * force;
  }
  float v = (vin + dv) * p.damp_factor;
  *v_raw = v;
  if (p.max_velocity > 0.f) v = clampf(v, -p.max_velocity, p.max_velocity);
  *vc = v;
  float pp = xc + p.dt * v;
  *p_raw = pp;
  if (p.world_bounds > 0.f) pp = clampf(pp, -p.world_bounds, p.world_bounds);
  *pc = pp;
}

// The XPBD floor at height gh with positional friction (ops/collision.py)
// on one particle's predicted position pc, xc its substep-entry position.
__device__ __forceinline__ void floor_project(const MeshParams& p, float gh,
                                              float wa, const float xc[3],
                                              float pc[3]) {
  const float pen = gh - pc[1];
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

// Sphere row r (colliders.cuh) with positional friction in its tangent
// plane, relative to the sphere's velocity (0 for the config's spheres).
__device__ __forceinline__ void sphere_project(const MeshParams& p,
                                               const float* r, float wa,
                                               const float xc[3],
                                               float pc[3]) {
  float d[3], nrm[3], vel[3];
  for (int c = 0; c < 3; ++c) d[c] = pc[c] - r[c];
  const float dist = sqrtf(dot3(d, d));
  for (int c = 0; c < 3; ++c) nrm[c] = d[c] / fmaxf(dist, 1e-12f);
  const float pen = r[3] - dist;
  const bool active = pen > 0.f && wa >= p.static_eps;
  if (active)
    for (int c = 0; c < 3; ++c) pc[c] = pc[c] + nrm[c] * pen;
  for (int c = 0; c < 3; ++c) vel[c] = (pc[c] - xc[c]) / p.dt - r[4 + c];
  const float vn = dot3(vel, nrm);
  if (active)
    for (int c = 0; c < 3; ++c)
      pc[c] = pc[c] - (vel[c] - vn * nrm[c]) * p.friction_dt;
}

// The floor, then each sphere, then each box of the collider table tab
// (solvers/general.py's order).
__device__ __forceinline__ void project_contacts(const MeshParams& p,
                                                 const float* tab, float wa,
                                                 const float xc[3],
                                                 float pc[3]) {
  if (p.floor_mode == 1) floor_project(p, tab[0], wa, xc, pc);
  for (int s = 0; s < p.n_spheres; ++s)
    sphere_project(p, sphere_row(tab, s), wa, xc, pc);
  for (int k = 0; k < p.n_boxes; ++k)
    box_project(box_row(tab, p.n_spheres, k), wa, p.static_eps, p.dt,
                p.friction_dt, xc, pc);
}

// Where a particle pass takes a particle's constraint sum from: the
// contribution buffer and its CSR incidence rows, the sum divided by
// max(deg, 1) when deg is given; body b's contributions start at
// contrib + b * stride.
struct SumSource {
  const float* contrib;
  const int* cols;
  const int* ptr;
  const float* deg;
  size_t stride;
};

// Where a particle pass takes a self-collision correction from: thread t
// applies omega * corr[c * ld + t] to particle perm[t] (or t); body b's
// correction starts at corr + b * stride.
struct CorrSource {
  const float* corr;
  const int* perm;
  int ld;
  size_t stride;
};

template <typename T>
__device__ __forceinline__ T* body_ptr(T* ptr, size_t offset) {
  return ptr ? ptr + offset : ptr;
}

// Body blockIdx.y's view of the buffers of an ensemble (mesh_pallas.py's
// n_bodies > 1): its planes, multipliers, contributions, self-collision
// scratch and ext force; its inverse masses when they are per body
// (w_stride), its rest lengths and alphas when the materials are
// (mat_stride).  Body 0 of a one-body launch is the buffers themselves.
__device__ __forceinline__ MeshBuffers body_buffers(const MeshParams& p,
                                                    MeshBuffers b) {
  const size_t body = blockIdx.y;
  const size_t n3 = 3 * (size_t)p.n;
  b.x = body_ptr(b.x, body * n3);
  b.v = body_ptr(b.v, body * n3);
  b.f = body_ptr(b.f, body * n3);
  b.pred = body_ptr(b.pred, body * n3);
  b.cur = body_ptr(b.cur, body * n3);
  b.prev = body_ptr(b.prev, body * n3);
  b.sc_corr = body_ptr(b.sc_corr, body * n3);
  b.sc_stats = body_ptr(b.sc_stats, body * 3);
  b.w = body_ptr(b.w, body * p.w_stride);
  b.rest = body_ptr(b.rest, body * p.mat_stride);
  b.alpha = body_ptr(b.alpha, body * p.mat_stride);
  b.lam = body_ptr(b.lam, body * p.n_edges);
  b.blam = body_ptr(b.blam, body * p.n_hinges);
  b.tlam = body_ptr(b.tlam, body * p.n_tets);
  b.contrib = body_ptr(b.contrib, body * 6 * p.n_edges);
  b.bcontrib = body_ptr(b.bcontrib, body * 3 * max(4 * p.n_hinges, 1));
  b.tcontrib = body_ptr(b.tcontrib, body * 12 * p.n_tets);
  return b;
}

// The forward passes the fused backward (mesh_diff_xpbd.cu) replays, so
// that its linearization point is the forward trajectory to the bit.
// Each takes the whole ensemble's buffers and works on body blockIdx.y.
__global__ void predict_kernel(MeshParams p, MeshBuffers bb, int use_ext,
                               int save);
__global__ void edge_kernel(MeshParams p, MeshBuffers bb, int warm);
__global__ void particle_kernel(MeshParams p, MeshBuffers bb, SumSource src,
                                CorrSource sc, int flags, float om);

// count threads on x, one row of blocks per body on y
static inline dim3 grid_for(int count, int bodies = 1) {
  return dim3((count + MX_THREADS - 1) / MX_THREADS, bodies);
}
