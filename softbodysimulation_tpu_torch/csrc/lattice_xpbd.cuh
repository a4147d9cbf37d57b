// Shared by the lattice kernel (lattice_xpbd.cu, TPU kernels B-1/B-2) and
// the slab kernel (spatial_xpbd.cu, TPU kernel B-6): the constants struct
// bound through ctypes (kernels/lattice_cuda.LatticeParams), the family
// masks from integer coordinates, one distance constraint's multiplier
// step, the WARM_START pre-apply multiplier, and predict.  Each library is
// built from its own .cu, so the kernels here compile into each.  The
// colliders (spheres, boxes, a ColliderSet's ground) are not constants: the
// lattice kernel reads them from a device table (colliders.cuh).

#pragma once

#include <cuda_runtime.h>

#include "colliders.cuh"

#define LX_MAX_FAM 16
#define LX_MAX_SPHERES 16
#define LX_MAX_BOXES 16

// Every field is 4 bytes wide, so the ctypes mirror has no padding.
struct LatticeParams {
  int res;
  int n;             // particles: res^3, B * res^3 for an ensemble of B
                     // bodies (a slab's P*res^2 in B-6)
  int nfam;
  int iterations;
  int colored;       // SolveMode.COLORED (else JACOBI)
  int lambda_mode;   // 0 RESET, 1 DECAY, 2 WARM_START
  int fast_math;
  int gravity_acc;   // gravity_is_acceleration
  int floor_mode;    // 0 NONE, 1 XPBD_INEQUALITY, 2 VELOCITY_REFLECT
  int reference_bounds;
  int n_spheres;            // sphere rows of the collider table
  int n_boxes;              // box rows of the collider table
  int fam[LX_MAX_FAM][4];   // dx, dy, dz, kind
  float dt;
  float gravity[3];
  float max_force;
  float damp_factor;        // per-substep velocity multiplier
  float max_velocity;
  float world_bounds;
  float lambda_decay;
  float warm_fraction;
  float relax;              // JACOBI 0.5 * omega
  float max_dlambda;
  float lambda_clamp;
  float eps_length;
  float eps_denominator;
  float static_eps;         // static_inv_mass_eps
  float ground_height;      // the slab kernel's (the lattice kernel reads
                            // its collider table's row 0)
  float floor_alpha;        // collision_compliance / dt^2
  float friction;           // clamped to [0, 1]
  float sphere_dt_fr;       // dt * friction, rounded from double
  float box_dt_fr;          // dt * friction, each rounded to float first
  float floor_offset;
  float restitution;
  float penetration_kick;
  float normal_force_scale;
  float floor_friction_coeff;
  float rest[LX_MAX_FAM];
  float alpha[LX_MAX_FAM];     // max(compliance / dt^2, min_alpha_tilde)
  float dl_rel[LX_MAX_FAM];    // max_dlambda_rel * rest (0 = off)
  float warm_lim[LX_MAX_FAM];  // warm_start_clamp * rest (0 = off)
  int tets;                  // enable_tet_volume
  int tet_off[6][3][3];      // Kuhn path p: corner k+1's (dx, dy, dz)
  float tet_alpha;           // tet_compliance / dt^2
  float tet_target;          // tet_pressure * 6 x rest volume
  float tet_omega;           // omega if > 0 else 1
  int body_n;                // particles of one body (res^3): an ensemble
                             // of B bodies runs n = B * body_n threads
  int approx_math;           // rsqrt and the approximate reciprocal in the
                             // family passes and the tet sweep
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ bool fam_valid(const LatticeParams& p, int f,
                                          int x, int y, int z) {
  const int res = p.res;
  const int dx = p.fam[f][0], dy = p.fam[f][1], dz = p.fam[f][2];
  if (p.reference_bounds && p.fam[f][3] != 0)
    return x < res - 1 && y < res - 1 && z < res - 1;
  bool v = true;
  if (dx > 0) v = v && x < res - dx; else if (dx < 0) v = v && x >= -dx;
  if (dy > 0) v = v && y < res - dy; else if (dy < 0) v = v && y >= -dy;
  if (dz > 0) v = v && z < res - dz; else if (dz < 0) v = v && z >= -dz;
  return v;
}

// sel: -1 every valid anchor (JACOBI), 0 even parity class, 1 odd class.
__device__ __forceinline__ bool fam_mask(const LatticeParams& p, int f,
                                         int sel, int x, int y, int z) {
  if (!fam_valid(p, f, x, y, z)) return false;
  if (sel < 0) return true;
  const int lead = p.fam[f][0] ? x : (p.fam[f][1] ? y : z);
  return ((lead & 1) == 0) == (sel == 0);
}

// approx_math's reciprocal (pl.reciprocal(approx=True) in
// lattice_pallas.py:158-160, :1060-1061, :1281-1285): rcp.approx, not IEEE.
__device__ __forceinline__ float approx_rcp(float x) {
  return __fdividef(1.f, x);
}

// The multiplier step of one distance constraint, given its current length
// and the inverse masses of its anchor (wa) and partner (wb): the arithmetic
// of solvers/lattice.py::_family_pass for an anchor whose mask is set
// (with approx_math, times the approximate reciprocal of the denominator).
__device__ __forceinline__ float constraint_dl(const LatticeParams& p, int f,
                                               float len, float wa, float wb,
                                               float lam, int jacobi) {
  const float alpha = p.alpha[f];
  const float c = len - p.rest[f];
  const float denom = wa + wb + alpha;
  const float num = -c - alpha * lam;
  float dl = p.approx_math ? num * approx_rcp(fmaxf(denom, 1e-30f))
                           : num / fmaxf(denom, 1e-30f);
  if (p.max_dlambda > 0.f) dl = clampf(dl, -p.max_dlambda, p.max_dlambda);
  if (p.dl_rel[f] > 0.f) dl = clampf(dl, -p.dl_rel[f], p.dl_rel[f]);
  if (p.fast_math) {
    if (jacobi) dl = dl * p.relax;
  } else {
    const bool active = len >= p.eps_length &&
                        fabsf(denom) >= p.eps_denominator &&
                        (wa >= p.static_eps || wb >= p.static_eps);
    dl = active ? (jacobi ? dl * p.relax : dl) : 0.f;
  }
  return dl;
}

// The carried multiplier as WARM_START pre-applies it: SOR fraction, then
// clamped so the correction stays under warm_start_clamp * rest.
__device__ __forceinline__ float warm_lambda(const LatticeParams& p, int f,
                                             float lam, float wa, float wb) {
  lam = lam * p.warm_fraction;
  if (p.warm_lim[f] > 0.f) {
    const float lim = p.warm_lim[f] / fmaxf(fmaxf(wa, wb), 1e-12f);
    lam = clampf(lam, -lim, lim);
  }
  return lam;
}

// Predict (gravity, the ext force when f is given, damping, clamps) of n
// particles, with the lambda reset / decay folded in: lam_src may alias
// lam_dst, since each thread touches only its own entries.  lam_t (the tet
// multipliers, 6 planes) is null when the state has none.
__global__ void predict_kernel(LatticeParams p, const float* __restrict__ x,
                               float* __restrict__ v,
                               const float* __restrict__ w,
                               const float* __restrict__ f,
                               float* __restrict__ pred,
                               const float* lam_src, float* lam_dst,
                               float* __restrict__ lam_t) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const float wa = w[a];
  for (int c = 0; c < 3; ++c) {
    float vc = v[c * n + a];
    const float g = p.gravity[c];
    float e = f ? f[c * n + a] : 0.f;
    if (p.gravity_acc) {
      if (p.max_force > 0.f) e = clampf(e, -p.max_force, p.max_force);
      vc = vc + p.dt * ((wa > 0.f ? g : 0.f) + wa * e);
    } else {
      float force = g + e;
      if (p.max_force > 0.f)
        force = clampf(force, -p.max_force, p.max_force);
      vc = vc + p.dt * wa * force;
    }
    vc = vc * p.damp_factor;
    if (p.max_velocity > 0.f)
      vc = clampf(vc, -p.max_velocity, p.max_velocity);
    float pc = x[c * n + a] + p.dt * vc;
    if (p.world_bounds > 0.f)
      pc = clampf(pc, -p.world_bounds, p.world_bounds);
    v[c * n + a] = vc;
    pred[c * n + a] = pc;
  }
  for (int fi = 0; fi < p.nfam; ++fi) {
    const size_t i = (size_t)fi * n + a;
    lam_dst[i] = p.lambda_mode == 0 ? 0.f : lam_src[i] * p.lambda_decay;
  }
  // tet multipliers are fresh every substep except in DECAY
  if (lam_t)
    for (int pi = 0; pi < 6; ++pi) {
      const size_t i = (size_t)pi * n + a;
      lam_t[i] = p.lambda_mode == 1 ? lam_t[i] * p.lambda_decay : 0.f;
    }
}

