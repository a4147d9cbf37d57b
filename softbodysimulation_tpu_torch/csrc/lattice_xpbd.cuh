// Shared by the lattice kernel (lattice_xpbd.cu, TPU kernels B-1/B-2) and
// the slab kernel (spatial_xpbd.cu, TPU kernel B-6): the constants struct
// bound through ctypes (kernels/lattice_cuda.LatticeParams), the family
// masks from integer coordinates, one distance constraint's multiplier
// step, the WARM_START pre-apply multiplier, and predict.  Each library is
// built from its own .cu, so the kernels here compile into each.  The
// colliders (spheres, boxes, a ColliderSet's ground) are not constants: the
// lattice kernel reads them from a device table (colliders.cuh).
//
// The lattice kernel's passes are __device__ functions of one particle
// (predict_one, warm_one, family_one, tet_tables_one, tet_cell_one,
// tet_apply_one, contact_finalize_one), called by both of its designs: the
// per-pass kernels, one launch a pass, and the persistent kernel, one
// launch a call (lattice_xpbd.cu).  A neighbour policy says how a pass
// finds a particle's partners: WrapNbr with the rolls' wrap-around from
// integer division (the per-pass kernels), FastNbr by adding the offset to
// coordinates carried from particle to particle (the persistent kernel).
// Where a partner is read, the two give the same index, so both designs
// run the same arithmetic on the same values.  A layout policy says where
// the gathered planes (the iterate, w, the multipliers) live: GlobalPlanes
// in global memory (the per-pass kernels, the persistent kernel's grid
// kind), TilePlanes in a block's shared memory (its block kind); the
// arithmetic is the same in both.

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

// Where a pass finds the planes it gathers from -- the iterate (pred), the
// inverse masses w and the distance multipliers -- and how a particle's
// index there relates to its index in the planes that stay in global memory
// (x, v, the ext force, the tet multipliers and terms, each n long).
//   GlobalPlanes: every plane in global memory, n long, indexed by the
//     particle (the per-pass loop, the grid kind of the persistent kernel);
//     n is read where a function starts, as a kernel parameter.
//   TilePlanes: the block kind's tile in shared memory, planes of the
//     block's chunk, ps, indexed by the particle less the tile's first, lo
//     (a slot): 32-bit addresses, and a Cell's a and base are slots too.
// stride(): a plane's length; glob(a): the global index of a; Off: the
// type of a plane's offset, k * stride (plane_off).
struct GlobalPlanes {
  using Off = size_t;
  const LatticeParams& p;
  __device__ __forceinline__ int stride() const { return p.n; }
  __device__ __forceinline__ int glob(int a) const { return a; }
};

struct TilePlanes {
  using Off = int;
  int ps, lo;
  __device__ __forceinline__ int stride() const { return ps; }
  __device__ __forceinline__ int glob(int a) const { return a + lo; }
};

// The offset of plane k of planes `stride` long.
template <class Pl>
__device__ __forceinline__ typename Pl::Off plane_off(int k, int stride) {
  return (typename Pl::Off)k * stride;
}

// Predict (gravity, the ext force when f is given, damping, clamps) of
// particle a, with the lambda reset / decay folded in: lam_src may alias
// lam_dst, since only particle a's entries are touched.  lam_t (the tet
// multipliers, 6 planes) is null when the state has none.  w, pred and the
// multipliers in the layout of pl, the rest in global memory.
template <class Pl>
__device__ __forceinline__ void predict_one(const LatticeParams& p,
                                            const Pl& pl, int a,
                                            const float* x, float* v,
                                            const float* w, const float* f,
                                            float* pred, const float* lam_src,
                                            float* lam_dst, float* lam_t) {
  const int n = p.n, ps = pl.stride(), ga = pl.glob(a);
  const float wa = w[a];
  for (int c = 0; c < 3; ++c) {
    float vc = v[c * n + ga];
    const float g = p.gravity[c];
    float e = f ? f[c * n + ga] : 0.f;
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
    float pc = x[c * n + ga] + p.dt * vc;
    if (p.world_bounds > 0.f)
      pc = clampf(pc, -p.world_bounds, p.world_bounds);
    v[c * n + ga] = vc;
    pred[c * ps + a] = pc;
  }
  for (int fi = 0; fi < p.nfam; ++fi) {
    const auto i = plane_off<Pl>(fi, ps) + a;
    lam_dst[i] = p.lambda_mode == 0 ? 0.f : lam_src[i] * p.lambda_decay;
  }
  // tet multipliers are fresh every substep except in DECAY
  if (lam_t)
    for (int pi = 0; pi < 6; ++pi) {
      const size_t i = (size_t)pi * n + ga;
      lam_t[i] = p.lambda_mode == 1 ? lam_t[i] * p.lambda_decay : 0.f;
    }
}

// Predict of n particles, one thread each (the slab kernel's and the
// per-pass loop's launch).
__global__ void predict_kernel(LatticeParams p, const float* __restrict__ x,
                               float* __restrict__ v,
                               const float* __restrict__ w,
                               const float* __restrict__ f,
                               float* __restrict__ pred,
                               const float* lam_src, float* lam_dst,
                               float* __restrict__ lam_t) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= p.n) return;
  predict_one(p, GlobalPlanes{p}, a, x, v, w, f, pred, lam_src, lam_dst,
              lam_t);
}

// ---- the lattice kernel's particles, partners and passes ----------------

// the tet sweep's scratch planes: 72 endpoint terms, then the tables
#define TET_TDEG 72
#define TET_VALID 73
#define TET_PLANES 74

// A particle of an ensemble of bodies stored one after another (body b's
// particle l at a = b * body_n + l), and its lattice coordinates within
// its body (c = y * res + z, the lane).
struct Cell {
  int a, base, x, c, y, z;
};

__device__ __forceinline__ Cell cell_of(const LatticeParams& p, int a) {
  const int r2 = p.res * p.res;
  Cell q;
  q.a = a;
  q.base = (a / p.body_n) * p.body_n;
  const int l = a - q.base;
  q.x = l / r2;
  q.c = l - q.x * r2;
  q.y = q.c / p.res;
  q.z = q.c - q.y * p.res;
  return q;
}

// Roll-consistent neighbour at offset step * (dx, dy, dz) in the same
// body: x mod res, the lane y*res+z mod res^2, as the plain engine's rolls
// wrap, so no pass reads across a body boundary.
__device__ __forceinline__ Cell shift_cell(const LatticeParams& p,
                                           const Cell& q, int dx, int dy,
                                           int dz, int step) {
  const int res = p.res, r2 = res * res;
  const int k = dy * res + dz;
  Cell o;
  o.base = q.base;
  o.x = (q.x + step * dx + res) % res;
  o.c = (q.c + step * k + r2) % r2;
  o.y = o.c / res;
  o.z = o.c - o.y * res;
  o.a = q.base + o.x * r2 + o.c;
  return o;
}

// Along family f: step = +1 gives the partner a+d, step = -1 the anchor a-d
// whose partner is a.
__device__ __forceinline__ Cell step_cell(const LatticeParams& p, int f,
                                          const Cell& q, int step) {
  return shift_cell(p, q, p.fam[f][0], p.fam[f][1], p.fam[f][2], step);
}

__device__ __forceinline__ bool inside(const LatticeParams& p, int x, int y,
                                       int z) {
  return (unsigned)x < (unsigned)p.res && (unsigned)y < (unsigned)p.res &&
         (unsigned)z < (unsigned)p.res;
}

// The cell at (x, y, z) of q's body, inside it.
__device__ __forceinline__ int cell_index(const LatticeParams& p,
                                          const Cell& q, int x, int y,
                                          int z) {
  return q.base + (x * p.res + y) * p.res + z;
}

// Partners with the rolls' wrap (integer division on every read).
struct WrapNbr {
  // the partner a+d of a valid anchor
  __device__ static int fwd(const LatticeParams& p, int f, const Cell& q) {
    return step_cell(p, f, q, 1).a;
  }
  // the partner a+d of any anchor (WARM_START reads its inverse mass)
  __device__ static int fwd_any(const LatticeParams& p, int f,
                                const Cell& q) {
    return step_cell(p, f, q, 1).a;
  }
  // the anchor a-d whose constraint (a-d, a) the mask keeps, if any
  __device__ static bool back(const LatticeParams& p, int f, int sel,
                              const Cell& q, Cell& bw) {
    bw = step_cell(p, f, q, -1);
    return fam_mask(p, f, sel, bw.x, bw.y, bw.z);
  }
  // a tet corner at +o of a cell (every cell; an invalid one's are masked)
  __device__ static int corner(const LatticeParams& p, const Cell& q,
                               const int* o) {
    return shift_cell(p, q, o[0], o[1], o[2], 1).a;
  }
  // the cell at -o whose path has q as that corner; false where its terms
  // are known to be zero
  __device__ static bool anchor(const LatticeParams& p, const Cell& q,
                                const int* o, int& src) {
    src = shift_cell(p, q, o[0], o[1], o[2], -1).a;
    return true;
  }
};

// Partners by offset from carried coordinates.  A valid anchor's partner,
// a kept backward anchor and a valid cell's corners lie inside the body, so
// no wrap is taken there.  Outside the body a wrapped partner is masked:
// the backward anchor is dropped (its mask is false), an invalid cell's
// corner is clamped into the body (its multiplier step is 0 whatever it
// reads), and an anchor outside the body is skipped in the tet apply (its
// wrapped cell is invalid, so its terms are +-0, and adding +-0 to a sum
// that starts at +0 changes no bit).  Only WARM_START's inverse mass of an
// invalid anchor's partner, which sets that anchor's carried multiplier,
// takes the wrap's division.
struct FastNbr {
  __device__ static int fwd(const LatticeParams& p, int f, const Cell& q) {
    return cell_index(p, q, q.x + p.fam[f][0], q.y + p.fam[f][1],
                      q.z + p.fam[f][2]);
  }
  __device__ static int fwd_any(const LatticeParams& p, int f,
                                const Cell& q) {
    const int x = q.x + p.fam[f][0], y = q.y + p.fam[f][1],
              z = q.z + p.fam[f][2];
    return inside(p, x, y, z) ? cell_index(p, q, x, y, z)
                              : step_cell(p, f, q, 1).a;
  }
  __device__ static bool back(const LatticeParams& p, int f, int sel,
                              const Cell& q, Cell& bw) {
    bw.x = q.x - p.fam[f][0];
    bw.y = q.y - p.fam[f][1];
    bw.z = q.z - p.fam[f][2];
    if (!inside(p, bw.x, bw.y, bw.z)) return false;
    bw.a = cell_index(p, q, bw.x, bw.y, bw.z);
    return fam_mask(p, f, sel, bw.x, bw.y, bw.z);
  }
  __device__ static int corner(const LatticeParams& p, const Cell& q,
                               const int* o) {
    const int hi = p.res - 1;
    return cell_index(p, q, min(max(q.x + o[0], 0), hi),
                      min(max(q.y + o[1], 0), hi),
                      min(max(q.z + o[2], 0), hi));
  }
  __device__ static bool anchor(const LatticeParams& p, const Cell& q,
                                const int* o, int& src) {
    const int x = q.x - o[0], y = q.y - o[1], z = q.z - o[2];
    if (!inside(p, x, y, z)) return false;
    src = cell_index(p, q, x, y, z);
    return true;
  }
};

// WARM_START's pre-apply of family f at particle q: the carried multiplier
// (SOR fraction, clamp) moves a along its own constraint (a, a+d) and the
// one anchored at a-d; o gets the new position, lam_out[a] the multiplier.
// Every read is issued before the first write, so a thread waits for
// memory once a pass.
template <class Nbr, class Pl>
__device__ __forceinline__ void warm_one(const LatticeParams& p, const Pl& pl,
                                         int f, const Cell& q, const float* w,
                                         const float* pin,
                                         const float* lam_in, float* lam_out,
                                         float o[3]) {
  const int n = pl.stride(), a = q.a;
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[n + a], pin[2 * n + a]};
  const float lam_in_a = lam_in[a];
  const float wf = w[Nbr::fwd_any(p, f, q)];
  const bool own = fam_valid(p, f, q.x, q.y, q.z);
  float pf[3] = {0.f, 0.f, 0.f};
  if (own) {
    const int fw = Nbr::fwd(p, f, q);
    for (int c = 0; c < 3; ++c) pf[c] = pin[c * n + fw];
  }
  Cell bw;
  const bool back = Nbr::back(p, f, -1, q, bw);
  float pb[3] = {0.f, 0.f, 0.f}, wb = 0.f, lam_in_b = 0.f;
  if (back) {
    for (int c = 0; c < 3; ++c) pb[c] = pin[c * n + bw.a];
    wb = w[bw.a];
    lam_in_b = lam_in[bw.a];
  }
  for (int c = 0; c < 3; ++c) o[c] = pa[c];

  const float lam_a = warm_lambda(p, f, lam_in_a, wa, wf);
  if (own) {
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = pf[c] - pa[c];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    const float s = lam_a / len;
    for (int c = 0; c < 3; ++c) o[c] = pa[c] - wa * (d[c] * s);
  }
  if (back) {
    const float lam_b = warm_lambda(p, f, lam_in_b, wb, wa);
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = pa[c] - pb[c];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    const float s = lam_b / len;
    for (int c = 0; c < 3; ++c) o[c] = o[c] + wa * (d[c] * s);
  }
  lam_out[a] = lam_a;
}

// An edge's length for a family pass: sqrt(max(|d|^2, 1e-24)), or with
// approx_math |d|^2 * rsqrt(max(|d|^2, 1e-24)), *inv then holding that
// rsqrt, by which the correction's scale multiplies in place of dividing
// by the length (lattice_pallas.py:1053-1056, :1099).
__device__ __forceinline__ float edge_length(const LatticeParams& p,
                                             const float d[3], float* inv) {
  const float len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  if (p.approx_math) {
    *inv = rsqrtf(fmaxf(len_sq, 1e-24f));
    return len_sq * *inv;
  }
  *inv = 0.f;
  return sqrtf(fmaxf(len_sq, 1e-24f));
}

// One family pass at particle q (sel -1 JACOBI, 0 / 1 a COLORED parity
// class): gather-only.  It computes its own constraint (a, a+d) -- the
// lambda it writes -- and recomputes, from the same pass-entry inputs, the
// constraint anchored at a-d; o gets p_a - w_a*dp_a + w_a*dp_{a-d}, the
// term order of _family_pass.  Every read is issued before the first
// write, so a thread waits for memory once a pass.
template <class Nbr, class Pl>
__device__ __forceinline__ void family_one(const LatticeParams& p,
                                           const Pl& pl, int f, int sel,
                                           int jacobi, const Cell& q,
                                           const float* w, const float* pin,
                                           const float* lam_in,
                                           float* lam_out, float o[3]) {
  const int n = pl.stride(), a = q.a;
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[n + a], pin[2 * n + a]};
  const float lam_a = lam_in[a];
  const bool own = fam_mask(p, f, sel, q.x, q.y, q.z);
  float pf[3] = {0.f, 0.f, 0.f}, wf = 0.f;
  if (own) {
    const int fw = Nbr::fwd(p, f, q);
    for (int c = 0; c < 3; ++c) pf[c] = pin[c * n + fw];
    wf = w[fw];
  }
  Cell bw;
  const bool back = Nbr::back(p, f, sel, q, bw);
  float pb[3] = {0.f, 0.f, 0.f}, wb = 0.f, lam_b = 0.f;
  if (back) {
    for (int c = 0; c < 3; ++c) pb[c] = pin[c * n + bw.a];
    wb = w[bw.a];
    lam_b = lam_in[bw.a];
  }
  for (int c = 0; c < 3; ++c) o[c] = pa[c];

  // own constraint (a, a+d)
  float dl_a = 0.f;
  if (own) {
    float d[3], inv;
    for (int c = 0; c < 3; ++c) d[c] = pf[c] - pa[c];
    const float len = edge_length(p, d, &inv);
    dl_a = constraint_dl(p, f, len, wa, wf, lam_a, jacobi);
    const float s = p.approx_math ? dl_a * inv : dl_a / len;
    for (int c = 0; c < 3; ++c) o[c] = pa[c] - wa * (d[c] * s);
  }
  float lam_new = lam_a + dl_a;
  if (p.lambda_clamp > 0.f)
    lam_new = clampf(lam_new, -p.lambda_clamp, p.lambda_clamp);

  // the constraint (a-d, a), recomputed from the pass-entry inputs
  if (back) {
    float d[3], inv;
    for (int c = 0; c < 3; ++c) d[c] = pa[c] - pb[c];
    const float len = edge_length(p, d, &inv);
    const float dl_b = constraint_dl(p, f, len, wb, wa, lam_b, jacobi);
    const float s = p.approx_math ? dl_b * inv : dl_b / len;
    for (int c = 0; c < 3; ++c) o[c] = o[c] + wa * (d[c] * s);
  }
  lam_out[a] = lam_new;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The tet sweep's tables at particle q: terms plane TET_TDEG holds its tet
// degree (the valid cells whose paths have it as a corner: the anchor
// q - o_k of corner k must lie in [0, res - 2]^3), plane TET_VALID 1 where
// the cell anchored at q is valid, else 0.
template <class Pl>
__device__ __forceinline__ void tet_tables_one(const LatticeParams& p,
                                               const Pl& pl, const Cell& q,
                                               float* terms) {
  const int n = p.n, ga = pl.glob(q.a);
  const int cmax = p.res - 2;   // a valid cell's largest coordinate
  float tdeg = 0.f;
  for (int pi = 0; pi < 6; ++pi) {
    for (int k = 0; k < 4; ++k) {
      int ox = 0, oy = 0, oz = 0;
      if (k > 0) {
        ox = p.tet_off[pi][k - 1][0];
        oy = p.tet_off[pi][k - 1][1];
        oz = p.tet_off[pi][k - 1][2];
      }
      const int ax = q.x - ox, ay = q.y - oy, az = q.z - oz;
      if (ax >= 0 && ax <= cmax && ay >= 0 && ay <= cmax && az >= 0 &&
          az <= cmax)
        tdeg += 1.f;
    }
  }
  terms[(size_t)TET_TDEG * n + ga] = tdeg;
  terms[(size_t)TET_VALID * n + ga] =
      q.x <= cmax && q.y <= cmax && q.z <= cmax ? 1.f : 0.f;
}

// The tet sweep's projection at cell q, the anchor (origin corner) of the
// 6 Kuhn paths: updates their multipliers in place and writes dl*g_k for
// corners k = 0..3 to terms[((pi*4 + k)*3 + c)*n + a].
template <class Nbr, class Pl>
__device__ __forceinline__ void tet_cell_one(const LatticeParams& p,
                                             const Pl& pl, const Cell& q,
                                             const float* w,
                                             const float* pin, float* lam_t,
                                             float* terms) {
  const int n = p.n, ps = pl.stride(), a = q.a, ga = pl.glob(a);
  const bool valid = terms[(size_t)TET_VALID * n + ga] != 0.f;
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[ps + a], pin[2 * ps + a]};
  for (int pi = 0; pi < 6; ++pi) {
    float e[3][3], wk[3], g[4][3];
    for (int k = 0; k < 3; ++k) {
      const int ck = Nbr::corner(p, q, p.tet_off[pi][k]);
      for (int c = 0; c < 3; ++c) e[k][c] = pin[c * ps + ck] - pa[c];
      wk[k] = w[ck];
    }
    cross3(e[1], e[2], g[1]);
    cross3(e[2], e[0], g[2]);
    cross3(e[0], e[1], g[3]);
    for (int c = 0; c < 3; ++c) g[0][c] = -((g[1][c] + g[2][c]) + g[3][c]);
    const float cerr = dot3(e[0], g[1]) - p.tet_target;
    const float denom = wa * dot3(g[0], g[0]) + wk[0] * dot3(g[1], g[1]) +
                        wk[1] * dot3(g[2], g[2]) + wk[2] * dot3(g[3], g[3]) +
                        p.tet_alpha;
    const size_t li = (size_t)pi * n + ga;
    const float lam = lam_t[li];
    const float num = -cerr - p.tet_alpha * lam;
    float dl = p.approx_math ? num * approx_rcp(fmaxf(denom, 1e-30f))
                             : num / fmaxf(denom, 1e-30f);
    dl = (valid && denom > p.eps_denominator ? dl : 0.f) * p.tet_omega;
    lam_t[li] = lam + dl;
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c)
        terms[((size_t)(pi * 4 + k) * 3 + c) * n + ga] = dl * g[k][c];
  }
}

// The tet sweep's apply at particle q: its terms summed in the plain
// engine's order, path by path (g0 at its own cell, then g1, g2, g3 from
// the cells at -o1, -o2, -o3); o = pin + w / max(tdeg, 1) * the sum.
template <class Nbr, class Pl>
__device__ __forceinline__ void tet_apply_one(const LatticeParams& p,
                                              const Pl& pl, const Cell& q,
                                              const float* w,
                                              const float* pin,
                                              const float* terms,
                                              float o[3]) {
  const int n = p.n, ps = pl.stride(), a = q.a;
  float delta[3] = {0.f, 0.f, 0.f};
  for (int pi = 0; pi < 6; ++pi) {
    for (int k = 0; k < 4; ++k) {
      int src = a;
      if (k > 0 && !Nbr::anchor(p, q, p.tet_off[pi][k - 1], src)) continue;
      for (int c = 0; c < 3; ++c)
        delta[c] = delta[c] +
                   terms[((size_t)(pi * 4 + k) * 3 + c) * n + pl.glob(src)];
    }
  }
  const float tdeg = terms[(size_t)TET_TDEG * n + pl.glob(a)];
  const float coef = w[a] / fmaxf(tdeg, 1.f);
  for (int c = 0; c < 3; ++c) o[c] = pin[c * ps + a] + coef * delta[c];
}

// Contacts of one iteration (XPBD floor, boxes, spheres) on particle a's
// iterate pc, stored to pred[a]; or, after the last iteration, finalize
// (velocity from the position change, pinned particles held,
// VELOCITY_REFLECT floor) into x and v, pred left alone.  tab: the
// collider table (colliders.cuh).
template <class Pl>
__device__ __forceinline__ void contact_finalize_one(
    const LatticeParams& p, const Pl& pl, int do_contacts, int do_finalize,
    int a, float* x, float* v, const float* w, float pc[3], const float* tab,
    float* pred) {
  const int n = p.n, ps = pl.stride(), ga = pl.glob(a);
  const float wa = w[a];
  float xc[3] = {x[ga], x[n + ga], x[2 * n + ga]};
  const float gh = tab[0];

  if (do_contacts) {
    if (p.floor_mode == 1) {
      const float pen = gh - pc[1];
      const float denom = wa + p.floor_alpha;
      const float dl = pen / fmaxf(denom, 1e-30f);
      const bool hit = pen > 0.f && wa >= p.static_eps &&
                       fabsf(denom) >= p.eps_denominator;
      if (hit) {
        const float p0 = pc[0] - (pc[0] - xc[0]) * p.friction;
        const float p1 = pc[1] + wa * dl;
        const float p2 = pc[2] - (pc[2] - xc[2]) * p.friction;
        pc[0] = p0;
        pc[1] = p1;
        pc[2] = p2;
      }
    }
    for (int b = 0; b < p.n_boxes; ++b)
      box_project(box_row(tab, p.n_spheres, b), wa, p.static_eps, p.dt,
                  p.box_dt_fr, xc, pc);
    for (int s = 0; s < p.n_spheres; ++s) {
      const float* r = sphere_row(tab, s);
      float dv[3], nrm[3], vel[3];
      for (int c = 0; c < 3; ++c) dv[c] = pc[c] - r[c];
      const float dist = sqrtf(
          fmaxf(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], 1e-24f));
      for (int c = 0; c < 3; ++c) nrm[c] = dv[c] / dist;
      const float penet = r[3] - dist;
      const bool act = penet > 0.f && wa >= p.static_eps;
      if (act)
        for (int c = 0; c < 3; ++c) pc[c] = pc[c] + nrm[c] * penet;
      // friction relative to the collider's velocity (0 for the config's)
      for (int c = 0; c < 3; ++c) vel[c] = (pc[c] - xc[c]) / p.dt - r[4 + c];
      const float vdot = vel[0] * nrm[0] + vel[1] * nrm[1] + vel[2] * nrm[2];
      if (act)
        for (int c = 0; c < 3; ++c)
          pc[c] = pc[c] - (vel[c] - vdot * nrm[c]) * p.sphere_dt_fr;
    }
  }

  if (!do_finalize) {
    for (int c = 0; c < 3; ++c) pred[c * ps + a] = pc[c];
    return;
  }
  const bool pinned = wa == 0.f;
  float vc[3];
  for (int c = 0; c < 3; ++c) {
    vc[c] = pinned ? 0.f : (pc[c] - xc[c]) / p.dt;
    xc[c] = pinned ? xc[c] : pc[c];
  }
  if (p.floor_mode == 2) {
    const float pen = gh - xc[1];
    const bool hit = pen > 0.f && wa > 0.f;
    const bool falling = hit && vc[1] < 0.f;
    const float vy = fabsf(vc[1]) * p.restitution + pen * p.penetration_kick;
    const float v1 = falling ? vy : vc[1];
    const float normal_force = fabsf(v1) + pen * p.normal_force_scale;
    const float h_speed =
        sqrtf(fmaxf(vc[0] * vc[0] + vc[2] * vc[2], 1e-24f));
    const bool moving = h_speed > 1e-3f;
    const float fmag =
        fminf(h_speed, normal_force * p.floor_friction_coeff * p.dt);
    const float scalef = (falling && moving) ? fmag / h_speed : 0.f;
    if (hit) xc[1] = gh + p.floor_offset;
    vc[0] = vc[0] - vc[0] * scalef;
    vc[1] = v1;
    vc[2] = vc[2] - vc[2] * scalef;
  }
  for (int c = 0; c < 3; ++c) {
    x[c * n + ga] = xc[c];
    v[c * n + ga] = vc[c];
  }
}
