// Braced-lattice XPBD substep loop for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernels softbodysimulation_tpu/kernels/lattice_pallas.py
// make_pallas_substep_runner_streamed (:501, kernel body :812) and
// make_pallas_substep_runner (:114, kernel body :211): a whole multi-substep
// lattice XPBD rollout.  It ports WHAT those kernels compute, the semantics
// of softbodysimulation_tpu/solvers/lattice.py::_substep, including the
// resident kernel's corner (joint g + ext clamping under max_force in
// force-unit gravity mode), and none of their VMEM machinery (lane padding,
// residency ladder, double-buffered lambda DMA).
//
// Layout: structure of arrays, x, v, pred (3, N) float32, w (N), lambda
// (nfam, N); particle index a = (x*res + y)*res + z, N = res^3.  The
// offset-family partner of a is taken with the wrap-around of the JAX
// engine's rolls (x mod res, y*res+z mod res^2), so every read is in bounds,
// and the family's validity mask, computed from integer coordinates, kills
// the wrapped constraints exactly as it does there.
//
// Ensembles (lattice_pallas.py n_bodies > 1, :545, :692, :868,
// :1596-1641): B bodies of one spec lie one after another, particle l of
// body b at a = b * res^3 + l in every plane (x, v, pred, w, ext, each
// lambda plane, the tet planes), so n = B * res^3 threads run one launch
// per pass for the whole ensemble.  cell_of and shift_cell take a
// particle's coordinates within its body, and its neighbours with the
// rolls' wrap inside that body: the CUDA form of the TPU kernel's lane
// index taken mod res^2.  The family masks and the tet tables are the one
// body's, so no pass reads across a body boundary, and each body's
// arithmetic is the single-body kernel's to the bit.  The collider table
// is shared: every body sees the same rigid world.  The TPU kernel's
// 128-lane padding has no counterpart.
//
// Each substep is one launch per pass on the caller's stream, with no host
// sync inside the loop:
//   predict (gravity, first-substep ext force, damping, clamps) with the
//     lambda reset / decay folded in (the tet multipliers' too);
//   WARM_START: one pre-apply pass per family;
//   per iteration: one pass per family (JACOBI) or two parity passes
//     (COLORED), then the per-cell tet sweep (two launches), then the
//     contacts -- the XPBD floor, the boxes, the spheres, the order of
//     solvers/lattice.py -- in one launch; the last iteration's contacts
//     share it with finalize (VELOCITY_REFLECT).
// The spheres and boxes come from the collider table of colliders.cuh (the
// config's constants, or a ColliderSet's traced poses and velocities, whose
// friction then acts on the velocity relative to the collider; the
// set's ground height replaces the config's).  A new pose is a new table,
// read by the next launch: the TPU kernel's box block
// (lattice_pallas.py:1360-1409) and pose table (:576-589) in one.
// A family pass is gather-only, with no atomics: thread a reads the
// pass-entry positions from one buffer and writes another (ping-pong).  It
// computes its own constraint (a, a+d) -- the lambda it writes -- and
// recomputes, from the same inputs with the same arithmetic, the constraint
// anchored at a-d; it writes p_a - w_a*dp_a + w_a*dp_{a-d}, the term order of
// _family_pass.  Lambda planes ping-pong the same way, because the a-d
// constraint reads the pass-entry multiplier at a-d.
//
// What bounds it on the card: at res 40 the state (x, v, two pred buffers,
// ext, w, 2 x 13 lambda planes) is about 10 MB and lives in the 50 MB L2, and
// a pass is ~100 flops per particle, so with about 15 launches of a
// 64k-thread grid per substep the launch overhead, not HBM or the ALUs,
// should set the pace.  The design does nothing about that yet, by choice:
// a persistent kernel, CUDA graphs or shared-memory slab tiling come later.
//
// The per-cell tet sweep (solvers/lattice.py::_tet_sweep; the TPU kernel's
// in-kernel sweep, lattice_pallas.py:591-659 and :1189) projects the 6 Kuhn
// paths of every cell against the same pred (Jacobi), then applies
// pred += w / max(tdeg, 1) * delta.  No atomics: tet_cell_kernel writes each
// path's multiplier and its four endpoint terms dl*g_k to per-endpoint
// planes (72 floats a particle, 18 MB at res 40, L2-resident), and
// tet_apply_kernel sums a particle's incidences in the plain engine's
// order, path by path: g0 at its own cell, then g1, g2, g3 from the cells
// at -o1, -o2, -o3 (with the rolls' wrap, whose cells carry dl = 0).  The
// tet degree and the valid-cell mask (_tet_fields' tdeg and valid) are two
// more planes of the same scratch, built once a run on the device by
// tet_tables_kernel from integer coordinates, so no table is uploaded.
// With that order the sweep equals the plain engine to the bit.
//
// Floats stay IEEE (built without --use_fast_math, with -fmad=false): sqrtf
// and '/' as in the exact engines, and no multiply-add is contracted.
//
// approx_math (lattice_pallas.py:152-185 resident, :1053-1061 and :1099
// streamed, :1281-1285 the tet sweep; the bench.py headline engine) swaps,
// in the family passes, the length's sqrt for |d|^2 * rsqrtf(|d|^2), the
// division of the multiplier step by its denominator for a product with
// the approximate reciprocal (__fdividef(1, x): rcp.approx) and the
// correction's division by the length for a product with that rsqrt; in
// the tet sweep the same reciprocal.  The warm pre-apply, the contacts and
// finalize stay exact, as in the TPU kernel.  The plain twin
// (solvers/lattice.py, approx_math=True) takes torch.rsqrt and
// torch.reciprocal, which is IEEE: kernel and twin agree to a tolerance,
// not to the bit.  With approx_math off every pass is the exact engine's.

#include "lattice_xpbd.cuh"

#define LX_THREADS 256
// the tet sweep's scratch planes: 72 endpoint terms, then the tables
#define TET_TDEG 72
#define TET_VALID 73
#define TET_PLANES 74

// A particle of an ensemble of bodies stored one after another (body b's
// particle l at a = b * body_n + l), and its lattice coordinates within
// its body.
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

__global__ void warm_pass_kernel(LatticeParams p, int f,
                                 const float* __restrict__ w,
                                 const float* __restrict__ pin,
                                 float* __restrict__ pout,
                                 const float* __restrict__ lam_in,
                                 float* __restrict__ lam_out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const Cell q = cell_of(p, a);
  const Cell fw = step_cell(p, f, q, 1);
  const Cell bw = step_cell(p, f, q, -1);
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[n + a], pin[2 * n + a]};
  float o[3] = {pa[0], pa[1], pa[2]};

  const float lam_a = warm_lambda(p, f, lam_in[a], wa, w[fw.a]);
  lam_out[a] = lam_a;
  if (fam_valid(p, f, q.x, q.y, q.z)) {
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = pin[c * n + fw.a] - pa[c];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    const float s = lam_a / len;
    for (int c = 0; c < 3; ++c) o[c] = pa[c] - wa * (d[c] * s);
  }
  if (fam_valid(p, f, bw.x, bw.y, bw.z)) {
    const float lam_b = warm_lambda(p, f, lam_in[bw.a], w[bw.a], wa);
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = pa[c] - pin[c * n + bw.a];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    const float s = lam_b / len;
    for (int c = 0; c < 3; ++c) o[c] = o[c] + wa * (d[c] * s);
  }
  for (int c = 0; c < 3; ++c) pout[c * n + a] = o[c];
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

__global__ void family_pass_kernel(LatticeParams p, int f, int sel,
                                   int jacobi, const float* __restrict__ w,
                                   const float* __restrict__ pin,
                                   float* __restrict__ pout,
                                   const float* __restrict__ lam_in,
                                   float* __restrict__ lam_out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const Cell q = cell_of(p, a);
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[n + a], pin[2 * n + a]};
  float o[3] = {pa[0], pa[1], pa[2]};

  // own constraint (a, a+d)
  const float lam_a = lam_in[a];
  float dl_a = 0.f;
  if (fam_mask(p, f, sel, q.x, q.y, q.z)) {
    const Cell fw = step_cell(p, f, q, 1);
    float d[3], inv;
    for (int c = 0; c < 3; ++c) d[c] = pin[c * n + fw.a] - pa[c];
    const float len = edge_length(p, d, &inv);
    dl_a = constraint_dl(p, f, len, wa, w[fw.a], lam_a, jacobi);
    const float s = p.approx_math ? dl_a * inv : dl_a / len;
    for (int c = 0; c < 3; ++c) o[c] = pa[c] - wa * (d[c] * s);
  }
  float lam_new = lam_a + dl_a;
  if (p.lambda_clamp > 0.f)
    lam_new = clampf(lam_new, -p.lambda_clamp, p.lambda_clamp);
  lam_out[a] = lam_new;

  // the constraint (a-d, a), recomputed from the pass-entry inputs
  const Cell bw = step_cell(p, f, q, -1);
  if (fam_mask(p, f, sel, bw.x, bw.y, bw.z)) {
    float d[3], inv;
    for (int c = 0; c < 3; ++c) d[c] = pa[c] - pin[c * n + bw.a];
    const float len = edge_length(p, d, &inv);
    const float dl_b =
        constraint_dl(p, f, len, w[bw.a], wa, lam_in[bw.a], jacobi);
    const float s = p.approx_math ? dl_b * inv : dl_b / len;
    for (int c = 0; c < 3; ++c) o[c] = o[c] + wa * (d[c] * s);
  }
  for (int c = 0; c < 3; ++c) pout[c * n + a] = o[c];
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

// The tet sweep's tables, once a run: terms plane TET_TDEG holds each
// particle's tet degree (the valid cells whose paths have it as a corner:
// the anchor q - o_k of corner k must lie in [0, res - 2]^3), plane
// TET_VALID 1 where the cell anchored at the particle is valid, else 0.
__global__ void tet_tables_kernel(LatticeParams p, float* __restrict__ terms) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const Cell q = cell_of(p, a);
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
  terms[(size_t)TET_TDEG * n + a] = tdeg;
  terms[(size_t)TET_VALID * n + a] =
      q.x <= cmax && q.y <= cmax && q.z <= cmax ? 1.f : 0.f;
}

// The tet sweep's projection: thread a is the anchor cell (origin corner)
// of the 6 Kuhn paths; it updates their multipliers in place and writes
// dl*g_k for corners k = 0..3 to terms[((pi*4 + k)*3 + c)*n + a].
__global__ void tet_cell_kernel(LatticeParams p, const float* __restrict__ w,
                                const float* __restrict__ pin,
                                float* __restrict__ lam_t,
                                float* __restrict__ terms) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const Cell q = cell_of(p, a);
  const bool valid = terms[(size_t)TET_VALID * n + a] != 0.f;
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[n + a], pin[2 * n + a]};
  for (int pi = 0; pi < 6; ++pi) {
    float e[3][3], wk[3], g[4][3];
    for (int k = 0; k < 3; ++k) {
      const int* o = p.tet_off[pi][k];
      const Cell ck = shift_cell(p, q, o[0], o[1], o[2], 1);
      for (int c = 0; c < 3; ++c) e[k][c] = pin[c * n + ck.a] - pa[c];
      wk[k] = w[ck.a];
    }
    cross3(e[1], e[2], g[1]);
    cross3(e[2], e[0], g[2]);
    cross3(e[0], e[1], g[3]);
    for (int c = 0; c < 3; ++c) g[0][c] = -((g[1][c] + g[2][c]) + g[3][c]);
    const float cerr = dot3(e[0], g[1]) - p.tet_target;
    const float denom = wa * dot3(g[0], g[0]) + wk[0] * dot3(g[1], g[1]) +
                        wk[1] * dot3(g[2], g[2]) + wk[2] * dot3(g[3], g[3]) +
                        p.tet_alpha;
    const size_t li = (size_t)pi * n + a;
    const float lam = lam_t[li];
    const float num = -cerr - p.tet_alpha * lam;
    float dl = p.approx_math ? num * approx_rcp(fmaxf(denom, 1e-30f))
                             : num / fmaxf(denom, 1e-30f);
    dl = (valid && denom > p.eps_denominator ? dl : 0.f) * p.tet_omega;
    lam_t[li] = lam + dl;
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c)
        terms[((size_t)(pi * 4 + k) * 3 + c) * n + a] = dl * g[k][c];
  }
}

// The tet sweep's apply: particle a sums its terms in the plain engine's
// order and moves by w / max(tdeg, 1) times the sum.
__global__ void tet_apply_kernel(LatticeParams p, const float* __restrict__ w,
                                 const float* __restrict__ pin,
                                 const float* __restrict__ terms,
                                 float* __restrict__ pout) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const Cell q = cell_of(p, a);
  float delta[3] = {0.f, 0.f, 0.f};
  for (int pi = 0; pi < 6; ++pi) {
    for (int k = 0; k < 4; ++k) {
      int src = a;
      if (k > 0) {
        const int* o = p.tet_off[pi][k - 1];
        src = shift_cell(p, q, o[0], o[1], o[2], -1).a;
      }
      for (int c = 0; c < 3; ++c)
        delta[c] = delta[c] + terms[((size_t)(pi * 4 + k) * 3 + c) * n + src];
    }
  }
  const float tdeg = terms[(size_t)TET_TDEG * n + a];
  const float coef = w[a] / fmaxf(tdeg, 1.f);
  for (int c = 0; c < 3; ++c)
    pout[c * n + a] = pin[c * n + a] + coef * delta[c];
}

// Contacts of one iteration (XPBD floor, boxes, spheres) on pred in place,
// and, after the last iteration, finalize (velocity from the position
// change, pinned particles held, VELOCITY_REFLECT floor) into x and v.
// tab: the collider table (colliders.cuh).
__global__ void contact_finalize_kernel(LatticeParams p, int do_contacts,
                                        int do_finalize,
                                        float* __restrict__ x,
                                        float* __restrict__ v,
                                        const float* __restrict__ w,
                                        float* __restrict__ pred,
                                        const float* __restrict__ tab) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const float wa = w[a];
  float pc[3] = {pred[a], pred[n + a], pred[2 * n + a]};
  float xc[3] = {x[a], x[n + a], x[2 * n + a]};
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
    for (int c = 0; c < 3; ++c) pred[c * n + a] = pc[c];
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
    x[c * n + a] = xc[c];
    v[c * n + a] = vc[c];
  }
}

// A diagnostic off every path: out[i] = rsqrtf(x[i]) and out[n + i] =
// approx_rcp(x[i]), the approx variant's two intrinsics, for holding them
// against torch.rsqrt and torch.reciprocal on the card (chip_smoke.py).
__global__ void approx_probe_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = rsqrtf(x[i]);
  out[n + i] = approx_rcp(x[i]);
}

extern "C" {

int lattice_xpbd_params_size(void) { return (int)sizeof(LatticeParams); }

// approx_probe_kernel over n floats on `stream`; returns a cudaError_t.
int lattice_xpbd_approx_probe(const float* x, float* out, int n,
                              void* stream_handle) {
  approx_probe_kernel<<<(n + LX_THREADS - 1) / LX_THREADS, LX_THREADS, 0,
                        (cudaStream_t)stream_handle>>>(x, out, n);
  return (int)cudaGetLastError();
}

const char* lattice_xpbd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Advance n_substeps substeps on `stream`.  x, v: (3, N) in/out; w: (N);
// f: (3, N) ext force consumed on the first substep when ext_first, else
// unused; lam: (nfam, N) in/out; lam_scratch: (nfam, N) and pred_a,
// pred_b: (3, N) scratch; lam_t: (6, N) tet multipliers in/out, or null
// when the state has none; tet_terms: (TET_PLANES, N) scratch when p.tets;
// colliders: the collider table (1 + n_spheres + n_boxes, KIN_W).
// *n_launched counts the kernels launched.  Returns a cudaError_t;
// nothing is synchronised.
int lattice_xpbd_run(const LatticeParams* hp, int device, float* x, float* v,
                     const float* w, const float* f, int ext_first,
                     float* lam, float* lam_scratch, float* pred_a,
                     float* pred_b, float* lam_t, float* tet_terms,
                     const float* colliders, int n_substeps,
                     long long* n_launched, void* stream_handle) {
  const LatticeParams p = *hp;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.nfam > LX_MAX_FAM || p.n_spheres > LX_MAX_SPHERES ||
      p.n_boxes > LX_MAX_BOXES || !colliders || p.body_n <= 0 ||
      p.n % p.body_n != 0 || (p.tets && (!lam_t || !tet_terms)))
    return (int)cudaErrorInvalidValue;

  const dim3 grid((p.n + LX_THREADS - 1) / LX_THREADS);
  const dim3 block(LX_THREADS);
  const size_t plane = (size_t)p.n;
  const bool has_contacts =
      p.floor_mode == 1 || p.n_spheres > 0 || p.n_boxes > 0;
  float* lam_buf[2] = {lam, lam_scratch};
  int bit = 0;  // the buffer holding every family's lambda between substeps

#define LX_CHECK()                                  \
  do {                                              \
    err = cudaGetLastError();                       \
    if (err != cudaSuccess) {                       \
      *n_launched = launched;                       \
      return (int)err;                              \
    }                                               \
    ++launched;                                     \
  } while (0)

  if (p.tets) {
    tet_tables_kernel<<<grid, block, 0, stream>>>(p, tet_terms);
    LX_CHECK();
  }
  for (int i = 0; i < n_substeps; ++i) {
    predict_kernel<<<grid, block, 0, stream>>>(
        p, x, v, w, (ext_first && i == 0) ? f : nullptr, pred_a,
        lam_buf[bit], lam_buf[0], lam_t);
    LX_CHECK();
    int fb[LX_MAX_FAM] = {0};
    float* pin = pred_a;
    float* pout = pred_b;
    if (p.lambda_mode == 2) {
      for (int fi = 0; fi < p.nfam; ++fi) {
        warm_pass_kernel<<<grid, block, 0, stream>>>(
            p, fi, w, pin, pout, lam_buf[fb[fi]] + fi * plane,
            lam_buf[fb[fi] ^ 1] + fi * plane);
        LX_CHECK();
        fb[fi] ^= 1;
        float* t = pin; pin = pout; pout = t;
      }
    }
    for (int it = 0; it < p.iterations; ++it) {
      for (int fi = 0; fi < p.nfam; ++fi) {
        const int n_pass = p.colored ? 2 : 1;
        for (int ps = 0; ps < n_pass; ++ps) {
          family_pass_kernel<<<grid, block, 0, stream>>>(
              p, fi, p.colored ? ps : -1, p.colored ? 0 : 1, w, pin, pout,
              lam_buf[fb[fi]] + fi * plane,
              lam_buf[fb[fi] ^ 1] + fi * plane);
          LX_CHECK();
          fb[fi] ^= 1;
          float* t = pin; pin = pout; pout = t;
        }
      }
      if (p.tets) {
        tet_cell_kernel<<<grid, block, 0, stream>>>(p, w, pin, lam_t,
                                                    tet_terms);
        LX_CHECK();
        tet_apply_kernel<<<grid, block, 0, stream>>>(p, w, pin, tet_terms,
                                                     pout);
        LX_CHECK();
        float* t = pin; pin = pout; pout = t;
      }
      const bool last = it == p.iterations - 1;
      if (has_contacts || last) {
        contact_finalize_kernel<<<grid, block, 0, stream>>>(
            p, has_contacts ? 1 : 0, last ? 1 : 0, x, v, w, pin, colliders);
        LX_CHECK();
      }
    }
    bit = fb[0];  // every family ran the same number of passes
  }
#undef LX_CHECK
  *n_launched = launched;
  if (bit) {
    err = cudaMemcpyAsync(lam, lam_scratch,
                          (size_t)p.nfam * plane * sizeof(float),
                          cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
