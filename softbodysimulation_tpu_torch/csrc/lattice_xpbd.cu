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
// Each substep is one launch per pass on the caller's stream, with no host
// sync inside the loop:
//   predict (gravity, first-substep ext force, damping, clamps) with the
//     lambda reset / decay folded in;
//   WARM_START: one pre-apply pass per family;
//   per iteration: one pass per family (JACOBI) or two parity passes
//     (COLORED), then the XPBD floor and sphere contacts; the last
//     iteration's contacts share a launch with finalize (VELOCITY_REFLECT).
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
// Floats stay IEEE (built without --use_fast_math): sqrtf and '/' as in the
// exact engines; only FMA contraction differs, at ulp level.

#include <cuda_runtime.h>

#define LX_MAX_FAM 16
#define LX_MAX_SPHERES 16
#define LX_THREADS 256

// Every field is 4 bytes wide, so the ctypes mirror has no padding.
struct LatticeParams {
  int res;
  int n;             // res^3
  int nfam;
  int iterations;
  int colored;       // SolveMode.COLORED (else JACOBI)
  int lambda_mode;   // 0 RESET, 1 DECAY, 2 WARM_START
  int fast_math;
  int gravity_acc;   // gravity_is_acceleration
  int floor_mode;    // 0 NONE, 1 XPBD_INEQUALITY, 2 VELOCITY_REFLECT
  int reference_bounds;
  int n_spheres;
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
  float ground_height;
  float floor_alpha;        // collision_compliance / dt^2
  float friction;           // clamped to [0, 1]
  float sphere_dt_fr;       // dt * friction
  float floor_rest;         // ground_height + floor_offset
  float restitution;
  float penetration_kick;
  float normal_force_scale;
  float floor_friction_coeff;
  float rest[LX_MAX_FAM];
  float alpha[LX_MAX_FAM];     // max(compliance / dt^2, min_alpha_tilde)
  float dl_rel[LX_MAX_FAM];    // max_dlambda_rel * rest (0 = off)
  float warm_lim[LX_MAX_FAM];  // warm_start_clamp * rest (0 = off)
  float spheres[LX_MAX_SPHERES][4];
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

// The multiplier step of one distance constraint, given its current length
// and the inverse masses of its anchor (wa) and partner (wb): the arithmetic
// of solvers/lattice.py::_family_pass for an anchor whose mask is set.
__device__ __forceinline__ float constraint_dl(const LatticeParams& p, int f,
                                               float len, float wa, float wb,
                                               float lam, int jacobi) {
  const float alpha = p.alpha[f];
  const float c = len - p.rest[f];
  const float denom = wa + wb + alpha;
  float dl = (-c - alpha * lam) / fmaxf(denom, 1e-30f);
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

struct Cell {
  int a, x, c, y, z;
};

__device__ __forceinline__ Cell cell_of(const LatticeParams& p, int a) {
  const int r2 = p.res * p.res;
  Cell q;
  q.a = a;
  q.x = a / r2;
  q.c = a - q.x * r2;
  q.y = q.c / p.res;
  q.z = q.c - q.y * p.res;
  return q;
}

// Roll-consistent neighbour along family f: step = +1 gives the partner
// a+d, step = -1 the anchor a-d whose partner is a.
__device__ __forceinline__ Cell step_cell(const LatticeParams& p, int f,
                                          const Cell& q, int step) {
  const int res = p.res, r2 = res * res;
  const int k = p.fam[f][1] * res + p.fam[f][2];
  Cell o;
  o.x = (q.x + step * p.fam[f][0] + res) % res;
  o.c = (q.c + step * k + r2) % r2;
  o.y = o.c / res;
  o.z = o.c - o.y * res;
  o.a = o.x * r2 + o.c;
  return o;
}

__global__ void predict_kernel(LatticeParams p, const float* __restrict__ x,
                               float* __restrict__ v,
                               const float* __restrict__ w,
                               const float* __restrict__ f,
                               float* __restrict__ pred,
                               const float* lam_src, float* lam_dst) {
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
  // lam_src may alias lam_dst: each thread touches only its own entries
  for (int fi = 0; fi < p.nfam; ++fi) {
    const size_t i = (size_t)fi * n + a;
    lam_dst[i] = p.lambda_mode == 0 ? 0.f : lam_src[i] * p.lambda_decay;
  }
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
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = pin[c * n + fw.a] - pa[c];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    dl_a = constraint_dl(p, f, len, wa, w[fw.a], lam_a, jacobi);
    const float s = dl_a / len;
    for (int c = 0; c < 3; ++c) o[c] = pa[c] - wa * (d[c] * s);
  }
  float lam_new = lam_a + dl_a;
  if (p.lambda_clamp > 0.f)
    lam_new = clampf(lam_new, -p.lambda_clamp, p.lambda_clamp);
  lam_out[a] = lam_new;

  // the constraint (a-d, a), recomputed from the pass-entry inputs
  const Cell bw = step_cell(p, f, q, -1);
  if (fam_mask(p, f, sel, bw.x, bw.y, bw.z)) {
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = pa[c] - pin[c * n + bw.a];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    const float dl_b =
        constraint_dl(p, f, len, w[bw.a], wa, lam_in[bw.a], jacobi);
    const float s = dl_b / len;
    for (int c = 0; c < 3; ++c) o[c] = o[c] + wa * (d[c] * s);
  }
  for (int c = 0; c < 3; ++c) pout[c * n + a] = o[c];
}

// Contacts of one iteration (XPBD floor, static spheres) on pred in place,
// and, after the last iteration, finalize (velocity from the position
// change, pinned particles held, VELOCITY_REFLECT floor) into x and v.
__global__ void contact_finalize_kernel(LatticeParams p, int do_contacts,
                                        int do_finalize,
                                        float* __restrict__ x,
                                        float* __restrict__ v,
                                        const float* __restrict__ w,
                                        float* __restrict__ pred) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (a >= n) return;
  const float wa = w[a];
  float pc[3] = {pred[a], pred[n + a], pred[2 * n + a]};
  float xc[3] = {x[a], x[n + a], x[2 * n + a]};

  if (do_contacts) {
    if (p.floor_mode == 1) {
      const float pen = p.ground_height - pc[1];
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
    for (int s = 0; s < p.n_spheres; ++s) {
      float dv[3], nrm[3], vel[3];
      for (int c = 0; c < 3; ++c) dv[c] = pc[c] - p.spheres[s][c];
      const float dist = sqrtf(
          fmaxf(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], 1e-24f));
      for (int c = 0; c < 3; ++c) nrm[c] = dv[c] / dist;
      const float penet = p.spheres[s][3] - dist;
      const bool act = penet > 0.f && wa >= p.static_eps;
      if (act)
        for (int c = 0; c < 3; ++c) pc[c] = pc[c] + nrm[c] * penet;
      for (int c = 0; c < 3; ++c) vel[c] = (pc[c] - xc[c]) / p.dt;
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
    const float pen = p.ground_height - xc[1];
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
    if (hit) xc[1] = p.floor_rest;
    vc[0] = vc[0] - vc[0] * scalef;
    vc[1] = v1;
    vc[2] = vc[2] - vc[2] * scalef;
  }
  for (int c = 0; c < 3; ++c) {
    x[c * n + a] = xc[c];
    v[c * n + a] = vc[c];
  }
}

extern "C" {

int lattice_xpbd_params_size(void) { return (int)sizeof(LatticeParams); }

const char* lattice_xpbd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Advance n_substeps substeps on `stream`.  x, v: (3, N) in/out; w: (N);
// f: (3, N) ext force consumed on the first substep when ext_first, else
// unused; lam: (nfam, N) in/out; lam_scratch: (nfam, N) and pred_a,
// pred_b: (3, N) scratch.  *n_launched counts the kernels launched.
// Returns a cudaError_t; nothing is synchronised.
int lattice_xpbd_run(const LatticeParams* hp, int device, float* x, float* v,
                     const float* w, const float* f, int ext_first,
                     float* lam, float* lam_scratch, float* pred_a,
                     float* pred_b, int n_substeps, long long* n_launched,
                     void* stream_handle) {
  const LatticeParams p = *hp;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.nfam > LX_MAX_FAM || p.n_spheres > LX_MAX_SPHERES)
    return (int)cudaErrorInvalidValue;

  const dim3 grid((p.n + LX_THREADS - 1) / LX_THREADS);
  const dim3 block(LX_THREADS);
  const size_t plane = (size_t)p.n;
  const bool has_contacts = p.floor_mode == 1 || p.n_spheres > 0;
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

  for (int i = 0; i < n_substeps; ++i) {
    predict_kernel<<<grid, block, 0, stream>>>(
        p, x, v, w, (ext_first && i == 0) ? f : nullptr, pred_a,
        lam_buf[bit], lam_buf[0]);
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
      const bool last = it == p.iterations - 1;
      if (has_contacts || last) {
        contact_finalize_kernel<<<grid, block, 0, stream>>>(
            p, has_contacts ? 1 : 0, last ? 1 : 0, x, v, w, pin);
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
