// Fused backward of the mesh kernel's distance-sweep substep loop for Hopper
// (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel softbodysimulation_tpu/kernels/mesh_diff_pallas.py
// _make_backward_chunk (:188, kernel body :278, pallas_call :895): the VJP
// of C substeps of the mesh kernel (mesh_xpbd.cu) in its envelope -- JACOBI
// distance sweeps (plain or Chebyshev), RESET / DECAY / WARM_START, the
// XPBD floor and spheres (the config's, or a ColliderSet's traced poses)
// -- linearized at the chunk-entry state, with optional per-edge
// rest-length and alpha cotangents (traced materials) and, for a
// ColliderSet, the pose cotangents of each sphere's center, radius and
// velocity and of the ground height (mesh_diff_pallas.py:503-617; its
// output layout :1076-1097).  Its plain version is kernels/mesh_diff.py::
// backward_chunk_plain, which has the same phases in the same order.
//
// This source is built into the mesh library, beside mesh_xpbd.cu.  Phase A
// replays the chunk with the forward's own passes (predict_kernel,
// edge_kernel, particle_kernel of mesh_xpbd.cu),
// so the linearization point is the forward trajectory to the bit, and
// stashes in global memory, per substep, the entry x and v (and with
// WARM_START the post-predict positions and the decayed multipliers) and,
// per iteration, the entry positions, multipliers and Chebyshev prev and
// the post-sweep positions (the sweep's sum recomputed by new_kernel in the
// particle pass's order).  Phase B walks substeps and iterations backward:
//   finalize VJP (fin_bwd_kernel);
//   per iteration: the contact and Chebyshev VJPs (iter_bwd_kernel), the
//     edge pass of the sweep's VJP (edge_bwd_kernel: d, length, dl and the
//     clamp masks recomputed from the stash, the multiplier cotangent
//     updated and the material cotangents accumulated per edge, which is
//     elementwise across substeps, so no atomics; the +-g_d contributions
//     written to a (2E, 3) buffer), and its particle pass (sum_bwd_kernel:
//     each particle sums its CSR incidence row of them in column order,
//     deterministic and without atomics);
//   the WARM_START pre-apply's VJP (the same two passes);
//   predict's VJP with the world_bounds / max_velocity masks and the
//     multiplier lifecycle's (predict_bwd_kernel).
// inv_mass and ext_force get no cotangent.  The pose is constant over the
// chunk, so its cotangents are sums over every particle, iteration and
// substep, taken without atomics: iter_bwd_kernel adds each particle's
// terms into that particle's column of the gpose planes (its own entries
// only), and after the chunk pose_sum_kernel sums each plane in one block,
// in a fixed order (strided partial sums, then a tree), so the result is
// the same on every run.
//
// The design is a simple one that is right: one launch per pass, about 32
// per substep at 4 iterations; at a few thousand particles the launches,
// not the bytes or the flops, should set the pace.  Floats: built with
// -fmad=false like the forward.

#include "mesh_xpbd.cuh"

// Device pointers, all 8 bytes wide; stash slots are (3, N) planes or (E)
// vectors, indexed by substep (sub) or substep * K + iteration (si).
struct DiffBuffers {
  float* st_x;      // (C, 3, N) substep-entry positions (contact anchors)
  float* st_v;      // (C, 3, N) substep-entry velocities
  float* st_wx;     // (C, 3, N) post-predict positions (WARM_START)
  float* st_wlam;   // (C, E) decayed entry multipliers (WARM_START)
  float* st_pred;   // (C*K, 3, N) iteration-entry positions
  float* st_new;    // (C*K, 3, N) post-sweep, pre-contact positions
  float* st_prev;   // (C*K, 3, N) Chebyshev prev at iteration entry
  float* st_lam;    // (C*K, E) iteration-entry multipliers
  float* gx;        // (3, N) in: output-x cotangent; out: entry-x's
  float* gv;        // (3, N) likewise for v
  float* glam;      // (E) likewise for lambda_dist
  float* grest;     // (E) rest-length cotangent (accumulated), or null
  float* galpha;    // (E) alpha cotangent (accumulated), or null
  float* gp;        // (3, N) running position cotangent
  float* gprev;     // (3, N) Chebyshev prev cotangent
  float* gq;        // (3, N) post-sweep cotangent
  float* gcur;      // (3, N) Chebyshev entry cotangent
  float* gcontrib;  // (2E, 3) the sweep VJP's per-endpoint contributions
  float* gpose;     // (1 + 7S, N) per-particle pose cotangents (ground,
                    // then per sphere center x3, radius, velocity x3),
                    // zero on entry; null without a ColliderSet
  float* gpose_out; // (1 + 7S) their sums over the particles
};

__device__ __forceinline__ void copy3(const float* src, float* dst, int n,
                                      int i) {
  for (int c = 0; c < 3; ++c) dst[c * n + i] = src[c * n + i];
}

// Phase A: the substep's entry x and v.
__global__ void stash_sub_kernel(MeshParams p, MeshBuffers b, DiffBuffers d,
                                 int sub) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const size_t o = (size_t)sub * 3 * p.n;
  copy3(b.x, d.st_x + o, p.n, i);
  copy3(b.v, d.st_v + o, p.n, i);
}

// Phase A: the post-predict positions and multipliers into (pos, lam),
// and the Chebyshev prev into prev when given.
__global__ void stash_kernel(MeshParams p, MeshBuffers b, float* pos,
                             float* prev, float* lam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n_edges) lam[i] = b.lam[i];
  if (i >= p.n) return;
  copy3(b.pred, pos, p.n, i);
  if (prev) copy3(b.prev, prev, p.n, i);
}

// Phase A: the sweep's result before contacts, pred + the particle's row
// sum of contrib, in particle_kernel's arithmetic.
__global__ void new_kernel(MeshParams p, MeshBuffers b, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (i >= n) return;
  float pc[3], s[3] = {0.f, 0.f, 0.f};
  load3(b.pred, n, i, pc);
  for (int k = b.inc_ptr[i]; k < b.inc_ptr[i + 1]; ++k) {
    const int j = b.inc_cols[k];
    for (int c = 0; c < 3; ++c) s[c] = s[c] + b.contrib[3 * j + c];
  }
  for (int c = 0; c < 3; ++c) pc[c] = pc[c] + s[c];
  store3(out, n, i, pc);
}

// Phase B: finalize's VJP (v = (pred - x) / dt, x = pred, pinned frozen).
__global__ void fin_bwd_kernel(MeshParams p, MeshBuffers b, DiffBuffers d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (i >= n) return;
  const bool pinned = b.w[i] == 0.f;
  for (int c = 0; c < 3; ++c) {
    const float a = d.gx[c * n + i], v = d.gv[c * n + i];
    d.gp[c * n + i] = pinned ? 0.f : a + v / p.dt;
    d.gx[c * n + i] = pinned ? a : -v / p.dt;
    d.gprev[c * n + i] = 0.f;
  }
}

// Adds v to particle i's entry of pose-cotangent plane row (no-op without
// a ColliderSet): each thread touches only its own particle's column.
__device__ __forceinline__ void pose_add(const DiffBuffers& d, int n, int i,
                                         int row, float v) {
  if (d.gpose) {
    float* e = d.gpose + (size_t)row * n + i;
    *e = *e + v;
  }
}

// VJP of the floor at height gh at its input q: g in/out, the anchor's
// cotangent added into ga, the ground's into pose plane 0.
__device__ void floor_bwd(const MeshParams& p, const DiffBuffers& d, int i,
                          float gh, float wa, const float q[3], float g[3],
                          float ga[3]) {
  const float pen = gh - q[1];
  const float denom = wa + p.floor_alpha;
  const bool active = pen > 0.f && wa >= p.static_eps &&
                      fabsf(denom) >= p.eps_denominator;
  if (!active) return;
  for (int c = 0; c < 3; c += 2) {
    const float gu = -g[c] * p.friction_dt;
    ga[c] = ga[c] + -gu / p.dt;
    g[c] = g[c] + gu / p.dt;
  }
  const float g_gh = g[1] * wa / denom;
  pose_add(d, p.n, i, 0, g_gh);
  g[1] = g[1] - g_gh;
}

// VJP of sphere s (table row r) at its input q; its center, radius and
// velocity cotangents go into pose planes 1 + 7s ... 7 + 7s.
__device__ void sphere_bwd(const MeshParams& p, const DiffBuffers& dd, int i,
                           int s, const float* r, float wa,
                           const float xc[3], const float q[3], float g[3],
                           float ga[3]) {
  float d[3], nrm[3], p1[3], vel[3];
  for (int c = 0; c < 3; ++c) d[c] = q[c] - r[c];
  const float dist = sqrtf(dot3(d, d));
  const float dmax = fmaxf(dist, 1e-12f);
  for (int c = 0; c < 3; ++c) nrm[c] = d[c] / dmax;
  const float pen = r[3] - dist;
  if (!(pen > 0.f && wa >= p.static_eps)) return;
  for (int c = 0; c < 3; ++c) p1[c] = q[c] + nrm[c] * pen;
  for (int c = 0; c < 3; ++c) vel[c] = (p1[c] - xc[c]) / p.dt - r[4 + c];
  const float vn = dot3(vel, nrm);
  float gvt[3], g_vel[3], gvel[3], gn[3], gp1[3];
  for (int c = 0; c < 3; ++c) gvt[c] = -g[c] * p.friction_dt;
  const float gvtn = dot3(gvt, nrm);
  for (int c = 0; c < 3; ++c) {
    g_vel[c] = gvt[c] - nrm[c] * gvtn;
    gvel[c] = g_vel[c] / p.dt;
    gn[c] = -(vn * gvt[c] + vel[c] * gvtn);
    gp1[c] = g[c] + gvel[c];
    gn[c] = gn[c] + pen * gp1[c];
  }
  const float g_pen = dot3(gp1, nrm);
  float gdist = -g_pen;
  if (dist >= 1e-12f) gdist = gdist + -dot3(gn, d) / (dmax * dmax);
  const int row = 1 + 7 * s;
  for (int c = 0; c < 3; ++c) {
    const float gd = gn[c] / dmax + d[c] * (gdist / dist);
    g[c] = gp1[c] + gd;
    ga[c] = ga[c] + -gvel[c];
    pose_add(dd, p.n, i, row + c, -gd);
    pose_add(dd, p.n, i, row + 4 + c, -g_vel[c]);
  }
  pose_add(dd, p.n, i, row + 3, g_pen);
}

// VJP of the contact chain (floor, then each sphere) at its input q; the
// chain's intermediate inputs are recomputed with the forward's stages.
__device__ void contacts_bwd(const MeshParams& p, const MeshBuffers& b,
                             const DiffBuffers& d, int i, float wa,
                             const float xc[3], const float q[3], float g[3],
                             float ga[3]) {
  const float gh = b.colliders[0];
  for (int s = p.n_spheres - 1; s >= 0; --s) {
    float qs[3] = {q[0], q[1], q[2]};
    if (p.floor_mode == 1) floor_project(p, gh, wa, xc, qs);
    for (int t = 0; t < s; ++t)
      sphere_project(p, sphere_row(b.colliders, t), wa, xc, qs);
    sphere_bwd(p, d, i, s, sphere_row(b.colliders, s), wa, xc, qs, g, ga);
  }
  if (p.floor_mode == 1) floor_bwd(p, d, i, gh, wa, q, g, ga);
}

// Phase B, per iteration: the contact and Chebyshev VJPs.  From gp (the
// cotangent of the iteration's result) to gq (that of the post-sweep
// positions) and, accelerated, gcur (the iteration entry's, Chebyshev part)
// and gprev; the anchors' cotangents go into gx, each contact chain's in
// turn (the plain version's order of sums).
__global__ void iter_bwd_kernel(MeshParams p, MeshBuffers b, DiffBuffers d,
                                int sub, int si, float om) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (i >= n) return;
  const size_t o = (size_t)si * 3 * n;
  const float wa = b.w[i];
  float xc[3], new0[3], g[3], gxi[3], ga[3] = {0.f, 0.f, 0.f};
  load3(d.st_x + (size_t)sub * 3 * n, n, i, xc);
  load3(d.st_new + o, n, i, new0);
  load3(d.gp, n, i, g);
  load3(d.gx, n, i, gxi);
  if (p.accelerate) {
    float cur[3], pv[3], acc[3], gpv[3];
    load3(d.st_pred + o, n, i, cur);
    load3(d.st_prev + o, n, i, pv);
    load3(d.gprev, n, i, gpv);
    for (int c = 0; c < 3; ++c) acc[c] = new0[c];
    project_contacts(p, b.colliders, wa, xc, acc);
    for (int c = 0; c < 3; ++c)
      acc[c] = om * (p.gamma * (acc[c] - cur[c]) + cur[c] - pv[c]) + pv[c];
    contacts_bwd(p, b, d, i, wa, xc, acc, g, ga);
    for (int c = 0; c < 3; ++c) {
      gxi[c] = gxi[c] + ga[c];
      ga[c] = 0.f;
    }
    const float a_new = om * p.gamma, a_cur = om * (1.f - p.gamma);
    for (int c = 0; c < 3; ++c) {
      d.gcur[c * n + i] = a_cur * g[c] + gpv[c];
      d.gprev[c * n + i] = (1.f - om) * g[c];
      g[c] = a_new * g[c];
    }
  }
  contacts_bwd(p, b, d, i, wa, xc, new0, g, ga);
  store3(d.gq, n, i, g);
  for (int c = 0; c < 3; ++c) gxi[c] = gxi[c] + ga[c];
  store3(d.gx, n, i, gxi);
}

// Phase B: the edge pass of a sweep's VJP (warm = 0, at stash slot si,
// g_after = gq) or of the WARM_START pre-apply's (warm = 1, at substep
// sub's stash, g_after = gp).  Updates glam[e], accumulates the material
// cotangents, writes -g_d to gcontrib row e and +g_d to row E + e.
__global__ void edge_bwd_kernel(MeshParams p, MeshBuffers b, DiffBuffers d,
                                int slot, int warm) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.n_edges) return;
  const int n = p.n, ne = p.n_edges;
  const float* pos = warm ? d.st_wx + (size_t)slot * 3 * n
                          : d.st_pred + (size_t)slot * 3 * n;
  const float lam_e = warm ? d.st_wlam[(size_t)slot * ne + e]
                           : d.st_lam[(size_t)slot * ne + e];
  const float* ga = warm ? d.gp : d.gq;
  const int ia = b.edges[2 * e], ib = b.edges[2 * e + 1];
  const float wa = b.w[ia], wb = b.w[ib];
  float pa[3], pb[3], dd[3], g_dp[3], nrm[3];
  load3(pos, n, ia, pa);
  load3(pos, n, ib, pb);
  for (int c = 0; c < 3; ++c) dd[c] = pb[c] - pa[c];
  const float len_sq = dot3(dd, dd);
  const float len = sqrtf(fmaxf(len_sq, 1e-24f));
  for (int c = 0; c < 3; ++c) {
    g_dp[c] = wb * ga[c * n + ib] - wa * ga[c * n + ia];
    nrm[c] = dd[c] / len;
  }
  float s, q = 0.f;
  if (warm) {
    // s = clamp(lam * warm_scale, +-lim): the multiplier applied
    s = lam_e * b.warm_scale[e];
    bool ok = true;
    if (p.warm_clamp > 0.f) {
      const float lim = p.warm_clamp * b.rest[e] / fmaxf(fmaxf(wa, wb),
                                                         1e-12f);
      ok = s > -lim && s < lim;
      s = clampf(s, -lim, lim);
    }
    const float glc = d.glam[e] + dot3(g_dp, nrm);
    d.glam[e] = (ok ? glc : 0.f) * b.warm_scale[e];
  } else {
    // distance_dl's arithmetic, with the masks of its clamps
    const float rest = b.rest[e], alpha = b.alpha[e];
    const float denom = wa + wb + alpha;
    const bool valid = len >= p.eps_length &&
                       fabsf(denom) >= p.eps_denominator &&
                       (wa >= p.static_eps || wb >= p.static_eps);
    const float denom_v = valid ? denom : 1.f;
    const float raw = (-(len - rest) - alpha * lam_e) / denom_v;
    bool ok = valid;
    float dl = raw;
    if (p.max_dlambda > 0.f) {
      ok = ok && dl > -p.max_dlambda && dl < p.max_dlambda;
      dl = clampf(dl, -p.max_dlambda, p.max_dlambda);
    }
    if (p.max_dlambda_rel > 0.f) {
      const float m = p.max_dlambda_rel * rest;
      ok = ok && dl > -m && dl < m;
      dl = clampf(dl, -m, m);
    }
    s = (valid ? dl : 0.f) * b.relax[e];
    float glo = d.glam[e];
    if (p.lambda_clamp > 0.f) {
      const float lam_pre = lam_e + s;
      if (!(lam_pre > -p.lambda_clamp && lam_pre < p.lambda_clamp))
        glo = 0.f;
    }
    const float graw = ok ? (dot3(g_dp, nrm) + glo) * b.relax[e] : 0.f;
    q = graw / denom_v;
    if (d.grest) {
      d.grest[e] = d.grest[e] + q;
      d.galpha[e] = d.galpha[e] - q * (lam_e + raw);
    }
    d.glam[e] = glo - alpha * q;
  }
  // d -> n = d / len and len: the position cotangent of the edge vector
  float gn[3], gd[3];
  for (int c = 0; c < 3; ++c) gn[c] = s * g_dp[c];
  const float glen = -q - dot3(gn, dd) / (len * len);
  const float glsq = len_sq >= 1e-24f ? glen * 0.5f / len : 0.f;
  for (int c = 0; c < 3; ++c) {
    gd[c] = gn[c] / len + dd[c] * (2.f * glsq);
    d.gcontrib[3 * e + c] = -gd[c];
    d.gcontrib[3 * (ne + e) + c] = gd[c];
  }
}

// Phase B: the particle pass of a sweep's (or the pre-apply's) VJP:
// gp = gbase + the particle's CSR row sum of gcontrib (in the forward's
// column order), then + gcur and + gprev when asked.
__global__ void sum_bwd_kernel(MeshParams p, MeshBuffers b, DiffBuffers d,
                               const float* gbase, int add_cur,
                               int add_prev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = p.n;
  if (i >= n) return;
  float s[3] = {0.f, 0.f, 0.f};
  for (int k = b.inc_ptr[i]; k < b.inc_ptr[i + 1]; ++k) {
    const int j = b.inc_cols[k];
    for (int c = 0; c < 3; ++c) s[c] = s[c] + d.gcontrib[3 * j + c];
  }
  for (int c = 0; c < 3; ++c) {
    float g = gbase[c * n + i] + s[c];
    if (add_cur) g = g + d.gcur[c * n + i];
    if (add_prev) g = g + d.gprev[c * n + i];
    d.gp[c * n + i] = g;
  }
}

// Phase B: predict's VJP (masks of the world_bounds and max_velocity
// clamps recomputed from the substep's entry) and the multiplier
// lifecycle's.  Grid: max(N, E) threads.
__global__ void predict_bwd_kernel(MeshParams p, MeshBuffers b,
                                   DiffBuffers d, int sub) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n_edges)
    d.glam[i] = p.lambda_mode == 0 ? 0.f : d.glam[i] * p.lambda_decay;
  if (i >= p.n) return;
  const int n = p.n;
  const size_t o = (size_t)sub * 3 * n;
  const float wa = b.w[i];
  for (int c = 0; c < 3; ++c) {
    float v_raw, vc, p_raw, pc;
    predict_coord(p, c, wa, d.st_x[o + c * n + i], d.st_v[o + c * n + i],
                  0.f, &v_raw, &vc, &p_raw, &pc);
    float g0 = d.gp[c * n + i];
    if (p.world_bounds > 0.f &&
        !(p_raw > -p.world_bounds && p_raw < p.world_bounds))
      g0 = 0.f;
    d.gx[c * n + i] = d.gx[c * n + i] + g0;
    float gv = p.dt * g0;
    if (p.max_velocity > 0.f &&
        !(v_raw > -p.max_velocity && v_raw < p.max_velocity))
      gv = 0.f;
    d.gv[c * n + i] = gv * p.damp_factor;
  }
}

// After the chunk: gpose_out[row] = the sum of pose plane `row` over the
// particles, one block a plane, in a fixed order (thread t sums particles
// t, t + MX_THREADS, ... in turn; then a tree over the threads).
__global__ void pose_sum_kernel(int n, const float* __restrict__ gpose,
                                float* __restrict__ out) {
  __shared__ float part[MX_THREADS];
  const float* plane = gpose + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += MX_THREADS) s = s + plane[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = MX_THREADS / 2; h > 0; h /= 2) {
    if (threadIdx.x < h)
      part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

extern "C" {

int mesh_diff_xpbd_buffers_size(void) { return (int)sizeof(DiffBuffers); }

// The VJP of n_substeps (C) substeps on `stream`.  hb: the forward's
// buffers with x, v, lam holding the chunk-entry state (overwritten by the
// replay) and pred, cur, prev, contrib scratch; hd: the stash and the
// cotangents (gx, gv, glam in: the outputs', out: the entry state's; grest
// and galpha accumulated when given; gpose, when given, zeroed by the
// caller, and gpose_out its sums).  om: the Chebyshev weight
// of each iteration (host memory).  *n_launched counts the kernels
// launched.
// Returns a cudaError_t; nothing is synchronised.
int mesh_diff_xpbd_run(const MeshParams* hp, const MeshBuffers* hb,
                       const DiffBuffers* hd, int device, int n_substeps,
                       const float* om, long long* n_launched,
                       void* stream_handle) {
  const MeshParams p = *hp;
  const MeshBuffers b = *hb;
  const DiffBuffers d = *hd;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the envelope: JACOBI distance sweeps, no other family, no
  // self-collision or velocity-reflect floor
  if (p.colored || p.bending || p.tets_on || p.n_hinges || p.n_tets ||
      p.sc_mode || p.floor_mode == 2 || p.n_boxes || !b.colliders ||
      p.n <= 0 || p.n_edges <= 0 || p.n_spheres > MX_MAX_SPHERES ||
      (p.accelerate && !d.st_prev) || (p.lambda_mode == 2 && !d.st_wx) ||
      (!d.gpose != !d.gpose_out))
    return (int)cudaErrorInvalidValue;

#define MD_CHECK()            \
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
  const dim3 g_all = grid_for(p.n > p.n_edges ? p.n : p.n_edges);
  const int n = p.n, ne = p.n_edges, K = p.iterations;
  const bool warm = p.lambda_mode == 2;
  const int contacts = (p.floor_mode == 1 || p.n_spheres > 0)
                           ? PF_CONTACTS : 0;
  const int save = p.accelerate ? PF_SAVE : 0;
  const CorrSource no_corr = {nullptr, nullptr, 0};
  const SumSource edge_sum = {b.contrib, b.inc_cols, b.inc_ptr, nullptr};

  // ---- phase A: replay with the forward's passes, stashing
  for (int sub = 0; sub < n_substeps; ++sub) {
    stash_sub_kernel<<<g_part, block, 0, stream>>>(p, b, d, sub);
    MD_CHECK();
    predict_kernel<<<g_all, block, 0, stream>>>(p, b, 0, save && !warm);
    MD_CHECK();
    if (warm) {
      stash_kernel<<<g_all, block, 0, stream>>>(
          p, b, d.st_wx + (size_t)sub * 3 * n, nullptr,
          d.st_wlam + (size_t)sub * ne);
      MD_CHECK();
      edge_kernel<<<g_edge, block, 0, stream>>>(p, b, 1);
      MD_CHECK();
      particle_kernel<<<g_part, block, 0, stream>>>(p, b, edge_sum, no_corr,
                                                    save, 0.f);
      MD_CHECK();
    }
    for (int it = 0; it < K; ++it) {
      const size_t si = (size_t)sub * K + it;
      const int fin = it == K - 1 ? PF_FINALIZE : 0;
      const int tail = contacts | fin | (p.accelerate ? PF_CHEBY : 0);
      stash_kernel<<<g_all, block, 0, stream>>>(
          p, b, d.st_pred + si * 3 * n,
          p.accelerate ? d.st_prev + si * 3 * n : nullptr,
          d.st_lam + si * ne);
      MD_CHECK();
      edge_kernel<<<g_edge, block, 0, stream>>>(p, b, 0);
      MD_CHECK();
      new_kernel<<<g_part, block, 0, stream>>>(p, b, d.st_new + si * 3 * n);
      MD_CHECK();
      particle_kernel<<<g_part, block, 0, stream>>>(p, b, edge_sum, no_corr,
                                                    tail, om[it]);
      MD_CHECK();
    }
  }

  // ---- phase B: cotangents, substeps and iterations in reverse
  for (int sub = n_substeps - 1; sub >= 0; --sub) {
    fin_bwd_kernel<<<g_part, block, 0, stream>>>(p, b, d);
    MD_CHECK();
    for (int it = K - 1; it >= 0; --it) {
      const int si = sub * K + it;
      iter_bwd_kernel<<<g_part, block, 0, stream>>>(p, b, d, sub, si,
                                                    om[it]);
      MD_CHECK();
      edge_bwd_kernel<<<g_edge, block, 0, stream>>>(p, b, d, si, 0);
      MD_CHECK();
      sum_bwd_kernel<<<g_part, block, 0, stream>>>(
          p, b, d, d.gq, p.accelerate, p.accelerate && it == 0);
      MD_CHECK();
    }
    if (warm) {
      edge_bwd_kernel<<<g_edge, block, 0, stream>>>(p, b, d, sub, 1);
      MD_CHECK();
      sum_bwd_kernel<<<g_part, block, 0, stream>>>(p, b, d, d.gp, 0, 0);
      MD_CHECK();
    }
    predict_bwd_kernel<<<g_all, block, 0, stream>>>(p, b, d, sub);
    MD_CHECK();
  }
  if (d.gpose) {
    pose_sum_kernel<<<1 + 7 * p.n_spheres, block, 0, stream>>>(n, d.gpose,
                                                               d.gpose_out);
    MD_CHECK();
  }
#undef MD_CHECK
  *n_launched = launched;
  return (int)cudaSuccess;
}

}  // extern "C"
