// X-slab sharded lattice XPBD substep loop for Hopper (sm_90a), bound
// through ctypes.
//
// Replaces the TPU kernel softbodysimulation_tpu/kernels/spatial_pallas.py
// make_spatial_pallas_substep (:68, kernel body :102): one braced res^3
// lattice split along x into D slabs of P = res / D planes, one per device
// (repeats allowed: four slabs may share one card), each slab running its
// whole substep loop.  It computes what that kernel computes, with the
// arithmetic of the port's plain sharded engine (parallel/spatial.py, the
// counterpart of the JAX XLA spatial engine) so the two agree to the bit:
// dp = dl * (d / length), the general engine's XPBD floor and
// VELOCITY_REFLECT (ops/collision.py), predict and finalize of
// ops/integrate.py.  COLORED and JACOBI, every lambda mode, both floors;
// no SDF colliders, tets or self-collision (the wrapper refuses them, as
// the TPU kernel's _check_supported does, and names backend="xla").
//
// Layout per slab: x, v, pred (3, M), w (M), lambda (nfam, M) float32 with
// M = P * res^2, particle a = xl * res^2 + y * res + z at global x = x0 + xl.
// The family masks come from global coordinates (lattice_xpbd.cuh).
//
// Design.  Each slab runs B-1's structure on its own planes: one launch per
// pass on the slab's own CUDA stream, ping-pong buffers, no atomics.  A
// pass is gather-only: thread a computes its own constraint (a, a+d) and
// recomputes, from the same inputs with the same arithmetic, the
// constraint anchored at a-d, and writes (p_a - w_a dp_a) + w_a dp_{a-d},
// the plain engine's term order.  Across a slab edge (the 9 families with
// dx = 1) that needs, at pass entry, the right neighbour's first plane of
// pred (for the own constraint of the last plane) and the left
// neighbour's last plane of pred and of the family's multipliers (for the
// recomputed constraint of the first plane); the inverse-mass planes are
// static and move once per call.  Gather over spill: the TPU kernel sends
// one correction plane right after each pass and adds it in a second
// step; gathering costs one more plane a pass (7 x res^2 floats in, not 6)
// but keeps a pass one launch with no add-back launch, and equals the
// plain engine's spill to the bit, since per element both add
// (p - w dp) + corr in that order.
//
// The exchange is a one-plane device-to-device copy between passes, outside
// the kernels (the mapping of the TPU's in-kernel remote copies): before an
// x-family pass each slab pushes, on its own stream, its first pred plane
// into its left neighbour's right-halo slot and its last pred and lambda
// planes into its right neighbour's left-halo slot, then records its event;
// each slab's pass waits on both neighbours' events.  Slots are double-
// buffered by the parity of the x-family pass: that is the flow-control
// credit the TPU kernel lacks (spatial_pallas.py:26-29).  A sender's push
// into slot j % 2 for pass j + 2 is ordered on its stream after its pass
// j + 1, which waited on the receiver's push for pass j + 1, which the
// receiver issued after its own pass j: so no slab overwrites a halo its
// neighbour has not read, however far its stream runs ahead.  Slabs on
// different cards copy peer to peer (cudaMemcpyAsync with UVA) and wait on
// each other's events across devices: the same code path as four slabs on
// one card.  The caller's stream on each device is joined to the slab
// streams by events at entry and exit; nothing synchronises the host.
//
// What bounds it on the card: the same as B-1, per slab.  At res 128 over 4
// slabs a pass is 524,288 threads reading ~20 bytes a thread (the 13
// passes a substep move ~0.14 GB at 3.35 TB/s, ~40 us); with a launch and
// up to 7 copies a slab per x-family pass, host issue of ~250 operations a
// substep (one thread issuing for all slabs) may well set the pace
// instead.  The design does nothing about either yet: a persistent slab
// kernel with in-kernel peer stores and flags, clusters and CUDA graphs
// are later work.
//
// Built with -fmad=false: sqrtf and '/' are IEEE, and no multiply-add is
// contracted, as in the plain engine's separate torch ops.

#include "lattice_xpbd.cuh"

#define SX_THREADS 256

// Every field is 8 bytes wide, so the ctypes mirror has no padding.
struct SlabArgs {
  long long device;
  void* stream;         // the slab's own stream
  void* caller_stream;  // the caller's current stream on the slab's device
  float* x;             // (3, M) in/out
  float* v;             // (3, M) in/out
  const float* w;       // (M)
  const float* f;       // (3, M) ext force, consumed on the first substep
  float* lam;           // (nfam, M) in/out
  float* lam_scratch;   // (nfam, M)
  float* pred_a;        // (3, M)
  float* pred_b;        // (3, M)
  float* w_left;        // (r2) the left neighbour's last w plane (or 0)
  float* w_right;       // (r2) the right neighbour's first w plane (or 0)
  float* halo_left;     // 2 slots x (4, r2): its last pred plane, lambda
  float* halo_right;    // 2 slots x (3, r2): its first pred plane
};

// Pred (3 components) and inverse mass of the particle at local plane xl,
// lane c: from the slab, or from a halo plane at xl = -1 or P.
struct Side {
  float p[3];
  float w;
};

__device__ __forceinline__ Side load_side(const float* pin, const float* w,
                                          const float* halo, int halo_stride,
                                          const float* w_halo, int xl,
                                          int c, int planes, int r2, int m) {
  Side s;
  if (xl >= 0 && xl < planes) {
    const int a = xl * r2 + c;
    for (int k = 0; k < 3; ++k) s.p[k] = pin[k * m + a];
    s.w = w[a];
  } else {
    for (int k = 0; k < 3; ++k) s.p[k] = halo[k * halo_stride + c];
    s.w = w_halo[c];
  }
  return s;
}

// One pass of family f on a slab: sel -1 every valid anchor (JACOBI), 0/1
// a parity class (COLORED); warm: the WARM_START pre-apply.  hl: the left
// halo slot (pred x, y, z, lambda planes); hr: the right halo slot.
__global__ void slab_pass_kernel(LatticeParams p, int f, int sel, int jacobi,
                                 int warm, int planes, int x0,
                                 const float* __restrict__ w,
                                 const float* __restrict__ wl,
                                 const float* __restrict__ wr,
                                 const float* __restrict__ pin,
                                 const float* __restrict__ hl,
                                 const float* __restrict__ hr,
                                 float* __restrict__ pout,
                                 const float* __restrict__ lam_in,
                                 float* __restrict__ lam_out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = p.n;
  if (a >= m) return;
  const int res = p.res, r2 = res * res;
  const int xl = a / r2, c = a - xl * r2;
  const int y = c / res, z = c - y * res;
  const int dx = p.fam[f][0];
  const int k = p.fam[f][1] * res + p.fam[f][2];
  const float wa = w[a];
  const float pa[3] = {pin[a], pin[m + a], pin[2 * m + a]};
  float o[3] = {pa[0], pa[1], pa[2]};

  // own constraint (a, a+d); the partner may be in the right halo
  const int cf = (c + k + r2) % r2;
  const Side fw = load_side(pin, w, hr, r2, wr, xl + dx, cf, planes, r2, m);
  const float lam_a = lam_in[a];
  const bool own = warm ? fam_valid(p, f, x0 + xl, y, z)
                        : fam_mask(p, f, sel, x0 + xl, y, z);
  float dl_a = 0.f;
  float lam_new;
  if (warm) {
    lam_new = warm_lambda(p, f, lam_a, wa, fw.w);
    if (own) dl_a = lam_new;
  }
  if (own) {
    float d[3];
    for (int q = 0; q < 3; ++q) d[q] = fw.p[q] - pa[q];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    if (!warm) dl_a = constraint_dl(p, f, len, wa, fw.w, lam_a, jacobi);
    for (int q = 0; q < 3; ++q) o[q] = pa[q] - wa * (dl_a * (d[q] / len));
  }
  if (!warm) {
    lam_new = lam_a + dl_a;
    if (p.lambda_clamp > 0.f)
      lam_new = clampf(lam_new, -p.lambda_clamp, p.lambda_clamp);
  }
  lam_out[a] = lam_new;

  // the constraint (a-d, a), recomputed; its anchor may be in the left halo
  const int xb = xl - dx, cb = (c - k + r2) % r2;
  const int yb = cb / res, zb = cb - (cb / res) * res;
  if (x0 + xb < 0) {
    for (int q = 0; q < 3; ++q) pout[q * m + a] = o[q];
    return;
  }
  const bool back = warm ? fam_valid(p, f, x0 + xb, yb, zb)
                         : fam_mask(p, f, sel, x0 + xb, yb, zb);
  if (back) {
    const Side bw =
        load_side(pin, w, hl, r2, wl, xb, cb, planes, r2, m);
    const float lam_b =
        xb >= 0 ? lam_in[xb * r2 + cb] : hl[3 * r2 + cb];
    float d[3];
    for (int q = 0; q < 3; ++q) d[q] = pa[q] - bw.p[q];
    const float len =
        sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    const float dl_b = warm ? warm_lambda(p, f, lam_b, bw.w, wa)
                            : constraint_dl(p, f, len, bw.w, wa, lam_b,
                                            jacobi);
    for (int q = 0; q < 3; ++q) o[q] = o[q] + wa * (dl_b * (d[q] / len));
  }
  for (int q = 0; q < 3; ++q) pout[q * m + a] = o[q];
}

// The XPBD floor of one iteration on pred in place (ops/collision.py
// floor_project_xpbd: positional friction through the velocity), and after
// the last iteration finalize (ops/integrate.py) and the VELOCITY_REFLECT
// floor (floor_velocity_reflect) into x and v.
__global__ void slab_contact_finalize_kernel(LatticeParams p, int do_floor,
                                             int do_finalize,
                                             float* __restrict__ x,
                                             float* __restrict__ v,
                                             const float* __restrict__ w,
                                             float* __restrict__ pred) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = p.n;
  if (a >= m) return;
  const float wa = w[a];
  float pc[3] = {pred[a], pred[m + a], pred[2 * m + a]};
  float xc[3] = {x[a], x[m + a], x[2 * m + a]};

  if (do_floor) {
    const float pen = p.ground_height - pc[1];
    const float denom = wa + p.floor_alpha;
    const bool act = pen > 0.f && wa >= p.static_eps &&
                     fabsf(denom) >= p.eps_denominator;
    const float dl = pen / (act ? denom : 1.f);
    pc[1] = pc[1] + (act ? wa * dl : 0.f);
    const float v0 = (pc[0] - xc[0]) / p.dt;
    const float v2 = (pc[2] - xc[2]) / p.dt;
    pc[0] = pc[0] - (act ? v0 * p.sphere_dt_fr : 0.f);
    pc[2] = pc[2] - (act ? v2 * p.sphere_dt_fr : 0.f);
  }
  if (!do_finalize) {
    for (int q = 0; q < 3; ++q) pred[q * m + a] = pc[q];
    return;
  }
  const bool pinned = wa == 0.f;
  float vc[3];
  for (int q = 0; q < 3; ++q) {
    vc[q] = pinned ? 0.f : (pc[q] - xc[q]) / p.dt;
    xc[q] = pinned ? xc[q] : pc[q];
  }
  if (p.floor_mode == 2) {
    const float pen = p.ground_height - xc[1];
    const bool hit = pen > 0.f && wa > 0.f;
    if (hit) xc[1] = p.ground_height + p.floor_offset;
    const bool falling = hit && vc[1] < 0.f;
    const float vy = fabsf(vc[1]) * p.restitution + pen * p.penetration_kick;
    const float v1 = falling ? vy : vc[1];
    const float normal_force = fabsf(v1) + pen * p.normal_force_scale;
    const float h_speed = sqrtf(vc[0] * vc[0] + vc[2] * vc[2]);
    const bool slide = falling && h_speed > 1e-3f;
    const float hs = fmaxf(h_speed, 1e-12f);
    const float fmag =
        fminf(h_speed, normal_force * p.floor_friction_coeff * p.dt);
    vc[0] = vc[0] - (slide ? vc[0] / hs * fmag : 0.f);
    vc[1] = v1;
    vc[2] = vc[2] - (slide ? vc[2] / hs * fmag : 0.f);
  }
  for (int q = 0; q < 3; ++q) {
    x[q * m + a] = xc[q];
    v[q * m + a] = vc[q];
  }
}

extern "C" {

int spatial_xpbd_slab_args_size(void) { return (int)sizeof(SlabArgs); }

const char* spatial_xpbd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Advance n_substeps substeps of n_slabs slabs of `planes` planes each;
// hp->n is a slab's particle count.  ext_first: slab f is consumed on the
// first substep.  Counts the kernels launched, the exchange copies and
// their bytes.  Returns a cudaError_t; nothing synchronises the host.
int spatial_xpbd_run(const LatticeParams* hp, int n_slabs, int planes,
                     const SlabArgs* slabs, int ext_first, int n_substeps,
                     long long* n_launched, long long* n_copies,
                     long long* n_bytes) {
  const LatticeParams p = *hp;
  const int r2 = p.res * p.res;
  const int m = p.n;
  const size_t plane_bytes = (size_t)r2 * sizeof(float);
  *n_launched = *n_copies = *n_bytes = 0;
  if (p.nfam > LX_MAX_FAM || n_slabs < 1 || n_slabs > 64 || planes < 2 ||
      m != planes * r2)
    return (int)cudaErrorInvalidValue;

  cudaError_t err = cudaSuccess;
  cudaEvent_t ready[64];
  int made = 0;
  const dim3 grid((m + SX_THREADS - 1) / SX_THREADS);
  const dim3 block(SX_THREADS);
  float* lam_buf[64][2];
  for (int s = 0; s < n_slabs; ++s) {
    lam_buf[s][0] = slabs[s].lam;
    lam_buf[s][1] = slabs[s].lam_scratch;
  }

#define SX_TRY(expr)                  \
  do {                                \
    err = (expr);                     \
    if (err != cudaSuccess) goto out; \
  } while (0)
#define SX_LAUNCHED()                 \
  do {                                \
    SX_TRY(cudaGetLastError());       \
    ++*n_launched;                    \
  } while (0)
#define SX_COPY(dst, src, bytes, s)                                    \
  do {                                                                 \
    SX_TRY(cudaMemcpyAsync((dst), (src), (bytes), cudaMemcpyDefault,   \
                           (cudaStream_t)slabs[s].stream));            \
    ++*n_copies;                                                       \
    *n_bytes += (long long)(bytes);                                    \
  } while (0)
#define SX_DEV(s) SX_TRY(cudaSetDevice((int)slabs[s].device))

  // peer access between neighbours on different cards, where the cards
  // allow it (else the copies are staged by the driver)
  for (int s = 0; s + 1 < n_slabs; ++s) {
    const int a = (int)slabs[s].device, b = (int)slabs[s + 1].device;
    if (a == b) continue;
    for (int dir = 0; dir < 2; ++dir) {
      const int from = dir ? b : a, to = dir ? a : b;
      int can = 0;
      SX_TRY(cudaDeviceCanAccessPeer(&can, from, to));
      if (!can) continue;
      SX_TRY(cudaSetDevice(from));
      const cudaError_t e = cudaDeviceEnablePeerAccess(to, 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled)
        cudaGetLastError();  // clear the sticky-free error
      else
        SX_TRY(e);
    }
  }

  // join: each slab stream waits for its caller stream's work so far
  for (int s = 0; s < n_slabs; ++s) {
    SX_DEV(s);
    SX_TRY(cudaEventCreateWithFlags(&ready[s], cudaEventDisableTiming));
    ++made;
    SX_TRY(cudaEventRecord(ready[s], (cudaStream_t)slabs[s].caller_stream));
    SX_TRY(cudaStreamWaitEvent((cudaStream_t)slabs[s].stream, ready[s], 0));
  }

  {
    // the static inverse-mass halos, once per call
    for (int s = 0; s < n_slabs; ++s) {
      SX_DEV(s);
      if (s > 0) SX_COPY(slabs[s - 1].w_right, slabs[s].w, plane_bytes, s);
      if (s + 1 < n_slabs)
        SX_COPY(slabs[s + 1].w_left, slabs[s].w + (size_t)(planes - 1) * r2,
                plane_bytes, s);
      SX_TRY(cudaEventRecord(ready[s], (cudaStream_t)slabs[s].stream));
    }
    for (int s = 0; s < n_slabs; ++s) {
      cudaStream_t st = (cudaStream_t)slabs[s].stream;
      SX_DEV(s);
      if (s > 0) SX_TRY(cudaStreamWaitEvent(st, ready[s - 1], 0));
      if (s + 1 < n_slabs) SX_TRY(cudaStreamWaitEvent(st, ready[s + 1], 0));
    }

    int bit = 0;          // the lambda buffer between substeps
    long long xpass = 0;  // x-family passes so far: the halo slot parity
    for (int i = 0; i < n_substeps; ++i) {
      for (int s = 0; s < n_slabs; ++s) {
        SX_DEV(s);
        predict_kernel<<<grid, block, 0, (cudaStream_t)slabs[s].stream>>>(
            p, slabs[s].x, slabs[s].v, slabs[s].w,
            (ext_first && i == 0) ? slabs[s].f : nullptr, slabs[s].pred_a,
            lam_buf[s][bit], lam_buf[s][0], nullptr);
        SX_LAUNCHED();
      }
      int fb[LX_MAX_FAM] = {0};
      int in = 0;  // 0: pred_a holds the current iterate, 1: pred_b
      const int n_warm = p.lambda_mode == 2 ? 1 : 0;
      for (int phase = 0; phase < n_warm + p.iterations; ++phase) {
        const bool warm = phase < n_warm;
        for (int fi = 0; fi < p.nfam; ++fi) {
          const int n_pass = (!warm && p.colored) ? 2 : 1;
          for (int ps = 0; ps < n_pass; ++ps) {
            const int dx = p.fam[fi][0];
            const size_t slot = (size_t)(xpass & 1);
            if (dx) {
              for (int s = 0; s < n_slabs; ++s) {
                const SlabArgs& A = slabs[s];
                const float* pin = in ? A.pred_b : A.pred_a;
                SX_DEV(s);
                if (s > 0) {
                  float* dst = slabs[s - 1].halo_right + slot * 3 * r2;
                  for (int q = 0; q < 3; ++q)
                    SX_COPY(dst + (size_t)q * r2, pin + (size_t)q * m,
                            plane_bytes, s);
                }
                if (s + 1 < n_slabs) {
                  float* dst = slabs[s + 1].halo_left + slot * 4 * r2;
                  const size_t last = (size_t)(planes - 1) * r2;
                  for (int q = 0; q < 3; ++q)
                    SX_COPY(dst + (size_t)q * r2, pin + (size_t)q * m + last,
                            plane_bytes, s);
                  SX_COPY(dst + 3 * (size_t)r2,
                          lam_buf[s][fb[fi]] + (size_t)fi * m + last,
                          plane_bytes, s);
                }
                SX_TRY(cudaEventRecord(ready[s], (cudaStream_t)A.stream));
              }
            }
            for (int s = 0; s < n_slabs; ++s) {
              const SlabArgs& A = slabs[s];
              cudaStream_t st = (cudaStream_t)A.stream;
              SX_DEV(s);
              if (dx) {
                if (s > 0) SX_TRY(cudaStreamWaitEvent(st, ready[s - 1], 0));
                if (s + 1 < n_slabs)
                  SX_TRY(cudaStreamWaitEvent(st, ready[s + 1], 0));
              }
              slab_pass_kernel<<<grid, block, 0, st>>>(
                  p, fi, (warm || !p.colored) ? -1 : ps,
                  (!warm && !p.colored) ? 1 : 0, warm ? 1 : 0, planes,
                  s * planes, A.w, A.w_left, A.w_right,
                  in ? A.pred_b : A.pred_a, A.halo_left + slot * 4 * r2,
                  A.halo_right + slot * 3 * r2, in ? A.pred_a : A.pred_b,
                  lam_buf[s][fb[fi]] + (size_t)fi * m,
                  lam_buf[s][fb[fi] ^ 1] + (size_t)fi * m);
              SX_LAUNCHED();
            }
            if (dx) ++xpass;
            fb[fi] ^= 1;
            in ^= 1;
          }
        }
        const bool last = phase == n_warm + p.iterations - 1;
        const bool floor = !warm && p.floor_mode == 1;
        if (floor || last) {
          for (int s = 0; s < n_slabs; ++s) {
            const SlabArgs& A = slabs[s];
            SX_DEV(s);
            slab_contact_finalize_kernel<<<grid, block, 0,
                                           (cudaStream_t)A.stream>>>(
                p, floor ? 1 : 0, last ? 1 : 0, A.x, A.v, A.w,
                in ? A.pred_b : A.pred_a);
            SX_LAUNCHED();
          }
        }
      }
      bit = fb[0];  // every family ran the same number of passes
    }

    // the multipliers back into lam, then join the caller streams
    for (int s = 0; s < n_slabs; ++s) {
      const SlabArgs& A = slabs[s];
      SX_DEV(s);
      if (bit)
        SX_TRY(cudaMemcpyAsync(A.lam, A.lam_scratch,
                               (size_t)p.nfam * m * sizeof(float),
                               cudaMemcpyDeviceToDevice,
                               (cudaStream_t)A.stream));
      SX_TRY(cudaEventRecord(ready[s], (cudaStream_t)A.stream));
      SX_TRY(cudaStreamWaitEvent((cudaStream_t)A.caller_stream, ready[s],
                                 0));
    }
  }

out:
  // an event still pending is released when its work completes
  for (int s = 0; s < made; ++s) {
    cudaSetDevice((int)slabs[s].device);
    cudaEventDestroy(ready[s]);
  }
#undef SX_TRY
#undef SX_LAUNCHED
#undef SX_COPY
#undef SX_DEV
  return (int)err;
}

}  // extern "C"
