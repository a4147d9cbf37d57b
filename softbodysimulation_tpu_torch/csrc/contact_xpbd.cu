// Blocked exact self-collision pass for Hopper (sm_90a), bound through
// ctypes (kernels/contact_cuda.py) and linked into the mesh library, whose
// substep loop runs it (mesh_xpbd.cu).
//
// Replaces the TPU kernel softbodysimulation_tpu/kernels/contact_pallas.py
// self_collision_project_blocked_pallas (:132; kernel body _contact_kernel
// :47, pallas_call :121).  It ports WHAT that kernel computes -- one Jacobi
// separation pass over the particles sorted along a Hilbert curve, in
// blocks of B, each block against its M nearest AABB-touching blocks:
//   d2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j on centred positions,
//   dist = sqrt(max(d2, 1e-18)), overlap = 2r - dist, wsum = w_i + w_j,
//   m = overlap / (max(dist, 1e-12) max(wsum, 1e-12)) on touching pairs
//   (not self, overlap > 0, dist > 1e-9, wsum > 1e-12, candidate block
//   touching, both ids < n),
//   corr_i = w_i (x_i sum_j m - sum_j m x_j),  pred += omega corr
// -- and none of its TPU machinery: no augmented K=5 / K=2 matrix-unit
// contractions, no 128-lane block alignment (any B >= 8 up to 1024
// threads), no scoped-VMEM guard.
//
// What ran outside the Pallas kernel, in XLA, runs here as small kernels of
// its own: the curve order (stats, Hilbert codes, a stable radix sort from
// CUB, so particles of one cell keep their index order as jnp.argsort
// keeps them), the centred sorted layout with pads that replicate the last
// particle, the block AABBs, and the top-M selection, whose rank of block j
// in row i counts the blocks with a smaller key or an equal key and a lower
// index -- the tie order of lax.top_k.  The pair kernel: one thread block
// per row block of B particles, one thread per row particle; each of the M
// candidate blocks is staged in shared memory (5 B floats) and each thread
// loops over its B particles, summing m and m x_j in registers; every row
// owns its output, so there are no atomics.
//
// What bounds it at the main path's shapes (ball-on-cloth at 20,243
// particles, B = 128 -> 159 row blocks, M = 32 -> 4,096 candidates per
// row): about 8.3e7 pair tests per pass of ~20 flops with a sqrt and a
// division each, 8 passes per contact substep, on data that lives in the
// 50 MB L2 (the sorted planes are 0.4 MB).  So it is bound by the
// operations issued per thread, and, with 159 blocks of 128 threads on 132
// SMs, by latency at about one block per SM.  The design does nothing about
// that yet, by choice: candidate blocks split across threads, skipping
// non-overlapping candidate pairs by block distance, or tensor-core Gram
// products come later.
//
// Floats: built without --use_fast_math and with -fmad=false, so every
// product and sum is rounded as written, except the two sums the plain
// version takes from matrix products: x_i.x_j and sum_j m x_j are
// accumulated with explicit fused multiply-adds in index order, the
// rounding of a float32 GEMM's inner loop.  That matters: for two close
// particles d2 is a small difference of large terms (the Gram trick loses
// ~1e-7 absolute to cancellation), and a plain sum of products there
// moved a 1,000-particle cloud's result by 5e-6 against the plain version
// on the card, the fused sums by 1e-7.  A pair at the contact boundary can
// still classify either way; the optional `bits` output records which
// pairs touched, so callers can count the pairs the two classify
// differently.

#include <math.h>

#include <cub/device/device_radix_sort.cuh>

#include "contact_xpbd.cuh"

#define CX_STATS_THREADS 512
#define CX_THREADS 256
#define CX_HILBERT_BITS 9

static inline dim3 cx_grid(int count) {
  return dim3((count + CX_THREADS - 1) / CX_THREADS);
}

// Sum (as the mean), min and max of each coordinate of pred, in one block.
__global__ void cx_stats_kernel(ContactParams p, ContactBuffers b) {
  __shared__ float s_sum[3][CX_STATS_THREADS];
  __shared__ float s_min[3][CX_STATS_THREADS];
  __shared__ float s_max[3][CX_STATS_THREADS];
  const int t = threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    float sum = 0.f, mn = INFINITY, mx = -INFINITY;
    for (int i = t; i < p.n; i += CX_STATS_THREADS) {
      const float v = b.pred[(size_t)i * p.si + (size_t)c * p.sc];
      sum = sum + v;
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    s_sum[c][t] = sum;
    s_min[c][t] = mn;
    s_max[c][t] = mx;
  }
  __syncthreads();
  for (int half = CX_STATS_THREADS / 2; half > 0; half >>= 1) {
    if (t < half)
      for (int c = 0; c < 3; ++c) {
        s_sum[c][t] = s_sum[c][t] + s_sum[c][t + half];
        s_min[c][t] = fminf(s_min[c][t], s_min[c][t + half]);
        s_max[c][t] = fmaxf(s_max[c][t], s_max[c][t + half]);
      }
    __syncthreads();
  }
  if (t == 0)
    for (int c = 0; c < 3; ++c) {
      b.stats[c] = s_sum[c][0] / (float)p.n;
      b.stats[3 + c] = s_min[c][0];
      b.stats[6 + c] = s_max[c][0];
    }
}

__device__ __forceinline__ int cx_spread3(int x) {
  x = x & 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

// 3-D Hilbert index of a cell (Skilling's transpose algorithm, then bit
// interleave): ops/spatial_hash.py::_hilbert_code for one particle.
__device__ int cx_hilbert(int x0, int x1, int x2) {
  int X[3] = {x0, x1, x2};
  for (int Q = 1 << (CX_HILBERT_BITS - 1); Q > 1; Q >>= 1) {
    const int P = Q - 1;
    for (int i = 0; i < 3; ++i) {
      const bool cond = (X[i] & Q) != 0;
      const int t = (X[0] ^ X[i]) & P;
      const int x0_swap = X[0] ^ t;
      const int xi_swap = X[i] ^ t;
      X[0] = cond ? (X[0] ^ P) : x0_swap;
      if (i) X[i] = cond ? X[i] : xi_swap;
    }
  }
  X[1] = X[1] ^ X[0];
  X[2] = X[2] ^ X[1];
  int t = 0;
  for (int Q = 1 << (CX_HILBERT_BITS - 1); Q > 1; Q >>= 1)
    if (X[2] & Q) t = t ^ (Q - 1);
  for (int i = 0; i < 3; ++i) X[i] = X[i] ^ t;
  return (cx_spread3(X[0]) << 2) | (cx_spread3(X[1]) << 1) |
         cx_spread3(X[2]);
}

// Hilbert code of each particle's cell on the 512^3 grid whose cell is the
// contact diameter or extent / 511, whichever is larger.
__global__ void cx_hilbert_kernel(ContactParams p, ContactBuffers b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int g = 1 << CX_HILBERT_BITS;
  float extent = b.stats[6] - b.stats[3];
  extent = fmaxf(extent, b.stats[7] - b.stats[4]);
  extent = fmaxf(extent, b.stats[8] - b.stats[5]);
  const float cell = fmaxf(p.diam, extent / (float)(g - 1));
  int q[3];
  for (int c = 0; c < 3; ++c) {
    const float v = b.pred[(size_t)i * p.si + (size_t)c * p.sc];
    const float f = floorf((v - b.stats[3 + c]) / cell);
    q[c] = (int)fminf(fmaxf(f, 0.f), (float)(g - 1));
  }
  b.codes[i] = cx_hilbert(q[0], q[1], q[2]);
  b.iota[i] = i;
}

// Slot s of the curve order: centred position, |x|^2 and inverse mass;
// pads (s >= n) replicate the last particle with inverse mass 0.
__global__ void cx_layout_kernel(ContactParams p, ContactBuffers b) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int npad = p.nb * p.block;
  if (s >= npad) return;
  const int src = b.order[s < p.n ? s : p.n - 1];
  float x[3];
  for (int c = 0; c < 3; ++c) {
    x[c] = b.pred[(size_t)src * p.si + (size_t)c * p.sc] - b.stats[c];
    b.xs[(size_t)c * npad + s] = x[c];
  }
  b.sq[s] = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  b.ws[s] = s < p.n ? b.w[src] : 0.f;
}

// One thread per block: its AABB.
__global__ void cx_box_kernel(ContactParams p, ContactBuffers b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.nb) return;
  const int npad = p.nb * p.block;
  for (int c = 0; c < 3; ++c) {
    float mn = INFINITY, mx = -INFINITY;
    for (int k = 0; k < p.block; ++k) {
      const float v = b.xs[(size_t)c * npad + (size_t)j * p.block + k];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    b.box[6 * j + c] = mn;
    b.box[6 * j + 3 + c] = mx;
  }
}

// One thread block per row block i: the squared AABB gap to every block j,
// the key d2 (touching) or +inf, and the rank of each j in ascending key,
// ties by index (lax.top_k of -key); ranks below M are the candidates.
__global__ void cx_select_kernel(ContactParams p, ContactBuffers b) {
  extern __shared__ float key[];
  const int i = blockIdx.x;
  const float* bi = b.box + 6 * i;
  for (int j = threadIdx.x; j < p.nb; j += blockDim.x) {
    const float* bj = b.box + 6 * j;
    float g[3];
    for (int c = 0; c < 3; ++c)
      g[c] = fmaxf(fmaxf(bi[c] - bj[3 + c], bj[c] - bi[3 + c]), 0.f);
    const float d2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
    key[j] = d2 < p.diam2 ? d2 : INFINITY;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.nb; j += blockDim.x) {
    const float kj = key[j];
    int rank = 0;
    for (int k = 0; k < p.nb; ++k) {
      const float kk = key[k];
      rank += (kk < kj) || (kk == kj && k < j);
    }
    if (rank < p.m_nbr) {
      b.nbr[i * p.m_nbr + rank] = j;
      b.ok[i * p.m_nbr + rank] = kj < INFINITY;
    }
  }
}

// The pair kernel (TPU kernel B-4's body): one thread block per row block,
// one thread per row particle, the candidate blocks staged in shared memory
// in turn.  blockDim.x == block.
__global__ void cx_pair_kernel(ContactParams p, ContactBuffers b) {
  extern __shared__ float stage[];
  const int B = p.block;
  float* sx = stage;
  float* sy = stage + B;
  float* sz = stage + 2 * B;
  float* ssq = stage + 3 * B;
  float* sw = stage + 4 * B;
  const int npad = p.nb * B;
  const int t = threadIdx.x;
  const int s = blockIdx.x * B + t;
  const float xi0 = b.xs[s], xi1 = b.xs[npad + s], xi2 = b.xs[2 * npad + s];
  const float sqi = b.sq[s], wi = b.ws[s];
  float msum = 0.f, mx0 = 0.f, mx1 = 0.f, mx2 = 0.f;
  const int words = (p.m_nbr * B + 31) / 32;
  unsigned acc = 0;
  int q = 0;
  for (int m = 0; m < p.m_nbr; ++m) {
    const int j = b.nbr[blockIdx.x * p.m_nbr + m];
    const bool okm = b.ok[blockIdx.x * p.m_nbr + m] != 0;
    if (!okm) {
      // a non-touching candidate block adds no pair
      if (b.bits)
        for (int k = 0; k < B; ++k, ++q)
          if ((q & 31) == 31) {
            b.bits[(size_t)s * words + (q >> 5)] = acc;
            acc = 0;
          }
      continue;
    }
    __syncthreads();
    const int src = j * B + t;
    sx[t] = b.xs[src];
    sy[t] = b.xs[npad + src];
    sz[t] = b.xs[2 * npad + src];
    ssq[t] = b.sq[src];
    sw[t] = b.ws[src];
    __syncthreads();
    for (int k = 0; k < B; ++k, ++q) {
      const int cid = j * B + k;
      const float g = fmaf(xi2, sz[k], fmaf(xi1, sy[k], xi0 * sx[k]));
      const float d2 = (sqi + ssq[k]) - 2.f * g;
      const float dist = sqrtf(fmaxf(d2, 1e-18f));
      const float overlap = p.diam - dist;
      const float wsum = wi + sw[k];
      const bool touch = s != cid && overlap > 0.f && dist > 1e-9f &&
                         wsum > 1e-12f && s < p.n && cid < p.n;
      if (touch) {
        const float mm =
            overlap / (fmaxf(dist, 1e-12f) * fmaxf(wsum, 1e-12f));
        msum = msum + mm;
        mx0 = fmaf(mm, sx[k], mx0);
        mx1 = fmaf(mm, sy[k], mx1);
        mx2 = fmaf(mm, sz[k], mx2);
        acc |= 1u << (q & 31);
      }
      if ((q & 31) == 31) {
        if (b.bits) b.bits[(size_t)s * words + (q >> 5)] = acc;
        acc = 0;
      }
    }
  }
  if (b.bits && (q & 31)) b.bits[(size_t)s * words + (q >> 5)] = acc;
  b.corr[s] = wi * (xi0 * msum - mx0);
  b.corr[npad + s] = wi * (xi1 * msum - mx1);
  b.corr[2 * npad + s] = wi * (xi2 * msum - mx2);
}

// Slot s < n: pred[order[s]] += omega * corr[s], the unsort and apply of
// the plain version (in the mesh loop, its particle pass does this).
__global__ void cx_apply_kernel(ContactParams p, ContactBuffers b) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.n) return;
  const int npad = p.nb * p.block;
  const int i = b.order[s];
  for (int c = 0; c < 3; ++c) {
    float* x = b.pred + (size_t)i * p.si + (size_t)c * p.sc;
    *x = *x + p.omega * b.corr[(size_t)c * npad + s];
  }
}

#define CX_CHECK()            \
  do {                        \
    cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_; \
    ++*n_launched;            \
  } while (0)

static int cx_valid(const ContactParams* p) {
  if (p->n <= 0 || p->block < 8 || p->block > 1024 || p->m_nbr < 1 ||
      p->m_nbr > p->nb || (long long)p->nb * p->block < p->n ||
      p->nb * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The layout and the top-M selection of pred in the order b.order.
static int cx_candidates(const ContactParams& p, const ContactBuffers& b,
                         long long* n_launched, cudaStream_t stream) {
  cx_stats_kernel<<<1, CX_STATS_THREADS, 0, stream>>>(p, b);
  CX_CHECK();
  cx_layout_kernel<<<cx_grid(p.nb * p.block), CX_THREADS, 0, stream>>>(p,
                                                                       b);
  CX_CHECK();
  cx_box_kernel<<<cx_grid(p.nb), CX_THREADS, 0, stream>>>(p, b);
  CX_CHECK();
  cx_select_kernel<<<p.nb, CX_THREADS, p.nb * sizeof(float), stream>>>(p,
                                                                       b);
  CX_CHECK();
  return 0;
}

extern "C" {

int contact_xpbd_params_size(void) { return (int)sizeof(ContactParams); }

int contact_xpbd_buffers_size(void) { return (int)sizeof(ContactBuffers); }

const char* contact_xpbd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Scratch bytes the radix sort of n codes needs (query only, no launch).
long long contact_xpbd_sort_bytes(int n) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, (const unsigned*)nullptr,
                                  (unsigned*)nullptr, (const int*)nullptr,
                                  (int*)nullptr, n, 0, 3 * CX_HILBERT_BITS);
  return (long long)bytes;
}

int contact_xpbd_order(const ContactParams* hp, const ContactBuffers* hb,
                       long long* n_launched, void* stream_handle) {
  const ContactParams p = *hp;
  const ContactBuffers b = *hb;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  if (int bad = cx_valid(&p)) return bad;
  cx_stats_kernel<<<1, CX_STATS_THREADS, 0, stream>>>(p, b);
  CX_CHECK();
  cx_hilbert_kernel<<<cx_grid(p.n), CX_THREADS, 0, stream>>>(p, b);
  CX_CHECK();
  size_t bytes = (size_t)b.sort_temp_bytes;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      b.sort_temp, bytes, (const unsigned*)b.codes,
      (unsigned*)b.codes_sorted, (const int*)b.iota, b.order, p.n, 0,
      3 * CX_HILBERT_BITS, stream);
  if (err != cudaSuccess) return (int)err;
  CX_CHECK();
  return 0;
}

int contact_xpbd_corr(const ContactParams* hp, const ContactBuffers* hb,
                      long long* n_launched, void* stream_handle) {
  const ContactParams p = *hp;
  const ContactBuffers b = *hb;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  if (int bad = cx_valid(&p)) return bad;
  if (int rc = cx_candidates(p, b, n_launched, stream)) return rc;
  cx_pair_kernel<<<p.nb, p.block, 5 * p.block * sizeof(float), stream>>>(
      p, b);
  CX_CHECK();
  return 0;
}

// The whole pass in the order b.order (the standalone entry): the passes
// of contact_xpbd_corr, as the mesh loop runs them, then the unsort and
// apply into b.pred in place.  On `stream`, nothing synchronised; returns
// a cudaError_t.
int contact_xpbd_project(const ContactParams* hp, const ContactBuffers* hb,
                         int device, long long* n_launched,
                         void* stream_handle) {
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int rc = contact_xpbd_corr(hp, hb, n_launched, stream_handle))
    return rc;
  cx_apply_kernel<<<cx_grid(hp->n), CX_THREADS, 0,
                    (cudaStream_t)stream_handle>>>(*hp, *hb);
  CX_CHECK();
  return 0;
}

// The layout and the candidate selection alone (into b.nbr, b.ok), as the
// mesh library's loop makes them, for tests.
int contact_xpbd_select_only(const ContactParams* hp,
                             const ContactBuffers* hb, int device,
                             long long* n_launched, void* stream_handle) {
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int bad = cx_valid(hp)) return bad;
  return cx_candidates(*hp, *hb, n_launched, (cudaStream_t)stream_handle);
}

// The curve order alone, for tests.
int contact_xpbd_order_only(const ContactParams* hp, const ContactBuffers* hb,
                            int device, long long* n_launched,
                            void* stream_handle) {
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return contact_xpbd_order(hp, hb, n_launched, stream_handle);
}

}  // extern "C"
