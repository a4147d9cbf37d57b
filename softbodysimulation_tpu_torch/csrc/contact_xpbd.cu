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
// What ran outside the Pallas kernel, in XLA, runs here as kernels of its
// own: the curve order (stats, Hilbert codes, a stable radix sort from
// CUB, so particles of one cell keep their index order as jnp.argsort
// keeps them), the centred sorted layout with pads that replicate the last
// particle, the block AABBs and the top-M selection, whose rank of block j
// in row i counts the blocks with a smaller key or an equal key and a lower
// index -- the tie order of lax.top_k.
//
// The pass is three launches (contact_xpbd_corr), the "culled" design:
//  1. cx_stats_kernel: mean, min and max of pred, in one block;
//  2. cx_layout_box_kernel: a block per row block, a thread per slot: the
//     centred layout packed as float4 (x, y, z, |x|^2) beside w, the AABB
//     of each 32-slot sub-block by warp shuffles, and the block's AABB from
//     those;
//  3. cx_select_pair_kernel: a block per row block.  Its prologue is the
//     selection: the key of every block (the squared AABB gap, or +inf
//     where the boxes do not touch), the touching blocks compacted in index
//     order by a ballot count, ranked among themselves by (key, index), and
//     the rest filled in index order -- the stable descending sort of
//     select_candidates.  Touching blocks rank first, so a row block tests
//     candidates nbr[0, K), K = min(touching, M).  Then the pair tests, by
//     S roundup(B, 32) threads (S = 4 at B = 128).  The candidate blocks
//     are staged in shared memory in chunks, the next chunk's cp.async
//     copies in flight while this one is tested.  For a chunk the block
//     fills a cull table (which row warp -- 32 consecutive rows -- comes
//     within reach of which candidate sub-block of 32 slots), then shares
//     its warps among the row warps in proportion to their kept
//     sub-blocks (cx_share_warps: a row warp whose rows spread keeps
//     many, and would set the block's time alone); the warps of a
//     row warp take its kept sub-blocks in turn, cull their points against
//     the row warp's box by one ballot, and test the near ones, unrolled.
//     Each warp's partial sums go to shared memory, and each row adds its
//     own in (chunk, warp) order: no float atomics, the same bits every
//     run.
//
// What bounds it.  At the main path's shapes (the ball-on-cloth at 20,243
// particles, B = 128 -> 159 row blocks, M = 32) a pass has about 2.5e7
// candidate pair tests in touching blocks, of which a few hundred touch;
// the data (0.4 MB) lives in L2.  The serial design (design 1, kept as the
// yardstick for chip_smoke.py and the card tests, selected by no route)
// ran them as one dependent chain per row thread, 128 threads a block on
// 132 SMs, with an IEEE sqrtf in every test: bound by the latency of about
// four warps an SM, plus a thread per block AABB and an O(nb^2) rank of
// every block in two launches more.  Here (a) the 16 warps of a
// 512-thread block share a row block's tests, by row warp as their kept
// sub-blocks ask; (b) each row warp skips every candidate sub-block whose
// AABB lies farther from its own than the cull bound (cx_cull_bound), then
// every candidate point of a kept sub-block that lies that far (a ballot,
// one lane a candidate): at the 20k state the cull keeps about 7 % of the
// tests; (c) a kept test costs a shared-memory broadcast, three products,
// three sums and a compare with t_touch, unrolled over a sub-block, and
// only below t_touch come sqrtf, the overlap and the division.  What
// bounds the pass then (chip_smoke.py, b4_designs): the row warp with the
// most near points (a few row warps keep twenty times the mean), the
// one-block stats kernel, and the launches.  Tensor cores are not used:
// the Gram product has K = 3 in float32, Hopper has no float32 tensor-core
// product, and TF32 would move d2 near the contact boundary.
//
// The cheap test.  A pair touches only if diam - sqrtf(max(d2, 1e-18)) >
// 0, that is sqrtf(max(d2, 1e-18)) < diam.  sqrtf is correctly rounded and
// monotone and diam is a float, so if d2 >= diam^2 (the real square) then
// sqrtf(d2) >= diam and the pair does not touch.  t_touch = diam * diam
// rounded up (__fmul_ru) is >= diam^2, so every touching pair has d2 <
// t_touch: testing d2 < t_touch first and the guards after classifies
// every pair as the serial design does, with the same d2 (same floats,
// same fused sums).
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
// the culled pair kernel: S roundup(B, 32) threads, S as many as fit in
// this many threads (at least 1, at most M)
#define CX_PAIR_THREADS 512
// bytes of candidate particles (20 a slot) one staging buffer holds; two
// buffers are in flight
#define CX_STAGE_BYTES (40 * 1024)
// bytes of a chunk's cull table: (row warps) x (candidate sub-blocks)
#define CX_KEEP_BYTES 2048
// the warp cull's bound (cx_cull_bound): slack on the largest |x|^2, the
// Gram error per unit of it (2^-19), slack on the whole bound (2^-16)
#define CX_SMAX_SLACK 1.0009765625f
#define CX_GRAM_ERR 1.9073486328125e-06f
#define CX_CULL_SLACK 1.0000152587890625f

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

// Squared gap between two AABBs, as the selection's key takes it (and the
// plain version's d2ab): per axis max(a_lo - b_hi, b_lo - a_hi, 0).
__device__ __forceinline__ float cx_gap2(float alx, float aly, float alz,
                                         float ahx, float ahy, float ahz,
                                         float blx, float bly, float blz,
                                         float bhx, float bhy, float bhz) {
  const float gx = fmaxf(fmaxf(alx - bhx, blx - ahx), 0.f);
  const float gy = fmaxf(fmaxf(aly - bhy, bly - ahy), 0.f);
  const float gz = fmaxf(fmaxf(alz - bhz, blz - ahz), 0.f);
  return gx * gx + gy * gy + gz * gz;
}

// The warp cull's bound: a warp skips a candidate sub-block, and then a
// candidate point, whose gap to the warp's AABB, squared as cx_gap2 takes
// it, exceeds this.
//
// Why no touching pair is skipped (u = 2^-24, every operation rounded to
// nearest, no contraction but the fused sums named).  Let S bound |x|^2 of
// every slot of the layout and D^2 = |x_i - x_j|^2 (real).  The pass takes
// sq = x0 x0 + x1 x1 + x2 x2 (|sq - |x|^2| <= 3.0001 u |x|^2), g = x_i.x_j
// by two fused multiply-adds on one product (|g - x_i.x_j| <= 3.0001 u
// |x_i||x_j| <= 3.0001 u S), then (sq_i + sq_j) - 2g, two roundings more.
// So |d2 - D^2| <= 2 (3.0001 u S) + 2 u (2 S) (1 + 4u) + 2 (3.0001 u S)
// + u |d2| <= 16.0004 u S + u |d2|.  A touching pair has d2 < t_touch (see
// the cheap test), so D^2 < t_touch (1 + u) + 16.0004 u S.  The true gap g*
// between two AABBs that hold x_i and x_j (a point is one) is <= D, and
// its float, three
// differences, three squares and two sums, exceeds g*^2 by at most a
// factor (1 + u)^5 < 1 + 6u.  The bound below is at least (t_touch +
// 2^-19 S) (1 + 2^-16) (1 - 4u): 2^-19 S = 32 u S > 16.0004 u S and 1 +
// 2^-16 = 1 + 256 u > (1 + u)(1 + 6u) / (1 - 4u), so a touching pair's
// sub-blocks are never skipped.  S is the layout's largest |x|^2, bounded
// from the stats: x_c = pred_c - mean_c rounded, so |x_c| <= (1 + u)
// max(|max_c - mean_c|, |mean_c - min_c|), each difference rounded by at
// most u more; the sum of their squares, rounded three times, times (1 +
// 2^-10) covers (1 + u)^2 / (1 - u)^5.
__device__ __forceinline__ float cx_cull_bound(const float* stats,
                                               float t_touch) {
  float smax = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float e = fmaxf(fabsf(stats[6 + c] - stats[c]),
                          fabsf(stats[c] - stats[3 + c]));
    smax = smax + e * e;
  }
  smax = smax * CX_SMAX_SLACK;
  return (t_touch + smax * CX_GRAM_ERR) * CX_CULL_SLACK;
}

// ------------------------------------------------- the culled design

// A block per row block j, a thread per slot (blockDim = roundup(B, 32)):
// slot s's centred position and |x|^2 (as the serial layout takes them)
// packed into xq, its inverse mass; the AABB of every 32-slot sub-block
// by warp shuffles into sbox; the block's AABB from those into box.
__global__ void __launch_bounds__(1024)
    cx_layout_box_kernel(ContactParams p, ContactBuffers b) {
  __shared__ float s_lo[3][32], s_hi[3][32];
  const int B = p.block, j = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5, nsub = (B + 31) >> 5;
  float lo[3], hi[3];
  if (t < B) {
    const int s = j * B + t;
    const int src = b.order[s < p.n ? s : p.n - 1];
    float x[3];
    for (int c = 0; c < 3; ++c) {
      x[c] = b.pred[(size_t)src * p.si + (size_t)c * p.sc] - b.stats[c];
      lo[c] = hi[c] = x[c];
    }
    const float sq = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
    reinterpret_cast<float4*>(b.xq)[s] = make_float4(x[0], x[1], x[2], sq);
    b.ws[s] = s < p.n ? b.w[src] : 0.f;
  } else {
    for (int c = 0; c < 3; ++c) {
      lo[c] = INFINITY;
      hi[c] = -INFINITY;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], off));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], off));
    }
  if (lane == 0) {
    float4* sb = reinterpret_cast<float4*>(b.sbox) + 2 * ((size_t)j * nsub + w);
    sb[0] = make_float4(lo[0], lo[1], lo[2], 0.f);
    sb[1] = make_float4(hi[0], hi[1], hi[2], 0.f);
    for (int c = 0; c < 3; ++c) {
      s_lo[c][w] = lo[c];
      s_hi[c][w] = hi[c];
    }
  }
  __syncthreads();
  if (w == 0) {
    for (int c = 0; c < 3; ++c) {
      lo[c] = lane < nsub ? s_lo[c][lane] : INFINITY;
      hi[c] = lane < nsub ? s_hi[c][lane] : -INFINITY;
    }
    for (int off = 16; off > 0; off >>= 1)
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], off));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], off));
      }
    if (lane == 0)
      for (int c = 0; c < 3; ++c) {
        b.box[6 * j + c] = lo[c];
        b.box[6 * j + 3 + c] = hi[c];
      }
  }
}

__device__ __forceinline__ void cx_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cx_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cx_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cx_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one staging buffer of C candidate blocks: C B float4 (x, y, z,
// |x|^2), C nsub pairs of float4 sub-block AABBs, C B inverse masses, C
// block ids, rounded up to 16.
__host__ __device__ __forceinline__ size_t cx_buffer_bytes(int C, int B,
                                                          int nsub) {
  const size_t bytes = (size_t)C * (16 * B + 32 * nsub + 4 * B + 4);
  return (bytes + 15) & ~(size_t)15;
}

// Which row warp each of the block's nw warps serves in a chunk, by warp
// 0: every row warp with kept sub-blocks (keep, nsub rows of cu) gets one
// warp, the spare ones go in proportion to the kept counts (rounded down,
// what is left one each in row-warp order), and warps [pre_w, pre_w +
// ns_w) serve row warp w as its slices 0, 1, ... (rw -1: idle).  A
// function of the table alone, so the sums' order is too.
__device__ void cx_share_warps(const unsigned char* keep, int cu, int nsub,
                               int nw, int lane, int* rw, int* sl, int* ns) {
  int cnt = 0;
  if (lane < nsub)
    for (int u = 0; u < cu; ++u) cnt += keep[lane * cu + u];
  int total = cnt;
  for (int o = 16; o > 0; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  const unsigned has = __ballot_sync(0xffffffffu, cnt > 0);
  int share = 0;
  if (total > 0) {
    const int spare = nw - __popc(has);
    share = cnt > 0 ? 1 + (int)((long long)spare * cnt / total) : 0;
    int used = share;
    for (int o = 16; o > 0; o >>= 1)
      used += __shfl_xor_sync(0xffffffffu, used, o);
    if (cnt > 0 && __popc(has & ((1u << lane) - 1u)) < nw - used) ++share;
  }
  int pre = share;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, pre, o);
    if (lane >= o) pre += v;
  }
  const int end = __shfl_sync(0xffffffffu, pre, 31);
  pre -= share;
  if (lane < nsub) ns[lane] = share;
  for (int g = 0; g < share; ++g) {
    rw[pre + g] = lane;
    sl[pre + g] = g;
  }
  for (int g = end + lane; g < nw; g += 32) rw[g] = -1;
}

// A block per row block i, blockDim = S roundup(B, 32) (at most 1,024).
// The selection (into nbr and ok), then, unless `select_only`, the pair
// tests of the touching candidates (into corr, and bits if given).
// Dynamic shared memory: the selection's lists (8 nb + 4 M bytes), then
// over them two staging buffers of C blocks each.
__global__ void __launch_bounds__(1024)
    cx_select_pair_kernel(ContactParams p, ContactBuffers b, int C,
                          int select_only) {
  extern __shared__ float4 cx_smem[];
  __shared__ int s_wsum[32];
  __shared__ unsigned char s_keep[CX_KEEP_BYTES];
  __shared__ int s_rw[32], s_sl[32], s_ns[32];
  __shared__ float4 s_part[1024];
  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int M = p.m_nbr, nb = p.nb, B = p.block;
  const int words = (M * B + 31) / 32;
  if (b.bits && !select_only)
    for (size_t e = tid; e < (size_t)B * words; e += nt)
      b.bits[(size_t)i * B * words + e] = 0u;

  // the selection: keys of the touching blocks compacted in index order
  float* ckey = reinterpret_cast<float*>(cx_smem);  // (nb)
  int* clist = reinterpret_cast<int*>(ckey + nb);   // (nb)
  int* cfill = clist + nb;  // (M) the first non-touching blocks
  float bi[6];
  for (int c = 0; c < 6; ++c) bi[c] = b.box[6 * i + c];
  int touching = 0;
  for (int j0 = 0; j0 < nb; j0 += nt) {
    const int j = j0 + tid;
    float key = 0.f;
    bool t = false;
    if (j < nb) {
      const float* bj = b.box + 6 * j;
      key = cx_gap2(bi[0], bi[1], bi[2], bi[3], bi[4], bi[5], bj[0], bj[1],
                    bj[2], bj[3], bj[4], bj[5]);
      t = key < p.diam2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, t);
    if (lane == 0) s_wsum[wid] = __popc(ballot);
    __syncthreads();
    int before = touching, total = 0;
    for (int v = 0; v < nw; ++v) {
      const int c = s_wsum[v];
      before += v < wid ? c : 0;
      total += c;
    }
    before += __popc(ballot & ((1u << lane) - 1u));
    if (t) {
      ckey[before] = key;
      clist[before] = j;
    } else if (j < nb && j - before < M) {
      cfill[j - before] = j;
    }
    touching += total;
    __syncthreads();
  }
  // rank the touching blocks by (key, index); the rest in index order
  const int K = touching < M ? touching : M;
  for (int a = tid; a < touching; a += nt) {
    const float ka = ckey[a];
    int rank = 0;
    for (int c = 0; c < touching; ++c) {
      const float kc = ckey[c];
      rank += (kc < ka) || (kc == ka && c < a);
    }
    if (rank < M) {
      b.nbr[i * M + rank] = clist[a];
      b.ok[i * M + rank] = 1;
    }
  }
  for (int r = tid; r < M - K; r += nt) {
    b.nbr[i * M + K + r] = cfill[r];
    b.ok[i * M + K + r] = 0;
  }
  if (select_only) return;
  __syncthreads();  // nbr written; the lists' memory is staged over next

  const int nsub = (B + 31) >> 5;
  const float4* xq = reinterpret_cast<const float4*>(b.xq);
  const float4* sbox = reinterpret_cast<const float4*>(b.sbox);
  const float t_touch = __fmul_ru(p.diam, p.diam);
  const float t_cull = cx_cull_bound(b.stats, t_touch);
  const int* row_nbr = b.nbr + i * M;
  const size_t buf_bytes = cx_buffer_bytes(C, B, nsub);
  char* const smem = reinterpret_cast<char*>(cx_smem);

  // chunk ch of the candidates into buffer ch & 1
  auto stage = [&](int ch) {
    float4* q = reinterpret_cast<float4*>(smem + (ch & 1) * buf_bytes);
    float4* bx = q + C * B;
    float* w = reinterpret_cast<float*>(bx + 2 * C * nsub);
    int* js = reinterpret_cast<int*>(w + C * B);
    const int m0 = ch * C, cn = min(C, K - m0);
    for (int e = tid; e < cn * B; e += nt) {
      const int mm = e / B;
      const size_t src = (size_t)row_nbr[m0 + mm] * B + (e - mm * B);
      cx_cp16(q + e, xq + src);
      cx_cp4(w + e, b.ws + src);
    }
    for (int e = tid; e < cn * 2 * nsub; e += nt) {
      const int mm = e / (2 * nsub);
      cx_cp16(bx + e, sbox + (size_t)row_nbr[m0 + mm] * 2 * nsub +
                          (e - mm * 2 * nsub));
    }
    for (int e = tid; e < cn; e += nt) js[e] = row_nbr[m0 + e];
    cx_commit();
  };

  // thread r < B owns row r's sums: the chunks' partial sums added in
  // (chunk, warp) order
  float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nch = (K + C - 1) / C;
  if (nch > 0) stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      cx_wait<1>();
    } else {
      cx_wait<0>();
    }
    __syncthreads();
    const float4* q = reinterpret_cast<const float4*>(smem + (ch & 1) * buf_bytes);
    const float4* bx = q + C * B;
    const float* w = reinterpret_cast<const float*>(bx + 2 * C * nsub);
    const int* js = reinterpret_cast<const int*>(w + C * B);
    const int m0 = ch * C, cn = min(C, K - m0), cu = cn * nsub;
    // the chunk's cull table, by the whole block: row warp e / cu keeps
    // candidate sub-block e % cu unless their boxes lie beyond t_cull
    for (int e = tid; e < nsub * cu; e += nt) {
      const int ew = e / cu, u = e - ew * cu;
      const float4 alo = sbox[2 * (i * nsub + ew)];
      const float4 ahi = sbox[2 * (i * nsub + ew) + 1];
      const float4 clo = bx[2 * u], chi = bx[2 * u + 1];
      s_keep[e] = !(cx_gap2(alo.x, alo.y, alo.z, ahi.x, ahi.y, ahi.z, clo.x,
                            clo.y, clo.z, chi.x, chi.y, chi.z) > t_cull);
    }
    __syncthreads();
    if (wid == 0) cx_share_warps(s_keep, cu, nsub, nw, lane, s_rw, s_sl, s_ns);
    __syncthreads();

    // this warp's rows and its share of their kept sub-blocks
    float msum = 0.f, mx0 = 0.f, mx1 = 0.f, mx2 = 0.f;
    const int rw = s_rw[wid];
    if (rw >= 0) {
      const int sl = s_sl[wid], S = s_ns[rw], r = rw * 32 + lane;
      const int s = i * B + (r < B ? r : 0);
      const bool live = r < B && s < p.n;
      const float4 xi = xq[s];
      const float wi = b.ws[s];
      const float4 wlo = sbox[2 * (i * nsub + rw)];
      const float4 whi = sbox[2 * (i * nsub + rw) + 1];
      const unsigned char* keep = s_keep + rw * cu;
      int turn = 0;  // the row warp's kept sub-blocks go to its warps in turn
      for (int u0 = 0; u0 < cu; u0 += 32) {
        unsigned kept =
            __ballot_sync(0xffffffffu, u0 + lane < cu && keep[u0 + lane]);
        while (kept) {
          const int u = u0 + __ffs(kept) - 1;
          kept &= kept - 1u;
          const bool mine = turn == sl;
          turn = turn + 1 == S ? 0 : turn + 1;
          if (!mine) continue;
          const int mm = u / nsub, k0 = (u - mm * nsub) * 32;
          const int base = mm * B + k0;
          const int cid0 = js[mm] * B + k0;
          const int len = min(32, B - k0);
          // each candidate point against the warp's box, a lane each (a
          // point's gap is at least its sub-block's: this cull is finer)
          bool near = false;
          if (lane < len) {
            const float4 c = q[base + lane];
            near = !(cx_gap2(wlo.x, wlo.y, wlo.z, whi.x, whi.y, whi.z, c.x,
                             c.y, c.z, c.x, c.y, c.z) > t_cull);
          }
          const unsigned todo = __ballot_sync(0xffffffffu, near);
          // the cheap test of every near point, unrolled; then the full
          // test of those below t_touch, in index order
          unsigned cand = 0u;
#pragma unroll
          for (int kk = 0; kk < 32; ++kk) {
            if ((todo >> kk) & 1u) {
              const float4 c = q[base + kk];
              const float g = fmaf(xi.z, c.z, fmaf(xi.y, c.y, xi.x * c.x));
              const float d2 = (xi.w + c.w) - 2.f * g;
              cand |= (d2 < t_touch ? 1u : 0u) << kk;
            }
          }
          unsigned mask = 0u;
          while (cand) {
            const int kk = __ffs(cand) - 1;
            cand &= cand - 1u;
            const float4 c = q[base + kk];
            const float g = fmaf(xi.z, c.z, fmaf(xi.y, c.y, xi.x * c.x));
            const float d2 = (xi.w + c.w) - 2.f * g;
            const int cid = cid0 + kk;
            const float dist = sqrtf(fmaxf(d2, 1e-18f));
            const float overlap = p.diam - dist;
            const float wsum = wi + w[base + kk];
            if (live && s != cid && overlap > 0.f && dist > 1e-9f &&
                wsum > 1e-12f && cid < p.n) {
              const float m =
                  overlap / (fmaxf(dist, 1e-12f) * fmaxf(wsum, 1e-12f));
              msum = msum + m;
              mx0 = fmaf(m, c.x, mx0);
              mx1 = fmaf(m, c.y, mx1);
              mx2 = fmaf(m, c.z, mx2);
              mask |= 1u << kk;
            }
          }
          if (b.bits && mask) {
            // column (m0 + mm) B + k0 + kk of the row's bit row
            const int q0 = (m0 + mm) * B + k0, sh = q0 & 31;
            unsigned* bits = b.bits + (size_t)s * words + (q0 >> 5);
            atomicOr(bits, mask << sh);
            if (sh && (mask >> (32 - sh)))
              atomicOr(bits + 1, mask >> (32 - sh));
          }
        }
      }
    }
    s_part[tid] = make_float4(msum, mx0, mx1, mx2);
    __syncthreads();
    if (tid < B)
      for (int g = 0; g < nw; ++g)
        if (s_rw[g] == tid >> 5) {
          const float4 o = s_part[32 * g + (tid & 31)];
          tot.x = tot.x + o.x;
          tot.y = tot.y + o.y;
          tot.z = tot.z + o.z;
          tot.w = tot.w + o.w;
        }
    __syncthreads();  // the tables and this buffer are reused next chunk
  }
  if (tid < B) {
    const int s = i * B + tid, npad = p.nb * B;
    const float4 xi = xq[s];
    const float wi = b.ws[s];
    b.corr[s] = wi * (xi.x * tot.x - tot.y);
    b.corr[npad + s] = wi * (xi.y * tot.x - tot.z);
    b.corr[2 * npad + s] = wi * (xi.z * tot.x - tot.w);
  }
}

// ---------------------------------- the serial design (the yardstick)

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
      p->nb * 4 > 48 * 1024 || p->design < 0 || p->design > 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Let cx_select_pair_kernel take `bytes` of dynamic shared memory (its
// static arrays and the dynamic ones pass 48 KB only after this); once per
// device and size.
static int cx_allow_smem(size_t bytes) {
  static size_t allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && allowed[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(cx_select_pair_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) allowed[dev] = bytes;
  return 0;
}

// The culled design: stats, the layout with its boxes, the selection and
// (unless select_only) the pair tests.
static int cx_culled(const ContactParams& p, const ContactBuffers& b,
                     int select_only, long long* n_launched,
                     cudaStream_t stream) {
  const int nsub = (p.block + 31) / 32, bw = 32 * nsub;
  int S = CX_PAIR_THREADS / bw;
  S = S < 1 ? 1 : (S > p.m_nbr ? p.m_nbr : S);
  int C = CX_STAGE_BYTES / (20 * p.block);
  if (C > CX_KEEP_BYTES / (nsub * nsub)) C = CX_KEEP_BYTES / (nsub * nsub);
  C = C < 1 ? 1 : (C > p.m_nbr ? p.m_nbr : C);
  size_t bytes = (size_t)8 * p.nb + (size_t)4 * p.m_nbr;
  if (2 * cx_buffer_bytes(C, p.block, nsub) > bytes)
    bytes = 2 * cx_buffer_bytes(C, p.block, nsub);
  if (int rc = cx_allow_smem(bytes)) return rc;
  cx_stats_kernel<<<1, CX_STATS_THREADS, 0, stream>>>(p, b);
  CX_CHECK();
  cx_layout_box_kernel<<<p.nb, bw, 0, stream>>>(p, b);
  CX_CHECK();
  cx_select_pair_kernel<<<p.nb, S * bw, bytes, stream>>>(p, b, C,
                                                        select_only);
  CX_CHECK();
  return 0;
}

// The serial design: stats, the layout, the block AABBs, the selection
// and (unless select_only) the pair kernel.
static int cx_serial(const ContactParams& p, const ContactBuffers& b,
                     int select_only, long long* n_launched,
                     cudaStream_t stream) {
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
  if (select_only) return 0;
  cx_pair_kernel<<<p.nb, p.block, 5 * p.block * sizeof(float), stream>>>(
      p, b);
  CX_CHECK();
  return 0;
}

// The pass up to the correction (or, with select_only, the candidates) in
// the design p.design.
static int cx_pass(const ContactParams& p, const ContactBuffers& b,
                   int select_only, long long* n_launched,
                   cudaStream_t stream) {
  return p.design == 0 ? cx_culled(p, b, select_only, n_launched, stream)
                       : cx_serial(p, b, select_only, n_launched, stream);
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
  if (int bad = cx_valid(hp)) return bad;
  return cx_pass(*hp, *hb, 0, n_launched, (cudaStream_t)stream_handle);
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
  return cx_pass(*hp, *hb, 1, n_launched, (cudaStream_t)stream_handle);
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
