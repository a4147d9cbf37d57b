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
// lambda plane, the tet planes), so one launch runs the whole ensemble's
// n = B * res^3 particles.  cell_of and shift_cell take a
// particle's coordinates within its body, and its neighbours with the
// rolls' wrap inside that body: the CUDA form of the TPU kernel's lane
// index taken mod res^2.  The family masks and the tet tables are the one
// body's, so no pass reads across a body boundary, and each body's
// arithmetic is the single-body kernel's to the bit.  The collider table
// is shared: every body sees the same rigid world.  The TPU kernel's
// 128-lane padding has no counterpart.
//
// A substep runs these passes, in this order:
//   predict (gravity, first-substep ext force, damping, clamps) with the
//     lambda reset / decay folded in (the tet multipliers' too);
//   WARM_START: one pre-apply pass per family;
//   per iteration: one pass per family (JACOBI) or two parity passes
//     (COLORED), then the per-cell tet sweep (two passes), then the
//     contacts -- the XPBD floor, the boxes, the spheres, the order of
//     solvers/lattice.py -- and, after the last iteration, finalize
//     (VELOCITY_REFLECT).
// The spheres and boxes come from the collider table of colliders.cuh (the
// config's constants, or a ColliderSet's traced poses and velocities, whose
// friction then acts on the velocity relative to the collider; the
// set's ground height replaces the config's).  A new pose is a new table,
// read by the next launch: the TPU kernel's box block
// (lattice_pallas.py:1360-1409) and pose table (:576-589) in one.
// A family pass is gather-only, with no atomics: particle a reads the
// pass-entry positions from one buffer and writes another (ping-pong).  It
// computes its own constraint (a, a+d) -- the lambda it writes -- and
// recomputes, from the same inputs with the same arithmetic, the constraint
// anchored at a-d; it writes p_a - w_a*dp_a + w_a*dp_{a-d}, the term order of
// _family_pass.  Lambda planes ping-pong the same way, because the a-d
// constraint reads the pass-entry multiplier at a-d.  The passes are the
// __device__ functions of lattice_xpbd.cuh.
//
// What bounds it on the card: at res 40 the state (x, v, two pred buffers,
// ext, w, 2 x 13 lambda planes) is about 10 MB and lives in the 50 MB L2,
// and a pass is ~100 flops and a few dozen bytes of L2 traffic a particle,
// well under a microsecond of work for the whole card.  Launched one
// kernel a pass (15 a substep), each pass cost the 3.3-4.4 us of a launch,
// a fresh grid that ramps up and drains, and the integer divisions of
// every thread's coordinates and partners: launches, not HBM or the ALUs,
// set the pace.  So a call is one persistent launch
// (lattice_persistent_kernel) that runs every substep, the passes
// separated by barriers:
//   - each block owns a fixed tile of particles for the whole call (block
//     j: [j * chunk, (j + 1) * chunk)), and each thread its particles at a
//     stride of the block size; a particle's coordinates are worked out
//     once a call and carried to the next by additions, and a partner is
//     the particle plus its offset (FastNbr), with no division;
//   - whole bodies in a block (ensembles of small bodies) synchronise with
//     __syncthreads(): no pass reads across a body, so such a block needs
//     no other block;
//   - one body across blocks synchronises the whole grid, launched
//     cooperatively (cudaLaunchCooperativeKernel: a grid that cannot be
//     co-resident is refused, never run) with a counting barrier on a
//     global counter (release add, acquire spin; grid_barrier.cuh, shared
//     with the mesh library's persistent kernel), which timed ahead of
//     cooperative_groups' grid.sync() at every size tried (PERF.md), so
//     grid.sync() was dropped; kernels/lattice_cuda.py plans the tiles,
//     the kind of barrier and the grid from the shape alone;
//   - a pass issues all of a particle's reads before its first write:
//     without __restrict__ (the kernel writes what later passes read) the
//     compiler keeps reads after writes, and a thread would wait for L2
//     twice a pass;
//   - fusions that keep every bit: the contacts and finalize run in the
//     tail of the iteration's last pass, on the value the pass computed,
//     and the next substep's predict (pointwise) right after finalize, in
//     the same thread, into the buffer the pass wrote; the multipliers are
//     reset or decayed in place.  Predict is not folded into the first
//     pass (that would predict each tile's halo twice).
// Where the state lives.  The grid kind reads a tile and its halo straight
// from L2 each pass: the state fits in L2, and a shared-memory copy of a
// tile would have to be written back for its neighbours before each grid
// barrier.  The block kind's tiles read nothing outside their block, so
// it keeps w, the iterate's two buffers and the multipliers' two in
// dynamic shared memory for the whole call (block_tile; 33,792 bytes for
// a 256-particle tile of 13 families), gathered at 32-bit addresses; x,
// v, the ext force, the collider table, the tet multipliers and the tet
// scratch stay in global memory, touched once a substep or only on the
// tet route.  What bounds it now: a pass's own instructions, a few hundred
// dependent ones a particle with one particle a thread (fuller threads
// are slower: chip_smoke.py phase 41).  At example 5's shape (H100 80GB
// HBM3, 700 W; PERF.md) the tile in shared memory alone took a call from
// 18.7 to 17.1 ms (8 %), the tile's plane pointers held without spills
// (80 registers, three blocks an SM, as before) to 16.5 ms, a pass 1.33
// us; approx_math's rsqrt and reciprocal in place of the IEEE sqrtf and
// divisions take 5 % more: neither memory nor the IEEE arithmetic is most
// of a pass.  The grid kind waits 9 % of its time in the grid barrier;
// res 128's 2.1M particles no longer fit in L2.
// The per-pass loop (one launch a pass, lattice_xpbd_run_per_pass) stays
// as the yardstick the persistent kernel is timed and checked against.
// lattice_counted_kernel is the persistent kernel with clock64() tallies
// of its barriers (the same body, persistent_body<KIND, true>), launched
// only inside the host's counting scope; the kernel the benchmark times
// never carries them.
//
// The per-cell tet sweep (solvers/lattice.py::_tet_sweep; the TPU kernel's
// in-kernel sweep, lattice_pallas.py:591-659 and :1189) projects the 6 Kuhn
// paths of every cell against the same pred (Jacobi), then applies
// pred += w / max(tdeg, 1) * delta.  No atomics: tet_cell_one writes each
// path's multiplier and its four endpoint terms dl*g_k to per-endpoint
// planes (72 floats a particle, 18 MB at res 40, L2-resident), and
// tet_apply_one sums a particle's incidences in the plain engine's
// order, path by path: g0 at its own cell, then g1, g2, g3 from the cells
// at -o1, -o2, -o3 (with the rolls' wrap, whose cells carry dl = 0).  The
// tet degree and the valid-cell mask (_tet_fields' tdeg and valid) are two
// more planes of the same scratch, built once a run on the device by
// tet_tables_one from integer coordinates, so no table is uploaded.
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

#include "grid_barrier.cuh"
#include "lattice_xpbd.cuh"

#define LX_THREADS 256

// barrier kinds (kernels/lattice_cuda.py BARRIERS), grid_barrier.cuh's
#define LX_BLOCK 0     // __syncthreads(): whole bodies in a block
#define LX_GRID_CTR 1  // counting barrier on a global counter
static_assert(LX_BLOCK == BARRIER_BLOCK && LX_GRID_CTR == BARRIER_GRID_CTR,
              "the lattice kernel's barrier kinds are grid_barrier.cuh's");

__device__ __forceinline__ void store3(float* buf, int n, int a,
                                       const float o[3]) {
  for (int c = 0; c < 3; ++c) buf[c * n + a] = o[c];
}

// ---- the per-pass loop: one launch a pass, one thread a particle ---------

__global__ void warm_pass_kernel(LatticeParams p, int f,
                                 const float* __restrict__ w,
                                 const float* __restrict__ pin,
                                 float* __restrict__ pout,
                                 const float* __restrict__ lam_in,
                                 float* __restrict__ lam_out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= p.n) return;
  float o[3];
  warm_one<WrapNbr>(p, GlobalPlanes{p}, f, cell_of(p, a), w, pin, lam_in,
                    lam_out, o);
  store3(pout, p.n, a, o);
}

__global__ void family_pass_kernel(LatticeParams p, int f, int sel,
                                   int jacobi, const float* __restrict__ w,
                                   const float* __restrict__ pin,
                                   float* __restrict__ pout,
                                   const float* __restrict__ lam_in,
                                   float* __restrict__ lam_out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= p.n) return;
  float o[3];
  family_one<WrapNbr>(p, GlobalPlanes{p}, f, sel, jacobi, cell_of(p, a), w,
                      pin, lam_in, lam_out, o);
  store3(pout, p.n, a, o);
}

__global__ void tet_tables_kernel(LatticeParams p, float* __restrict__ terms) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= p.n) return;
  tet_tables_one(p, GlobalPlanes{p}, cell_of(p, a), terms);
}

__global__ void tet_cell_kernel(LatticeParams p, const float* __restrict__ w,
                                const float* __restrict__ pin,
                                float* __restrict__ lam_t,
                                float* __restrict__ terms) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= p.n) return;
  tet_cell_one<WrapNbr>(p, GlobalPlanes{p}, cell_of(p, a), w, pin, lam_t,
                        terms);
}

__global__ void tet_apply_kernel(LatticeParams p, const float* __restrict__ w,
                                 const float* __restrict__ pin,
                                 const float* __restrict__ terms,
                                 float* __restrict__ pout) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= p.n) return;
  float o[3];
  tet_apply_one<WrapNbr>(p, GlobalPlanes{p}, cell_of(p, a), w, pin, terms,
                         o);
  store3(pout, p.n, a, o);
}

// Contacts of one iteration on pred in place, or finalize into x and v.
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
  float pc[3] = {pred[a], pred[n + a], pred[2 * n + a]};
  contact_finalize_one(p, GlobalPlanes{p}, do_contacts, do_finalize, a, x, v,
                       w, pc, tab, pred);
}

// ---- the persistent kernel: one launch a call ----------------------------

// A call's buffers (lattice_xpbd_run's arguments).  No pointer is
// __restrict__: the kernel writes, between barriers, what it reads later.
// The block kind keeps its iterate and multipliers in shared memory and
// leaves lam_scratch, pred_a and pred_b alone.
struct RunArgs {
  float* x;
  float* v;
  const float* w;
  const float* f;
  float* lam;
  float* lam_scratch;
  float* pred_a;
  float* pred_b;
  float* lam_t;
  float* terms;
  const float* tab;
  unsigned long long* counter;  // LX_GRID_CTR's, zeroed before the launch
  int n_substeps;
  int ext_first;
  int chunk;  // particles a block owns: [blockIdx.x * chunk, + chunk)
};

// A thread's walk over its particles: the first from integer division,
// once a call, each next one a stride of blockDim.x further on, its
// coordinates carried with additions (the stride split into bodies, x, y
// and z once; one carry per axis at most).
struct Walker {
  int res, body_n, stride, sb, sx, sy, sz;

  __device__ Walker(const LatticeParams& p, int stride_) {
    res = p.res;
    body_n = p.body_n;
    stride = stride_;
    const int r2 = res * res;
    sb = stride / body_n;
    int l = stride - sb * body_n;
    sx = l / r2;
    l -= sx * r2;
    sy = l / res;
    sz = l - sy * res;
  }

  __device__ __forceinline__ void next(Cell& q) const {
    q.a += stride;
    q.z += sz;
    q.y += sy;
    q.x += sx;
    int b = sb;
    if (q.z >= res) { q.z -= res; ++q.y; }
    if (q.y >= res) { q.y -= res; ++q.x; }
    if (q.x >= res) { q.x -= res; ++b; }
    q.base += b * body_n;
    q.c = q.y * res + q.z;
  }
};

// The contacts and finalize of particle a on its iterate pc, the tail of
// the iteration's last pass (pc to pred[a] unless the iteration is the
// last), and, when `next`, the next substep's predict into pred.
template <class Pl>
__device__ __forceinline__ void tail_one(const LatticeParams& p, const Pl& pl,
                                         const RunArgs& r, int a,
                                         int has_contacts, bool last,
                                         bool next, float pc[3], float* pred,
                                         float* lam_next) {
  contact_finalize_one(p, pl, has_contacts, last, a, r.x, r.v, pl.w(), pc,
                       r.tab, pred);
  if (next)
    predict_one(p, pl, a, r.x, r.v, pl.w(), nullptr, pred, lam_next,
                lam_next, r.lam_t);
}

// Where run_tile finds a call's gathered planes, besides their layout
// (lattice_xpbd.cuh).  The grid kind's in global memory, named by the
// kernel's arguments and read from them where they are used;
struct GridPlanes : GlobalPlanes {
  const RunArgs& r;
  __device__ __forceinline__ const float* w() const { return r.w; }
  __device__ __forceinline__ float* pred(int i) const {
    return i ? r.pred_b : r.pred_a;
  }
  __device__ __forceinline__ float* lam(int i) const {
    return i ? r.lam_scratch : r.lam;
  }
};

// the block kind's in dynamic shared memory, one after another: w, the
// iterate's two buffers (3 planes each) and the multipliers' two (nfam
// planes each), planes of the block's chunk (tile_floats).
extern __shared__ float lx_tile[];

struct SharedPlanes : TilePlanes {
  float *w_, *pred0, *pred1, *lam0, *lam1;
  __device__ __forceinline__ float* w() const { return w_; }
  __device__ __forceinline__ float* pred(int i) const {
    return i ? pred1 : pred0;
  }
  __device__ __forceinline__ float* lam(int i) const {
    return i ? lam1 : lam0;
  }
};

#define LX_EACH(q) for (Cell q = first; q.a < end; walk.next(q))

// Every substep of a call on one block's tile, the passes of the per-pass
// loop in its order with a barrier between two that read each other's
// output.  pl (GridPlanes or SharedPlanes) gives w, the iterate's two
// buffers and the multipliers' two (nfam planes each), and their layout;
// first: the thread's first particle, end: the tile's end, both in pl's
// indices, walk: the thread's stride.  The iterate ping-pongs between the
// pred buffers; family f's multipliers are in lam(0) or lam(1), the buffer
// index advancing with each of f's passes (every family runs as many
// passes as the others, so one index `fb` at substep boundaries).  Returns
// the buffer that holds every family's multipliers at the end.
template <class Pl, class Bar>
__device__ __forceinline__ int run_tile(const LatticeParams& p,
                                        const RunArgs& r, const Pl& pl,
                                        Bar& bar, const Walker& walk,
                                        const Cell first, int end) {
  const int plane = pl.stride();
  const int has_contacts =
      p.floor_mode == 1 || p.n_spheres > 0 || p.n_boxes > 0;
  const int nwarm = p.lambda_mode == 2 ? 1 : 0;
  const int npass = p.colored ? 2 : 1;
  const int per_sub = nwarm + p.iterations * npass;  // passes a family
#define LAM(i) pl.lam(i)

  if (p.tets) LX_EACH(q) tet_tables_one(p, pl, q, r.terms);
  float* cur = pl.pred(0);  // the substep's predicted positions
  float* oth = pl.pred(1);
  int fb = 0;
  bool predicted = false;
  for (int i = 0; i < r.n_substeps; ++i) {
    const int fb_next = fb ^ (per_sub & 1);
    if (!predicted)
      LX_EACH(q) predict_one(p, pl, q.a, r.x, r.v, pl.w(),
                             (r.ext_first && i == 0) ? r.f : nullptr, cur,
                             LAM(fb), LAM(fb), r.lam_t);
    bar.sync();
    float* pin = cur;
    float* pout = oth;
    for (int fi = 0; fi < nwarm * p.nfam; ++fi) {
      const float* lin = LAM(fb) + plane_off<Pl>(fi, plane);
      float* lout = LAM(fb ^ 1) + plane_off<Pl>(fi, plane);
      LX_EACH(q) {
        float o[3];
        warm_one<FastNbr>(p, pl, fi, q, pl.w(), pin, lin, lout, o);
        store3(pout, plane, q.a, o);
      }
      bar.sync();
      float* t = pin; pin = pout; pout = t;
    }
    for (int it = 0; it < p.iterations; ++it) {
      const bool last = it == p.iterations - 1;
      const bool tail = has_contacts || last;
      const bool next = last && i + 1 < r.n_substeps;
      for (int fi = 0; fi < p.nfam; ++fi) {
        for (int ps = 0; ps < npass; ++ps) {
          const int li = fb ^ ((nwarm + it * npass + ps) & 1);
          const float* lin = LAM(li) + plane_off<Pl>(fi, plane);
          float* lout = LAM(li ^ 1) + plane_off<Pl>(fi, plane);
          const bool fused =
              tail && !p.tets && fi == p.nfam - 1 && ps == npass - 1;
          LX_EACH(q) {
            float o[3];
            family_one<FastNbr>(p, pl, fi, p.colored ? ps : -1,
                                p.colored ? 0 : 1, q, pl.w(), pin, lin, lout,
                                o);
            if (fused)
              tail_one(p, pl, r, q.a, has_contacts, last, next, o, pout,
                       LAM(fb_next));
            else
              store3(pout, plane, q.a, o);
          }
          float* t = pin; pin = pout; pout = t;
          if (!(fused && last)) bar.sync();
        }
      }
      if (p.tets) {
        LX_EACH(q) tet_cell_one<FastNbr>(p, pl, q, pl.w(), pin, r.lam_t,
                                         r.terms);
        bar.sync();
        LX_EACH(q) {
          float o[3];
          tet_apply_one<FastNbr>(p, pl, q, pl.w(), pin, r.terms, o);
          if (tail)
            tail_one(p, pl, r, q.a, has_contacts, last, next, o, pout,
                     LAM(fb_next));
          else
            store3(pout, plane, q.a, o);
        }
        float* t = pin; pin = pout; pout = t;
        if (!(tail && last)) bar.sync();
      } else if (p.nfam == 0 && tail) {
        // an iteration without passes: its contacts on pred in place
        LX_EACH(q) {
          float o[3] = {pin[q.a], pin[plane + q.a], pin[2 * plane + q.a]};
          tail_one(p, pl, r, q.a, has_contacts, last, next, o, pin,
                   LAM(fb_next));
        }
        if (!last) bar.sync();
      }
    }
    predicted = p.iterations > 0 && i + 1 < r.n_substeps;
    cur = pin;
    oth = pout;
    fb = fb_next;
  }
#undef LAM
  return fb;
}

#undef LX_EACH

// Floats of a block-kind tile in shared memory (SharedPlanes):
// kernels/lattice_cuda.py tile_bytes.
__host__ __device__ __forceinline__ int tile_floats(int chunk, int nfam) {
  return chunk * (6 + 1 + 2 * nfam);
}

// A block-kind call of one block, its tile's w, iterate and multipliers in
// shared memory for the whole call, planes of the block's chunk.  Each
// thread copies in, and at the end writes back, the particles it walks, so
// no barrier is added: the first read of another thread's slot comes after
// predict's barrier.
template <class Bar>
__device__ __forceinline__ void block_tile(const LatticeParams& p,
                                           const RunArgs& r, Bar& bar,
                                           const Walker& walk,
                                           const Cell first, int lo,
                                           int hi) {
  const int n = p.n, nfam = p.nfam;
  const int cs = r.chunk;
  const SharedPlanes pl{{cs, lo}, lx_tile, lx_tile + cs, lx_tile + 4 * cs,
                        lx_tile + 7 * cs, lx_tile + (7 + nfam) * cs};
  for (int s = threadIdx.x; s < hi - lo; s += blockDim.x) {
    pl.w()[s] = r.w[lo + s];
    for (int fi = 0; fi < nfam; ++fi)
      pl.lam(0)[fi * cs + s] = r.lam[(size_t)fi * n + lo + s];
  }
  Cell mine = first;  // slots: indices less lo
  mine.a -= lo;
  mine.base -= lo;
  const int fb = run_tile(p, r, pl, bar, walk, mine, hi - lo);
  // the grid kind's last barrier, kept so both kinds cross the loop's
  // count (a thread writes back only what it wrote itself)
  if (fb) bar.sync();
  for (int s = threadIdx.x; s < hi - lo; s += blockDim.x)
    for (int fi = 0; fi < nfam; ++fi)
      r.lam[(size_t)fi * n + lo + s] = pl.lam(fb)[fi * cs + s];
}

// A call of one block.  The block kind (whole bodies a block) keeps its
// tile in shared memory (block_tile): no pass reads outside its block, so
// every gather is a shared-memory read with a 32-bit address.  The grid
// kind keeps every plane in global memory (its tiles read halos other
// blocks wrote) and copies the multipliers back from lam_scratch when they
// end there.
// COUNT: the counted kernel's tallies (lattice_counted_kernel); without it
// `totals` is unused.
template <int KIND, bool COUNT>
__device__ __forceinline__ void persistent_body(
    const LatticeParams& p, const RunArgs& r, unsigned long long* totals) {
  long long entered = 0;
  if constexpr (COUNT) entered = clock64();
  Barrier<KIND, COUNT> bar{r.counter, 0ull};
  const int n = p.n;
  const int lo = blockIdx.x * r.chunk;
  const int hi = min(lo + r.chunk, n);
  const Walker walk(p, blockDim.x);
  const Cell first = cell_of(p, lo + (int)threadIdx.x);
  if constexpr (KIND == LX_BLOCK) {
    block_tile(p, r, bar, walk, first, lo, hi);
  } else if (run_tile(p, r, GridPlanes{{p}, r}, bar, walk, first, hi)) {
    // every family's multipliers end in lam_scratch: back to lam, once the
    // last pass's readers are done
    bar.sync();
    for (Cell q = first; q.a < hi; walk.next(q))
      for (int fi = 0; fi < p.nfam; ++fi) {
        const size_t k = (size_t)fi * n + q.a;
        r.lam[k] = r.lam_scratch[k];
      }
  }
  if constexpr (COUNT) {
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(totals, bar.wait_cycles);
      atomicAdd(totals + 1, (unsigned long long)(clock64() - entered));
      atomicAdd(totals + 2, bar.crossed);
    }
  }
}

// A call, the kernel the benchmark times and profiles.
template <int KIND>
__global__ void __launch_bounds__(LX_THREADS)
    lattice_persistent_kernel(LatticeParams p, RunArgs r) {
  persistent_body<KIND, false>(p, r, nullptr);
}

// The same call, counted: each warp adds, at its exit, lane 0's cycles
// inside Barrier::sync() (arrival to release), its cycles resident (entry
// to exit) and the barriers it crossed to totals[0], [1] and [2].  The
// simulated state is the off kernel's to the bit; only
// softbodysimulation_tpu_torch.diag.profiling.counting() launches it.
template <int KIND>
__global__ void __launch_bounds__(LX_THREADS)
    lattice_counted_kernel(LatticeParams p, RunArgs r,
                           unsigned long long* totals) {
  persistent_body<KIND, true>(p, r, totals);
}

static const void* persistent_fn(int kind, bool counted) {
  if (kind == LX_BLOCK)
    return counted ? (const void*)lattice_counted_kernel<LX_BLOCK>
                   : (const void*)lattice_persistent_kernel<LX_BLOCK>;
  if (kind == LX_GRID_CTR)
    return counted ? (const void*)lattice_counted_kernel<LX_GRID_CTR>
                   : (const void*)lattice_persistent_kernel<LX_GRID_CTR>;
  return nullptr;
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

static bool bad_params(const LatticeParams& p, const float* colliders,
                       const float* lam_t, const float* tet_terms) {
  return p.nfam > LX_MAX_FAM || p.nfam < 0 || p.n_spheres > LX_MAX_SPHERES ||
         p.n_boxes > LX_MAX_BOXES || !colliders || p.body_n <= 0 ||
         p.n % p.body_n != 0 || (p.tets && (!lam_t || !tet_terms));
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

// The persistent kernel of barrier `kind` on `device`: its threads a block
// (LX_THREADS), the blocks of it one SM holds at once, the SMs, and
// whether the device launches cooperatively.  Returns a cudaError_t.  (The
// counted twin takes the same plan: it uses no more registers a thread.)
int lattice_xpbd_occupancy(int device, int kind, int* threads,
                           int* blocks_per_sm, int* n_sms, int* coop) {
  const void* fn = persistent_fn(kind, false);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        LX_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, device);
  *threads = LX_THREADS;
  return (int)err;
}

// tile_floats for kernels/lattice_cuda.py to check its tile_bytes against.
int lattice_xpbd_tile_floats(int chunk, int nfam) {
  return tile_floats(chunk, nfam);
}

// Returns, and clears, the calling thread's last CUDA error: the per-pass
// loop checks each launch with cudaGetLastError(), which would also report
// what an earlier call left (a refused launch).
int lattice_xpbd_last_error(void) { return (int)cudaGetLastError(); }

// Advance n_substeps substeps on `stream` in one launch of the persistent
// kernel.  x, v: (3, N) in/out; w: (N); f: (3, N) ext force consumed on
// the first substep when ext_first, else unused; lam: (nfam, N) in/out;
// lam_scratch: (nfam, N) and pred_a, pred_b: (3, N) scratch; lam_t: (6, N)
// tet multipliers in/out, or null when the state has none; tet_terms:
// (TET_PLANES, N) scratch when p.tets; colliders: the collider table
// (1 + n_spheres + n_boxes, KIN_W).  kind: LX_BLOCK (grid blocks of
// `chunk` particles, a whole number of bodies each, each block's tile in
// tile_floats(chunk, nfam) floats of dynamic shared memory, above 48 KB
// after raising the kernel's limit, whose refusal is returned before any
// launch) or LX_GRID_CTR (a
// cooperative launch of `grid` blocks, planned by kernels/lattice_cuda.py
// to fit the device at once; counter: one 64-bit word of scratch, zeroed
// here).  totals: null launches lattice_persistent_kernel; else three
// 64-bit totals that lattice_counted_kernel adds to (never zeroed here).
// *n_launched counts the kernels launched (1, or 0 for no substep).
// Returns a cudaError_t: the cooperative launch itself refuses a grid
// that cannot be co-resident (cudaErrorCooperativeLaunchTooLarge);
// nothing is synchronised.
int lattice_xpbd_run(const LatticeParams* hp, int device, float* x, float* v,
                     const float* w, const float* f, int ext_first,
                     float* lam, float* lam_scratch, float* pred_a,
                     float* pred_b, float* lam_t, float* tet_terms,
                     const float* colliders, int n_substeps, int kind,
                     int grid, int chunk, unsigned long long* counter,
                     unsigned long long* totals, long long* n_launched,
                     void* stream_handle) {
  const LatticeParams p = *hp;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = persistent_fn(kind, totals != nullptr);
  if (!fn || bad_params(p, colliders, lam_t, tet_terms) || grid <= 0 ||
      chunk <= 0 || (long long)grid * chunk < p.n ||
      (kind == LX_BLOCK && chunk % p.body_n != 0) ||
      (kind == LX_GRID_CTR && !counter))
    return (int)cudaErrorInvalidValue;
  if (n_substeps <= 0) return (int)cudaSuccess;

  RunArgs r{x, v, w, f, lam, lam_scratch, pred_a, pred_b, lam_t, tet_terms,
            colliders, counter, n_substeps, ext_first, chunk};
  void* args[] = {(void*)&p, (void*)&r, (void*)&totals};
  if (kind == LX_BLOCK) {
    const size_t smem = sizeof(float) * (size_t)tile_floats(chunk, p.nfam);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    // the launch's own status: cudaGetLastError() after <<<>>> would also
    // report an error an earlier call left on this thread (a refused
    // cooperative launch), and fail this launch for it
    err = cudaLaunchKernel(fn, dim3(grid), dim3(LX_THREADS), args, smem,
                           stream);
  } else {
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(LX_THREADS), args,
                                      0, stream);
  }
  if (err != cudaSuccess) return (int)err;
  *n_launched = 1;
  return (int)cudaSuccess;
}

// The yardstick: the same substeps as lattice_xpbd_run, one launch a pass
// (LX_THREADS threads a block, one a particle), the design the persistent
// kernel replaced.  No route reaches it; chip_smoke.py and the card tests
// time and check the persistent kernel against it.  *n_launched counts the
// kernels launched.
int lattice_xpbd_run_per_pass(const LatticeParams* hp, int device, float* x,
                              float* v, const float* w, const float* f,
                              int ext_first, float* lam, float* lam_scratch,
                              float* pred_a, float* pred_b, float* lam_t,
                              float* tet_terms, const float* colliders,
                              int n_substeps, long long* n_launched,
                              void* stream_handle) {
  const LatticeParams p = *hp;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  long long launched = 0;
  *n_launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_params(p, colliders, lam_t, tet_terms))
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
