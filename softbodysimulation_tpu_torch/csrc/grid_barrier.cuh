// The barrier between the passes of a persistent kernel, shared by the
// lattice (lattice_xpbd.cu) and mesh (mesh_xpbd.cu) libraries.
//
// BARRIER_BLOCK: __syncthreads(), for a block that holds whole bodies (no
// pass reads across a body, so such a block needs no other block).
// BARRIER_GRID_CTR: a counting barrier on one 64-bit word of global memory
// in a cooperative launch (a grid that cannot be co-resident is refused,
// never run): every block's thread 0 adds 1 with release semantics after
// the block's __syncthreads() (so its block's writes go with it) and spins
// with acquire loads until all gridDim.x blocks have arrived at this
// barrier, the k-th of the launch.  The counter only grows, so it needs
// neither a reset nor a sense flag; the caller zeroes it before the
// launch.  It timed ahead of cooperative_groups' grid.sync() at every
// lattice size tried (PERF.md, PR 10), which is why it is hand-written.

#pragma once

#include <cuda_runtime.h>

#define BARRIER_BLOCK 0
#define BARRIER_GRID_CTR 1

__device__ __forceinline__ void red_release_add(unsigned long long* ptr) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;"
               :: "l"(ptr), "l"(1ull) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* ptr) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(ptr) : "memory");
  return v;
}

template <int KIND>
struct Barrier {
  unsigned long long* counter;
  unsigned long long target;

  __device__ void sync() {
    if constexpr (KIND == BARRIER_BLOCK) {
      __syncthreads();
    } else {
      __syncthreads();
      target += gridDim.x;
      if (threadIdx.x == 0) {
        red_release_add(counter);
        while (ld_acquire(counter) < target) {
        }
      }
      __syncthreads();
    }
  }
};
