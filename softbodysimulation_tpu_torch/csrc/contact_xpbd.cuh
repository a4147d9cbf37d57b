// Interface of the blocked self-collision pass (contact_xpbd.cu), shared by
// its own library and by the mesh library (mesh_xpbd.cu), which runs the
// same pass inside its substep loop.  Mirrored by ctypes in
// kernels/contact_cuda.py (ContactParams, ContactBuffers).

#pragma once

#include <cuda_runtime.h>

// Every field is 4 bytes wide, so the ctypes mirror has no padding.
struct ContactParams {
  int n;            // particles
  int block;        // B: particles per block (>= 8)
  int nb;           // row blocks, npad / B
  int m_nbr;        // M: candidate blocks per row block (<= nb)
  int si;           // pred element (i, c) lies at pred[i * si + c * sc]
  int sc;
  float diam;       // 2 * particle_radius
  float diam2;      // (2 * particle_radius)^2
  float omega;      // self_collision_omega
  int design;       // 0 culled (the pass), 1 serial (the yardstick)
};

// Device pointers (and one byte count), all 8 bytes wide.
struct ContactBuffers {
  float* pred;        // positions, strided as ContactParams says
  const float* w;     // (N) inverse masses
  int* order;         // (N) curve order: slot s holds particle order[s]
  float* stats;       // (9) mean xyz, min xyz, max xyz of pred
  float* xs;          // (3, npad) serial: centred positions, curve order
  float* sq;          // (npad) serial: |xs|^2
  float* ws;          // (npad) inverse masses in curve order, pads 0
  float* xq;          // (npad, 4) culled: centred xyz and |x|^2 packed
  float* box;         // (nb, 6) block AABB: min xyz, max xyz
  float* sbox;        // (nb * ceil(B/32), 8) culled: AABB of each 32-slot
                      // sub-block: min xyz, 0, max xyz, 0
  int* nbr;           // (nb, M) candidate blocks, nearest first
  int* ok;            // (nb, M) 1 where the candidate block touches
  float* corr;        // (3, npad) correction of each slot
  unsigned* bits;     // optional (npad, ceil(M*B/32)): touching pairs
  int* codes;         // (N) Hilbert codes
  int* codes_sorted;  // (N)
  int* iota;          // (N)
  void* sort_temp;    // CUB radix-sort scratch
  long long sort_temp_bytes;
};

extern "C" {
// Curve order of pred into b.order: stats, Hilbert codes, a stable radix
// sort (CUB) of the codes with the particle ids.  *n_launched counts.
int contact_xpbd_order(const ContactParams* p, const ContactBuffers* b,
                       long long* n_launched, void* stream);
// The pass up to the correction, into b.corr: stats, the centred sorted
// layout with the block AABBs, and the top-M candidate selection with the
// pair tests (three launches; the serial design's five).
int contact_xpbd_corr(const ContactParams* p, const ContactBuffers* b,
                      long long* n_launched, void* stream);
}
