// The rigid world as the lattice and mesh kernels read it: one small device
// table of 1 + S + B rows of KIN_W floats, read on every launch, so a new
// collider pose needs neither a rebuild of the kernels' constants nor a
// host sync (the TPU kernels' traced pose block, lattice_pallas.py:576-589,
// mesh_pallas.py:881-898).
//   row 0           ground height  (eight pad floats)
//   rows 1..S       spheres  cx cy cz r  vx vy vz  (two pad floats)
//   rows 1+S..S+B   boxes    cx cy cz hx hy hz  vx vy vz
// The wrappers (ops/collision.py RigidWorld.table) build it from a
// ColliderSet on each call, or once from the config's ground, spheres and
// boxes with zero velocities: subtracting a zero velocity leaves every bit
// as it was, so one code path serves both.
//
// box_project is shared by both kernels; it is ops/collision.py::
// box_sdf_project for one particle and one box, operation for operation
// (the face normal as an identity row times the sign, ties of the argmin to
// the first axis, sign(0) = +1), so with -fmad=false it rounds as the plain
// engine does.

#pragma once

#define KIN_W 9

__device__ __forceinline__ const float* sphere_row(const float* tab, int s) {
  return tab + (size_t)(1 + s) * KIN_W;
}

__device__ __forceinline__ const float* box_row(const float* tab, int n_sph,
                                                int b) {
  return tab + (size_t)(1 + n_sph + b) * KIN_W;
}

// Box row r (center r[0..2], half extents r[3..5], velocity r[6..8]) on one
// particle of inverse mass wa: pc in/out, xc its substep-entry position.
__device__ __forceinline__ void box_project(const float* r, float wa,
                                            float static_eps, float dt,
                                            float friction_dt,
                                            const float xc[3], float pc[3]) {
  float local[3], face[3];
  for (int c = 0; c < 3; ++c) {
    local[c] = pc[c] - r[c];
    face[c] = r[3 + c] - fabsf(local[c]);
  }
  const bool act = face[0] > 0.f && face[1] > 0.f && face[2] > 0.f &&
                   wa >= static_eps;
  int axis = 0;
  if (face[1] < face[axis]) axis = 1;
  if (face[2] < face[axis]) axis = 2;
  const float sg = local[axis] < 0.f ? -1.f : 1.f;
  const float push = sg * face[axis];
  float e[3], nrm[3], vel[3];
  for (int c = 0; c < 3; ++c) {
    e[c] = c == axis ? 1.f : 0.f;
    pc[c] = pc[c] + (act ? e[c] * push : 0.f);
  }
  for (int c = 0; c < 3; ++c) {
    nrm[c] = e[c] * sg;
    vel[c] = (pc[c] - xc[c]) / dt - r[6 + c];
  }
  const float vn = vel[0] * nrm[0] + vel[1] * nrm[1] + vel[2] * nrm[2];
  for (int c = 0; c < 3; ++c)
    pc[c] = pc[c] - (act ? (vel[c] - vn * nrm[c]) * friction_dt : 0.f);
}
