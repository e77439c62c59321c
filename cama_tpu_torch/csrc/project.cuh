// The projection every kernel of this package shares (CUDA C++, sm_90a).
//
// A point (x, y, z) of frame f is kept by camera c when
//   crop test      xyz = A[f] rows 0..2 applied to (x, y, z, 1), inclusive box
//   projection     (px, py, pz) = B[f, c] applied to (x, y, z, 1)
//   keep           pz > 0 & 0 <= u < W & 0 <= v < H & in_crop & valid & fv[f]
//                  with u = px / pz, v = py / pz (pz replaced by 1 when <= 0).
//
// Bit-exactness: every product and sum is an explicit round-to-nearest
// intrinsic in the order ((m0*x + m1*y) + m2*z) + m3, the divide is
// __fdiv_rn, and the library is built with -fmad=false; the plain PyTorch
// version (ops/geometry.py project_frames) evaluates the same sequence
// elementwise, so kernels and plain versions keep the same points and
// compute the same (v, u) bit for bit on the card.
#pragma once

#include <cuda_runtime.h>

namespace cama {

constexpr int MAX_CAM = 8;  // cameras per frame (matrices held on chip)

// Geometry of one launch: points, frames, cameras, image size, crop box.
struct Geo {
  int P, F, C, W, H;
  float lo0, lo1, lo2, hi0, hi1, hi2;
};

inline Geo make_geo(int P, int F, int C, int W, int H, float lo0, float lo1,
                    float lo2, float hi0, float hi1, float hi2) {
  Geo g;
  g.P = P; g.F = F; g.C = C; g.W = W; g.H = H;
  g.lo0 = lo0; g.lo1 = lo1; g.lo2 = lo2;
  g.hi0 = hi0; g.hi1 = hi1; g.hi2 = hi2;
  return g;
}

__device__ __forceinline__ float row4(const float* m, float x, float y,
                                      float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)),
                             __fmul_rn(m[2], z)),
                   m[3]);
}

// Frame matrices of one block in shared memory: A rows 0..2 (12 floats)
// followed by B[c] rows 0..2 (12 per camera).
constexpr int MATS_FLOATS = 12 + 12 * MAX_CAM;

__device__ __forceinline__ void load_mats(float* mats, const float* A,
                                          const float* B, int f, int C,
                                          int tid) {
  if (tid < 12) mats[tid] = A[(size_t)f * 16 + tid];
  if (tid < 12 * C) mats[12 + tid] = B[(size_t)f * C * 12 + tid];
}

// The chassis crop test of point (x, y, z).
__device__ __forceinline__ bool in_crop(const float* mats, const Geo& g,
                                        float x, float y, float z) {
  const float cx = row4(mats + 0, x, y, z);
  const float cy = row4(mats + 4, x, y, z);
  const float cz = row4(mats + 8, x, y, z);
  return cx >= g.lo0 && cx <= g.hi0 && cy >= g.lo1 && cy <= g.hi1 &&
         cz >= g.lo2 && cz <= g.hi2;
}

// Camera c's rows (px, py, pz) of point (x, y, z), before the divide.
__device__ __forceinline__ void cam_rows(const float* mats, int c, float x,
                                         float y, float z, float& px,
                                         float& py, float& pz) {
  const float* b = mats + 12 + 12 * c;
  px = row4(b + 0, x, y, z);
  py = row4(b + 4, x, y, z);
  pz = row4(b + 8, x, y, z);
}

// Camera c's pixel coordinates (u, v) of point (x, y, z); returns whether
// the camera keeps it, given `ok` (crop, validity and frame validity).
__device__ __forceinline__ bool project_cam(const float* mats, const Geo& g,
                                            int c, float x, float y, float z,
                                            bool ok, float& u, float& v) {
  float px, py, pz;
  cam_rows(mats, c, x, y, z, px, py, pz);
  const bool mz = pz > 0.0f;
  const float sz = mz ? pz : 1.0f;
  u = __fdiv_rn(px, sz);
  v = __fdiv_rn(py, sz);
  return ok && mz && u >= 0.0f && u < (float)g.W && v >= 0.0f &&
         v < (float)g.H;
}

}  // namespace cama
