// All-camera projection of a chunk of frames (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel `project_frame_pallas`
// (cama_tpu/ops/pallas_project.py:82-147, kernel body `_kernel` :29-79).
// For frame f, camera c and point i it writes
//   vu[f, c, i]    = (v, u), the pixel coordinates of csrc/project.cuh
//   keep[f, c, i]  = crop & z > 0 & in-bounds & valid[i] & fv[f]   (uint8)
// for every point, kept or not, as ops/geometry.py project_frames does.
//
// What bounds it on this card: per frame it reads each point's 12 B
// position and 1 B validity and writes C * (8 + 1) B, 54 B/point for six
// cameras; arithmetic is ~100 flops/point.  So it is bound by the writes
// to device memory: at 1,048,576 points ~74 MB/frame, ~22 us at 3.35 TB/s.
//
// How the design answers it: one launch covers all F frames of a chunk
// (grid (ceil(P/BLOCK), F)); one thread owns one point and writes its
// (v, u) as one 8-byte store per camera, so a warp's stores to one camera's
// row are one contiguous 256-byte run, and its keep bytes a 32-byte run.
// The TPU kernel contracted [C*4, 4] @ [4, TILE] on the MXU and padded P to
// a multiple of its 2048-point tile; here the K = 4 contraction is four
// scalar products per row and the ragged last block is masked, so P needs
// no padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "project.cuh"

namespace {

using cama::Geo;
constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
pp_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
          const uint8_t* __restrict__ fv, const float* __restrict__ A,
          const float* __restrict__ B, Geo g, float2* __restrict__ vu,
          uint8_t* __restrict__ keep) {
  __shared__ float mats[cama::MATS_FLOATS];
  const int f = blockIdx.y;
  cama::load_mats(mats, A, B, f, g.C, threadIdx.x);
  __syncthreads();
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= g.P) return;
  const float x = pts[3 * (size_t)i];
  const float y = pts[3 * (size_t)i + 1];
  const float z = pts[3 * (size_t)i + 2];
  const bool ok =
      fv[f] != 0 && valid[i] != 0 && cama::in_crop(mats, g, x, y, z);
  for (int c = 0; c < g.C; ++c) {
    float u, v;
    const bool k = cama::project_cam(mats, g, c, x, y, z, ok, u, v);
    const size_t o = ((size_t)f * g.C + c) * g.P + i;
    vu[o] = make_float2(v, u);
    keep[o] = k ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// vu[F, C, P] float2 (v, u) and keep[F, C, P] uint8 for a chunk of frames.
int cama_pp_project(const float* pts, const uint8_t* valid, const uint8_t* fv,
                    const float* A, const float* B, int P, int F, int C,
                    int W, int H, float lo0, float lo1, float lo2, float hi0,
                    float hi1, float hi2, float* vu, uint8_t* keep,
                    void* stream) {
  const Geo g = cama::make_geo(P, F, C, W, H, lo0, lo1, lo2, hi0, hi1, hi2);
  pp_kernel<<<dim3((P + BLOCK - 1) / BLOCK, F), BLOCK, 0,
              (cudaStream_t)stream>>>(pts, valid, fv, A, B, g,
                                      reinterpret_cast<float2*>(vu), keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
