// Fused project + dedup + compact for a batch of frames (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel `fused_compact_project`
// (cama_tpu/ops/fused_compact.py:241-326, kernel body `_kernel` :84-238).
// Per frame f and point i it computes
//   crop test      xyz = A[f] rows 0..2 applied to (x, y, z, 1), inclusive box
//   projection     (px, py, pz) = B[f, c] applied to (x, y, z, 1) per camera
//   keep           pz > 0 & 0 <= u < W & 0 <= v < H & in_crop & valid & fv[f]
//                  with u = px / pz, v = py / pz (pz replaced by 1 when <= 0)
//   pixel          pix = keep ? int(v) * W + int(u) : -1
//   dedup          eff = pix >= 0 & pix(i + 1) != pix(i)   (original order)
//   payload        vals[f, r, c] = eff ? pix * MAX_CLS + cls + 1 : 0
// and stably compacts the rows of points with any eff into vals[f, 0..],
// row index = paint priority; count[f] is the true total, also above k_cap.
//
// What bounds it on this card: per frame it streams each point's 12 B
// position, 1 B validity and 4 B class id (16-17 B/point) from device
// memory and projects C + 1 rows of four terms; the compaction writes only
// the survivors (a few percent of P).  Arithmetic is ~100 flops/point, so
// the kernel is bound by device-memory bandwidth, and across F frames of a
// chunk the 17 MB point set of a 1M-point scene stays in the 50 MB L2.
//
// How the design answers it: one launch covers all F frames of a chunk
// (grid (ceil(P/BLOCK), F)); one thread owns one point, loads it once and
// keeps its C pixel codes in registers; the successor's codes come from the
// next lane by warp shuffle, and only lane 31 recomputes point i + 1, so
// blocks need no carry between them (the TPU kernel's SMEM pend carry is
// gone).  Compaction is count -> scan -> write: pass 1 counts survivors per
// block with __ballot_sync/__popc, pass 2 scans the block counts per frame,
// pass 3 recomputes and ranks each survivor inside its block (ballot prefix
// popcount plus warp offsets in shared memory) and writes its row.  The
// list lives in device memory as int32, so the TPU kernel's VMEM list
// budget and its 24-bit bf16 byte-split encoding do not exist here.
//
// Bit-exactness: the projection is csrc/project.cuh's, evaluated in the
// same order as the plain PyTorch version (ops/fused_compact.py), so the
// two agree exactly on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "project.cuh"

namespace {

using cama::Geo;
using cama::MAX_CAM;
constexpr int MAX_CLS = 8;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// Pixel code of point (x, y, z) in every camera: -1 when not kept.
__device__ __forceinline__ void project_point(const float* mats, const Geo& g,
                                              float x, float y, float z,
                                              bool ok, int pix[MAX_CAM]) {
  ok = ok && cama::in_crop(mats, g, x, y, z);
#pragma unroll
  for (int c = 0; c < MAX_CAM; ++c) {
    pix[c] = -1;
    float u, v;
    if (c < g.C && cama::project_cam(mats, g, c, x, y, z, ok, u, v))
      pix[c] = (int)v * g.W + (int)u;
  }
}

// Passes 1 (WRITE = false: per-block survivor counts) and 3 (WRITE = true:
// rank and write each survivor's row).
template <bool WRITE>
__global__ void __launch_bounds__(BLOCK)
fc_pass(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
        const int* __restrict__ cls, const uint8_t* __restrict__ fv,
        const float* __restrict__ A, const float* __restrict__ B, Geo g,
        int nblk, int* __restrict__ block_cnt,
        const int* __restrict__ block_off, int* __restrict__ vals,
        int k_cap) {
  __shared__ float mats[cama::MATS_FLOATS];
  __shared__ int warp_cnt[WARPS];
  const int f = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  cama::load_mats(mats, A, B, f, g.C, tid);
  __syncthreads();
  const bool frame_ok = fv[f] != 0;

  const int i = blockIdx.x * BLOCK + tid;
  const bool in_range = i < g.P;
  int pix[MAX_CAM];
  {
    float x = 0.f, y = 0.f, z = 0.f;
    bool ok = false;
    if (in_range) {
      x = pts[3 * (size_t)i];
      y = pts[3 * (size_t)i + 1];
      z = pts[3 * (size_t)i + 2];
      ok = frame_ok && valid[i] != 0;
    }
    project_point(mats, g, x, y, z, ok, pix);
  }
  // successor codes: lane + 1 by shuffle; lane 31 recomputes point i + 1
  int spix[MAX_CAM];
#pragma unroll
  for (int c = 0; c < MAX_CAM; ++c) spix[c] = __shfl_down_sync(FULL, pix[c], 1);
  if (lane == 31) {
    const int j = i + 1;
    float x = 0.f, y = 0.f, z = 0.f;
    bool ok = false;
    if (j < g.P) {
      x = pts[3 * (size_t)j];
      y = pts[3 * (size_t)j + 1];
      z = pts[3 * (size_t)j + 2];
      ok = frame_ok && valid[j] != 0;
    }
    project_point(mats, g, x, y, z, ok, spix);
  }

  bool any = false;
  int val[MAX_CAM];
  const int ci = in_range ? cls[i] : 0;
#pragma unroll
  for (int c = 0; c < MAX_CAM; ++c) {
    const bool eff = pix[c] >= 0 && spix[c] != pix[c];
    val[c] = eff ? pix[c] * MAX_CLS + ci + 1 : 0;
    any = any || eff;
  }
  const unsigned bal = __ballot_sync(FULL, any);
  if (lane == 0) warp_cnt[warp] = __popc(bal);
  __syncthreads();

  if (!WRITE) {
    if (tid == 0) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += warp_cnt[w];
      block_cnt[(size_t)f * nblk + blockIdx.x] = s;
    }
    return;
  }
  if (any) {
    int rank = __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += warp_cnt[w];
    const int row = block_off[(size_t)f * nblk + blockIdx.x] + rank;
    if (row < k_cap) {
      int* dst = vals + ((size_t)f * k_cap + row) * g.C;
      for (int c = 0; c < g.C; ++c) dst[c] = val[c];
    }
  }
}

// Pass 2: one block per frame, exclusive scan of the block counts into
// block offsets, and the frame's total.
__global__ void __launch_bounds__(SCAN_THREADS)
fc_scan(const int* __restrict__ block_cnt, int nblk,
        int* __restrict__ block_off, int* __restrict__ count) {
  __shared__ int wsum[SCAN_THREADS / 32];
  __shared__ int carry;
  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nblk; base += SCAN_THREADS) {
    const int idx = base + tid;
    const int v = idx < nblk ? block_cnt[(size_t)f * nblk + idx] : 0;
    int s = v;  // inclusive scan inside the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    if (lane == 31) wsum[warp] = s;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int w = wsum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += t;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp ? wsum[warp - 1] : 0) + s - v;
    if (idx < nblk) block_off[(size_t)f * nblk + idx] = excl;
    __syncthreads();  // everyone has read carry and wsum
    if (tid == SCAN_THREADS - 1) carry = excl + v;
    __syncthreads();
  }
  if (tid == 0) count[f] = carry;
}

}  // namespace

extern "C" {

// Number of point blocks per frame: size of the block_cnt / block_off
// scratch rows the caller allocates ([F, nblk] int32 each).
int cama_fc_blocks(int P) { return (P + BLOCK - 1) / BLOCK; }

// Passes 1 and 2: count[F] survivor totals (block_off is left filled).
int cama_fc_count(const float* pts, const uint8_t* valid, const int* cls,
                  const uint8_t* fv, const float* A, const float* B, int P,
                  int F, int C, int W, int H, float lo0, float lo1, float lo2,
                  float hi0, float hi1, float hi2, int* block_cnt,
                  int* block_off, int* count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Geo g = cama::make_geo(P, F, C, W, H, lo0, lo1, lo2, hi0, hi1, hi2);
  const int nblk = cama_fc_blocks(P);
  fc_pass<false><<<dim3(nblk, F), BLOCK, 0, s>>>(
      pts, valid, cls, fv, A, B, g, nblk, block_cnt, nullptr, nullptr, 0);
  fc_scan<<<F, SCAN_THREADS, 0, s>>>(block_cnt, nblk, block_off, count);
  return (int)cudaGetLastError();
}

// Passes 1-3: vals[F, k_cap, C] survivor rows and count[F] totals.
int cama_fc_project(const float* pts, const uint8_t* valid, const int* cls,
                    const uint8_t* fv, const float* A, const float* B, int P,
                    int F, int C, int W, int H, float lo0, float lo1,
                    float lo2, float hi0, float hi1, float hi2, int k_cap,
                    int* block_cnt, int* block_off, int* vals, int* count,
                    void* stream) {
  int err = cama_fc_count(pts, valid, cls, fv, A, B, P, F, C, W, H, lo0, lo1,
                          lo2, hi0, hi1, hi2, block_cnt, block_off, count,
                          stream);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const Geo g = cama::make_geo(P, F, C, W, H, lo0, lo1, lo2, hi0, hi1, hi2);
  const int nblk = cama_fc_blocks(P);
  fc_pass<true><<<dim3(nblk, F), BLOCK, 0, s>>>(
      pts, valid, cls, fv, A, B, g, nblk, nullptr, block_off, vals, k_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
