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
// What bounds it on this card.  Bytes: each point's 12 B position and 1 B
// validity per frame, its 4 B class id only where it survives, and the
// union rows out (C x 4 B each).  At 1,048,576 points x 16 frames of the
// wide fixture that is 17.8 MB in and ~24k rows (0.6 MB) a frame out:
// ~0.5 us a frame at 3.35 TB/s, and the 17 MB point set stays in the 50 MB
// L2 across the chunk's frames.  Operations: the crop test of every point
// and the camera projections of the 16 % inside the crop, ~0.7 us a frame
// at 67 TFLOP/s.  Issued instructions and their latency are what bound
// it: with -fmad=false and __fdiv_rn, projecting one point into six
// cameras issues ~300 instructions, ~13 us a frame at 1M points on 132 SMs
// for a single pass without culling.  The first design paid it twice (a
// counting pass and a write pass), twice again in every warp (lane 31
// recomputed point i + 1 alone while 31 lanes waited), and ran a scan
// kernel between the passes: ~0.07 ms a frame on the card.
//
// What the design does about it:
// - One launch, one projection per point and frame.  A tile is 1024
//   points (four 32-point groups per warp; the counting kernel takes 768).
//   Ticket b of one atomic counter (the wrapper zeroes it) is tile b / F of
//   frame b % F, so every predecessor of a tile has started, the chunk's
//   frames of one tile run side by side and share its points in L2, and a
//   frame's consecutive tiles are F tickets apart.  Tiles scan by decoupled
//   look-back (Merrill & Garland): each publishes a 64-bit descriptor
//   (status in the high word: aggregate or inclusive prefix; the count in
//   the low word) with a release store, and warp 0 reads up to 32
//   predecessors at a time, one per lane, with acquire loads.  The wrapper
//   zeroes descriptors and the ticket with one memset; the frame's last
//   tile writes count[f].
// - Latency hidden, not paid in turn: every load of a tile (its points,
//   the halo point below, the frame's matrices) is issued before any
//   arithmetic, and the survivors' class ids are in flight across the scan
//   and the look-back.  The register budget keeps four blocks on an SM.
// - No recompute for the successor.  Inside a group it comes by shuffle;
//   lane 31 takes the next group's first codes from shared memory; the
//   tile's one outside successor (the next tile's first point) is projected
//   by C lanes of the last warp, one camera each.
// - Warp-level culls.  After the crop test a group with no in-crop valid
//   point skips every camera (__any_sync), and a camera that no lane sees
//   in front (pz > 0) skips its divides.  Both are exact: the skipped codes
//   are -1 either way, and dedup only consults a successor where pix >= 0.
//   The points are instance-major polylines, so groups are spatially
//   coherent: ~84 % of the groups of the wide fixture lie outside the crop.
// - count_union is the same tile body with no writes and no look-back: one
//   launch, one atomicAdd per tile into a zeroed count[f].
// On the card (NVIDIA H100 80GB HBM3, 700 W) this runs at ~0.014 ms a frame
// (count_union ~0.009), ~5 % of its bound: a 768-1024-point tile waits on
// its loads, the ticket and the look-back, at half occupancy.
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
// 32-point groups per warp and tile, and the blocks per SM the register
// budget must allow, of the writing and the counting kernel
constexpr int WRITE_ITEMS = 4, WRITE_MIN_BLOCKS = 4;
constexpr int COUNT_ITEMS = 3, COUNT_MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;

// look-back descriptor: status in the high word (0 = not yet published),
// the tile's count or its inclusive prefix in the low word
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Pixel codes of one 32-point group in every camera (-1 = not kept); every
// lane of the warp calls it, ragged-tail lanes with ok = false.
__device__ __forceinline__ void project_group(const float* mats, const Geo& g,
                                              float x, float y, float z,
                                              bool ok, int pix[MAX_CAM]) {
#pragma unroll
  for (int c = 0; c < MAX_CAM; ++c) pix[c] = -1;
  ok = ok && cama::in_crop(mats, g, x, y, z);
  if (!__any_sync(FULL, ok)) return;  // the whole group is culled
#pragma unroll
  for (int c = 0; c < MAX_CAM; ++c) {
    if (c >= g.C) break;
    float px, py, pz;
    cama::cam_rows(mats, c, x, y, z, px, py, pz);
    const bool live = ok && pz > 0.0f;
    if (!__any_sync(FULL, live)) continue;  // no lane in front of camera c
    // where live, pz > 0, so project_cam's divisor is pz itself
    const float u = __fdiv_rn(px, pz);
    const float v = __fdiv_rn(py, pz);
    if (live && u >= 0.0f && u < (float)g.W && v >= 0.0f && v < (float)g.H)
      pix[c] = (int)v * g.W + (int)u;
  }
}

// Exclusive prefix of tile `tile` from its predecessors' descriptors
// (warp 0, every lane): 32 predecessors per step, one per lane, until the
// nearest inclusive prefix.
__device__ __forceinline__ int look_back(const unsigned long long* desc,
                                         int tile, int lane) {
  int excl = 0;
  for (int end = tile - 1;; end -= 32) {
    const int j = end - lane;
    unsigned long long d;
    while (true) {  // predecessors have started: each publishes soon
      d = j >= 0 ? ld_acquire(desc + j) : INCLUSIVE;  // before tile 0: 0
      if (!__any_sync(FULL, (d >> 32) == 0)) break;
      __nanosleep(64);
    }
    const unsigned incl = __ballot_sync(FULL, (d & INCLUSIVE) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= stop ? (int)(unsigned)d : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    excl += v;
    if (incl) return excl;
  }
}

// One tile of one frame.  Block b (WRITE = false) or ticket b (WRITE =
// true) is tile b / F of frame b % F: the chunk's frames of one tile run
// side by side and share its points in L2, and a frame's consecutive tiles
// are F tickets apart, so a tile's predecessors have mostly finished by
// the time it looks back.  WRITE = true: rank and write the survivors' rows
// (look-back; count[f] from the frame's last tile).  WRITE = false: add the
// tile's survivor count to the zeroed count[f].
template <bool WRITE, int ITEMS, int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
fc_tile(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
        const int* __restrict__ cls, const uint8_t* __restrict__ fv,
        const float* __restrict__ A, const float* __restrict__ B, Geo g,
        int n_tiles, unsigned long long* __restrict__ desc,
        unsigned* __restrict__ ticket, int* __restrict__ vals, int k_cap,
        int* __restrict__ count) {
  constexpr int GROUPS = ITEMS * WARPS;  // groups per tile, in point order
  constexpr int TILE = ITEMS * BLOCK;    // points per tile
  static_assert(GROUPS <= 32, "one warp scans a tile's group counts");
  __shared__ float mats[cama::MATS_FLOATS];
  // lane 0's codes of every group; row GROUPS: the next tile's first point
  __shared__ int head[GROUPS + 1][MAX_CAM];
  __shared__ int group_cnt[GROUPS];
  __shared__ int group_off[GROUPS];
  __shared__ int s_ticket, s_excl;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (WRITE) {
    if (tid == 0) s_ticket = (int)atomicAdd(ticket, 1u);
    __syncthreads();
  }
  const int b = WRITE ? s_ticket : (int)blockIdx.x;
  const int f = b % g.F, tile = b / g.F;
  const int base = tile * TILE;
  cama::load_mats(mats, A, B, f, g.C, tid);

  // every load of the tile is issued before any arithmetic
  const bool frame_ok = fv[f] != 0;
  float x[ITEMS], y[ITEMS], z[ITEMS];
  bool ok[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = base + k * BLOCK + tid;
    x[k] = y[k] = z[k] = 0.f;
    ok[k] = false;
    if (i < g.P) {
      x[k] = pts[3 * (size_t)i];
      y[k] = pts[3 * (size_t)i + 1];
      z[k] = pts[3 * (size_t)i + 2];
      ok[k] = valid[i] != 0;
    }
  }
  // the next tile's first point, projected by the last warp, one camera a
  // lane
  const int j = base + TILE;
  const bool halo = warp == WARPS - 1 && lane < g.C && j < g.P;
  float hx = 0.f, hy = 0.f, hz = 0.f;
  bool hok = false;
  if (halo) {
    hx = pts[3 * (size_t)j];
    hy = pts[3 * (size_t)j + 1];
    hz = pts[3 * (size_t)j + 2];
    hok = valid[j] != 0;
  }
  __syncthreads();  // mats

  int val[ITEMS][MAX_CAM];  // pixel codes, then payloads
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    project_group(mats, g, x[k], y[k], z[k], frame_ok && ok[k], val[k]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < MAX_CAM; ++c) head[k * WARPS + warp][c] = val[k][c];
    }
  }
  if (warp == WARPS - 1) {
    int code = -1;
    float u, v;
    if (halo && frame_ok && hok &&
        cama::project_cam(mats, g, lane, hx, hy, hz,
                          cama::in_crop(mats, g, hx, hy, hz), u, v))
      code = (int)v * g.W + (int)u;
    if (lane < MAX_CAM) head[GROUPS][lane] = code;
  }
  __syncthreads();

  unsigned eff[ITEMS], bal[ITEMS];  // eff bit c: camera c keeps the point
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int grp = k * WARPS + warp;
    eff[k] = 0;
#pragma unroll
    for (int c = 0; c < MAX_CAM; ++c) {
      if (c >= g.C) break;
      int succ = __shfl_down_sync(FULL, val[k][c], 1);
      if (lane == 31) succ = head[grp + 1][c];
      if (val[k][c] >= 0 && succ != val[k][c]) eff[k] |= 1u << c;
    }
    bal[k] = __ballot_sync(FULL, eff[k] != 0);
    if (lane == 0) group_cnt[grp] = __popc(bal[k]);
  }
  // the survivors' class ids, in flight across the scan and the look-back
  int ci[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    ci[k] = (WRITE && eff[k]) ? cls[base + k * BLOCK + tid] : 0;
  __syncthreads();

  if (warp == 0) {
    const int n = lane < GROUPS ? group_cnt[lane] : 0;
    int s = n;  // inclusive scan of the group counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    const int agg = __shfl_sync(FULL, s, 31);
    if (!WRITE) {
      if (lane == 0 && agg) atomicAdd(count + f, agg);
    } else {
      if (lane < GROUPS) group_off[lane] = s - n;
      unsigned long long* fdesc = desc + (size_t)f * n_tiles;
      if (lane == 0)
        st_release(fdesc + tile,
                   (tile == 0 ? INCLUSIVE : AGGREGATE) | (unsigned)agg);
      const int excl = tile == 0 ? 0 : look_back(fdesc, tile, lane);
      if (lane == 0) {
        if (tile > 0) st_release(fdesc + tile, INCLUSIVE | (unsigned)(excl + agg));
        s_excl = excl;
        if (tile == n_tiles - 1) count[f] = excl + agg;
      }
    }
  }
  if (!WRITE) return;
  __syncthreads();

  const int excl = s_excl;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (!eff[k]) continue;
    const int grp = k * WARPS + warp;
    const int row = excl + group_off[grp] + __popc(bal[k] & ((1u << lane) - 1u));
    if (row < k_cap) {
      int* dst = vals + ((size_t)f * k_cap + row) * g.C;
#pragma unroll
      for (int c = 0; c < MAX_CAM; ++c)
        if (c < g.C)
          dst[c] = (eff[k] >> c) & 1u ? val[k][c] * MAX_CLS + ci[k] + 1 : 0;
    }
  }
}

template <bool WRITE>
int tiles(int P) {
  const int tile = (WRITE ? WRITE_ITEMS : COUNT_ITEMS) * BLOCK;
  return (P + tile - 1) / tile;
}

}  // namespace

extern "C" {

// 64-bit words of the look-back scratch the caller allocates for
// cama_fc_project: one descriptor per tile and frame, then the ticket.
long long cama_fc_scratch_words(int P, int F) {
  return (long long)F * tiles<true>(P) + 1;
}

// count[F] union survivor totals: one memset, one launch.
int cama_fc_count(const float* pts, const uint8_t* valid, const int* cls,
                  const uint8_t* fv, const float* A, const float* B, int P,
                  int F, int C, int W, int H, float lo0, float lo1, float lo2,
                  float hi0, float hi1, float hi2, int* count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 0) return 0;
  const Geo g = cama::make_geo(P, F, C, W, H, lo0, lo1, lo2, hi0, hi1, hi2);
  int err = (int)cudaMemsetAsync(count, 0, sizeof(int) * (size_t)F, s);
  if (err != 0) return err;
  fc_tile<false, COUNT_ITEMS, COUNT_MIN_BLOCKS><<<tiles<false>(P) * F, BLOCK,
                                                 0, s>>>(
      pts, valid, cls, fv, A, B, g, tiles<false>(P), nullptr, nullptr,
      nullptr, 0, count);
  return (int)cudaGetLastError();
}

// vals[F, k_cap, C] survivor rows and count[F] totals: one memset of the
// scratch (cama_fc_scratch_words(P, F) words), one launch.
int cama_fc_project(const float* pts, const uint8_t* valid, const int* cls,
                    const uint8_t* fv, const float* A, const float* B, int P,
                    int F, int C, int W, int H, float lo0, float lo1,
                    float lo2, float hi0, float hi1, float hi2, int k_cap,
                    unsigned long long* scratch, int* vals, int* count,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 0) return 0;
  const Geo g = cama::make_geo(P, F, C, W, H, lo0, lo1, lo2, hi0, hi1, hi2);
  const int n_tiles = tiles<true>(P);
  int err = (int)cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * cama_fc_scratch_words(P, F), s);
  if (err != 0) return err;
  unsigned* ticket = (unsigned*)(scratch + (size_t)F * n_tiles);
  fc_tile<true, WRITE_ITEMS, WRITE_MIN_BLOCKS><<<n_tiles * F, BLOCK, 0, s>>>(
      pts, valid, cls, fv, A, B, g, n_tiles, scratch, ticket, vals, k_cap,
      count);
  return (int)cudaGetLastError();
}

}  // extern "C"
