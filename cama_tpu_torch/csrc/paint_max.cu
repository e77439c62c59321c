// Max-paint of points into int32 rasters (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU probe `probe` / `probe_kernel`
// (tools/bench_pallas.py:148-176): a raster that starts at -1, and for each
// point with prio >= 0, out[y, x] = max(out[y, x], prio).  Here over a batch
// of N_img rasters [N_img, H, Wp], with K points per raster; a point whose
// (y, x) lies outside the raster is skipped (the TPU probe assumed its
// inputs in range).  The result is order-independent, so it equals the
// plain version (ops/paint.py paint_max_ref, a scatter_reduce_ amax)
// exactly, whatever order the atomics land in.
//
// What bounds it on this card: the -1 fill writes 4 B per pixel
// (2.2 MB for the probe's [540, 1024], 99.5 MB for a chunk's 48 rasters of
// 540 x 960), then each point reads 12 B and issues one 4-byte atomicMax
// to a scattered address, resolved in L2.  Dense fill bandwidth dominates
// when points are few against pixels; the atomics' L2 rate otherwise.
//
// How the design answers it: the fill is one cudaMemsetAsync of 0xFF bytes
// (every int32 becomes -1) on the caller's stream, at copy-engine rate;
// the paint is one thread per point, grid (ceil(K/BLOCK), N_img), with the
// range test in the thread and no ordering between points.  The TPU probe
// was a serial fori_loop of (8, 128)-tile read-modify-writes, because
// Mosaic has no scalar VMEM stores and no atomics; Hopper has both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
paint_kernel(const int* __restrict__ py, const int* __restrict__ px,
             const int* __restrict__ prio, int K, int H, int Wp,
             int* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= K) return;
  const size_t o = (size_t)blockIdx.y * K + i;
  const int p = prio[o];
  if (p < 0) return;
  const int y = py[o], x = px[o];
  if (y < 0 || y >= H || x < 0 || x >= Wp) return;
  atomicMax(out + ((size_t)blockIdx.y * H + y) * Wp + x, p);
}

}  // namespace

extern "C" {

// out[N_img, H, Wp] = -1, then the max-paint of K points per raster.
int cama_paint_max(const int* py, const int* px, const int* prio, int n_img,
                   int K, int H, int Wp, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0xFF, (size_t)n_img * H * Wp * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (K > 0)
    paint_kernel<<<dim3((K + BLOCK - 1) / BLOCK, n_img), BLOCK, 0, s>>>(
        py, px, prio, K, H, Wp, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
