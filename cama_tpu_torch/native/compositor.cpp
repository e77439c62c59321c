// Native host compositor of cama_tpu_torch: the hot host-side loop of the
// video path (a copy of cama_tpu/native/compositor.cpp).
//
// The device rasterizes or compacts; the host only has to (a) copy the
// cached undistorted base image and (b) recolor the painted pixels given a
// [H, W] uint8 class raster, in one streaming pass per camera that writes
// straight into the video mosaic slot, or paint a sparse point list onto
// the copied base.
//
// Exposed via ctypes.  The Python wrapper (cama_tpu_torch/native/__init__.py)
// builds this file with g++ on first use into build/cama_tpu_torch/ and
// falls back to the NumPy path when a toolchain is unavailable.
//
// Layout contracts (asserted by the wrapper):
//   base:   [H, W, 3] uint8, row stride base_stride bytes (pixels packed)
//   raster: [H, W]    uint8, row stride raster_stride bytes; 0 = unpainted,
//           else class_id + 1 (cama_tpu_torch/ops/raster.py packed_to_cls)
//   table:  [8, 3]    uint8 BGR rows (wrapper pads to 8 so (r-1)&7 is safe)
//   out:    [H, W, 3] uint8, row stride out_stride bytes — may be a slot
//           view into a larger mosaic; may alias `base` (paint in place)
#include <cstdint>
#include <cstring>

extern "C" {

// Fused copy+paint of one camera image. base == nullptr means `out` already
// holds the base pixels (paint in place).
void cama_composite(const uint8_t *base, int64_t base_stride,
                    const uint8_t *raster, int64_t raster_stride,
                    const uint8_t *table, int height, int width,
                    uint8_t *out, int64_t out_stride) {
  const int64_t row_bytes = static_cast<int64_t>(width) * 3;
  for (int y = 0; y < height; ++y) {
    const uint8_t *rrow = raster + y * raster_stride;
    uint8_t *orow = out + y * out_stride;
    if (base != nullptr) {
      std::memcpy(orow, base + y * base_stride, row_bytes);
    }
    int x = 0;
    // skip unpainted pixels 8 at a time (overlay rasters are ~99 % zero)
    const int w8 = width & ~7;
    for (; x < w8; x += 8) {
      uint64_t block;
      std::memcpy(&block, rrow + x, 8);
      if (block == 0) continue;
      for (int i = 0; i < 8; ++i) {
        const uint8_t r = rrow[x + i];
        if (r) {
          const uint8_t *c = table + ((r - 1) & 7) * 3;
          uint8_t *p = orow + (x + i) * 3;
          p[0] = c[0];
          p[1] = c[1];
          p[2] = c[2];
        }
      }
    }
    for (; x < width; ++x) {
      const uint8_t r = rrow[x];
      if (r) {
        const uint8_t *c = table + ((r - 1) & 7) * 3;
        uint8_t *p = orow + x * 3;
        p[0] = c[0];
        p[1] = c[1];
        p[2] = c[2];
      }
    }
  }
}

// Same, but the raster arrives 2-bit packed ([H, ceil(W/4)] uint8, 4 pixels
// per byte, little-end first — cama_tpu_torch/ops/raster.py pack_cls_2bit), so the
// host never materializes the unpacked [H, W] raster at all.
void cama_composite_packed2(const uint8_t *base, int64_t base_stride,
                            const uint8_t *packed, int64_t packed_stride,
                            const uint8_t *table, int height, int width,
                            uint8_t *out, int64_t out_stride) {
  const int64_t row_bytes = static_cast<int64_t>(width) * 3;
  for (int y = 0; y < height; ++y) {
    const uint8_t *prow = packed + y * packed_stride;
    uint8_t *orow = out + y * out_stride;
    if (base != nullptr) {
      std::memcpy(orow, base + y * base_stride, row_bytes);
    }
    for (int xb = 0; xb * 4 < width; ++xb) {
      const uint8_t b = prow[xb];
      if (b == 0) continue;
      const int x0 = xb * 4;
      const int n = (width - x0 < 4) ? width - x0 : 4;
      for (int i = 0; i < n; ++i) {
        const uint8_t r = (b >> (2 * i)) & 3;
        if (r) {
          const uint8_t *c = table + ((r - 1) & 7) * 3;
          uint8_t *p = orow + (x0 + i) * 3;
          p[0] = c[0];
          p[1] = c[1];
          p[2] = c[2];
        }
      }
    }
  }
}

// Sparse variant: paint compacted encoded points (cama_tpu_torch/ops/raster.py
// compact_points) with the cv2 radius-2 disk footprint, in order — exact
// cv2.circle last-drawn-wins semantics (paint_sparse_host).  `vals` holds
// n entries of (v * width + u) * 8 + cls (-1 entries are skipped).  `out`
// must already hold base pixels.  width/height describe the camera image;
// out_stride lets `out` be a mosaic slot view.
void cama_paint_sparse(const int32_t *vals, int64_t n, const uint8_t *table,
                       int height, int width, uint8_t *out,
                       int64_t out_stride) {
  // cv2.circle(radius=2) footprint: the 13-pixel L1 ball (ops/raster.py)
  static const int8_t DY[13] = {-2, -1, -1, -1, 0, 0, 0, 0, 0, 1, 1, 1, 2};
  static const int8_t DX[13] = {0, -1, 0, 1, -2, -1, 0, 1, 2, -1, 0, 1, 0};
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = vals[i];
    if (v < 0) continue;
    const uint8_t *c = table + (v & 7) * 3;
    const int32_t pix = v >> 3;  // vals encode with MAX_CLS == 8
    const int py = pix / width;
    const int px = pix - py * width;
    for (int s = 0; s < 13; ++s) {
      const int yy = py + DY[s];
      const int xx = px + DX[s];
      if (yy < 0 || yy >= height || xx < 0 || xx >= width) continue;
      uint8_t *p = out + yy * out_stride + xx * 3;
      p[0] = c[0];
      p[1] = c[1];
      p[2] = c[2];
    }
  }
}

}  // extern "C"
