// Native host-side data-path kernels (the port's copy of
// native/rangeview_io.cpp).
//
// The reference's only justified native host component is the numba-JIT
// z-buffer (reference: src/torchbox3d/math/numpy/conversions.py:106-128 and
// converters/av2/utils.py:186-208) plus the per-sweep column-major ->
// (H, W, C) reshape hot path (prototype/loader.py:818-822). This C++
// translation unit provides both; data/native_io.py builds it with
// lz4_frame.cpp into one shared library at first use and binds it through
// ctypes. The build has no -fopenmp (the g++ beside the card has no
// libgomp), so the OpenMP pragma below is inert and the loop serial.
//
// Build: g++ -O3 -fPIC -shared (data/native_io.py::library)

#include <cstdint>
#include <cstring>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Nearest-return-wins rasterization of N points into an (H, W, C) image.
//
// rows/cols: per-point pixel coordinates (int64, already bounds-clipped)
// dists:     per-point depth for the z-test (float32)
// values:    (N, C) float32 features to scatter
// out:       (H*W*C) float32, zero-initialized by the caller
// depth:     (H*W) float32 scratch, caller-initialized to +inf
void z_buffer(const int64_t* rows, const int64_t* cols, const float* dists,
              const float* values, int64_t n, int64_t height, int64_t width,
              int64_t channels, float min_distance, float* out, float* depth) {
  // Pass 1: depth test (sequential min per pixel; contention-free enough to
  // keep single-threaded — N ~ 1e5 and the op is memory-bound).
  for (int64_t i = 0; i < n; ++i) {
    float d = dists[i];
    if (d < min_distance) continue;
    int64_t px = rows[i] * width + cols[i];
    if (d < depth[px]) depth[px] = d;
  }
  // Pass 2: scatter winners. A point wins iff its distance equals the pixel
  // minimum; ties resolved by first writer (matches the reference's
  // sequential nearest-wins loop up to tie order).
  for (int64_t i = 0; i < n; ++i) {
    float d = dists[i];
    if (d < min_distance) continue;
    int64_t px = rows[i] * width + cols[i];
    if (d == depth[px]) {
      std::memcpy(out + px * channels, values + i * channels,
                  sizeof(float) * channels);
      depth[px] = -1.0f;  // claim the pixel so later ties don't overwrite
    }
  }
}

// Column-major feather buffer -> channel-last (H, W, C) image + validity.
//
// src:   C pointers to per-column float32 buffers of length H*W
// out:   (H*W, C) float32 (channel-last)
// range_col: index of the "range" column used for the validity mask, or -1
// mask:  (H*W) uint8 output (range > 0)
void columns_to_image(const float** src, int64_t num_columns, int64_t num_pixels,
                      int64_t range_col, float* out, uint8_t* mask) {
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < num_pixels; ++p) {
    float* dst = out + p * num_columns;
    for (int64_t c = 0; c < num_columns; ++c) dst[c] = src[c][p];
    if (range_col >= 0) mask[p] = src[range_col][p] > 0.0f ? 1 : 0;
  }
}

}  // extern "C"
