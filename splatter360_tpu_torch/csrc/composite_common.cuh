// What the four tile-compositor kernels share: the tile geometry, the
// compositing constants, and where a kernel finds an instance's attributes.
//
// An instance is one entry of a view's depth-sorted list (K entries, blocks
// of 128; tile t owns entries [start, start + count)). Its 16 attribute
// rows are u v a b c o r g b depth rx ry 0 0 0 0. The fused kernels read
// them from the per-Gaussian table attrs[N, 16] through gidx
// (GatheredRows); the unfused kernels from the pre-gathered instance blocks
// inst[K / 128, 16, 128] (PackedRows), one contiguous 8 KB block per 128
// instances. Both give the same values, so the kernels built on them compute
// the same function.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace composite {

constexpr int TILE_H = 16;
constexpr int TILE_W = 128;
constexpr int N_PIX = TILE_H * TILE_W;
constexpr int CHUNK = 128;
constexpr int ROWS = 16;
constexpr int N_GRAD = 10;                    // gradient rows: u v a b c o r g b depth
constexpr int SUB_W = 32;                     // a tile region: one warp wide
constexpr int SUB_H = 4;                      // and four pixel rows
constexpr int SUB_X = TILE_W / SUB_W;
constexpr int N_SUB = SUB_X * (TILE_H / SUB_H);
constexpr float NEG_CUTOFF = -4.5f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float LOG_T_EPS = -9.21034f;

// key(view, idx): what locates instance idx's row (its Gaussian);
// load(view, key, row): the row's 16 values, through the read-only cache.
struct GatheredRows {
  const float4* attrs;  // [V, N, 16]
  const int* gidx;      // [V, K]
  int n;
  int k;

  __device__ int key(int view, int idx) const {
    return __ldg(gidx + static_cast<size_t>(view) * k + idx);
  }
  __device__ void load(int view, int key, float4 (&row)[ROWS / 4]) const {
    const float4* a = attrs + (static_cast<size_t>(view) * n + key) * (ROWS / 4);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) row[q] = __ldg(a + q);
  }
};

struct PackedRows {
  const float* inst;  // [V, K / 128, 16, 128]
  int k;

  __device__ int key(int, int idx) const { return idx; }
  // lane idx % 128 of block idx / 128: threads of a warp on neighbouring
  // lanes read 128 contiguous bytes of each row
  __device__ void load(int view, int key, float4 (&row)[ROWS / 4]) const {
    const float* p = inst + static_cast<size_t>(view) * k * ROWS +
                     static_cast<size_t>(key / CHUNK) * ROWS * CHUNK + key % CHUNK;
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      row[q] = make_float4(__ldg(p + (4 * q + 0) * CHUNK), __ldg(p + (4 * q + 1) * CHUNK),
                           __ldg(p + (4 * q + 2) * CHUNK), __ldg(p + (4 * q + 3) * CHUNK));
    }
  }
};

}  // namespace composite
