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
constexpr int PART_W = 32 / SUB_H;              // a region's 8x4 parts: a pixel a lane
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

// What the span designs of the forward and backward kernels share: the work
// items a tile's blocks are cut into (spans that run at once) and the scan
// that gives each span its starting state.
constexpr int SCAN_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

static_assert(N_PIX % SCAN_THREADS == 0, "the scan covers a tile's pixels exactly");

// The span length of a tile of n blocks: `span` for a tile heavier than
// `heavy` blocks, else all of them.
__device__ __forceinline__ int tile_span(int n, int span, int heavy) {
  return n > heavy ? span : max(n, 1);
}

// Spans of a tile's n blocks (the forward numbers them from the first
// block, the backward from the last walked one).
__device__ __forceinline__ int n_spans_of(int n, int span, int heavy) {
  const int sp = tile_span(n, span, heavy);
  return (n + sp - 1) / sp;
}

// Work item `item` -> (view * n_tiles + tile, its span, the tile's spans,
// the span length); false past the last item. Items are numbered tile by
// tile: item_end is the inclusive cumsum over (view, tile) of the spans of
// each tile's n[seg] blocks.
struct SpanItem {
  int seg, s, n_spans, len;
};

__device__ inline bool find_item(const int* __restrict__ item_end, const int* __restrict__ n_blk,
                                 int n_segs, int span, int heavy, int item, SpanItem& it) {
  if (item >= item_end[n_segs - 1]) return false;
  int lo = 0, hi = n_segs - 1;  // the first seg whose item_end exceeds item
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (item_end[mid] > item) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int n = n_blk[lo];
  it.len = tile_span(n, span, heavy);
  it.seg = lo;
  it.n_spans = (n + it.len - 1) / it.len;
  it.s = item - (item_end[lo] - it.n_spans);
  return true;
}

// Per (tile, pixel) of a tile with several spans: x[item] (one span's own
// sum, span 0 first) becomes the sum of the spans before it in walk order,
// added span 0 first; span 0's own row is left as it was (its start is 0).
// n_blk as for find_item.
__global__ void __launch_bounds__(SCAN_THREADS)
span_scan_kernel(const int* __restrict__ item_end, const int* __restrict__ n_blk, int span,
                 const int* __restrict__ heavy, float* __restrict__ x) {
  const int seg = blockIdx.x;
  const int p = blockIdx.y * SCAN_THREADS + threadIdx.x;
  const int n_spans = n_spans_of(n_blk[seg], span, *heavy);
  if (n_spans < 2) return;
  float* row = x + static_cast<size_t>(item_end[seg] - n_spans) * N_PIX + p;
  float acc = 0.0f;
  float v = row[0];
  for (int s = 1; s < n_spans; ++s) {
    acc = acc + v;
    // the last span stored nothing: its row only receives its start
    const float next = s + 1 < n_spans ? row[static_cast<size_t>(s) * N_PIX] : 0.0f;
    row[static_cast<size_t>(s) * N_PIX] = acc;
    v = next;
  }
}

}  // namespace composite
