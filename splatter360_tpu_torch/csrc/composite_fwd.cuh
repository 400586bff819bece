// Forward tile compositor for Hopper (sm_90a), shared by the fused and the
// unfused kernel (composite_fwd.cu, composite_fwd_unfused.cu); the two
// differ only in where an instance's row is read (composite_common.cuh).
//
// For every (view, 16x128 tile) it walks the tile's depth-sorted segment of
// instances in blocks of 128 and composites front to back in
// log-transmittance space:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, o exp(power))
//   gated by |dx| <= rx, |dy| <= ry, -4.5 < power <= 0, alpha >= 1/255;
//   T_i = exp(logT + exclusive prefix of log1p(-alpha)), w = alpha T_i,
//   kept only where T_i (1 - alpha) >= 1e-4; logT carries the unmasked sum.
// A tile stops at a block boundary once every pixel has logT < log(1e-4).
// Output per tile: the planes r g b depth T logT n_processed 0 ([8, 2048]).
//
// The work per tile is very uneven (a few tiles hold thousands of blocks),
// so the design spreads each tile over several thread blocks and skips the
// pairs that cannot contribute:
// - a tile is split into 16 regions of 32x4 pixels, one thread block (4
//   warps, one pixel a thread, its state in registers) per (view, tile,
//   region); all views of a request are one grid;
// - per 128-instance block, each thread reads one instance's row (the read
//   of the next block is issued before the current block's pixel work, so
//   its latency hides behind it), stages it in shared memory, and marks
//   which warps (pixel rows) its radius box, widened by a pixel, touches;
//   each warp then walks only the marked instances, found by one ballot per
//   32. A pair outside the box adds exactly 0 to every sum, so skipping it
//   changes nothing.
// - Pixels depend on each other only through the per-tile exit. A tile's
//   early exit is the last of its regions' own exits, since logT never grows.
//   So pass 1 runs each region to its own exit and records it; pass 2 takes
//   the tile's exit as the largest and lets every region that stopped sooner
//   run on to it (its weights are all gated to 0 by then, only logT moves).
// Each pixel walks its instances in segment order, as the plain PyTorch
// versions do; with -fmad=false every product and sum rounds as the plain
// versions' separate ops do, and kernel and plain version agree bit for bit.
// So do the fused and the unfused kernel on the same instances. What this
// design does not fix: a region still walks its tile's blocks one after
// another.

#pragma once

#include "composite_common.cuh"

namespace composite {

constexpr int FWD_THREADS = SUB_W * SUB_H;  // one pixel a thread

static_assert(FWD_THREADS == CHUNK, "each thread reads one instance of a block");

// Bit w set when row w of the region whose top-left pixel is (cx0, ry0) may
// hold a pixel with |px - u| <= rx and |py - v| <= ry, for a centre (du, dv)
// relative to the tile's corner. The box is widened by a pixel, far beyond
// the rounding of px - u; NaNs give 0, as they fail the per-pixel test too.
__device__ inline unsigned region_mask(float du, float dv, float rx, float ry, float cx0,
                                       float ry0) {
  const float c0 = du - rx - 1.0f, c1 = du + rx + 1.0f;
  const float r0 = dv - ry - 1.0f - ry0, r1 = dv + ry + 1.0f - ry0;
  if (!(c1 >= cx0 && c0 <= cx0 + (SUB_W - 1) && r1 >= 0.0f && r0 <= SUB_H - 1.0f)) {
    return 0u;
  }
  const int a = static_cast<int>(fmaxf(r0, 0.0f));
  const int b = static_cast<int>(fminf(r1, SUB_H - 1.0f));
  return (2u << b) - (1u << a);
}

// RESUME = false: pass 1, each region runs to its own exit, recorded in
// `j_sub`. RESUME = true: pass 2, regions that stopped before their tile's
// exit continue to it from the planes pass 1 wrote; every region writes the
// tile's n_processed.
template <bool RESUME, class Src>
__global__ void __launch_bounds__(FWD_THREADS)
composite_fwd_kernel(Src src, const int* __restrict__ starts, const int* __restrict__ counts,
                     float* __restrict__ out, int* __restrict__ j_sub, int n_tiles, int ntx,
                     float w_img, int wrap_x) {
  __shared__ float s_attr[ROWS][CHUNK + 1];
  __shared__ unsigned s_mask[CHUNK];

  const int tile = blockIdx.x / N_SUB;
  const int sub = blockIdx.x % N_SUB;
  const int view = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = view * n_tiles + tile;
  const int start = starts[seg];
  const int count = counts[seg];
  const int blk0 = start / CHUNK;
  const int n_blocks = (start + count + CHUNK - 1) / CHUNK - blk0;

  const float x0 = static_cast<float>((tile % ntx) * TILE_W);
  const float y0 = static_cast<float>((tile / ntx) * TILE_H);
  const float xc = x0 + TILE_W * 0.5f;
  const int cx0 = (sub % SUB_X) * SUB_W;
  const int ry0 = (sub / SUB_X) * SUB_H;
  const int p = (ry0 + warp) * TILE_W + cx0 + lane;
  const float px = x0 + static_cast<float>(cx0 + lane);
  const float py = y0 + static_cast<float>(ry0 + warp);
  float* o_tile = out + static_cast<size_t>(seg) * 8 * N_PIX;

  float tacc = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int j = 0;
  int j_end = n_blocks;
  if (RESUME) {
    j_end = 0;
    for (int s = 0; s < N_SUB; ++s) j_end = max(j_end, j_sub[seg * N_SUB + s]);
    j = j_sub[seg * N_SUB + sub];
    o_tile[6 * N_PIX + p] = static_cast<float>(j_end);
    if (j >= j_end) return;  // uniform over the block
    for (int c = 0; c < 4; ++c) acc[c] = o_tile[c * N_PIX + p];
    tacc = o_tile[5 * N_PIX + p];
  }

  // Read pipeline: thread t reads lane t's row. `g_cur` is the key of the
  // row in `row`, `g_next` the one of the block after; -1 marks a lane
  // outside the segment (or past the last block), whose row reads as zeros.
  auto fetch_g = [&](int jj) -> int {
    if (jj >= j_end) return -1;
    const int idx = (blk0 + jj) * CHUNK + tid;
    return (idx >= start && idx < start + count) ? src.key(view, idx) : -1;
  };
  float4 row[ROWS / 4];
  auto fetch_row = [&](int g) {
    if (g >= 0) {
      src.load(view, g, row);
    } else {
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) row[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  int g_cur = fetch_g(j);
  fetch_row(g_cur);
  int g_next = fetch_g(j + 1);

  for (; j < j_end; ++j) {
    // also orders the previous block's shared-memory reads before the stores
    if (RESUME) {
      __syncthreads();
    } else if (!__syncthreads_or(tacc >= LOG_T_EPS)) {
      break;
    }
    unsigned m = 0u;
    if (g_cur >= 0) {
      if (wrap_x) {
        // re-centre u on the tile modulo W (rintf: half to even, as
        // jnp.round); exact because projection caps rx at W/2 - TILE_W/2 - 1
        row[0].x = row[0].x + w_img * rintf((xc - row[0].x) / w_img);
      }
      m = region_mask(row[0].x - x0, row[0].y - y0, row[2].z, row[2].w,
                      static_cast<float>(cx0), static_cast<float>(ry0));
    }
    s_mask[tid] = m;
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      s_attr[4 * q + 0][tid] = row[q].x;
      s_attr[4 * q + 1][tid] = row[q].y;
      s_attr[4 * q + 2][tid] = row[q].z;
      s_attr[4 * q + 3][tid] = row[q].w;
    }
    // next block's row and the key of the one after; used next iteration
    g_cur = g_next;
    fetch_row(g_cur);
    g_next = fetch_g(j + 2);
    __syncthreads();

    float e = 0.0f;
    const unsigned my_bit = 1u << warp;
#pragma unroll 1
    for (int q = 0; q < CHUNK; q += 32) {
      unsigned todo = __ballot_sync(0xffffffffu, (s_mask[q + lane] & my_bit) != 0u);
      while (todo != 0u) {
        const int l = q + __ffs(todo) - 1;
        todo &= todo - 1u;
        const float dx = px - s_attr[0][l];
        const float dy = py - s_attr[1][l];
        if (!(fabsf(dx) <= s_attr[10][l]) || !(fabsf(dy) <= s_attr[11][l])) continue;
        const float a = s_attr[2][l];
        const float b = s_attr[3][l];
        const float c = s_attr[4][l];
        const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
        if (!(power > NEG_CUTOFF && power <= 0.0f)) continue;
        float alpha = s_attr[5][l] * expf(power);
        if (!(alpha >= ALPHA_MIN)) continue;
        alpha = fminf(alpha, 0.99f);
        const float t_i = expf(tacc + e);
        if (t_i * (1.0f - alpha) >= T_EPS) {
          const float w = alpha * t_i;
          acc[0] = acc[0] + w * s_attr[6][l];
          acc[1] = acc[1] + w * s_attr[7][l];
          acc[2] = acc[2] + w * s_attr[8][l];
          acc[3] = acc[3] + w * s_attr[9][l];
        }
        e = e + log1pf(-alpha);
      }
    }
    tacc = tacc + e;
  }

  o_tile[0 * N_PIX + p] = acc[0];
  o_tile[1 * N_PIX + p] = acc[1];
  o_tile[2 * N_PIX + p] = acc[2];
  o_tile[3 * N_PIX + p] = acc[3];
  o_tile[4 * N_PIX + p] = expf(tacc);
  o_tile[5 * N_PIX + p] = tacc;
  o_tile[7 * N_PIX + p] = 0.0f;
  if (!RESUME) {
    o_tile[6 * N_PIX + p] = static_cast<float>(j);
    if (tid == 0) j_sub[seg * N_SUB + sub] = j;
  }
}

// starts/counts [V, T] i32, out [V, T, 8, 2048] f32, scratch [V, T, 16] i32
// (the regions' own exits). Launches both passes on `stream`; returns
// cudaGetLastError() after them.
template <class Src>
int launch_composite_fwd(Src src, const void* starts, const void* counts, void* out,
                         void* scratch, int n_views, int nty, int ntx, float w_img, int wrap_x,
                         void* stream) {
  const int n_tiles = nty * ntx;
  if (n_views == 0 || n_tiles == 0) return 0;
  const dim3 grid(n_tiles * N_SUB, n_views);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int*>(starts);
  const auto* ct = static_cast<const int*>(counts);
  auto* o = static_cast<float*>(out);
  auto* js = static_cast<int*>(scratch);
  composite_fwd_kernel<false, Src><<<grid, FWD_THREADS, 0, s>>>(src, st, ct, o, js, n_tiles,
                                                                ntx, w_img, wrap_x);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_fwd_kernel<true, Src><<<grid, FWD_THREADS, 0, s>>>(src, st, ct, o, js, n_tiles,
                                                               ntx, w_img, wrap_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace composite
