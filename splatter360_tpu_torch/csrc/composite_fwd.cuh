// Forward tile compositor for Hopper (sm_90a), shared by the fused and the
// unfused kernel (composite_fwd.cu, composite_fwd_unfused.cu); the two
// differ only in where an instance's row is read (composite_common.cuh).
//
// For every (view, 16x128 tile) it walks the tile's depth-sorted segment of
// instances in blocks of 128 and composites front to back in
// log-transmittance space:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, o exp(power))
//   gated by |dx| <= rx, |dy| <= ry, -4.5 < power <= 0, alpha >= 1/255;
//   T_i = exp(logT + e), e the block's exclusive prefix of log1p(-alpha),
//   w = alpha T_i, kept only where T_i (1 - alpha) >= 1e-4; logT carries
//   the unmasked sum, and each block's colour sums start from 0 and are then
//   added into the pixel's running sums, as its log1p(-alpha) sum is.
// A tile stops at a block boundary once every pixel has logT < log(1e-4).
// Output per tile: the planes r g b depth T logT n_processed 0 ([8, 2048]).
//
// The design: a heavy tile's blocks are cut into spans that run at once.
// - The state a block takes from the blocks before it is one per-pixel
//   number, logT, the unmasked sum of log1p(-alpha). A work item is (view,
//   tile, span): up to S consecutive blocks of the tile's segment, counted
//   from block 0. Only a tile of more than `heavy` segment blocks is cut:
//   the caller sets heavy to the call's segment blocks over four per SM
//   (split_slots in ops/cuda/composite.py), near which one tile's walk
//   alone would outlast the rest of the call, and to no less than three
//   times their mean; a lighter tile is one span and pays nothing extra.
//   The forward does not know n_processed before it runs, so spans and
//   threshold follow the segment; the floor over the mean keeps uncut the
//   tiles of a dense scene, whose segments end far past their exit. Items
//   are numbered tile by tile (item_end, built by the caller; an item finds
//   its tile by binary search). No count leaves the device: the scratch is
//   sized for V T + ceil(V NBLK / S) items, from shapes, and each pass runs
//   a card's worth of thread blocks that take (item, region) pairs in order
//   from a counter until the real items are done.
// - Each item runs as 16 pieces, one per 32x4 region of the tile, each on a
//   thread block of 4 warps (one pixel a thread, its state in registers):
//   a region does not wait for the busiest region of the tile (a 512-thread
//   block for the whole tile walked a block three times slower). A warp
//   takes an 8x4 part of the region, not a row of 32, so that an instance a
//   few pixels wide is visited by one or two warps.
// - pass 1: every span but a cut tile's last stores L[item][pixel], its
//   blocks' log1p(-alpha) sums added block by block from 0; scan: L becomes
//   each span's starting logT, the earlier spans' L added first span first
//   (one thread a pixel, no atomics); pass 2: every span composites from its
//   starting logT, and each region stops at its own first failing exit test
//   (every pixel of the region below log(1e-4); logT never grows, so the
//   tile's test fails first where the last of its regions' does); pass 3:
//   the span's stop is the last of its regions' stops, and the regions that
//   stopped sooner walk on to it (their weights are gated to 0 by then,
//   only logT moves). A tile of one span writes its planes there; a cut
//   tile's spans store their colour sums, their logT at the stop and the
//   block they stopped at, and the combine kernel adds the colour sums span
//   by span up to the first span that stopped: the tile's exit is its first
//   failing test, whichever span it falls in. Spans past it add nothing to
//   any plane. Spans of one block add across blocks exactly as one span a
//   tile does, so span 1 and one span a tile give the same bits; other
//   spans differ only in the association of logT and the colour sums across
//   blocks. Scratch: L / logT [items, 2048], colour sums [items, 4, 2048],
//   stops [items, 17], allocated by the caller.
// - per 128-instance block, each thread reads one instance's row (the read
//   of the next block is issued before the current block's pixel work, so
//   its latency hides behind it), stages it in shared memory, and marks
//   which warps (parts) its radius box, widened by a pixel, touches;
//   each warp then walks only the marked instances, found by one ballot per
//   32. A pair outside the box adds exactly 0 to every sum, so skipping it
//   changes nothing.
// Each pixel walks its instances in segment order, as the plain PyTorch
// versions do, and they sum across blocks and spans in this kernel's order;
// with -fmad=false every product and sum rounds as the plain versions'
// separate ops do, and kernel and plain version agree bit for bit. So do the
// fused and the unfused kernel on the same instances.
// What it costs: pass 1 walks every span of a cut tile but the last once
// more, past the tile's exit too (it cannot know the exit before the scan).

#pragma once

#include <algorithm>

#include "composite_common.cuh"

namespace composite {

constexpr int FWD_THREADS = SUB_W * SUB_H;  // one pixel a thread
constexpr int STOP_COLS = N_SUB + 1;        // an item's stops: its regions', then its own

static_assert(FWD_THREADS == CHUNK, "each thread reads one instance of a block");

static_assert(PART_W * SUB_H == 32 && SUB_W == 4 * PART_W, "four parts a region, a pixel a lane");

// Bit w set when part w (columns cx0 + 8 w .. + 7, rows ry0 .. ry0 + 3) of
// the region whose top-left pixel is (cx0, ry0) may hold a pixel with
// |px - u| <= rx and |py - v| <= ry, for a centre (du, dv) relative to the
// tile's corner. The box is widened by a pixel, far beyond the rounding of
// px - u; NaNs give 0, as they fail the per-pixel test too.
__device__ inline unsigned part_mask(float du, float dv, float rx, float ry, float cx0,
                                     float ry0) {
  const float c0 = du - rx - 1.0f - cx0, c1 = du + rx + 1.0f - cx0;
  const float r0 = dv - ry - 1.0f - ry0, r1 = dv + ry + 1.0f - ry0;
  if (!(c1 >= 0.0f && c0 <= SUB_W - 1.0f && r1 >= 0.0f && r0 <= SUB_H - 1.0f)) return 0u;
  const int a = static_cast<int>(fmaxf(c0, 0.0f)) / PART_W;
  const int b = static_cast<int>(fminf(c1, SUB_W - 1.0f)) / PART_W;
  return (2u << b) - (1u << a);
}

// The alpha of instance l (staged in s) at pixel (px, py), 0 where the gate
// drops the pair: the backward's pair_alpha, computed without branches.
__device__ __forceinline__ float gated_alpha(const float (*s)[CHUNK + 1], int l, float px,
                                             float py) {
  const float dx = px - s[0][l];
  const float dy = py - s[1][l];
  const float a = s[2][l];
  const float b = s[3][l];
  const float c = s[4][l];
  const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
  const float alpha = s[5][l] * expf(power);
  const bool keep = (fabsf(dx) <= s[10][l]) & (fabsf(dy) <= s[11][l]) & (power > NEG_CUTOFF) &
                    (power <= 0.0f) & (alpha >= ALPHA_MIN);
  return keep ? fminf(alpha, 0.99f) : 0.0f;
}

// Region `sub` of work item `item`, on one thread block. PASS 1 stores the
// span's L in `lsum` ([items, 2048]; after the scan it holds each span's
// starting logT).
// PASS 2 composites the region to its own stop, recorded in `stop` [items,
// 17] (column = region; -1: it ran to the span's end). PASS 3 takes the
// span's stop as the last of its regions' (column 16 for a cut tile), walks
// the regions that stopped sooner on to it, and writes n_processed. Passes
// 2 and 3 leave a tile of one span's planes in out [V, T, 8, 2048], and a
// cut tile's span its logT in `lsum` and its colour sums in `csum` [items,
// 4, 2048].
template <class Src, int PASS>
__device__ void fwd_item(Src src, const int* __restrict__ starts, const int* __restrict__ counts,
                         const int* __restrict__ nseg, const int* __restrict__ item_end, int span,
                         const int* __restrict__ heavy, float* __restrict__ lsum,
                         float* __restrict__ csum, int* __restrict__ stop,
                         float* __restrict__ out, int n_segs, int n_tiles, int ntx, float w_img,
                         int wrap_x, int item, int sub, float (*s_attr)[CHUNK + 1],
                         unsigned* s_mask) {
  SpanItem it;
  if (!find_item(item_end, nseg, n_segs, span, *heavy, item, it)) return;
  // pass 1: only spans that a later span waits for
  if (PASS == 1 && it.s == it.n_spans - 1) return;
  const int seg = it.seg;
  const int view = seg / n_tiles;
  const int tile = seg % n_tiles;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int start = starts[seg];
  const int count = counts[seg];
  const int blk0 = start / CHUNK;
  const int j_lo = it.s * it.len;
  const int j_end = min(nseg[seg], j_lo + it.len);
  const bool whole = it.n_spans == 1;  // the tile's planes are written here

  const float x0 = static_cast<float>((tile % ntx) * TILE_W);
  const float y0 = static_cast<float>((tile / ntx) * TILE_H);
  const float xc = x0 + TILE_W * 0.5f;
  const int cx0 = (sub % SUB_X) * SUB_W;
  const int ry0 = (sub / SUB_X) * SUB_H;
  // the thread's pixel: column cx0 + 8 warp + lane % 8, row ry0 + lane / 8
  const int p = (ry0 + lane / PART_W) * TILE_W + cx0 + PART_W * warp + lane % PART_W;
  const float px = x0 + static_cast<float>(cx0 + PART_W * warp + lane % PART_W);
  const float py = y0 + static_cast<float>(ry0 + lane / PART_W);
  float* o_tile = out + static_cast<size_t>(seg) * 8 * N_PIX;
  const size_t ip = static_cast<size_t>(item) * N_PIX + p;
  float* c_item = csum + static_cast<size_t>(item) * 4 * N_PIX + p;
  int* st = stop + static_cast<size_t>(item) * STOP_COLS;

  // the pixel's logT (pass 1: the span's L, from 0) and colour sums
  float tacc = (PASS == 2 && it.s > 0) ? lsum[ip] : 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int j = j_lo;
  int j_stop = j_end;
  if (PASS == 3) {
    j_stop = j_lo;
    for (int s = 0; s < N_SUB; ++s) j_stop = max(j_stop, st[s] < 0 ? j_end : st[s]);
    j = st[sub] < 0 ? j_end : st[sub];
    if (whole) {
      o_tile[6 * N_PIX + p] = static_cast<float>(j_stop);
    } else if (sub == 0 && tid == 0) {
      st[N_SUB] = j_stop < j_end ? j_stop : -1;
    }
    if (j >= j_stop) return;  // uniform over the block
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = whole ? o_tile[c * N_PIX + p] : c_item[c * N_PIX];
    tacc = whole ? o_tile[5 * N_PIX + p] : lsum[ip];
  }

  // Read pipeline: thread t reads lane t's row. `g_cur` is the key of the
  // row in `row`, `g_next` the one of the block after; -1 marks a lane
  // outside the segment (or past the walk), whose row reads as zeros.
  auto fetch_g = [&](int jj) -> int {
    if (jj >= j_stop) return -1;
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

  for (; j < j_stop; ++j) {
    // also orders the previous block's shared-memory reads before the stores
    if (PASS == 2) {
      if (!__syncthreads_or(tacc >= LOG_T_EPS)) break;
    } else {
      __syncthreads();
    }
    unsigned m = 0u;
    if (g_cur >= 0) {
      if (wrap_x) {
        // re-centre u on the tile modulo W (rintf: half to even, as
        // jnp.round); exact because projection caps rx at W/2 - TILE_W/2 - 1
        row[0].x = row[0].x + w_img * rintf((xc - row[0].x) / w_img);
      }
      m = part_mask(row[0].x - x0, row[0].y - y0, row[2].z, row[2].w,
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
    float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const unsigned my_bit = 1u << warp;
#pragma unroll 1
    for (int q = 0; q < CHUNK; q += 32) {
      unsigned todo = __ballot_sync(FULL, (s_mask[q + lane] & my_bit) != 0u);
      while (todo != 0u) {
        const int l = q + __ffs(todo) - 1;
        todo &= todo - 1u;
        const float alpha = gated_alpha(s_attr, l, px, py);
        if (!(alpha > 0.0f)) continue;
        if (PASS > 1) {
          const float t_i = expf(tacc + e);
          if (t_i * (1.0f - alpha) >= T_EPS) {
            const float w = alpha * t_i;
#pragma unroll
            for (int c = 0; c < 4; ++c) b[c] = b[c] + w * s_attr[6 + c][l];
          }
        }
        e = e + log1pf(-alpha);
      }
    }
    tacc = tacc + e;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + b[c];
  }

  if (PASS == 1) {
    lsum[ip] = tacc;
    return;
  }
  if (whole) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o_tile[c * N_PIX + p] = acc[c];
    o_tile[4 * N_PIX + p] = expf(tacc);
    o_tile[5 * N_PIX + p] = tacc;
    o_tile[7 * N_PIX + p] = 0.0f;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) c_item[c * N_PIX] = acc[c];
    lsum[ip] = tacc;
  }
  if (PASS == 2 && tid == 0) st[sub] = j < j_end ? j : -1;
}

// The thread blocks of a pass take (item, region) pairs in order from the
// counter `next` (zeroed by the caller) until none is left: the grid is a
// card's worth of blocks, not the items' bound from shapes, most of whose
// items are empty.
template <class Src, int PASS>
__global__ void __launch_bounds__(FWD_THREADS)
composite_fwd_kernel(Src src, const int* __restrict__ starts, const int* __restrict__ counts,
                     const int* __restrict__ nseg, const int* __restrict__ item_end, int span,
                     const int* __restrict__ heavy, float* __restrict__ lsum,
                     float* __restrict__ csum, int* __restrict__ stop, float* __restrict__ out,
                     int* __restrict__ next, int n_segs, int n_tiles, int ntx, float w_img,
                     int wrap_x) {
  __shared__ float s_attr[ROWS][CHUNK + 1];
  __shared__ unsigned s_mask[CHUNK];
  __shared__ int s_idx;
  const int n_idx = item_end[n_segs - 1] * N_SUB;
  for (;;) {
    if (threadIdx.x == 0) s_idx = atomicAdd(next, 1);
    __syncthreads();
    const int idx = s_idx;
    __syncthreads();  // every thread has read s_idx before the next pair's
    if (idx >= n_idx) return;
    fwd_item<Src, PASS>(src, starts, counts, nseg, item_end, span, heavy, lsum, csum, stop, out,
                        n_segs, n_tiles, ntx, w_img, wrap_x, idx / N_SUB, idx % N_SUB, s_attr,
                        s_mask);
  }
}

// Per (tile, pixel) of a tile that is not one span (several, or none: an
// empty segment): its planes from its spans, the colour sums added span by
// span from 0 up to the first span that stopped, whose logT and stop are
// the tile's.
__global__ void __launch_bounds__(SCAN_THREADS)
span_combine_kernel(const int* __restrict__ item_end, const int* __restrict__ nseg, int span,
                    const int* __restrict__ heavy, const float* __restrict__ lsum,
                    const float* __restrict__ csum, const int* __restrict__ stop,
                    float* __restrict__ out) {
  const int seg = blockIdx.x;
  const int p = blockIdx.y * SCAN_THREADS + threadIdx.x;
  const int n = nseg[seg];
  const int n_spans = n_spans_of(n, span, *heavy);
  if (n_spans == 1) return;  // written by passes 2 and 3
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float lt = 0.0f;
  int nproc = n;
  const int first = item_end[seg] - n_spans;
  for (int s = 0; s < n_spans; ++s) {
    const size_t item = static_cast<size_t>(first + s);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + csum[(item * 4 + c) * N_PIX + p];
    lt = lsum[item * N_PIX + p];
    const int at = stop[item * STOP_COLS + N_SUB];
    if (at >= 0) {
      nproc = at;
      break;
    }
  }
  float* o = out + static_cast<size_t>(seg) * 8 * N_PIX + p;
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c * N_PIX] = acc[c];
  o[4 * N_PIX] = expf(lt);
  o[5 * N_PIX] = lt;
  o[6 * N_PIX] = static_cast<float>(nproc);
  o[7 * N_PIX] = 0.0f;
}

// starts/counts/nseg [V, T] i32 (nseg: the blocks each segment spans),
// heavy [1] i32 (tiles of more segment blocks are cut into spans of `span`,
// the others are one span), item_end [V T] i32 (the inclusive cumsum of
// each tile's spans), lsum [n_items, 2048] / csum [n_items, 4, 2048] f32
// and stop [n_items, 17] i32 scratch with n_items >= item_end[-1], next
// [3] i32 zeros (the passes' work counters), out [V, T, 8, 2048] f32.
// Launches the three passes, the scan and the combine on `stream`; returns
// the first CUDA error, or cudaGetLastError() after the launches.
template <class Src>
int launch_composite_fwd(Src src, const void* starts, const void* counts, const void* nseg,
                         const void* heavy, const void* item_end, int span, int n_items,
                         void* lsum, void* csum, void* stop, void* next, void* out, int n_views,
                         int nty, int ntx, float w_img, int wrap_x, void* stream) {
  const int n_tiles = nty * ntx;
  const int n_segs = n_views * n_tiles;
  if (n_segs == 0) return 0;
  if (span < 1 || n_items < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* st_i = static_cast<const int*>(starts);
  const auto* co_i = static_cast<const int*>(counts);
  const auto* ns_i = static_cast<const int*>(nseg);
  const auto* hv_i = static_cast<const int*>(heavy);
  const auto* ie_i = static_cast<const int*>(item_end);
  auto* ls_f = static_cast<float*>(lsum);
  auto* cs_f = static_cast<float*>(csum);
  auto* sp_i = static_cast<int*>(stop);
  auto* nx_i = static_cast<int*>(next);
  auto* out_f = static_cast<float*>(out);
  // a card's worth of region blocks (16 an SM), no more than the pairs
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(
      std::min<long long>(static_cast<long long>(n_items) * N_SUB, 16LL * sms));
  const dim3 tile_grid(n_segs, N_PIX / SCAN_THREADS);
  composite_fwd_kernel<Src, 1><<<grid, FWD_THREADS, 0, st>>>(
      src, st_i, co_i, ns_i, ie_i, span, hv_i, ls_f, cs_f, sp_i, out_f, nx_i, n_segs, n_tiles,
      ntx, w_img, wrap_x);
  span_scan_kernel<<<tile_grid, SCAN_THREADS, 0, st>>>(ie_i, ns_i, span, hv_i, ls_f);
  composite_fwd_kernel<Src, 2><<<grid, FWD_THREADS, 0, st>>>(
      src, st_i, co_i, ns_i, ie_i, span, hv_i, ls_f, cs_f, sp_i, out_f, nx_i + 1, n_segs,
      n_tiles, ntx, w_img, wrap_x);
  composite_fwd_kernel<Src, 3><<<grid, FWD_THREADS, 0, st>>>(
      src, st_i, co_i, ns_i, ie_i, span, hv_i, ls_f, cs_f, sp_i, out_f, nx_i + 2, n_segs,
      n_tiles, ntx, w_img, wrap_x);
  span_combine_kernel<<<tile_grid, SCAN_THREADS, 0, st>>>(ie_i, ns_i, span, hv_i, ls_f, cs_f,
                                                          sp_i, out_f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace composite
