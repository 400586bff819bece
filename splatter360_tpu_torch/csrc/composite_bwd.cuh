// Backward tile compositor for Hopper (sm_90a), shared by the fused and the
// unfused kernel (composite_bwd.cu, composite_bwd_unfused.cu).
//
// For every (view, 16x128 tile) it walks the blocks of 128 instances that
// the forward processed (n_processed of them, from the forward's plane 6),
// last block first, and forms d loss / d (u v a b c o r g b depth) of each
// instance (rx ry and padding get none). Per block:
//   1. recompute alpha for every (pixel, instance) pair exactly as the forward
//      does (seam re-centring of u included);
//   2. sum_lg = per-pixel sum of log1p(-alpha) over the block, in lane order;
//   3. telescope: log_t_end = logT_final - suffix, log_t_start = log_t_end -
//      sum_lg, suffix += sum_lg (for every walked block);
//   4. only if some pixel of the tile has log_t_start >= log(1e-4), walk the
//      lanes back to front with R = inclusive suffix of log1p(-alpha):
//        T = exp(log_t_end - R)  (= exp(log_t_start + exclusive prefix)),
//        contrib = T (1 - alpha) >= 1e-4, w = contrib ? alpha T : 0,
//        gamma = <g_rgbd, colour/depth>, psi = w gamma,
//        g_alpha = contrib ? T gamma - (S + a_psi + gT T_final) / (1 - alpha) : 0
//      with S the strict in-block suffix of psi, then a_psi += sum of psi;
//   5. per instance, sum over the tile's pixels g_p = g_alpha alpha, g_p dx,
//      g_p dy, g_p dx^2, g_p dy^2, g_p dx dy and w g_rgbd, and form
//        g_u = a S_dx + b S_dy, g_v = c S_dy + b S_dx, g_a = -S_dxdx / 2,
//        g_b = -S_dxdy, g_c = -S_dydy / 2, g_o = S_1 / max(o, 1e-12),
//        g_{r,g,b,depth} = sum of w g_rgbd.
// As in the Pallas kernels, d alpha / d power = alpha and d alpha / d o =
// alpha / o even where alpha was capped at 0.99.
//
// The design: one thread block owns a tile and walks its blocks in order, so
// the heaviest tile sets the time.
// - one 512-thread block per (view, tile); warp w owns the 32x4-pixel region
//   w of the tile (the forward's regions), each thread one column of 4
//   pixels with their state (suffix, a_psi, logT_final, cotangents) in
//   registers;
// - per block, threads 0-127 read one instance's row each into shared
//   memory and mark the regions its radius box, widened by a pixel, touches;
//   each warp walks only its marked instances (one ballot per 32 lanes). A
//   pair outside the box has alpha = 0 and adds exactly 0 to every sum, so
//   skipping it changes nothing;
// - the tile-wide gate of step 4 is one __syncthreads_or;
// - step 5 reduces each (warp, instance)'s ten sums by warp shuffles. Then:
//   fused (TILE_OWNED = false): shared-memory atomicAdd across the 16 warps
//   and one global atomicAdd per (instance, row) into g_attrs[V, N, 16];
//   float atomics make the summation order, and so the last bits, vary from
//   run to run. Unfused (TILE_OWNED = true): each warp keeps its sums in its
//   own slot of dynamic shared memory, a thread adds its instance's slots in
//   warp order, and plain stores write the block's gradient rows (rows 10-15
//   zero) to the tile's own output block dout[obase[tile] + j], as the
//   Pallas `_backward_kernel` does; a walked block that fails the gate
//   writes zeros, a block past n_processed is not written. No atomics: the
//   same inputs give the same bits.
// The plain PyTorch versions sum log1p(-alpha) in this kernel's lane order
// (with -fmad=false both round alike), so the gate of step 4 decides alike;
// their back-to-front walk is taken as suffix sums, which round differently,
// as do their sums over pixels and tiles.

#pragma once

#include "composite_common.cuh"

namespace composite {

constexpr int BWD_THREADS = 32 * N_SUB;  // one warp per region
constexpr unsigned FULL = 0xffffffffu;
// the unfused kernel's per-warp sums: [N_SUB][N_GRAD][CHUNK] floats
constexpr int BWD_SLOT_BYTES = N_SUB * N_GRAD * CHUNK * 4;

static_assert(N_SUB <= 32, "one mask bit per region");
static_assert(BWD_THREADS >= CHUNK, "threads 0-127 read one instance each");

// Bit w set when region w of the tile may hold a pixel with |px - u| <= rx
// and |py - v| <= ry, for a centre (du, dv) relative to the tile's corner.
// The box is widened by a pixel, far beyond the rounding of px - u; NaNs give
// 0, as they fail the per-pixel test too.
__device__ inline unsigned region_bits(float du, float dv, float rx, float ry) {
  const float c0 = du - rx - 1.0f, c1 = du + rx + 1.0f;
  const float r0 = dv - ry - 1.0f, r1 = dv + ry + 1.0f;
  if (!(c1 >= 0.0f && c0 <= TILE_W - 1.0f && r1 >= 0.0f && r0 <= TILE_H - 1.0f)) {
    return 0u;
  }
  const int xa = static_cast<int>(fmaxf(c0, 0.0f)) / SUB_W;
  const int xb = static_cast<int>(fminf(c1, TILE_W - 1.0f)) / SUB_W;
  const int ya = static_cast<int>(fmaxf(r0, 0.0f)) / SUB_H;
  const int yb = static_cast<int>(fminf(r1, TILE_H - 1.0f)) / SUB_H;
  const unsigned cols = (2u << xb) - (1u << xa);
  unsigned m = 0u;
  for (int y = ya; y <= yb; ++y) m |= cols << (y * SUB_X);
  return m;
}

// The forward's alpha of instance l (staged in s) at pixel (px, py); 0 where
// the gate drops the pair. dx, dy are returned for the moment sums.
__device__ __forceinline__ float pair_alpha(const float (*s)[CHUNK + 1], int l, float px,
                                            float py, float& dx, float& dy) {
  dx = px - s[0][l];
  dy = py - s[1][l];
  if (!(fabsf(dx) <= s[10][l]) || !(fabsf(dy) <= s[11][l])) return 0.0f;
  const float a = s[2][l];
  const float b = s[3][l];
  const float c = s[4][l];
  const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
  if (!(power > NEG_CUTOFF && power <= 0.0f)) return 0.0f;
  const float alpha = s[5][l] * expf(power);
  if (!(alpha >= ALPHA_MIN)) return 0.0f;
  return fminf(alpha, 0.99f);
}

// out: g_attrs [V, n_out = N, 16] (fused, zeroed by the caller) or dout
// [V, n_out = NBLK + T, 16, 128] (TILE_OWNED; obase [V, T] is each tile's
// first output block).
template <class Src, bool TILE_OWNED>
__global__ void __launch_bounds__(BWD_THREADS)
composite_bwd_kernel(Src src, const int* __restrict__ starts, const int* __restrict__ counts,
                     const float* __restrict__ g_planes, const float* __restrict__ lt_final,
                     const int* __restrict__ nproc, const int* __restrict__ obase,
                     float* __restrict__ out, int n_out, int n_tiles, int ntx, float w_img,
                     int wrap_x) {
  __shared__ float s_attr[ROWS][CHUNK + 1];
  __shared__ unsigned s_mask[CHUNK];
  __shared__ float s_grad[TILE_OWNED ? 1 : N_GRAD][CHUNK + 1];
  extern __shared__ float s_slot[];  // TILE_OWNED: [N_SUB][N_GRAD][CHUNK]

  const int tile = blockIdx.x;
  const int view = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = view * n_tiles + tile;
  const int n_walk = nproc[seg];
  if (n_walk <= 0) return;  // uniform over the block
  const int start = starts[seg];
  const int count = counts[seg];
  const int blk0 = start / CHUNK;

  const float x0 = static_cast<float>((tile % ntx) * TILE_W);
  const float y0 = static_cast<float>((tile / ntx) * TILE_H);
  const float xc = x0 + TILE_W * 0.5f;
  const int cx0 = (warp % SUB_X) * SUB_W;
  const int ry0 = (warp / SUB_X) * SUB_H;
  const float px = x0 + static_cast<float>(cx0 + lane);
  const unsigned my_bit = 1u << warp;

  // per-pixel state of rows ry0 .. ry0+3 in column cx0 + lane
  float log_t_final[SUB_H], suffix[SUB_H], a_psi[SUB_H], gt_term[SUB_H], gc[SUB_H][4];
  const float* gp = g_planes + static_cast<size_t>(seg) * 8 * N_PIX;
  const float* lt = lt_final + static_cast<size_t>(seg) * N_PIX;
#pragma unroll
  for (int r = 0; r < SUB_H; ++r) {
    const int p = (ry0 + r) * TILE_W + cx0 + lane;
    log_t_final[r] = lt[p];
#pragma unroll
    for (int c = 0; c < 4; ++c) gc[r][c] = gp[c * N_PIX + p];
    gt_term[r] = gp[4 * N_PIX + p] * expf(log_t_final[r]);
    suffix[r] = 0.0f;
    a_psi[r] = 0.0f;
  }

  // TILE_OWNED: thread tid's lane of walked block j in the tile's output
  auto out_lane = [&](int j) {
    return out + (static_cast<size_t>(view) * n_out + obase[seg] + j) * ROWS * CHUNK + tid;
  };

  for (int j = n_walk - 1; j >= 0; --j) {
    const int idx = (blk0 + j) * CHUNK + tid;
    const int g = (tid < CHUNK && idx >= start && idx < start + count) ? src.key(view, idx) : -1;
    __syncthreads();  // the previous block's shared-memory reads are done
    if (tid < CHUNK) {
      float4 row[ROWS / 4];
      if (g >= 0) {
        src.load(view, g, row);
      } else {
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) row[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      unsigned m = 0u;
      if (g >= 0) {
        if (wrap_x) {
          // as the forward: rintf rounds half to even, as jnp.round
          row[0].x = row[0].x + w_img * rintf((xc - row[0].x) / w_img);
        }
        m = region_bits(row[0].x - x0, row[0].y - y0, row[2].z, row[2].w);
      }
      s_mask[tid] = m;
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        s_attr[4 * q + 0][tid] = row[q].x;
        s_attr[4 * q + 1][tid] = row[q].y;
        s_attr[4 * q + 2][tid] = row[q].z;
        s_attr[4 * q + 3][tid] = row[q].w;
      }
      if (!TILE_OWNED) {
#pragma unroll
        for (int i = 0; i < N_GRAD; ++i) s_grad[i][tid] = 0.0f;
      }
    }
    __syncthreads();

    // steps 1-3: the block's per-pixel sum of log1p(-alpha), lanes in order
    float sum_lg[SUB_H] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int q = 0; q < CHUNK; q += 32) {
      unsigned todo = __ballot_sync(FULL, (s_mask[q + lane] & my_bit) != 0u);
      while (todo != 0u) {
        const int l = q + __ffs(todo) - 1;
        todo &= todo - 1u;
#pragma unroll
        for (int r = 0; r < SUB_H; ++r) {
          float dx, dy;
          const float alpha = pair_alpha(s_attr, l, px, y0 + static_cast<float>(ry0 + r), dx, dy);
          if (alpha > 0.0f) sum_lg[r] = sum_lg[r] + log1pf(-alpha);
        }
      }
    }
    float log_t_end[SUB_H];
    bool live = false;
#pragma unroll
    for (int r = 0; r < SUB_H; ++r) {
      log_t_end[r] = log_t_final[r] - suffix[r];
      const float log_t_start = log_t_end[r] - sum_lg[r];
      suffix[r] = suffix[r] + sum_lg[r];
      live = live || (log_t_start >= LOG_T_EPS);
    }
    // step 4's gate: the max over the tile's pixels of log_t_start
    if (!__syncthreads_or(live)) {
      if (TILE_OWNED && tid < CHUNK) {
        float* dst = out_lane(j);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) dst[r * CHUNK] = 0.0f;
      }
      continue;
    }

    // step 4: lanes back to front
    float lg_suffix[SUB_H] = {0.0f, 0.0f, 0.0f, 0.0f};
    float psi_suffix[SUB_H] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int q = CHUNK - 32; q >= 0; q -= 32) {
      unsigned todo = __ballot_sync(FULL, (s_mask[q + lane] & my_bit) != 0u);
      while (todo != 0u) {
        const int bit = 31 - __clz(todo);
        todo &= ~(1u << bit);
        const int l = q + bit;
        const float cr = s_attr[6][l], cg = s_attr[7][l], cb = s_attr[8][l], cd = s_attr[9][l];
        float acc[N_GRAD];
#pragma unroll
        for (int i = 0; i < N_GRAD; ++i) acc[i] = 0.0f;
        bool any = false;
#pragma unroll
        for (int r = 0; r < SUB_H; ++r) {
          float dx, dy;
          const float alpha = pair_alpha(s_attr, l, px, y0 + static_cast<float>(ry0 + r), dx, dy);
          if (!(alpha > 0.0f)) continue;
          any = true;
          lg_suffix[r] = lg_suffix[r] + log1pf(-alpha);
          const float t_i = expf(log_t_end[r] - lg_suffix[r]);
          const float one_m = 1.0f - alpha;
          const bool contrib = t_i * one_m >= T_EPS;
          const float gamma = gc[r][0] * cr + gc[r][1] * cg + gc[r][2] * cb + gc[r][3] * cd;
          const float w = contrib ? alpha * t_i : 0.0f;
          const float psi = w * gamma;
          const float g_alpha =
              contrib ? t_i * gamma - (psi_suffix[r] + a_psi[r] + gt_term[r]) / one_m : 0.0f;
          psi_suffix[r] = psi_suffix[r] + psi;
          // step 5's per-pixel terms
          const float g_p = g_alpha * alpha;
          acc[0] = acc[0] + g_p;
          acc[1] = acc[1] + g_p * dx;
          acc[2] = acc[2] + g_p * dy;
          acc[3] = acc[3] + g_p * dx * dx;
          acc[4] = acc[4] + g_p * dy * dy;
          acc[5] = acc[5] + g_p * dx * dy;
          acc[6] = acc[6] + w * gc[r][0];
          acc[7] = acc[7] + w * gc[r][1];
          acc[8] = acc[8] + w * gc[r][2];
          acc[9] = acc[9] + w * gc[r][3];
        }
        const bool reduce = __any_sync(FULL, any);
        if (reduce) {
#pragma unroll
          for (int i = 0; i < N_GRAD; ++i) {
            float v = acc[i];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
            acc[i] = v;
          }
        }
        if (lane == 0) {
          if (TILE_OWNED) {
            // every warp marked for lane l writes its slot, zeros included
#pragma unroll
            for (int i = 0; i < N_GRAD; ++i) s_slot[(warp * N_GRAD + i) * CHUNK + l] = acc[i];
          } else if (reduce) {
#pragma unroll
            for (int i = 0; i < N_GRAD; ++i) atomicAdd(&s_grad[i][l], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SUB_H; ++r) a_psi[r] = a_psi[r] + psi_suffix[r];
    __syncthreads();

    // step 5: one gradient row per instance of the segment
    if (TILE_OWNED) {
      if (tid < CHUNK) {
        float m[N_GRAD];
#pragma unroll
        for (int i = 0; i < N_GRAD; ++i) m[i] = 0.0f;
        for (unsigned bits = s_mask[tid]; bits != 0u; bits &= bits - 1u) {
          const int w = __ffs(bits) - 1;  // warps in ascending order
#pragma unroll
          for (int i = 0; i < N_GRAD; ++i) m[i] = m[i] + s_slot[(w * N_GRAD + i) * CHUNK + tid];
        }
        float grad[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) grad[r] = 0.0f;
        if (g >= 0) {
          const float a = s_attr[2][tid], b = s_attr[3][tid], c = s_attr[4][tid];
          const float o = s_attr[5][tid];
          grad[0] = a * m[1] + b * m[2];
          grad[1] = c * m[2] + b * m[1];
          grad[2] = -0.5f * m[3];
          grad[3] = -m[5];
          grad[4] = -0.5f * m[4];
          grad[5] = m[0] / fmaxf(o, 1e-12f);
#pragma unroll
          for (int i = 6; i < N_GRAD; ++i) grad[i] = m[i];
        }
        float* dst = out_lane(j);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) dst[r * CHUNK] = grad[r];
      }
    } else if (g >= 0) {
      float m[N_GRAD];
      bool nonzero = false;
#pragma unroll
      for (int i = 0; i < N_GRAD; ++i) {
        m[i] = s_grad[i][tid];
        nonzero = nonzero || (m[i] != 0.0f);
      }
      if (nonzero) {
        const float a = s_attr[2][tid], b = s_attr[3][tid], c = s_attr[4][tid];
        const float o = s_attr[5][tid];
        float* dst = out + (static_cast<size_t>(view) * n_out + g) * ROWS;
        atomicAdd(dst + 0, a * m[1] + b * m[2]);
        atomicAdd(dst + 1, c * m[2] + b * m[1]);
        atomicAdd(dst + 2, -0.5f * m[3]);
        atomicAdd(dst + 3, -m[5]);
        atomicAdd(dst + 4, -0.5f * m[4]);
        atomicAdd(dst + 5, m[0] / fmaxf(o, 1e-12f));
#pragma unroll
        for (int i = 6; i < N_GRAD; ++i) atomicAdd(dst + i, m[i]);
      }
    }
  }
}

// starts/counts/nproc [V, T] i32, g_planes [V, T, 8, 2048] f32 (rows 0-4
// read), lt_final [V, T, 2048] f32; obase and out as for the kernel. Launches
// on `stream`; returns the first CUDA error, or cudaGetLastError() after the
// launch.
template <class Src, bool TILE_OWNED>
int launch_composite_bwd(Src src, const void* starts, const void* counts, const void* g_planes,
                         const void* lt_final, const void* nproc, const void* obase, void* out,
                         int n_out, int n_views, int nty, int ntx, float w_img, int wrap_x,
                         void* stream) {
  const int n_tiles = nty * ntx;
  if (n_views == 0 || n_tiles == 0) return 0;
  const auto kernel = composite_bwd_kernel<Src, TILE_OWNED>;
  const int dyn = TILE_OWNED ? BWD_SLOT_BYTES : 0;
  if (TILE_OWNED) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_tiles, n_views);
  kernel<<<grid, BWD_THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(g_planes), static_cast<const float*>(lt_final),
      static_cast<const int*>(nproc), static_cast<const int*>(obase), static_cast<float*>(out),
      n_out, n_tiles, ntx, w_img, wrap_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace composite
