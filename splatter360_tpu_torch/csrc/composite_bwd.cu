// Fused backward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_backward_kernel_fused`
// (splatter360_tpu/ops/pallas/composite.py:517). The kernel is
// composite_bwd.cuh's with TILE_OWNED = false: it re-gathers each walked
// instance's row from attrs[N, 16] through gidx and adds each instance's
// gradient into g_attrs[V, N, 16] with atomics, so the last bits of g_attrs
// vary from run to run (the Pallas kernel's sequential grid is
// deterministic).
//
// What bounds it on an H100, counting only what its inputs need: FP32
// operations (one alpha chain and the gradient terms, ~59 ops per gated
// pair; this design's second alpha recompute is not counted) or bytes (the
// gathered attribute rows, the cotangent planes and one 40-byte gradient per
// instance and tile). Neither limits it today: one thread block owns a tile
// and walks its blocks in order, so the heaviest tile sets the time.

#include "composite_bwd.cuh"

// attrs [V, N, 16] f32, gidx [V, K] i32, starts/counts/nproc [V, T] i32,
// g_planes [V, T, 8, 2048] f32 (rows 0-4 read), lt_final [V, T, 2048] f32,
// g_attrs [V, N, 16] f32, zeroed by the caller. Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int composite_bwd_fused(const void* attrs, const void* gidx,
                                   const void* starts, const void* counts,
                                   const void* g_planes, const void* lt_final,
                                   const void* nproc, void* g_attrs, int n_views,
                                   int n, int k, int nty, int ntx, float w_img,
                                   int wrap_x, void* stream) {
  const composite::GatheredRows src{static_cast<const float4*>(attrs),
                                    static_cast<const int*>(gidx), n, k};
  return composite::launch_composite_bwd<composite::GatheredRows, false>(
      src, starts, counts, g_planes, lt_final, nproc, nullptr, g_attrs, n, n_views, nty, ntx,
      w_img, wrap_x, stream);
}
