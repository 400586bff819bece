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
// pair; this design's recomputed alpha chains are not counted) or bytes (the
// gathered attribute rows, the cotangent planes and one 40-byte gradient per
// instance and tile). What limits it instead is instruction issue at a low
// lane occupancy inside a thread block (composite_bwd.cuh). The heaviest
// tile no longer sets the time: a heavy tile's walk is cut into spans of S
// blocks that run at once, at the price of two more walks of every span but
// its lowest.

#include "composite_bwd.cuh"

// attrs [V, N, 16] f32, gidx [V, K] i32, starts/counts/nproc [V, T] i32,
// g_planes [V, T, 8, 2048] f32 (rows 0-4 read), lt_final [V, T, 2048] f32,
// heavy [1] i32, item_end [V T] i32 and the scratch lsum/psum
// [n_items, 2048] f32 for spans of `span` blocks (composite_bwd.cuh),
// g_attrs [V, N, 16] f32, zeroed by the caller. Launches on `stream`;
// returns the first CUDA error.
extern "C" int composite_bwd_fused(const void* attrs, const void* gidx,
                                   const void* starts, const void* counts,
                                   const void* g_planes, const void* lt_final,
                                   const void* nproc, const void* heavy,
                                   const void* item_end, void* lsum, void* psum,
                                   void* g_attrs, int n_views, int n, int k,
                                   int nty, int ntx, int span, int n_items,
                                   float w_img, int wrap_x, void* stream) {
  const composite::GatheredRows src{static_cast<const float4*>(attrs),
                                    static_cast<const int*>(gidx), n, k};
  return composite::launch_composite_bwd<composite::GatheredRows, false>(
      src, starts, counts, g_planes, lt_final, nproc, nullptr, item_end, span, heavy, n_items,
      lsum, psum, g_attrs, n, n_views, nty, ntx, w_img, wrap_x, stream);
}
