// Unfused backward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_backward_kernel`
// (splatter360_tpu/ops/pallas/composite.py:705), the VJP of
// `_forward_kernel`. The kernel is composite_bwd.cuh's with TILE_OWNED =
// true: it reads each walked block of the packed instance buffer
// inst[NBLK, 16, 128] and writes the block's gradient rows into the tile's
// own output block dout[obase[tile] + j] (obase: the exclusive cumsum of
// blocks per tile, `_out_block_layout`), with plain stores and no atomics:
// the same inputs give the same bits. A walked block that fails the
// tile-wide gate writes zeros; blocks past the forward's n_processed are
// never written, and the caller masks them out (ops/cuda/composite.py:
// scatter_out_blocks, which also scatter-adds the live blocks' lanes into
// per-Gaussian gradients, as `_render_core_bwd` does in XLA).
//
// What bounds it on an H100, counting only what its inputs need: FP32
// operations (one alpha chain and the gradient terms, ~59 ops per gated
// pair) or bytes (8 KB of instance rows read and 8 KB of gradient rows
// written per walked block, the cotangent planes). Neither limits it today:
// one thread block owns a tile and walks its blocks in order, so the
// heaviest tile sets the time. Each warp's per-instance sums take their own
// slot of shared memory (80 KB a block) so that the sum over the tile's
// regions runs in a fixed order.

#include "composite_bwd.cuh"

// inst [V, NBLK, 16, 128] f32, starts/counts/nproc/obase [V, T] i32,
// g_planes [V, T, 8, 2048] f32 (rows 0-4 read), lt_final [V, T, 2048] f32,
// dout [V, NBLK + T, 16, 128] f32. Launches on `stream`; returns the first
// CUDA error.
extern "C" int composite_bwd_unfused(const void* inst, const void* starts,
                                     const void* counts, const void* g_planes,
                                     const void* lt_final, const void* nproc,
                                     const void* obase, void* dout, int n_views,
                                     int nblk, int nty, int ntx, float w_img,
                                     int wrap_x, void* stream) {
  const composite::PackedRows src{static_cast<const float*>(inst), nblk * composite::CHUNK};
  return composite::launch_composite_bwd<composite::PackedRows, true>(
      src, starts, counts, g_planes, lt_final, nproc, obase, dout, nblk + nty * ntx, n_views,
      nty, ntx, w_img, wrap_x, stream);
}
