// Unfused forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_forward_kernel`
// (splatter360_tpu/ops/pallas/composite.py:289), which the JAX package runs
// when the fused kernels' VMEM-resident table does not fit (N > ~1.47M, such
// as 3 context panoramas of 512x1024). It composites the same function as
// the fused forward (composite_fwd.cu) over a pre-gathered instance buffer
// inst[K / 128, 16, 128]: the caller packs it (ops/cuda/composite.py:
// pack_instances), the kernel reads each processed block's 8 KB
// contiguously, a warp's 32 lanes 128 contiguous bytes of each row, and
// gathers nothing. Lanes outside a tile's segment are masked in the kernel.
// Built -fmad=false on composite_fwd.cuh's kernel, it equals the fused
// forward bit for bit on the same instances, and both equal their plain
// PyTorch versions.
//
// What bounds it on an H100, counting only the work its inputs need: bytes
// (8 KB of instance rows per processed block, the output planes) where most
// pairs of a block lie outside the instances' radius boxes; FP32 operations
// (the per-pair alpha/transmittance chain) where splats cover most pixels of
// their blocks. Neither limits it today: as in the fused kernel, a tile's
// blocks are walked in order, so the heaviest tile sets the time
// (composite_fwd.cuh).

#include "composite_fwd.cuh"

// inst [V, NBLK, 16, 128] f32, starts/counts [V, T] i32, out [V, T, 8, 2048]
// f32, scratch [V, T, 16] i32 (the regions' own exits). Launches both passes
// on `stream`; returns cudaGetLastError() after them.
extern "C" int composite_fwd_unfused(const void* inst, const void* starts,
                                     const void* counts, void* out, void* scratch,
                                     int n_views, int nblk, int nty, int ntx,
                                     float w_img, int wrap_x, void* stream) {
  const composite::PackedRows src{static_cast<const float*>(inst), nblk * composite::CHUNK};
  return composite::launch_composite_fwd(src, starts, counts, out, scratch, n_views, nty, ntx,
                                         w_img, wrap_x, stream);
}
