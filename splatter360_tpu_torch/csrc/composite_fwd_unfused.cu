// Unfused forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_forward_kernel`
// (splatter360_tpu/ops/pallas/composite.py:289), which the JAX package runs
// when the fused kernels' VMEM-resident table does not fit (N > ~1.47M, such
// as 3 context panoramas of 512x1024). It composites the same function as
// the fused forward (composite_fwd.cu) over a pre-gathered instance buffer
// inst[K / 128, 16, 128]: the caller packs it (ops/cuda/composite.py:
// pack_instances), the kernel reads each block it walks (8 KB)
// contiguously, a warp's 32 lanes 128 contiguous bytes of each row, and
// gathers nothing. Lanes outside a tile's segment are masked in the kernel.
// Built -fmad=false on composite_fwd.cuh's kernel, it equals the fused
// forward bit for bit on the same instances, and both equal their plain
// PyTorch versions.
//
// What bounds it on an H100, counting only the work its inputs need: bytes
// (48 bytes of instance rows per instance of a processed block, the output
// planes) where most pairs of a block lie outside the instances' radius
// boxes; FP32 operations (the per-pair alpha/transmittance chain) where
// splats cover most pixels of their blocks. Neither limits it today: as in
// the fused kernel, a block's pixel work is a chain of dependent exp/log1p
// per pixel, and a heavy tile's blocks are cut into spans that run at once
// (composite_fwd.cuh).

#include "composite_fwd.cuh"

// inst [V, NBLK, 16, 128] f32; the rest as for launch_composite_fwd
// (composite_fwd.cuh). Returns its CUDA error, 0 if none.
extern "C" int composite_fwd_unfused(const void* inst, const void* starts, const void* counts,
                                     const void* nseg, const void* heavy, const void* item_end,
                                     void* lsum, void* csum, void* stop, void* next, void* out,
                                     int n_views, int nblk, int nty, int ntx, int span,
                                     int n_items, float w_img, int wrap_x, void* stream) {
  const composite::PackedRows src{static_cast<const float*>(inst), nblk * composite::CHUNK};
  return composite::launch_composite_fwd(src, starts, counts, nseg, heavy, item_end, span,
                                         n_items, lsum, csum, stop, next, out, n_views, nty, ntx,
                                         w_img, wrap_x, stream);
}
