// Fused forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_forward_kernel_fused`
// (splatter360_tpu/ops/pallas/composite.py:370). The kernel is
// composite_fwd.cuh's, reading each instance's 16 attributes from the
// per-Gaussian table attrs[N, 16] through gidx (a 64-byte gather per
// instance). The TPU kernel's instance-block residual is not written: only a
// backward pass would read it.
//
// What bounds it on an H100, counting only the work its inputs need: bytes
// (the gathered 64-byte attribute rows and the output planes) where most
// pairs of a block lie outside the instances' radius boxes, as in the
// encoder's scenes; FP32 operations (the per-pair alpha/transmittance chain)
// where splats cover most pixels of their blocks. Neither is what limits it
// today: a tile's blocks are walked in order (composite_fwd.cuh).

#include "composite_fwd.cuh"

// attrs [V, N, 16] f32, gidx [V, K] i32, starts/counts [V, T] i32,
// out [V, T, 8, 2048] f32, scratch [V, T, 16] i32 (the regions' own exits).
// Launches both passes on `stream`; returns cudaGetLastError() after them.
extern "C" int composite_fwd_fused(const void* attrs, const void* gidx,
                                   const void* starts, const void* counts,
                                   void* out, void* scratch, int n_views, int n,
                                   int k, int nty, int ntx, float w_img,
                                   int wrap_x, void* stream) {
  const composite::GatheredRows src{static_cast<const float4*>(attrs),
                                    static_cast<const int*>(gidx), n, k};
  return composite::launch_composite_fwd(src, starts, counts, out, scratch, n_views, nty, ntx,
                                         w_img, wrap_x, stream);
}
