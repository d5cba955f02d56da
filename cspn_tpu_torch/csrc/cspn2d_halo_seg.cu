// K-step 2D CSPN segment on a halo-extended row block (the spatially
// sharded CSPN's local propagation) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_halo_seg_kernel (and
// _halo_seg_kernel_nokeep), launched there by _halo_segment_impl for
// parallel/halo.py:_local_cspn.  It computes exactly
// cspn_tpu_torch/ops/cspn_ref.py:halo_segment_reference: on one block of He
// rows (a shard's rows and K halo rows from each neighbour) and W columns,
// K times
//
//   y[p] = sum_d gate_d[p] x[p + off_d]       (reference gate order)
//   x    = keep[p] y[p] + base[p]             (x = y + base without keep)
//
// with every cell beyond the block's first and last rows and beyond the
// image's columns read as 0 (JAX's zero `xpad`).  The gates arrive
// normalized on the halo-extended guidance (parallel/halo.py), base =
// keep*center*x0 + mask*x0; all arithmetic is f32.
//
// What bounds it on this card.  One segment reads 8 gate planes, base,
// keep and x and writes one plane: 12 f32 planes, 44.8 MB for a KITTI b4
// shard at S = 2 and K = 8 ([4, 8, 192, 1216]), 0.0134 ms at the H100 SXM's
// 3.35 TB/s.  Its arithmetic, ~17 flops per pixel per step, is 0.0024 ms
// at 67 TFLOP/s of f32 for K = 8: bytes bound it.
//
// What this design does about it.  The TPU kernel keeps the whole extended
// block in VMEM for the K steps; one KITTI shard plane (192x1216 f32, 934
// KB) is over four times an SM's shared memory.  So the block is treated as
// the image of the tiled 2D forward (cspn2d_tile.cuh): 32x32 interiors with
// an 8-deep tile halo, up to 8 steps per launch, the block's own edge a
// ring of zeros, which is JAX's `xpad`.  There is no prep: the gates arrive
// normalized, and each thread folds keep into its pixel's 8 gates as it
// loads them into registers (keep is 0, 1 or 2, so keep*gate is exact).  A
// segment of K > 8 steps (choose_halo ranges up to min(steps, rows - 1))
// runs ceil(K/8) launches with no exchange between them: the block is
// local.  Traffic per launch: the 11 input planes over 2.25x the interior
// and one output plane.  What it leaves open: larger interiors and bf16
// gates, as for the tiled forward.

#include "cspn2d_tile.cuh"  // kTile, kHalo, tile_steps, launch_tiles

namespace {

__global__ void __launch_bounds__(kExt * kTileRows)
    halo_seg_kernel(const float* __restrict__ gates, const float* __restrict__ base,
                    const float* __restrict__ keep, const float* __restrict__ x_in,
                    float* __restrict__ x_out, int h, int w, int k) {
  tile_steps<false>(gates, base, keep, x_in, x_out, h, w, k);
}

}  // namespace

// Runs a K-step segment on `stream` as ceil(k_steps / halo) tile launches.
// `tile` and `halo` must be the compiled kTile and kHalo (ops/cspn_cuda.py
// names them).  The caller allocates every buffer (contiguous f32): gates
// [n,8,h,w], base/x/out/x_scratch [n,h,w]; keep [n,h,w] or null.  Returns
// cudaGetLastError() after the first launch that fails, else 0.
extern "C" int cspn2d_halo_seg_f32(const float* gates, const float* base, const float* keep,
                                   const float* x, float* out, float* x_scratch, int n, int h,
                                   int w, int k_steps, int tile, int halo, void* stream) {
  if (tile != kTile || halo != kHalo) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, x, sizeof(float) * (size_t)n * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  return launch_tiles(halo_seg_kernel, gates, base, keep, x, out, x_scratch, n, h, w, k_steps,
                      s);
}
