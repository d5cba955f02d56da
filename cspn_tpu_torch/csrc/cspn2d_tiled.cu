// Tiled multi-step 2D CSPN forward (pytorch reference semantics) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_fwd_dma_kernel (and
// _fwd_dma_kernel_nosparse), launched there by _cspn2d_tiled_impl for
// frames past the whole-image kernel's VMEM budget.  It computes exactly
// what cspn2d_fwd.cu computes, cspn_tpu_torch/ops/cspn_ref.py:
// cspn2d_reference (see cspn2d_fwd.cu for the formula), with the same
// values: the same prep launch and, per pixel and step, the same FMA chain
// in the same order (an out-of-image neighbour adds g * 0 where the
// per-step kernel skips it).
//
// What bounds it on this card.  The fused op reads 8 guidance planes, blur
// and sparse and writes one plane: 11 f32 planes, 75.3 MB for a batch of
// four 352x1216 KITTI frames, 0.0225 ms at the H100 SXM's 3.35 TB/s.  Its
// arithmetic is ~17 flops per pixel per step, 0.0105 ms at 67 TFLOP/s of
// f32 for 24 steps: bytes bound it.
//
// Why a second forward kernel.  The per-step kernel (cspn2d_fwd.cu) reads
// 8 gate planes, base and x and writes y at every step: 11 planes a step.
// At NYU b8 (24.4 MB) that stays in the 50 MB L2; at KITTI b4 (75.3 MB a
// step) it goes to device memory 24 times.  Timed beside it on an H100,
// this kernel is faster at every shape of the paths, inside the L2 too
// (NYU b1-b16, KITTI b1-b4), so ops/cspn_cuda.py:use_tiled sends every
// forward here that no backward follows; a forward that cspn2d_bwd follows
// runs the per-step kernel, which keeps its states for the backward.
//
// What this design does about it.  The TPU kernel keeps a full-width row
// band and all steps in VMEM; on Hopper a 1216-wide band with a 24-row
// halo is over 600 KB of double-buffered state against 227 KB of shared
// memory.  So the tiles are 2D (cspn2d_tile.cuh): a 32x32 interior with an
// 8-deep halo on all four sides (48x48, 20 KB of shared state), 8 steps
// per launch, ceil(steps/8) launches, each thread keeping its pixels'
// gates and base in registers.  One prep launch (cspn2d_common.cuh,
// unchanged) writes keep*gate_d and base once.  Traffic per tile launch:
// the 10 planes it reads over 2.25x the interior (the halo), about 161 MB
// at KITTI b4, plus ~130 MB for prep: ~0.6 GB against the per-step
// kernel's ~1.8 GB.  The halo recompute costs 2.25x the interior's
// arithmetic.  What it leaves open: larger interiors (64x64: 1.56x), bf16
// gates, and folding prep into the first tile launch.

#include "cspn2d_common.cuh"  // kThreads, prep_kernel
#include "cspn2d_tile.cuh"    // kTile, kHalo, tile_steps, launch_tiles

namespace {

__global__ void __launch_bounds__(kExt * kTileRows)
    cspn2d_tiled_kernel(const float* __restrict__ gates, const float* __restrict__ base,
                        const float* __restrict__ keep, const float* __restrict__ x_in,
                        float* __restrict__ x_out, int h, int w, int k) {
  tile_steps<false>(gates, base, keep, x_in, x_out, h, w, k);
}

}  // namespace

// Runs the whole forward on `stream`: one prep launch and ceil(steps /
// halo) tile launches.  `tile` and `halo` must be the compiled kTile and
// kHalo (ops/cspn_cuda.py:plan_tiles names them).  The caller allocates
// every buffer (contiguous f32): guid [n,8,h,w], blur/out/x_scratch/
// base_scratch [n,h,w], gate_scratch [n,8,h,w]; sparse may be null.
// Returns cudaGetLastError() after the first launch that fails, else 0.
extern "C" int cspn2d_tiled_f32(const float* guid, const float* blur, const float* sparse,
                                float* out, float* gate_scratch, float* base_scratch,
                                float* x_scratch, int n, int h, int w, int steps,
                                int norm_abs, int tile, int halo, void* stream) {
  if (tile != kTile || halo != kHalo) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, blur, sizeof(float) * (size_t)n * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  prep_kernel<<<grid, kThreads, 0, s>>>(guid, blur, sparse, gate_scratch, base_scratch, h, w,
                                        norm_abs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // prep has folded keep into gate_scratch
  return launch_tiles(cspn2d_tiled_kernel, gate_scratch, base_scratch, nullptr, blur, out,
                      x_scratch, n, h, w, steps, s);
}
