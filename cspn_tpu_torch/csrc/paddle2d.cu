// Paddle-semantics multi-step 2D CSPN for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_paddle2d_kernel,
// launched there by _cspn2d_paddle_impl for cspn_nd's 2D branch (the
// paddle demo's --dimNum=2 path).  It computes `steps` iterations of
// cspn_tpu_torch/ops/cspn_ref.py:affinity_propagate_reference in 2D on
// fixed gates, the plain version being propagate_nd_reference: for each
// map m (the C channels folded into the batch) and pixel p,
//
//   x_{t+1}[p] = (1 - sum_d w_d[p]) x_t[p] + sum_d w_d[p] x_t[p + off_d]
//
// out-of-image neighbours contributing 0 while their gates still count in
// the centre weight.  The gates arrive normalized (abs, then per-pixel,
// per-channel sum-normalization with the max(., 1e-12) guard, in PyTorch:
// ops/cspn_paddle2d_cuda.py:paddle2d_layout).  Gate order: paddle raster
// order, neighbor_offsets(2, 3) = (-1,-1) (-1,0) (-1,1) (0,-1) (0,1)
// (1,-1) (1,0) (1,1), as [M,8,H,W]; JAX flips it to its _OFFS order, the
// exact reverse, and this kernel does not.  All arithmetic is f32.
//
// Backward: none here, on purpose.  JAX's custom VJP rematerializes the
// gradient through autodiff of its XLA reference (cspn_pallas.py:
// _cspn2d_paddle_bwd), so the only backward of this function on any
// device is autodiff of the plain version; the port's autograd Function
// runs autograd of propagate_nd_reference on the card.  It is not a
// fallback: there is no backward kernel to fall back from.
//
// What bounds it on this card.  The fused op reads 8 gate planes and x_0
// and writes one plane: 10 f32 planes, 1.0 MB at the demo's [3,64,128],
// 22 MB at [8,228,304] (4 frames, C=2).  ~18 flops per pixel per step
// (8 FMA, the centre term): 0.24 GFLOP at [8,228,304] and 24 steps,
// 0.0036 ms at 67 TFLOP/s of f32, below the 0.0066 ms of bytes.
//
// What this design does about it.  The paddle instantiation of the K-step
// tile stencil (cspn2d_tile.cuh) that the halo segment also runs: 32x32 interiors with
// an 8-deep halo, 8 steps per launch, the 8 gates and the centre weight
// (summed from them at load, so there is no prep launch) in registers,
// the state ping-ponging in shared memory.  The TPU kernel keeps the whole
// map and all steps in VMEM; a 228x304 f32 plane (277 KB) exceeds an SM's
// shared memory, so the map is tiled and the halo recomputed (2.25x the
// interior's arithmetic, 2.25x its reads per launch).

#include "cspn2d_tile.cuh"  // kTile, kHalo, tile_steps, launch_tiles

namespace {

__global__ void __launch_bounds__(kExt * kTileRows)
    paddle2d_kernel(const float* __restrict__ gates, const float* __restrict__ base,
                    const float* __restrict__ keep, const float* __restrict__ x_in,
                    float* __restrict__ x_out, int h, int w, int k) {
  tile_steps<true>(gates, base, keep, x_in, x_out, h, w, k);
}

}  // namespace

// Runs `steps` steps on `stream` as ceil(steps / halo) tile launches.
// `tile` and `halo` must be the compiled kTile and kHalo.  The caller
// allocates every buffer (contiguous f32): gates [m,8,h,w], x0/out/
// x_scratch [m,h,w].  Returns cudaGetLastError() after the first launch
// that fails, else 0.
extern "C" int paddle2d_f32(const float* gates, const float* x0, float* out, float* x_scratch,
                            int m, int h, int w, int steps, int tile, int halo, void* stream) {
  if (tile != kTile || halo != kHalo) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, x0, sizeof(float) * (size_t)m * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  return launch_tiles(paddle2d_kernel, gates, nullptr, nullptr, x0, out, x_scratch, m, h, w, steps,
                      s);
}
