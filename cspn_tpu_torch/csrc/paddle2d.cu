// Paddle-semantics multi-step 2D CSPN for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_paddle2d_kernel,
// launched there by _cspn2d_paddle_impl for cspn_nd's 2D branch (the
// paddle demo's --dimNum=2 path).  It computes cspn_nd_reference in 2D
// (cspn_tpu_torch/ops/cspn_ref.py), from the raw guide and features: for
// each map m (channel ch of frame n, m = n C + ch) and pixel p, with the
// gates w_d[p] = |g_d[p]| / max(sum_d |g_d[p]|, 1e-12) of the guide's
// channel group ch,
//
//   x_{t+1}[p] = (1 - sum_d w_d[p]) x_t[p] + sum_d w_d[p] x_t[p + off_d]
//
// `steps` times, out-of-image neighbours contributing 0 while their gates
// still count in the centre weight.  The guide's gate order is paddle
// raster order, neighbor_offsets(2, 3) = (-1,-1) (-1,0) (-1,1) (0,-1)
// (0,1) (1,-1) (1,0) (1,1); JAX flips it into its _OFFS order, the exact
// reverse (cspn_pallas.py:715), and this kernel reverses it as it loads.
// All arithmetic is f32.
//
// Backward: none here, on purpose.  JAX's custom VJP rematerializes the
// gradient through autodiff of its XLA reference (cspn_pallas.py:
// _cspn2d_paddle_bwd), so the only backward of this function on any
// device is autodiff of the plain version; the port's autograd Function
// runs autograd of cspn_nd_reference on the card.  It is not a fallback:
// there is no backward kernel to fall back from.
//
// What bounds it on this card.  The fused op reads 8 guide planes and x_0
// and writes one plane: 10 f32 planes, 1.0 MB at the demo's [3,64,128],
// 22 MB at [4,228,304] with C = 2 (8 maps).  ~18 flops per pixel per step
// (8 FMA and the centre product): 0.24 GFLOP there at 24 steps, 0.0036 ms
// at 67 TFLOP/s of f32, below the 0.0066 ms of bytes.  At the demo's maps
// (24 tiles) the launches' latency bounds it instead.
//
// What this design does about it.  The 2D CSPN's column march
// (cspn2d_march.cuh): 64x64 extended tiles with an interior of 40, 12
// steps a launch with the state in registers, ceil(steps / 12) launches
// (2 at 24 steps; an earlier version ran 32x32 interiors with an 8-deep
// halo, the state ping-ponging through shared memory, 3 launches), each
// step the march's 8 FMAs plus the centre tap on the thread's own state
// (kCentre).  There is no prep launch: each launch reads the raw guide and
// the features in the caller's layout (channel-last [N,H,W,C*8] and
// [N,H,W,C], or channel-first [N,C*8,H,W] and [N,C,H,W]), forms |g|, the
// sum, the quotients and the centre weight in registers (Load::kPaddle),
// and writes the output in the same layout.  A later launch normalizes
// the guide again at its load (one reciprocal a pixel, the channel-last
// gates as two float4s): queued, 0.0666 ms at [4,8,228,304] against 0.0756
// for a later launch reading a normalized copy that the first launch
// stores, and 0.0213 against 0.0204 at the demo's maps (PERF.md, row 6).

#include "cspn2d_march.cuh"  // MarchArgs, march_tile, march_launches

namespace {

// One launch of the paddle march: the raw guide normalized at load.
__global__ void __launch_bounds__(kMarchThreads, 1) paddle2d_kernel(MarchArgs a) {
  march_tile<Load::kPaddle, false>(a);
}

}  // namespace

// `steps` steps on `stream` in tile_launches(steps) launches (a copy at
// steps <= 0).  The caller allocates every buffer (contiguous f32): with
// channel_last, guide [n,h,w,c*8] and feat/out/x_scratch [n,h,w,c]; else
// guide [n,c*8,h,w] and feat/out/x_scratch [n,c,h,w].  Returns the first
// CUDA error, else 0.
extern "C" int paddle2d_f32(const float* guide, const float* feat, float* out, float* x_scratch,
                            int n, int c, int h, int w, int steps, int channel_last,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, feat, sizeof(float) * (size_t)n * c * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  MarchArgs a{};
  a.gates = guide;
  a.x_in = feat;
  a.x_out = out;
  a.h = h;
  a.w = w;
  a.chans = c;
  a.channel_last = channel_last;
  return static_cast<int>(
      march_launches(paddle2d_kernel, paddle2d_kernel, a, n * c, steps, s, x_scratch));
}
