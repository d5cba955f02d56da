// 2D CSPN forward (pytorch reference semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_fwd_kernel (and
// _fwd_kernel_nosparse), launched there by _cspn2d_pallas_impl.  It
// computes exactly cspn_tpu_torch/ops/cspn_ref.py:cspn2d_reference: for each
// pixel p and each offset off_d of OFFSETS_2D_REFERENCE,
//
//   B_d[p]   = g_d[p + off_d]           (|g_d| first under 8sum_abs; 0 outside)
//   gate_d   = B_d / max(sum_d |B_d|, 1e-30)   (exactly 0 where the sum is 0)
//   center   = 1 - sum_d gate_d
//   mask     = sign(sparse), keep = 1 - mask
//   base     = keep * center * x0 + mask * x0
//   x       <- sum_d keep * gate_d * x[p + off_d] + base      (`steps` times)
//
// with out-of-image neighbours 0 and all arithmetic in f32.  Without sparse,
// keep = 1 and base = center * x0.
//
// What bounds it on this card.  The fused op must read 8 guidance planes,
// blur and sparse and write one plane: 11 f32 planes per image, 3.05 MB at
// 228x304, about 0.9 us per image at the H100 SXM's 3.35 TB/s.  Its
// arithmetic is ~17 flops per pixel per step (8 FMA + the base add), about
// 28 MFLOP per 228x304 image at 24 steps, 0.4 us at 67 TFLOP/s of f32: the op
// is memory-bound.  This kernel is the forward that cspn2d_bwd.cu follows
// (ops/cspn_cuda.py:use_tiled), so it also writes what the backward reads:
// the states x_1..x_{T-1} and the 8 folded gates keep * gate_d: 10 planes
// read and 1 + 23 + 8 written at 24 steps, 42 planes, 0.0278 ms at NYU b8
// and 0.0859 ms at KITTI b4 (4x352x1216).
//
// What this design does about it (an earlier version ran a prep launch
// that folded the gates, then one launch a step, each reading 8 gate
// planes, base and x and writing y: 11 planes a step, 25 launches at 24
// steps).  It is the tiled forward's column march (cspn2d_march.cuh,
// cspn2d_tiled.cu): 64x64 extended tiles, an interior of 64 - 2K, K = 12
// steps a launch with the state in registers, ceil(steps / K) launches (2
// at 24 steps).  The first launch folds the gates from the raw guidance at
// load and writes the interior's folded gates ([N,8,H,W], the layout
// cspn2d_bwd.cu's reverse tiles read) and base ([N,H,W], for a later
// launch); after every step t < T the interior's threads store x_t into
// states[t - 1] (a float2 a lane and row, coalesced across the warp, which
// nothing waits for, so the stores overlap the next step's arithmetic), and
// step T writes `out`.  A later launch starts from the state the one before
// it stored.  The values are the tiled forward's and those of the version
// with a launch a step: the same fold code and, per pixel and step, the
// same FMA chain in the same order.  Traffic per launch: the tiled forward's (~10 input
// planes over 2.56x the interior, part of it from the L2) and K state
// planes; the halo's re-reads and one block an SM (its loads, fold and
// steps do not overlap) keep it several times its bound.

#include "cspn2d_march.cuh"  // MarchArgs, march_tile, march_launches

namespace {

// One launch of the forward that keeps its states (march_tile): kFold the
// first, folding the raw guidance; !kFold a later one, on the folded gates.
template <bool kFold>
__global__ void __launch_bounds__(kMarchThreads, 1) cspn2d_fwd_kernel(MarchArgs a) {
  march_tile<kFold ? Load::kRaw : Load::kFolded, true>(a);
}

}  // namespace

// Runs the whole forward on `stream`: ceil(steps / kHalo) launches.  The
// caller allocates every buffer (contiguous f32): guid [n,8,h,w],
// blur/out/base_scratch [n,h,w], gates [n,8,h,w] (out: the folded gates
// keep * gate_d, what cspn2d_bwd.cu reads), states [max(steps-1,0),n,h,w]
// (out: x_t in states[t-1]); sparse may be null.  base_scratch carries the
// folded base to the later launches.  Returns cudaGetLastError() after the
// first launch that fails, else 0.
extern "C" int cspn2d_fwd_f32(const float* guid, const float* blur, const float* sparse,
                              float* out, float* gates, float* base_scratch, float* states,
                              int n, int h, int w, int steps, int norm_abs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, blur, sizeof(float) * (size_t)n * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  MarchArgs a{};
  a.gates = guid;
  a.base = blur;
  a.mask = sparse;
  a.gates_out = gates;
  a.base_out = steps > kHalo ? base_scratch : nullptr;
  a.x_in = blur;
  a.x_out = out;
  a.states = states;
  a.h = h;
  a.w = w;
  a.norm_abs = norm_abs;
  return static_cast<int>(
      march_launches(cspn2d_fwd_kernel<true>, cspn2d_fwd_kernel<false>, a, n, steps, s));
}
