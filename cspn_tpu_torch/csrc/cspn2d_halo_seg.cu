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
// keep*center*x0 + mask*x0; all arithmetic is f32.  With G_d = keep *
// gate_d (keep is 0, 1 or 2, so the product is exact and scales every
// term of the FMA chain exactly) a step is x'[p] = sum_d G_d[p] x[p +
// off_d] + base[p], the column march's step.
//
// What bounds it on this card.  One segment reads 8 gate planes, base,
// keep and x and writes one plane: 12 f32 planes, 104.6 MB for the KITTI
// b4 segment at S = 2 and K = 24 ([8, 8, 224, 1216], the S blocks stacked),
// 0.0312 ms at the H100 SXM's 3.35 TB/s.  Its arithmetic, ~18 flops per
// pixel per step, is 0.94 GFLOP there, 0.0141 ms at 67 TFLOP/s of f32:
// bytes bound it.  The route a backward follows also writes x_1..x_{K-1}
// and G (23 + 8 planes at K = 24): 43 planes, 0.112 ms.
//
// What this design does about it (an earlier version ran 32x32 interiors
// with an 8-deep halo, the state ping-ponging through shared memory, 8
// steps a launch: 3 launches at K = 24, ~9.5x the 12-plane bound; the
// backward then replayed the K - 1 steps).  The block
// is the image of the 2D CSPN's column march (cspn2d_march.cuh): 64x64
// extended tiles, an interior of 40, K_m = 12 steps a launch with the state
// in registers, ceil(K / K_m) launches; the block's own edge rows and the
// image's edge columns are the march's zeros (gates and base 0 outside the
// map).  There is no prep: each thread multiplies keep into its pixels'
// gates as it loads them (Load::kKeep), or reads the gates as given
// without keep (Load::kFolded).  Two routes, the same march in the same
// FMA order, so their outputs are equal value for value:
//   - cspn2d_halo_seg_f32, no backward follows (serving, evaluation):
//     stores only the output; each launch folds keep into the gates again
//     at its load (9 planes a pixel), which measured faster than a later
//     launch reading a folded copy that the first writes (K = 24 on the
//     KITTI b4 segment: 0.192 against 0.208 ms, queued; PERF.md);
//   - cspn2d_halo_seg_states_f32, a backward follows (training): after
//     each step t < K the interior's threads store x_t, the last step
//     `out`, and the first launch stores G (with keep), which the later
//     launches read and the backward (cspn2d_halo_seg_bwd.cu) too: it then
//     runs only its reverse tiles.
// What it leaves open: bf16 gates, as for the tiled forward.

#include "cspn2d_march.cuh"  // MarchArgs, march_tile, march_launches, tile_launches

namespace {

// One launch of the segment (march_tile): kLoad kKeep folds keep into the
// given gates at load, kFolded reads them as they are; kStates stores
// every state (the route a backward follows).
template <Load kLoad, bool kStates>
__global__ void __launch_bounds__(kMarchThreads, 1) halo_seg_kernel(MarchArgs a) {
  march_tile<kLoad, kStates>(a);
}

MarchArgs segment_args(const float* gates, const float* base, const float* keep, const float* x,
                       float* out, int h, int w) {
  MarchArgs a{};
  a.gates = gates;
  a.base = base;
  a.mask = keep;
  a.x_in = x;
  a.x_out = out;
  a.h = h;
  a.w = w;
  return a;
}

cudaError_t copy_plane(float* out, const float* x, int n, int h, int w, cudaStream_t s) {
  return cudaMemcpyAsync(out, x, sizeof(float) * (size_t)n * h * w, cudaMemcpyDeviceToDevice, s);
}

}  // namespace

// The segment that no backward follows, on `stream`: tile_launches(k_steps)
// launches (a copy at k_steps <= 0), each on the given gates, base and
// keep.  The caller allocates every buffer (contiguous f32): gates
// [n,8,h,w], base/x/out/x_scratch [n,h,w]; keep [n,h,w] or null.  Returns
// the first CUDA error, else 0.
extern "C" int cspn2d_halo_seg_f32(const float* gates, const float* base, const float* keep,
                                   const float* x, float* out, float* x_scratch, int n, int h,
                                   int w, int k_steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_steps <= 0) return static_cast<int>(copy_plane(out, x, n, h, w, s));
  const MarchKernel kernel = keep != nullptr ? halo_seg_kernel<Load::kKeep, false>
                                             : halo_seg_kernel<Load::kFolded, false>;
  const MarchArgs a = segment_args(gates, base, keep, x, out, h, w);
  return static_cast<int>(march_launches(kernel, kernel, a, n, k_steps, s, x_scratch));
}

// The segment that a backward follows, on `stream`: tile_launches(k_steps)
// launches (a copy at k_steps <= 0).  The caller allocates every buffer
// (contiguous f32): gates [n,8,h,w], base/x/out [n,h,w]; keep [n,h,w] or
// null; folded [n,8,h,w] (out, with keep: G = keep * gate_d; unused
// without), states [max(k_steps-1,0),n,h,w] (out: x_t in states[t-1]).
// Returns the first CUDA error, else 0.
extern "C" int cspn2d_halo_seg_states_f32(const float* gates, const float* base,
                                          const float* keep, const float* x, float* out,
                                          float* folded, float* states, int n, int h, int w,
                                          int k_steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_steps <= 0) return static_cast<int>(copy_plane(out, x, n, h, w, s));
  MarchArgs a = segment_args(gates, base, keep, x, out, h, w);
  a.gates_out = keep != nullptr ? folded : nullptr;
  a.states = states;
  const MarchKernel as_given = halo_seg_kernel<Load::kFolded, true>;
  const MarchKernel first = keep != nullptr ? halo_seg_kernel<Load::kKeep, true> : as_given;
  return static_cast<int>(march_launches(first, as_given, a, n, k_steps, s));
}
