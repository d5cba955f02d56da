// Backward of the K-step halo segment (the exact adjoint of
// csrc/cspn2d_halo_seg.cu) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_halo_seg_bwd_kernel
// (and _halo_seg_bwd_kernel_nokeep), launched there by
// _halo_segment_bwd_pallas.  Given the segment's inputs and the cotangent v
// of its output it returns d gates [n,8,He,W], d base, d keep and d x in
// f32, what autograd of cspn_tpu_torch/ops/cspn_ref.py:
// halo_segment_reference returns.  With G_d = keep * gate_d (the folded
// gates of the forward; G_d = gate_d without keep) and x_0 = x:
//
//   forward   x_{t+1}[p] = sum_d G_d[p] x_t[p + off_d] + base[p]
//   reverse   for t = K-1 .. 0, with v = d x_{t+1}:
//               dbase[p]   += v[p]
//               Gbar_d[p]  += v[p] x_t[p + off_d]
//               v'[q]       = sum_d G_d[q - off_d] v[q - off_d]   (= d x_t)
//   epilogue  d gate_d = keep Gbar_d,  d keep = sum_d gate_d Gbar_d,
//             d x = v_0
//
// with cells beyond the block's rows and the image's columns 0, as in the
// forward.  Every launch is in gather form: a thread writes only its own
// pixel, so there are no atomics.
//
// What bounds it on this card.  The op must read 8 gate planes, base, keep,
// x and the cotangent and write 8 + 3 planes: 23 f32 planes, 200.5 MB for
// the KITTI b4 segment at S = 2 and K = 24 ([8, 8, 224, 1216]), 0.0598 ms
// at the H100 SXM's 3.35 TB/s; ~33 flops per pixel per reverse step, 0.0258
// ms at 67 TFLOP/s of f32.  Bytes bound it.  Reading the forward's G and
// x_1..x_{K-1} instead of base (below), it moves 53 planes at K = 24,
// 0.138 ms.

// What this design does about it (the first version folded keep in a
// launch of its own, replayed with one launch a step and ran one launch a
// reverse step, each reading and writing the 9 cotangent planes in device
// memory: 2K + 1 launches, 49 at K = 24, ~55x the bound; the next replayed
// the K - 1 states by the column march before its reverse tiles: 5
// launches).  The forward that a backward follows
// (cspn2d_halo_seg.cu:cspn2d_halo_seg_states_f32) keeps x_1..x_{K-1} and G
// = keep * gate (the gates as given without keep), so this runs only:
//   - reverse: the 2D CSPN backward's reverse tiles (cspn2d_reverse.cuh)
//     on those states with x_0 = x: d base is their bbar, the folded-gate
//     cotangent their Gbar and d x their v_0; the first launch starts the
//     accumulators at 0, so nothing is cleared first.  ceil(K/12)
//     launches, 12 the march's steps a launch;
//   - epilogue (with keep, pointwise): d gate_d = keep Gbar_d in place and
//     d keep = sum_d gate_d Gbar_d.
// 3 launches at K = 24 with keep, 2 at K = 8 (5 and 3 replaying, 49 and
// 17 before that).  No atomics: a second backward is bit for bit the first.

#include "cspn2d_common.cuh"   // kThreads
#include "cspn2d_reverse.cuh"  // reverse_tile, reverse_tiles

namespace {

// One launch of the reverse sweep (cspn2d_reverse.cuh:reverse_tile).
__global__ void __launch_bounds__(kMarchThreads, 1)
    halo_seg_reverse_kernel(const float* __restrict__ gates, const float* __restrict__ x0,
                            const float* __restrict__ states, const float* __restrict__ v_in,
                            float* __restrict__ v_out, float* __restrict__ gbar,
                            float* __restrict__ bbar, int n, int h, int w, int t_hi, int k,
                            int first) {
  reverse_tile(gates, x0, states, v_in, v_out, gbar, bbar, n, h, w, t_hi, k, first);
}

// In place over gbar (in: the folded-gate cotangents Gbar_d, out: d gate_d
// = keep Gbar_d), and d keep = sum_d gate_d Gbar_d.
__global__ void keep_epilogue_kernel(const float* __restrict__ gates,  // [N,8,H,W]
                                     const float* __restrict__ keep,   // [N,H,W]
                                     float* __restrict__ gbar,         // [N,8,H,W]
                                     float* __restrict__ dkeep,        // [N,H,W]
                                     int hw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const float kp = keep[n * hw + idx];
  const long long g0 = n * 8 * hw + idx;
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const float gb = gbar[g0 + d * hw];
    acc = fmaf(gates[g0 + d * hw], gb, acc);
    gbar[g0 + d * hw] = kp * gb;
  }
  dkeep[n * hw + idx] = acc;
}

}  // namespace

// Runs the whole backward on `stream`.  The caller allocates every buffer
// (contiguous f32):
//   gates [n,8,h,w], x/ct [n,h,w], keep [n,h,w] or null, and what the
//   forward kept: folded [n,8,h,w] (G = keep * gate_d; the gates without
//   keep) and states [max(k_steps-1,0),n,h,w] (x_t in states[t-1]) (inputs),
//   dgates [n,8,h,w], dbase/dx [n,h,w], dkeep [n,h,w] or null with keep
//   (outputs), v_scratch [n,h,w].
// Launches: k_steps <= 0: a copy and memsets; else ceil(k_steps / 12)
// reverse tiles and, with keep, 1 epilogue.  Returns the first CUDA error
// of a launch, copy or memset, else 0.
extern "C" int cspn2d_halo_seg_bwd_f32(const float* gates, const float* keep, const float* x,
                                       const float* folded, const float* states,
                                       const float* ct, float* dgates, float* dbase,
                                       float* dkeep, float* dx, float* v_scratch, int n, int h,
                                       int w, int k_steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  const size_t plane = (size_t)n * hw;
  cudaError_t err;
  if (k_steps <= 0) {  // out = x: d x = ct, every other cotangent 0
    if ((err = cudaMemsetAsync(dgates, 0, sizeof(float) * 8 * plane, s)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaMemsetAsync(dbase, 0, sizeof(float) * plane, s)) != cudaSuccess)
      return static_cast<int>(err);
    if (keep != nullptr &&
        (err = cudaMemsetAsync(dkeep, 0, sizeof(float) * plane, s)) != cudaSuccess)
      return static_cast<int>(err);
    return static_cast<int>(
        cudaMemcpyAsync(dx, ct, sizeof(float) * plane, cudaMemcpyDeviceToDevice, s));
  }
  // reverse sweep: Gbar into dgates, d base into dbase, d x_0 into dx
  err = reverse_tiles(halo_seg_reverse_kernel, folded, x, states, ct, v_scratch, dx, dgates,
                      dbase, n, h, w, k_steps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (keep == nullptr) return 0;  // d gate_d = Gbar_d as it stands
  const dim3 grid((hw + kThreads - 1) / kThreads, n);
  keep_epilogue_kernel<<<grid, kThreads, 0, s>>>(gates, keep, dgates, dkeep, hw);
  return static_cast<int>(cudaGetLastError());
}
