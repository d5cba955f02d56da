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
// x and the cotangent and write 8 + 3 planes: 23 f32 planes, 85.9 MB for a
// KITTI b4 shard at S = 2 and K = 8 ([4, 8, 192, 1216]), 0.0256 ms at the
// H100 SXM's 3.35 TB/s.  ~17 flops per pixel per replay step and ~33 per
// reverse step: 0.0051 ms at 67 TFLOP/s of f32 for K = 8.  Bytes bound it.
//
// What this design does about it: little, on purpose; it is the simple,
// correct first version, built from what the 2D CSPN backward
// (cspn2d_bwd.cu) already has.  One launch folds keep into the gates; the
// forward's step kernel replays the K - 1 inner states into scratch
// (cspn2d_common.cuh:step_kernel; K <= 24 planes, no checkpoints, as the
// TPU kernel keeps every pre-step state); K launches of the reverse step
// (cspn2d_common.cuh:reverse_step_kernel) accumulate the gate and base
// cotangents straight into the outputs; one epilogue launch turns the
// folded-gate cotangents into d gate and d keep in place.  Each reverse
// launch moves ~30 planes, so the traffic is ~15x the bound at K = 8.  A
// fused multi-step backward on tiles is the road left open.

#include "cspn2d_common.cuh"  // kThreads, step_kernel, reverse_step_kernel

namespace {

// folded_d = keep * gate_d, per pixel.
__global__ void fold_keep_kernel(const float* __restrict__ gates,  // [N,8,H,W]
                                 const float* __restrict__ keep,   // [N,H,W]
                                 float* __restrict__ folded,       // [N,8,H,W]
                                 int hw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const float kp = keep[n * hw + idx];
  const long long g0 = n * 8 * hw + idx;
#pragma unroll
  for (int d = 0; d < 8; ++d) folded[g0 + d * hw] = kp * gates[g0 + d * hw];
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
//   gates [n,8,h,w], base/x/ct [n,h,w], keep [n,h,w] or null (inputs),
//   dgates [n,8,h,w], dbase/dx [n,h,w], dkeep [n,h,w] or null with keep
//   (outputs),
//   folded_scratch [n,8,h,w] (unused without keep), v_scratch [n,h,w],
//   state_scratch [max(k_steps-1,0),n,h,w].
// Launches: k_steps == 0: a copy and memsets; else (with keep) 1 fold,
// k_steps-1 replay steps, k_steps reverse steps and (with keep) 1 epilogue.
// Returns the first CUDA error of a launch, copy or memset, else 0.
extern "C" int cspn2d_halo_seg_bwd_f32(const float* gates, const float* base,
                                       const float* keep, const float* x, const float* ct,
                                       float* dgates, float* dbase, float* dkeep, float* dx,
                                       float* folded_scratch, float* v_scratch,
                                       float* state_scratch, int n, int h, int w, int k_steps,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  const size_t plane = (size_t)n * hw;
  cudaError_t err;
  if ((err = cudaMemsetAsync(dgates, 0, sizeof(float) * 8 * plane, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaMemsetAsync(dbase, 0, sizeof(float) * plane, s)) != cudaSuccess)
    return static_cast<int>(err);
  if (k_steps <= 0) {  // out = x: d x = ct, every other cotangent 0
    if (keep != nullptr &&
        (err = cudaMemsetAsync(dkeep, 0, sizeof(float) * plane, s)) != cudaSuccess)
      return static_cast<int>(err);
    return static_cast<int>(
        cudaMemcpyAsync(dx, ct, sizeof(float) * plane, cudaMemcpyDeviceToDevice, s));
  }
  const dim3 grid((hw + kThreads - 1) / kThreads, n);
  const float* g = gates;
  if (keep != nullptr) {
    fold_keep_kernel<<<grid, kThreads, 0, s>>>(gates, keep, folded_scratch, hw);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    g = folded_scratch;
  }
  auto state = [&](int t) -> const float* {
    return t == 0 ? x : state_scratch + (size_t)(t - 1) * plane;
  };
  // replay: state_scratch[t-1] = x_t for t = 1 .. k_steps-1 (x_0 is x)
  for (int t = 1; t < k_steps; ++t) {
    step_kernel<<<grid, kThreads, 0, s>>>(g, base, state(t - 1),
                                          state_scratch + (size_t)(t - 1) * plane, h, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // reverse sweep into dgates (Gbar) and dbase; v ping-pongs between
  // v_scratch and dx so that the last step (t = 0) writes dx
  const float* v = ct;
  for (int t = k_steps - 1; t >= 0; --t) {
    float* v_next = (t % 2 == 0) ? dx : v_scratch;
    reverse_step_kernel<<<grid, kThreads, 0, s>>>(g, state(t), v, v_next, dgates, dbase, h, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    v = v_next;
  }
  if (keep == nullptr) return 0;  // d gate_d = Gbar_d as it stands
  keep_epilogue_kernel<<<grid, kThreads, 0, s>>>(gates, keep, dgates, dkeep, hw);
  return static_cast<int>(cudaGetLastError());
}
