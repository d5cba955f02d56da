// 3D CSPN forward (paddle affinity_propagate semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn3d_pallas.py:_seg_kernel,
// launched there by _run_segment for affinity_propagate3d_fused.  It
// computes `steps` iterations of
// cspn_tpu_torch/ops/cspn_ref.py:affinity_propagate_reference on fixed
// gates, the function JAX runs with gate_dtype=float32: for each volume m
// and voxel p, with the 26 offsets off_d of neighbor_offsets(3, 3),
//
//   x_{t+1}[p] = (1 - sum_d w_d[p]) x_t[p] + sum_d w_d[p] x_t[p + off_d]
//
// out-of-volume neighbours contributing 0 while their gates still count in
// the centre weight (cspn3d_pallas.py:295-297, :521).  The gates arrive
// normalized (abs and per-voxel sum-normalization stay in PyTorch, as JAX
// leaves them to XLA); all arithmetic is f32.
//
// What bounds it on this card.  The fused op must read 26 gate planes and
// x_0 and write one plane: 28 f32 planes, 176 MB for the stereo model's
// b4 48x64x128 volume, 0.053 ms at the H100 SXM's 3.35 TB/s.  Its
// arithmetic is ~54 flops per voxel per step (27 FMA), 2.0 GFLOP at 24
// steps, 0.030 ms at 67 TFLOP/s of f32: bytes bound it.
//
// What this design does about it: little, on purpose; it is the simple,
// correct first version.  One launch per step, one thread per voxel with
// neighbouring W on neighbouring addresses, ping-ponging two [M,D,H,W]
// buffers; the centre weight is summed in registers from the 26 gates the
// step reads anyway, so there is no prep launch.  Each step rereads the 26
// gate planes (164 MB at b4, more than the 50 MB L2), so the traffic is
// ~24x the fused bound, ~4.2 GB, about 1.3 ms at best.  Not carried over
// from the TPU kernel: the lane-unshifted gates, the XLA-side centre sum,
// the H/W padding to 8/128 and the K-step H-tile segments; one design
// covers every size.  What it leaves open: bf16 gate storage (the TPU
// kernel's default, half the gate bytes) and K steps per launch on tiles
// with a K-deep halo, which divide the gate traffic by K.

#include "cspn3d_common.cuh"  // kThreads3d, cspn3d_step_kernel

// Runs the whole forward on `stream`: `steps` step launches.  The caller
// allocates every buffer (contiguous f32): gates [m,26,d,h,w],
// x0/out/x_scratch [m,d,h,w].  Returns cudaGetLastError() after the first
// launch that fails, else 0.
extern "C" int cspn3d_fwd_f32(const float* gates, const float* x0, float* out,
                              float* x_scratch, int m, int d, int h, int w,
                              int steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vol = (long long)d * h * w;
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, x0, sizeof(float) * (size_t)m * vol,
                                            cudaMemcpyDeviceToDevice, s));
  }
  const dim3 grid((unsigned)((vol + kThreads3d - 1) / kThreads3d), m);
  // ping-pong so that the last step writes `out`
  const float* src = x0;
  for (int t = 0; t < steps; ++t) {
    float* dst = ((steps - 1 - t) % 2 == 0) ? out : x_scratch;
    cspn3d_step_kernel<<<grid, kThreads3d, 0, s>>>(gates, src, dst, d, h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
