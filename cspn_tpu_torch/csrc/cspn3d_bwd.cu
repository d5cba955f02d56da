// 3D CSPN backward (the exact adjoint of csrc/cspn3d_fwd.cu at fixed
// gates) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn3d_pallas.py:_bwd3_kernel,
// launched there by affinity_propagate3d_fused_bwd.  Given the normalized
// gates w [M,26,D,H,W], x_0 and the cotangent v_T of x_T it returns
// (wbar, x0bar), what autograd of `steps` plain steps
// (ops/cspn_ref.py:propagate_nd_reference) returns.  With
// c = 1 - sum_d w_d (all 26 gates, border ones too):
//
//   reverse   v_t[q]   = c[q] v_{t+1}[q] + sum_d w_d[q - off_d] v_{t+1}[q - off_d]
//   gates     wbar_d[p] = sum_t v_{t+1}[p] (x_t[p + off_d] - x_t[p])
//             (= sum_t v_{t+1} x_t[p + off_d] - cbar, cbar = sum_t v_{t+1} x_t,
//              with x_t[p + off_d] = 0 outside the volume)
//   x0bar     = v_0
//
// Every launch is in gather form: a thread writes only its own voxel, so
// there are no atomics and the result is deterministic.
//
// What bounds it on this card.  The fused op must read 26 gate planes, x_0
// and the cotangent and write 26 + 1 planes: 55 f32 planes, 346 MB for the
// stereo model's b4 48x64x128 volume, 0.103 ms at the H100 SXM's
// 3.35 TB/s.  Its arithmetic, ~54 flops per voxel per replay step, 54 per
// reverse step and 54 per step of gate cotangents (~6.1 GFLOP at 24
// steps, 0.091 ms at 67 TFLOP/s of f32), is below that: bytes bound it.
//
// What this design does about it: little, on purpose; it is the simple,
// correct first version.  The TPU kernel checkpoints every <= 4 steps
// because of VMEM; here every state is kept: a replay writes x_1..x_{T-1}
// (23 planes at 24 steps, 145 MB at b4) with the forward's step kernel, a
// `center` launch writes c, and the T reverse launches write every
// v_1..v_{T-1} (145 MB) and v_0 = x0bar.  The gate cotangents are NOT
// accumulated in device memory on every reverse step, which would read and
// write the 26 wbar planes T times (~330 MB a step, about two thirds of the
// backward's bytes): one last launch walks t = 0..T-1 per voxel with 26
// register accumulators, reading v_{t+1}[p] and x_t around p, and writes
// each wbar plane once.  So the traffic is ~23 replay steps of 28 planes,
// 24 reverse steps of 29 planes and ~75 planes for the gate cotangents,
// ~9.5 GB at b4, ~27x the bound.  Not carried over: the TPU kernel's
// lane-unshifted gate layout, its XLA-side centre input and its H/W
// padding.  What it leaves open: fusing K reverse steps per launch, and
// bf16 gates.

#include "cspn3d_common.cuh"  // kThreads3d, kGates3d, off_*, inside3, cspn3d_step_kernel

namespace {

// c[p] = 1 - sum_d w_d[p], summed in the forward step's order.
__global__ void cspn3d_center_kernel(const float* __restrict__ gates,  // [M,26,D,H,W]
                                     float* __restrict__ center,       // [M,D,H,W]
                                     long long vol) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vol) return;
  const long long m = blockIdx.y;
  const float* g = gates + m * kGates3d * vol + idx;
  float gsum = 0.0f;
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) gsum += g[dd * vol];
  center[m * vol + idx] = 1.0f - gsum;
}

// One reverse step v = v_{t+1} -> v_out = v_t.
__global__ void cspn3d_adjoint_step_kernel(const float* __restrict__ gates,   // [M,26,D,H,W]
                                           const float* __restrict__ center,  // [M,D,H,W]
                                           const float* __restrict__ v,       // [M,D,H,W]
                                           float* __restrict__ v_out,         // [M,D,H,W]
                                           int d, int h, int w) {
  const long long vol = (long long)d * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vol) return;
  const long long m = blockIdx.y;
  const int k = (int)(idx % w);
  const long long r = idx / w;
  const int j = (int)(r % h);
  const int i = (int)(r / h);
  const float* vm = v + m * vol;
  const float* gm = gates + m * kGates3d * vol;
  float acc = center[m * vol + idx] * vm[idx];
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) {
    const int z = i - off_z(dd), yy = j - off_y(dd), xx = k - off_x(dd);
    if (inside3(z, yy, xx, d, h, w)) {
      const long long q = ((long long)z * h + yy) * w + xx;
      acc = fmaf(gm[dd * vol + q], vm[q], acc);
    }
  }
  v_out[m * vol + idx] = acc;
}

// wbar_d[p] = sum_t v_{t+1}[p] (x_t[p + off_d] - x_t[p]), 26 accumulators
// per voxel; x_0 = x0, x_t = states[t-1]; v_{t+1} = vs[t] for t < T-1 and
// ct for t = T-1.
__global__ void cspn3d_gate_grad_kernel(const float* __restrict__ x0,      // [M,D,H,W]
                                        const float* __restrict__ states,  // [T-1,M,D,H,W]
                                        const float* __restrict__ vs,      // [T-1,M,D,H,W]
                                        const float* __restrict__ ct,      // [M,D,H,W]
                                        float* __restrict__ wbar,          // [M,26,D,H,W]
                                        int m_count, int d, int h, int w, int steps) {
  const long long vol = (long long)d * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vol) return;
  const long long m = blockIdx.y;
  const long long plane = (long long)m_count * vol;
  const int k = (int)(idx % w);
  const long long r = idx / w;
  const int j = (int)(r % h);
  const int i = (int)(r / h);

  float acc[kGates3d];
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) acc[dd] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const float* xt = (t == 0 ? x0 : states + (t - 1) * plane) + m * vol;
    const float* vt = (t == steps - 1 ? ct : vs + t * plane) + m * vol;
    const float vv = vt[idx];
    const float xc = xt[idx];
#pragma unroll
    for (int dd = 0; dd < kGates3d; ++dd) {
      const int z = i + off_z(dd), yy = j + off_y(dd), xx = k + off_x(dd);
      const float nb = inside3(z, yy, xx, d, h, w) ? xt[((long long)z * h + yy) * w + xx] : 0.0f;
      acc[dd] = fmaf(vv, nb - xc, acc[dd]);
    }
  }
  float* out = wbar + m * kGates3d * vol + idx;
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) out[dd * vol] = acc[dd];
}

}  // namespace

// Runs the whole backward on `stream`.  The caller allocates every buffer
// (contiguous f32):
//   gates [m,26,d,h,w], x0/ct [m,d,h,w] (inputs),
//   wbar [m,26,d,h,w], x0bar [m,d,h,w] (outputs),
//   center [m,d,h,w], states/vs [max(steps-1,0),m,d,h,w] (scratch).
// Launches: steps == 0: a copy and a memset; else steps-1 replay steps, one
// centre launch, steps reverse steps and one gate-cotangent launch.
// Returns the first CUDA error of a launch or copy, else 0.
extern "C" int cspn3d_bwd_f32(const float* gates, const float* x0, const float* ct,
                              float* wbar, float* x0bar, float* center, float* states,
                              float* vs, int m, int d, int h, int w, int steps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vol = (long long)d * h * w;
  const long long plane = (long long)m * vol;
  cudaError_t err;
  if (steps <= 0) {  // out = x0: x0bar = ct, wbar = 0
    err = cudaMemcpyAsync(x0bar, ct, sizeof(float) * plane, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemsetAsync(wbar, 0, sizeof(float) * kGates3d * plane, s));
  }
  const dim3 grid((unsigned)((vol + kThreads3d - 1) / kThreads3d), m);
  // replay: states[t-1] = x_t for t = 1 .. steps-1
  auto state = [&](int t) -> const float* { return t == 0 ? x0 : states + (t - 1) * plane; };
  for (int t = 1; t < steps; ++t) {
    cspn3d_step_kernel<<<grid, kThreads3d, 0, s>>>(gates, state(t - 1), states + (t - 1) * plane,
                                                   d, h, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  cspn3d_center_kernel<<<grid, kThreads3d, 0, s>>>(gates, center, vol);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // reverse sweep: vs[t-1] = v_t for t = steps-1 .. 1, then x0bar = v_0
  const float* v = ct;
  for (int t = steps - 1; t >= 0; --t) {
    float* v_out = t == 0 ? x0bar : vs + (t - 1) * plane;
    cspn3d_adjoint_step_kernel<<<grid, kThreads3d, 0, s>>>(gates, center, v, v_out, d, h, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    v = v_out;
  }
  cspn3d_gate_grad_kernel<<<grid, kThreads3d, 0, s>>>(x0, states, vs, ct, wbar, m, d, h, w, steps);
  return static_cast<int>(cudaGetLastError());
}
