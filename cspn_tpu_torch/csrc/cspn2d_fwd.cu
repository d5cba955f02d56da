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
// is memory-bound.
//
// What this design does about it: little, on purpose.  It is the simple,
// correct first version.  One `prep` launch folds the normalization, the
// sparse mask and the center term into keep*gate_d ([N,8,H,W]) and base
// ([N,H,W]) in scratch the caller allocates; then `steps` launches of `step`
// ping-pong two [N,H,W] buffers, one thread per pixel with neighbouring
// columns on neighbouring addresses.  Each step moves ~11 planes (8 gates,
// base, x, y), so at 24 steps the traffic is ~24x the fused bound.  At b8 the
// gate working set (~18 MB) stays in the 50 MB L2, so most of it is L2
// traffic; at b128 it is not.
//
// What it leaves open for the performance work.  One f32 plane of a 228x304
// frame is 277 KB, more than one SM's 227 KB of shared memory, so the TPU's
// "whole image resident for all steps" has no direct analogue.  Two roads
// stay open and both reuse `prep` unchanged: (1) a step kernel that runs K
// steps per launch on a shared-memory row tile with a K-row (and K-column)
// halo, recomputing the halo, as cspn_pallas.py:_fwd_dma_kernel does with
// its row tiles; (2) one persistent cooperative kernel that keeps its tile's
// gates in registers/shared memory and syncs the grid once per step.

#include <cuda_runtime.h>

namespace {

// (dy, dx) gather offsets in reference gate order (ops/neighbors.py).
__constant__ int kDy[8] = {1, 1, 1, 0, 0, -1, -1, -1};
__constant__ int kDx[8] = {1, 0, -1, 1, -1, 1, 0, -1};

constexpr int kThreads = 256;

__global__ void prep_kernel(const float* __restrict__ guid,    // [N,8,H,W]
                            const float* __restrict__ blur,    // [N,H,W]
                            const float* __restrict__ sparse,  // [N,H,W] or null
                            float* __restrict__ gates,         // [N,8,H,W] keep*gate_d
                            float* __restrict__ base,          // [N,H,W]
                            int h, int w, int norm_abs) {
  const int hw = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const int i = idx / w;
  const int j = idx - i * w;
  const float* g_img = guid + n * 8 * hw;

  float b[8];
  float denom = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int qi = i + kDy[d];
    const int qj = j + kDx[d];
    float v = 0.0f;
    if (qi >= 0 && qi < h && qj >= 0 && qj < w) {
      v = g_img[d * hw + qi * w + qj];
      if (norm_abs) v = fabsf(v);
    }
    b[d] = v;
    denom += fabsf(v);
  }
  const float div = fmaxf(denom, 1e-30f);
  float gate_sum = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    b[d] = b[d] / div;
    gate_sum += b[d];
  }
  const long long p = n * hw + idx;
  const float x0 = blur[p];
  const float center_x0 = (1.0f - gate_sum) * x0;
  float keep = 1.0f;
  float bs = center_x0;
  if (sparse != nullptr) {
    const float s = sparse[p];
    const float mask = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
    keep = 1.0f - mask;
    bs = keep * center_x0 + mask * x0;
  }
  float* g_out = gates + n * 8 * hw + idx;
#pragma unroll
  for (int d = 0; d < 8; ++d) g_out[d * hw] = keep * b[d];
  base[p] = bs;
}

__global__ void step_kernel(const float* __restrict__ gates,  // [N,8,H,W]
                            const float* __restrict__ base,   // [N,H,W]
                            const float* __restrict__ x,      // [N,H,W]
                            float* __restrict__ y,            // [N,H,W]
                            int h, int w) {
  const int hw = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const int i = idx / w;
  const int j = idx - i * w;
  const float* x_img = x + n * hw;
  const float* g_px = gates + n * 8 * hw + idx;
  float acc = base[n * hw + idx];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int qi = i + kDy[d];
    const int qj = j + kDx[d];
    if (qi >= 0 && qi < h && qj >= 0 && qj < w) {
      acc = fmaf(g_px[d * hw], x_img[qi * w + qj], acc);
    }
  }
  y[n * hw + idx] = acc;
}

}  // namespace

// Runs the whole forward on `stream`: one prep launch and `steps` step
// launches.  The caller allocates every buffer (contiguous f32):
//   guid [n,8,h,w], blur/out/x_scratch/base_scratch [n,h,w],
//   gate_scratch [n,8,h,w]; sparse may be null.
// Returns cudaGetLastError() after the first launch that fails, else 0.
extern "C" int cspn2d_fwd_f32(const float* guid, const float* blur,
                              const float* sparse, float* out,
                              float* gate_scratch, float* base_scratch,
                              float* x_scratch, int n, int h, int w, int steps,
                              int norm_abs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(
        out, blur, sizeof(float) * (size_t)n * h * w, cudaMemcpyDeviceToDevice,
        s));
  }
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  prep_kernel<<<grid, kThreads, 0, s>>>(guid, blur, sparse, gate_scratch,
                                        base_scratch, h, w, norm_abs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // ping-pong so that the last step writes `out`
  const float* src = blur;
  for (int t = 0; t < steps; ++t) {
    float* dst = ((steps - 1 - t) % 2 == 0) ? out : x_scratch;
    step_kernel<<<grid, kThreads, 0, s>>>(gate_scratch, base_scratch, src, dst,
                                          h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
