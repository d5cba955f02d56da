// The 2D CSPN forward's prep and step kernels, shared by cspn2d_fwd.cu
// (the forward) and cspn2d_bwd.cu (its replay), and the backward's reverse
// step, shared by cspn2d_bwd.cu and cspn2d_halo_seg_bwd.cu.  See
// cspn2d_fwd.cu for the function they compute.

#pragma once

#include <cuda_runtime.h>

namespace {

// (dy, dx) gather offsets in reference gate order (ops/neighbors.py).
__constant__ int kDy[8] = {1, 1, 1, 0, 0, -1, -1, -1};
__constant__ int kDx[8] = {1, 0, -1, 1, -1, 1, 0, -1};

constexpr int kThreads = 256;

__device__ __forceinline__ bool inside(int i, int j, int h, int w) {
  return i >= 0 && i < h && j >= 0 && j < w;
}

// keep * gate_d into `gates`, base into `base`: the canvas normalization,
// the sparse mask and the center term, folded once per forward.
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
    if (inside(qi, qj, h, w)) {
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

// One step x -> y = sum_d gates_d * x[p + off_d] + base.
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
    if (inside(qi, qj, h, w)) acc = fmaf(g_px[d * hw], x_img[qi * w + qj], acc);
  }
  y[n * hw + idx] = acc;
}

// One reverse step: v = d x_{t+1} -> v_out = d x_t, accumulating the base
// and gate cotangents of pixel p from x = x_t.
__global__ void reverse_step_kernel(const float* __restrict__ gates,  // [N,8,H,W]
                                    const float* __restrict__ x,      // x_t [N,H,W]
                                    const float* __restrict__ v,      // [N,H,W]
                                    float* __restrict__ v_out,        // [N,H,W]
                                    float* __restrict__ gbar,         // [N,8,H,W]
                                    float* __restrict__ bbar,         // [N,H,W]
                                    int h, int w) {
  const int hw = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const int i = idx / w;
  const int j = idx - i * w;
  const float* x_img = x + n * hw;
  const float* v_img = v + n * hw;
  const float* g_img = gates + n * 8 * hw;
  float* gb_px = gbar + n * 8 * hw + idx;
  const float vp = v_img[idx];
  bbar[n * hw + idx] += vp;
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int qi = i + kDy[d];
    const int qj = j + kDx[d];
    if (inside(qi, qj, h, w)) gb_px[d * hw] = fmaf(vp, x_img[qi * w + qj], gb_px[d * hw]);
    const int ri = i - kDy[d];
    const int rj = j - kDx[d];
    if (inside(ri, rj, h, w)) {
      const int r = ri * w + rj;
      acc = fmaf(g_img[d * hw + r], v_img[r], acc);
    }
  }
  v_out[n * hw + idx] = acc;
}

}  // namespace
