// The 2D CSPN forward's prep (fold_pixel) and step kernels, shared by
// cspn2d_fwd.cu (the forward), cspn2d_tiled.cu (fold_pixel at its tile
// load) and cspn2d_bwd.cu (its replay), and the reverse step of
// cspn2d_halo_seg_bwd.cu.  See cspn2d_fwd.cu for the function they compute.

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

// Offset d of OFFSETS_2D_REFERENCE as compile-time constants, for register
// windows indexed by offset (kDy/kDx are the same table in constant memory).
__host__ __device__ constexpr int ref_dy(int d) { return d < 3 ? 1 : d < 5 ? 0 : -1; }
__host__ __device__ constexpr int ref_dx(int d) {
  return d < 3 ? 1 - d : d == 3 ? 1 : d == 4 ? -1 : 6 - d;
}

// img[i, j] of an h x w plane, 0 outside it.  The load is unconditional
// (from a clamped address) and the zero a select, so that a thread's loads
// are all in flight together instead of one branch and one latency each.
// kReadOnly: through the read-only cache (the plane is not written while
// the kernel runs).
template <bool kReadOnly = true>
__device__ __forceinline__ float load_or_zero(const float* img, int i, int j, int h, int w) {
  const float* at = img + min(max(i, 0), h - 1) * w + min(max(j, 0), w - 1);
  const float v = kReadOnly ? __ldg(at) : *at;
  return inside(i, j, h, w) ? v : 0.0f;
}

// The raw guidance pixel (i, j) gathers, B_d = g_d[(i, j) + off_d] (0
// outside the image), from its map's [8,H,W] guidance, into b.
__device__ __forceinline__ void gather_pixel(const float* __restrict__ g_img, int i, int j, int h,
                                             int w, float (&b)[8]) {
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    b[d] = load_or_zero(g_img + d * h * w, i + ref_dy(d), j + ref_dx(d), h, w);
  }
}

// The canvas normalization, the sparse mask and the centre term of a
// pixel: its gathered raw guidance g (gather_pixel) becomes keep * gate_d,
// and base is returned; x0 is its blur value, s its sparse value (ignored
// without has_sparse).  prep_kernel stores what it computes and the tiled
// forward keeps it in registers: every operation is an explicit
// round-to-nearest intrinsic, so no contraction differs between the two
// and their values are equal.
__device__ __forceinline__ float fold_pixel(float (&g)[8], float x0, float s, bool has_sparse,
                                            int norm_abs) {
  float denom = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    if (norm_abs) g[d] = fabsf(g[d]);
    denom = __fadd_rn(denom, fabsf(g[d]));
  }
  const float div = fmaxf(denom, 1e-30f);
  float gate_sum = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    g[d] = __fdiv_rn(g[d], div);
    gate_sum = __fadd_rn(gate_sum, g[d]);
  }
  const float center_x0 = __fmul_rn(__fsub_rn(1.0f, gate_sum), x0);
  float keep = 1.0f;
  float base = center_x0;
  if (has_sparse) {
    const float mask = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
    keep = __fsub_rn(1.0f, mask);
    base = __fadd_rn(__fmul_rn(keep, center_x0), __fmul_rn(mask, x0));
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) g[d] = __fmul_rn(keep, g[d]);
  return base;
}

// keep * gate_d into `gates`, base into `base` (gather_pixel, fold_pixel),
// once per forward.
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
  const long long p = n * hw + idx;
  float g[8];
  gather_pixel(guid + n * 8 * hw, i, j, h, w, g);
  const float bs = fold_pixel(g, blur[p], sparse != nullptr ? sparse[p] : 0.0f, sparse != nullptr,
                              norm_abs);
  float* g_out = gates + n * 8 * hw + idx;
#pragma unroll
  for (int d = 0; d < 8; ++d) g_out[d * hw] = g[d];
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
