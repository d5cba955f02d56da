// The 2D CSPN's gather offsets, bounds, raw-input loads (io_value) and
// fold (fold_pixel), shared by the tile kernels (cspn2d_march.cuh,
// cspn2d_reverse.cuh) and the pointwise kernels of cspn2d_bwd.cu and
// cspn2d_halo_seg_bwd.cu.  See cspn2d_fwd.cu for the function they compute.

#pragma once

#include <cuda_bf16.h>
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

// How a first launch reads one raw input, guidance, blur or sparse
// (MarchArgs::io_g, io_b, io_s; ops/cspn_cuda.py:io_codes): float32 as it
// is, float32 rounded to bf16 (the bf16 I/O dtype, JAX's io_dtype), or
// bf16.
enum IoCode : int { kIoF32 = 0, kIoF32Round = 1, kIoBf16 = 2 };

// A raw input's value as the arithmetic reads it, in float32: a bf16 value
// upcast (exact), as cspn_pallas.py:_fwd_kernel upcasts at first use; a
// float32 one as it is or, with kRound, rounded to the nearest bf16 (ties
// to even: Tensor.to(torch.bfloat16), astype(jnp.bfloat16)), then upcast.
template <bool kRound>
__device__ __forceinline__ float io_value(float v) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <bool kRound>
__device__ __forceinline__ float io_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// img[i, j] of an h x w plane of T (float or __nv_bfloat16), as io_value
// reads it, 0 outside the plane.  The load is unconditional (from a
// clamped address) and the zero a select, so that a thread's loads are all
// in flight together instead of one branch and one latency each.
// kReadOnly: through the read-only cache (the plane is not written while
// the kernel runs).
template <bool kReadOnly = true, bool kRound = false, typename T = float>
__device__ __forceinline__ float load_or_zero(const T* img, int i, int j, int h, int w) {
  const T* at = img + min(max(i, 0), h - 1) * w + min(max(j, 0), w - 1);
  const float v = io_value<kRound>(kReadOnly ? __ldg(at) : *at);
  return inside(i, j, h, w) ? v : 0.0f;
}

// The raw guidance pixel (i, j) gathers, B_d = g_d[(i, j) + off_d] (0
// outside the image), from its map's [8,H,W] guidance of T, into b.
template <bool kRound = false, typename T = float>
__device__ __forceinline__ void gather_pixel(const T* __restrict__ g_img, int i, int j, int h,
                                             int w, float (&b)[8]) {
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    b[d] = load_or_zero<true, kRound>(g_img + d * h * w, i + ref_dy(d), j + ref_dx(d), h, w);
  }
}

// The canvas normalization, the sparse mask and the centre term of a
// pixel: its gathered raw guidance g (gather_pixel) becomes keep * gate_d,
// and base is returned; x0 is its blur value, s its sparse value (ignored
// without has_sparse).  Every operation is an explicit round-to-nearest
// intrinsic, so no contraction differs between the kernels that fold (the
// forwards' first launches, the backward's replay) and their values are
// equal.
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

}  // namespace
