// The 3D CSPN forward's step kernel and the neighbourhood it gathers from,
// shared by cspn3d_fwd.cu (the forward) and cspn3d_bwd.cu (its replay).
// See cspn3d_fwd.cu for the function they compute.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads3d = 256;
constexpr int kGates3d = 26;

// Offset d of neighbor_offsets(3, 3) (ops/neighbors.py): the 27 points of
// the centred 3-cube in raster order (dz slowest), the centre (13) skipped.
// With #pragma unroll over d these fold to constants.
__device__ __forceinline__ int off_index(int d) { return d < 13 ? d : d + 1; }
__device__ __forceinline__ int off_z(int d) { return off_index(d) / 9 - 1; }
__device__ __forceinline__ int off_y(int d) { return (off_index(d) / 3) % 3 - 1; }
__device__ __forceinline__ int off_x(int d) { return off_index(d) % 3 - 1; }

__device__ __forceinline__ bool inside3(int z, int y, int x, int d, int h, int w) {
  return z >= 0 && z < d && y >= 0 && y < h && x >= 0 && x < w;
}

// One step x -> y[p] = (1 - sum_d w_d[p]) x[p] + sum_d w_d[p] x[p + off_d],
// one thread per voxel (W fastest), blockIdx.y = volume m.  The centre
// weight sums all 26 gates, those of out-of-volume neighbours too.
__global__ void cspn3d_step_kernel(const float* __restrict__ gates,  // [M,26,D,H,W]
                                   const float* __restrict__ x,      // [M,D,H,W]
                                   float* __restrict__ y,            // [M,D,H,W]
                                   int d, int h, int w) {
  const long long vol = (long long)d * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vol) return;
  const long long m = blockIdx.y;
  const int k = (int)(idx % w);
  const long long r = idx / w;
  const int j = (int)(r % h);
  const int i = (int)(r / h);
  const float* xm = x + m * vol;
  const float* g = gates + m * kGates3d * vol + idx;

  float wv[kGates3d];
  float gsum = 0.0f;
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) {
    wv[dd] = g[dd * vol];
    gsum += wv[dd];
  }
  float acc = (1.0f - gsum) * xm[idx];
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) {
    const int z = i + off_z(dd), yy = j + off_y(dd), xx = k + off_x(dd);
    if (inside3(z, yy, xx, d, h, w)) acc = fmaf(wv[dd], xm[((long long)z * h + yy) * w + xx], acc);
  }
  y[m * vol + idx] = acc;
}

}  // namespace
