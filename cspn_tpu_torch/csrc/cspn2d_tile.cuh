// The K-step tile stencil shared by cspn2d_halo_seg.cu (the pytorch-semantics
// 2D CSPN's K-step segment on a halo-extended row block, PERF row 4) and
// paddle2d.cu (the paddle-semantics 2D CSPN, PERF row 6).  See those files
// for the function each computes.  (The tiled forward, PERF row 3, marches its
// columns in registers instead: cspn2d_march.cuh.)
//
// One block owns a kTile x kTile interior of one map and computes it on the
// interior extended by a kHalo-deep ring on all four sides (kExt x kExt).
// Each thread holds its pixels' 8 gates and one more weight (base, or the
// centre weight) in registers for the k <= kHalo steps of a launch; the
// state ping-pongs between two kPad x kPad shared buffers (the extended
// tile plus a ring of zeros) with one __syncthreads() per step.
//
// Why the interior is exact.  A cell of the extended tile that lies
// outside the image has gates and weight 0, so it stays exactly 0 at every
// step: that is the reference's zero padding at the image border.  A cell
// inside the image but on the extended tile's edge reads the zero ring in
// place of its true neighbours, so it goes stale; the error moves inward
// one ring per step, and after k <= kHalo steps the interior (kHalo rings
// in) is still exact.  Only the interior's in-image cells are written.
// Ragged last tiles need no padding of the inputs: their out-of-image
// cells are the held zeros above and are never written.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                   // interior side
constexpr int kHalo = 8;                    // K: steps per launch, halo depth
constexpr int kExt = kTile + 2 * kHalo;     // 48: extended side
constexpr int kPad = kExt + 2;              // 50: with the ring of zeros
constexpr int kTileRows = 8;                // blockDim = (kExt, kTileRows)
constexpr int kPxPerThread = kExt / kTileRows;  // rows ty, ty + 8, ...
static_assert(kExt % kTileRows == 0, "thread rows must divide the extended tile");

// Offsets of raster order (neighbor_offsets(2, 3)):
// (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1).  The reference
// order (OFFSETS_2D_REFERENCE) is its exact reverse: reference d = raster 7-d.
__host__ __device__ constexpr int raster_dy(int d) { return (d < 4 ? d : d + 1) / 3 - 1; }
__host__ __device__ constexpr int raster_dx(int d) { return (d < 4 ? d : d + 1) % 3 - 1; }

// Runs k <= kHalo steps on the tile (blockIdx.x, blockIdx.y) of map
// blockIdx.z, reading x_in and writing the interior of x_out.
//   kPaddle = false (pytorch semantics, reference gate order):
//     y = sum_d g_d x[p + off_d] + base            (g = keep * gate_d)
//   kPaddle = true (paddle semantics, raster gate order):
//     y = c x[p] + sum_d w_d x[p + off_d],  c = 1 - sum_d w_d
// gates [M,8,H,W], base [M,H,W] (null for paddle), x_in/x_out [M,H,W].
// keep [M,H,W] is folded into each pixel's gates as they are loaded (the
// halo segment's anchoring); null means 1, the gates as they are (paddle
// has none).
template <bool kPaddle>
__device__ __forceinline__ void tile_steps(const float* __restrict__ gates,
                                           const float* __restrict__ base,
                                           const float* __restrict__ keep,
                                           const float* __restrict__ x_in,
                                           float* __restrict__ x_out, int h, int w,
                                           int k) {
  __shared__ float buf[2][kPad * kPad];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kExt + tx;
  const long long hw = (long long)h * w;
  const long long map = blockIdx.z;
  const int r0 = blockIdx.y * kTile - kHalo;  // image row of extended row 0
  const int c0 = blockIdx.x * kTile - kHalo;  // image column of extended column 0
  const int j = c0 + tx;
  const float* g_map = gates + map * 8 * hw;

  for (int i = tid; i < 2 * kPad * kPad; i += kExt * kTileRows) (&buf[0][0])[i] = 0.0f;
  __syncthreads();

  float g[kPxPerThread][8];
  float e[kPxPerThread];  // base (pytorch) or the centre weight (paddle)
#pragma unroll
  for (int p = 0; p < kPxPerThread; ++p) {
    const int er = ty + p * kTileRows;
    const int i = r0 + er;
    float x = 0.0f;
    e[p] = 0.0f;
#pragma unroll
    for (int d = 0; d < 8; ++d) g[p][d] = 0.0f;
    if (i >= 0 && i < h && j >= 0 && j < w) {
      const long long q = (long long)i * w + j;
      const float kp = keep != nullptr ? keep[map * hw + q] : 1.0f;
      float sum = 0.0f;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        g[p][d] = kp * g_map[d * hw + q];
        sum += g[p][d];
      }
      e[p] = kPaddle ? 1.0f - sum : base[map * hw + q];
      x = x_in[map * hw + q];
    }
    buf[0][(er + 1) * kPad + tx + 1] = x;
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < k; ++s) {
    const float* xc = buf[cur];
    float* xn = buf[cur ^ 1];
#pragma unroll
    for (int p = 0; p < kPxPerThread; ++p) {
      const int at = (ty + p * kTileRows + 1) * kPad + tx + 1;
      float acc = kPaddle ? e[p] * xc[at] : e[p];
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int rd = kPaddle ? d : 7 - d;  // raster index of gate d
        acc = fmaf(g[p][d], xc[at + raster_dy(rd) * kPad + raster_dx(rd)], acc);
      }
      xn[at] = acc;
    }
    __syncthreads();
    cur ^= 1;
  }

  if (tx < kHalo || tx >= kHalo + kTile || j >= w) return;
#pragma unroll
  for (int p = 0; p < kPxPerThread; ++p) {
    const int er = ty + p * kTileRows;
    const int i = r0 + er;
    if (er >= kHalo && er < kHalo + kTile && i < h)
      x_out[map * hw + (long long)i * w + j] = buf[cur][(er + 1) * kPad + tx + 1];
  }
}

// Runs `steps` steps as ceil(steps / kHalo) tile launches of `kernel`,
// ping-ponging so that the last launch writes `out`.  kernel(gates, base,
// keep, x_in, x_out, h, w, k).  Returns the first launch error, else 0.
template <typename Kernel>
int launch_tiles(Kernel kernel, const float* gates, const float* base, const float* keep,
                 const float* x0, float* out, float* x_scratch, int m, int h, int w, int steps,
                 cudaStream_t s) {
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, m);
  const dim3 block(kExt, kTileRows);
  const int launches = (steps + kHalo - 1) / kHalo;
  const float* src = x0;
  for (int l = 0; l < launches; ++l) {
    const int k = (l + 1) * kHalo <= steps ? kHalo : steps - l * kHalo;
    float* dst = ((launches - 1 - l) % 2 == 0) ? out : x_scratch;
    kernel<<<grid, block, 0, s>>>(gates, base, keep, src, dst, h, w, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace
