// The column march of the 2D CSPN's tile kernels: cspn2d_tiled.cu (the
// tiled forward, PERF row 3) runs it forward, cspn2d_bwd.cu (the reverse
// tiles of the backward, PERF row 2) as its adjoint.  See those files for
// the function each computes.
//
// One block of kMarchThreads threads owns one kExt x kExt extended tile of
// one map: an interior of kTile = kExt - 2K rows and columns, extended by a
// K-deep halo on all four sides, K = kHalo the steps a launch runs.  Warp
// `warp` owns the kRows rows [kRows warp, kRows warp + kRows) of the
// extended tile and lane `lane` the two columns 2 lane and 2 lane + 1, so
// one warp spans the whole width.  A thread keeps its 2 kRows pixels' state, 8 gates and (forward)
// base in registers for the whole launch.  A step reads the 3x3 window of
// the state around each pixel from registers: the rows above and below a
// warp's band come from the neighbouring warps through shared memory (two
// rows a warp, one __syncthreads() a step), the columns left and right of
// a lane's pair from its neighbouring lanes by warp shuffles.  Nothing
// else of the state touches shared memory.
//
// Why the interior is exact.  A cell of the extended tile that lies outside
// the image has gates and base 0, so it stays exactly 0 at every step: that
// is the reference's zero padding at the image border.  A cell inside the
// image but on the extended tile's edge reads zeros in place of its true
// neighbours (lanes 0 and 31 and warps 0 and kWarps - 1 see a ring of
// zeros), so it goes stale; the error moves inward one ring per step, and
// after k <= K steps the interior (K rings in) is still exact.

#pragma once

#include <cuda_runtime.h>

#include "cspn2d_common.cuh"  // ref_dy, ref_dx

namespace {

constexpr int kExt = 64;                    // extended tile side: 32 lanes x 2 columns
// K: steps a launch and halo depth.  PERF.md has the by-K timing that chose
// 12 over 8: the backward 8-29% faster, the forward within 8% either way.
constexpr int kHalo = 12;
constexpr int kTile = kExt - 2 * kHalo;     // 40: interior side (ops/cspn_cuda.py:TILE)
constexpr int kRows = 4;                    // rows a thread owns
constexpr int kWarps = kExt / kRows;        // 16
constexpr int kMarchThreads = 32 * kWarps;  // 512: one block an SM, <= 128 registers a thread

// The rows a warp shows its neighbours, double-buffered by step parity: a
// warp writes one buffer while a slower one may still read the other.
struct Exchange {
  float2 top[2][kWarps][32];  // each warp's first row, lane-major
  float2 bot[2][kWarps][32];  // each warp's last row
};

// One step on the registers of one thread.  Forward (kAdjoint false):
//   x'[p] = sum_d g_d[p] x[p + off_d] + e[p]
// adjoint (g_d[q] holding the transposed gate G_d[q - off_d], e unused):
//   x'[q] = sum_d g_d[q] x[q - off_d]
// the FMA chain in reference gate order d = 0..7, starting from e (forward)
// or 0 (adjoint), as the per-step kernels' (cspn2d_common.cuh) chains: a
// neighbour outside the image adds g * 0 where they skip it.
template <bool kAdjoint>
__device__ __forceinline__ void march_step(const float (&g)[kRows][2][8], const float (&e)[kRows][2],
                                           float (&x)[kRows][2], Exchange& ex, int buf, int warp,
                                           int lane) {
  ex.top[buf][warp][lane] = make_float2(x[0][0], x[0][1]);
  ex.bot[buf][warp][lane] = make_float2(x[kRows - 1][0], x[kRows - 1][1]);
  __syncthreads();
  const float2 above = warp > 0 ? ex.bot[buf][warp - 1][lane] : make_float2(0.0f, 0.0f);
  const float2 below = warp < kWarps - 1 ? ex.top[buf][warp + 1][lane] : make_float2(0.0f, 0.0f);
  // win[r][c]: row r - 1 of the band, column c - 1 of the lane's pair
  float win[kRows + 2][4];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r) {
    const float a = r == 0 ? above.x : r == kRows + 1 ? below.x : x[r - 1][0];
    const float b = r == 0 ? above.y : r == kRows + 1 ? below.y : x[r - 1][1];
    const float left = __shfl_up_sync(0xffffffffu, b, 1);
    const float right = __shfl_down_sync(0xffffffffu, a, 1);
    win[r][0] = lane == 0 ? 0.0f : left;
    win[r][1] = a;
    win[r][2] = b;
    win[r][3] = lane == 31 ? 0.0f : right;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float acc = kAdjoint ? 0.0f : e[r][c];
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int sy = kAdjoint ? -ref_dy(d) : ref_dy(d);
        const int sx = kAdjoint ? -ref_dx(d) : ref_dx(d);
        acc = fmaf(g[r][c][d], win[r + 1 + sy][c + 1 + sx], acc);
      }
      x[r][c] = acc;
    }
  }
}

// Whether extended row er and column ec lie in a tile's interior.
__device__ __forceinline__ bool in_interior(int er, int ec) {
  return er >= kHalo && er < kExt - kHalo && ec >= kHalo && ec < kExt - kHalo;
}

// The launches of `steps` steps, K at most each: the plan's launch_steps
// (ops/cspn_cuda.py:plan_tiles).  The forward runs them in order, the
// ragged one last; the backward's reverse tiles run them in reverse, the
// ragged one first, so that its last launch ends at t = 0.
__host__ __device__ constexpr int tile_launches(int steps) {
  return (steps + kHalo - 1) / kHalo;
}

}  // namespace
