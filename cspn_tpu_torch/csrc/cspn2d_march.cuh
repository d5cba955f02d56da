// The column march of the 2D CSPN's tile kernels.  Forward (march_tile):
// cspn2d_tiled.cu (the tiled forward, PERF row 3), cspn2d_fwd.cu (the
// forward that keeps its states, PERF row 1) and the replays of
// cspn2d_bwd.cu and cspn2d_halo_seg_bwd.cu (PERF rows 2 and 5); as its
// adjoint: the reverse tiles of those two backwards (cspn2d_reverse.cuh).
// See those files for the function each computes.
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

#include <cstdint>

#include "cspn2d_common.cuh"  // ref_dy, ref_dx, gather_pixel, fold_pixel, load_or_zero, inside

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
// or 0 (adjoint); a neighbour outside the image adds g * 0.
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

// What a launch of march_tile loads, each pixel's gates and base from:
//   kRaw: the raw guidance, blur and sparse, folded (gather_pixel, fold_pixel);
//   kFolded: gather-form gates and base, as they are (the folded copy a
//     first launch stored, or the halo segment's gates without keep);
//   kKeep: the halo segment's gather-form gates, base and keep, with
//     keep * gate_d (keep is 0, 1 or 2, so the product is exact).
enum class Load { kRaw, kFolded, kKeep };

// What one launch of march_tile reads and writes.
struct MarchArgs {
  // kRaw: the raw guidance [N,8,H,W], blur [N,H,W] and sparse [N,H,W] or
  // null.  kFolded, kKeep: gather-form gates [N,8,H,W], base [N,H,W] and
  // (kKeep) keep [N,H,W].
  const float* gates;
  const float* base;
  const float* mask;
  float* gates_out;   // null, or the interior's folded gates [N,8,H,W] (kRaw, kKeep)
  float* base_out;    // null, or the interior's base [N,H,W] (kRaw)
  const float* x_in;  // the state x_{t0} [N,H,W]
  float* x_out;       // x_{t0 + k} (!kStates), or x_total (kStates)
  float* states;      // kStates: [total - 1,N,H,W], x_t in states[t - 1]
  long long plane;    // N*H*W, the stride of states
  int h, w, k, t0, total, norm_abs;
};

// Stores a thread's kRows x 2 pixels (image rows i0.., columns j0, j0 + 1)
// into an [H,W] plane, the part inside the image; a float2 a row where the
// pair lies inside and `vec` (w even, the planes 8-byte aligned), so that
// a warp's row of pairs is one coalesced store.
__device__ __forceinline__ void store_pairs(float* img, const float (&x)[kRows][2], int i0, int j0,
                                            int h, int w, bool vec) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= h) break;
    float* row = img + (long long)i * w;
    if (vec && j0 + 1 < w) {
      *reinterpret_cast<float2*>(row + j0) = make_float2(x[r][0], x[r][1]);
    } else {
      if (j0 < w) row[j0] = x[r][0];
      if (j0 + 1 < w) row[j0 + 1] = x[r][1];
    }
  }
}

// Pixel p's folded gates into a.gates_out and base into a.base_out, where
// those are given.
__device__ __forceinline__ void store_folded(const MarchArgs& a, long long map, int hw, int p,
                                             const float (&g)[8], float e) {
  if (a.gates_out != nullptr) {
#pragma unroll
    for (int d = 0; d < 8; ++d) a.gates_out[map * 8 * hw + d * hw + p] = g[d];
  }
  if (a.base_out != nullptr) a.base_out[map * hw + p] = e;
}

// Runs a.k <= kHalo forward steps on the tile (blockIdx.x, blockIdx.y) of
// map blockIdx.z from x_{t0}, the gates and base loaded as kLoad says.
// Every load first, unconditional (load_or_zero), so that a thread's loads
// are in flight together; then the arithmetic in registers.  A pixel
// outside the image has gates and base 0.  A first launch (kRaw, kKeep)
// stores the interior's gates and base into gates_out and base_out where
// those are given (once, for the later launches and the backward's
// reverse tiles).
//   !kStates: the interior of x_out is x_{t0 + k}, written after the last step;
//   kStates: after step t (t = t0 + 1 .. t0 + k) the interior's threads
//     store x_t into states[t - 1] (t < total) or x_out (t = total): stores
//     that nothing waits for, so they overlap the next step.
template <Load kLoad, bool kStates>
__device__ __forceinline__ void march_tile(const MarchArgs& a) {
  __shared__ Exchange ex;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = a.h, w = a.w, hw = h * w;
  const long long map = blockIdx.z;
  const int er0 = warp * kRows, ec0 = 2 * lane;          // extended row and column of own (0, 0)
  const int i0 = blockIdx.y * kTile - kHalo + er0;      // their image row
  const int j0 = blockIdx.x * kTile - kHalo + ec0;      // and column
  const float* x_img = a.x_in + map * hw;
  float g[kRows][2][8], e[kRows][2], x[kRows][2];
  if constexpr (kLoad == Load::kRaw) {
    const float* g_img = a.gates + map * 8 * hw;
    const float* blur_img = a.base + map * hw;
    const float* sparse_img = a.mask != nullptr ? a.mask + map * hw : nullptr;
    float x0[kRows][2], sp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
        gather_pixel(g_img, i, j, h, w, g[r][c]);
        x0[r][c] = load_or_zero(blur_img, i, j, h, w);
        sp[r][c] = sparse_img != nullptr ? load_or_zero(sparse_img, i, j, h, w) : 0.0f;
        x[r][c] = load_or_zero(x_img, i, j, h, w);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
        const bool in = inside(i, j, h, w);
        const float base = fold_pixel(g[r][c], x0[r][c], sp[r][c], sparse_img != nullptr, a.norm_abs);
        e[r][c] = in ? base : 0.0f;
#pragma unroll
        for (int d = 0; d < 8; ++d) g[r][c][d] = in ? g[r][c][d] : 0.0f;
        if (in && in_interior(er0 + r, ec0 + c)) store_folded(a, map, hw, i * w + j, g[r][c], e[r][c]);
      }
    }
  } else {
    const float* g_img = a.gates + map * 8 * hw;
    float kp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
#pragma unroll
        for (int d = 0; d < 8; ++d) g[r][c][d] = load_or_zero(g_img + d * hw, i, j, h, w);
        e[r][c] = load_or_zero(a.base + map * hw, i, j, h, w);
        if constexpr (kLoad == Load::kKeep) kp[r][c] = load_or_zero(a.mask + map * hw, i, j, h, w);
        x[r][c] = load_or_zero(x_img, i, j, h, w);
      }
    }
    if constexpr (kLoad == Load::kKeep) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + r, j = j0 + c;
#pragma unroll
          for (int d = 0; d < 8; ++d) g[r][c][d] = kp[r][c] * g[r][c][d];
          if (inside(i, j, h, w) && in_interior(er0 + r, ec0 + c)) {
            store_folded(a, map, hw, i * w + j, g[r][c], e[r][c]);
          }
        }
      }
    }
  }
  // warp-uniform: the band holds interior rows; per lane: its pair does
  // (kHalo is a multiple of kRows and even)
  const bool own = er0 >= kHalo && er0 < kExt - kHalo && ec0 >= kHalo && ec0 < kExt - kHalo;
  const bool vec = (w & 1) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.states) | reinterpret_cast<uintptr_t>(a.x_out)) &
                    7) == 0;
  for (int s = 0; s < a.k; ++s) {
    march_step<false>(g, e, x, ex, s & 1, warp, lane);
    if (kStates && own) {
      const int t = a.t0 + s + 1;
      float* dst = t < a.total ? a.states + (long long)(t - 1) * a.plane : a.x_out;
      store_pairs(dst + map * hw, x, i0, j0, h, w, vec);
    }
  }
  if (!kStates && own) store_pairs(a.x_out + map * hw, x, i0, j0, h, w, false);
}

using MarchKernel = void (*)(MarchArgs);

// `steps` forward steps in tile_launches(steps) launches of k <= kHalo
// steps, the ragged one last.  The first launch runs `first` on `a` as the
// caller set it (its inputs; gates_out and base_out written where given);
// each later one runs `later` (a Load::kFolded kernel) on gates_out and
// base_out (a.gates and a.base where those are null).
//   a.states given (kStates kernels): states[t - 1] = x_t for 0 < t < steps
//     and a.x_out = x_steps; a later launch starts from the state the
//     launch before it stored.  With steps == 0 and gates_out given, one
//     launch of no steps writes the folded gates and nothing else.
//   a.states null (!kStates kernels): each launch writes its x_out, a.x_out
//     and x_scratch in turn so that the last writes a.x_out, and the next
//     launch starts from it.
// Returns the first launch error, else cudaSuccess.
inline cudaError_t march_launches(MarchKernel first, MarchKernel later, MarchArgs a, int n,
                                  int steps, cudaStream_t s, float* x_scratch = nullptr) {
  const dim3 grid((a.w + kTile - 1) / kTile, (a.h + kTile - 1) / kTile, n);
  const int launches = steps > 0 ? tile_launches(steps) : (a.gates_out != nullptr ? 1 : 0);
  float* const out = a.x_out;
  a.total = steps;
  a.plane = (long long)n * a.h * a.w;
  for (int l = 0; l < launches; ++l) {
    a.t0 = l * kHalo;
    a.k = steps - a.t0 < kHalo ? steps - a.t0 : kHalo;
    if (l > 0) {
      a.gates = a.gates_out != nullptr ? a.gates_out : a.gates;
      a.base = a.base_out != nullptr ? a.base_out : a.base;
      a.mask = nullptr;
      a.gates_out = a.base_out = nullptr;
      a.x_in = a.states != nullptr ? a.states + (long long)(a.t0 - 1) * a.plane : a.x_out;
    }
    if (a.states == nullptr) a.x_out = (launches - 1 - l) % 2 == 0 ? out : x_scratch;
    const MarchKernel kernel = l == 0 ? first : later;
    kernel<<<grid, kMarchThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
