// The column march of the 2D CSPN's tile kernels.  Forward (march_tile):
// cspn2d_tiled.cu (the tiled forward, PERF row 3), cspn2d_fwd.cu (the
// forward that keeps its states, PERF row 1), the replay of cspn2d_bwd.cu
// (PERF row 2), both routes of the sharded segment, cspn2d_halo_seg.cu
// (PERF row 4), and with the centre tap (kCentre) the paddle-semantics 2D
// CSPN, paddle2d.cu (PERF row 6); as its adjoint: the reverse tiles of
// cspn2d_bwd.cu and cspn2d_halo_seg_bwd.cu (cspn2d_reverse.cuh).
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
// the image has gates and base (with the centre tap: centre weight) 0, so
// it stays exactly 0 at every step: that
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
// with the centre tap (kCentre, e[p] the centre weight c[p]):
//   x'[p] = sum_d g_d[p] x[p + off_d] + c[p] x[p]
// adjoint (g_d[q] holding the transposed gate G_d[q - off_d], e unused):
//   x'[q] = sum_d g_d[q] x[q - off_d]
// the FMA chain in reference gate order d = 0..7, starting from e (forward),
// c x (centre tap) or 0 (adjoint); a neighbour outside the image adds g * 0.
template <bool kAdjoint, bool kCentre = false>
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
      float acc = kAdjoint ? 0.0f : kCentre ? e[r][c] * win[r + 1][c + 1] : e[r][c];
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
//   kRaw: the raw guidance, blur and sparse, folded (gather_pixel, fold_pixel),
//     each read as MarchArgs::io_g, io_b, io_s say (IoCode) in a kernel
//     built with kIo, else as float32; the state starts at blur;
//   kFolded: gather-form gates and base, as they are (the folded copy a
//     first launch stored, or the halo segment's gates without keep);
//   kKeep: the halo segment's gather-form gates, base and keep, with
//     keep * gate_d (keep is 0, 1 or 2, so the product is exact);
//   kPaddle: the paddle 2D CSPN's raw per-pixel guide in the caller's
//     layout (paddle_pixel): gates |g_d| / max(sum |g|, 1e-12) in reference
//     order, and the centre weight c = 1 - sum_d w_d in e; every step with
//     the centre tap (march_step's kCentre), x in the caller's layout.
enum class Load { kRaw, kFolded, kKeep, kPaddle };

// What one launch of march_tile reads and writes.
struct MarchArgs {
  // kRaw: the raw guidance [N,8,H,W], blur [N,H,W] and sparse [N,H,W] or
  // null, float32 or (io_g, io_b, io_s kIoBf16) bf16.  kFolded, kKeep:
  // gather-form gates [N,8,H,W], base [N,H,W] and (kKeep) keep [N,H,W].
  const float* gates;
  const float* base;
  const float* mask;
  int io_g, io_b, io_s;  // kRaw with kIo: the IoCode of gates, base and mask
  float* gates_out;   // null, or the interior's folded gates [N,8,H,W] (kRaw, kKeep)
  float* base_out;    // null, or the interior's base [N,H,W] (kRaw)
  const float* x_in;  // the state x_{t0} [N,H,W] (kRaw: unused, x_0 is blur)
  float* x_out;       // x_{t0 + k} (!kStates), or x_total (kStates)
  float* states;      // kStates: [total - 1,N,H,W], x_t in states[t - 1]
  long long plane;    // N*H*W, the stride of states
  int h, w, k, t0, total, norm_abs;
  // kPaddle: x_in, x_out and the guide in `gates` in the caller's layout
  // (paddle_layout): map m = n C + ch of C = chans channels, channel-last
  // ([N,H,W,C], guide [N,H,W,C*8]) or channel-first ([N,C,H,W], guide
  // [N,C*8,H,W]).
  int chans, channel_last;
};

// Where map m of a kPaddle launch lies in the caller's layout: x of pixel
// p at x + x_off + p * ps; raw gate d (raster order) of pixel p at gates +
// g_off + p * gps + d * gds.
struct PaddleLayout {
  long long x_off, g_off;
  int ps, gps, gds;
};

__device__ __forceinline__ PaddleLayout paddle_layout(const MarchArgs& a, long long m, int hw) {
  const long long n = m / a.chans, ch = m % a.chans;
  if (a.channel_last) return {n * hw * a.chans + ch, (n * hw * a.chans + ch) * 8, a.chans,
                              8 * a.chans, 1};
  return {m * hw, m * 8 * hw, 1, 1, hw};
}

// x[i, j] of a map whose pixels lie ps floats apart, 0 outside it
// (load_or_zero's clamped, unconditional load).
__device__ __forceinline__ float load_or_zero_px(const float* img, int i, int j, int h, int w,
                                                 int ps) {
  const float v =
      __ldg(img + ((long long)min(max(i, 0), h - 1) * w + min(max(j, 0), w - 1)) * ps);
  return inside(i, j, h, w) ? v : 0.0f;
}

// Pixel (i, j)'s raw paddle gates (raster order, neighbor_offsets(2, 3):
// (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1), the exact reverse
// of the reference order) into g in reference order, normalized: w_d =
// |g_d| * (1 / max(sum |g|, 1e-12)) (one reciprocal, not 8 divisions:
// within 2 ulp of the quotient), summed in raster order; returns the
// centre weight 1 - sum_d w_d.  Outside the image: gates and centre 0.
// vec: a pixel's 8 gates are 8 floats in a row, 16-byte aligned (the
// channel-last guide), read as two float4s.
__device__ __forceinline__ float paddle_pixel(const float* g_map, const PaddleLayout& l, int i,
                                              int j, int h, int w, bool vec, float (&g)[8]) {
  const float* at =
      g_map + ((long long)min(max(i, 0), h - 1) * w + min(max(j, 0), w - 1)) * l.gps;
  float raw[8];
  if (vec) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(at));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(at) + 1);
    raw[0] = lo.x, raw[1] = lo.y, raw[2] = lo.z, raw[3] = lo.w;
    raw[4] = hi.x, raw[5] = hi.y, raw[6] = hi.z, raw[7] = hi.w;
  } else {
#pragma unroll
    for (int d = 0; d < 8; ++d) raw[d] = __ldg(at + (long long)d * l.gds);
  }
  float sum = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    raw[d] = fabsf(raw[d]);
    sum = __fadd_rn(sum, raw[d]);
  }
  const float inv = __frcp_rn(fmaxf(sum, 1e-12f));
  float wsum = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    raw[d] = __fmul_rn(raw[d], inv);
    wsum = __fadd_rn(wsum, raw[d]);
  }
  const bool in = inside(i, j, h, w);
#pragma unroll
  for (int d = 0; d < 8; ++d) g[7 - d] = in ? raw[d] : 0.0f;
  return in ? __fsub_rn(1.0f, wsum) : 0.0f;
}

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

// store_pairs into a map whose pixels lie ps floats apart (the paddle 2D
// CSPN's caller layout), one float a store.
__device__ __forceinline__ void store_pairs_px(float* img, const float (&x)[kRows][2], int i0,
                                               int j0, int h, int w, int ps) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= h) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (j0 + c < w) img[((long long)i * w + j0 + c) * ps] = x[r][c];
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

// A first launch's raw loads for a thread's pixels (rows i0.., columns j0,
// j0 + 1) from planes of T, read as io_value<kRound> reads them: the
// guidance each pixel gathers into g (raw_guidance), or one plane of map
// `map` into v (raw_plane).
template <typename T, bool kRound>
__device__ __forceinline__ void raw_guidance(const float* gates, long long map, int i0, int j0,
                                             int h, int w, float (&g)[kRows][2][8]) {
  const T* g_img = reinterpret_cast<const T*>(gates) + map * 8 * h * w;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) gather_pixel<kRound>(g_img, i0 + r, j0 + c, h, w, g[r][c]);
  }
}

template <typename T, bool kRound>
__device__ __forceinline__ void raw_plane(const float* img, long long map, int i0, int j0, int h,
                                          int w, float (&v)[kRows][2]) {
  const T* p = reinterpret_cast<const T*>(img) + map * h * w;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) v[r][c] = load_or_zero<true, kRound>(p, i0 + r, j0 + c, h, w);
  }
}

// raw_guidance and raw_plane on an input stored as `io` says (IoCode): one
// warp-uniform branch around all of the input's loads, so that they stay
// in flight together, and the next input's with them.
__device__ __forceinline__ void raw_guidance_io(int io, const float* gates, long long map, int i0,
                                                int j0, int h, int w, float (&g)[kRows][2][8]) {
  if (io == kIoBf16) {
    raw_guidance<__nv_bfloat16, false>(gates, map, i0, j0, h, w, g);
  } else if (io == kIoF32Round) {
    raw_guidance<float, true>(gates, map, i0, j0, h, w, g);
  } else {
    raw_guidance<float, false>(gates, map, i0, j0, h, w, g);
  }
}

__device__ __forceinline__ void raw_plane_io(int io, const float* img, long long map, int i0,
                                             int j0, int h, int w, float (&v)[kRows][2]) {
  if (io == kIoBf16) {
    raw_plane<__nv_bfloat16, false>(img, map, i0, j0, h, w, v);
  } else if (io == kIoF32Round) {
    raw_plane<float, true>(img, map, i0, j0, h, w, v);
  } else {
    raw_plane<float, false>(img, map, i0, j0, h, w, v);
  }
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
// kPaddle (the paddle 2D CSPN): each step has the centre tap (march_step's
// kCentre), e holding the centre weight; x_in and x_out lie in the
// caller's layout (paddle_layout).
// kIo (kRaw only): each raw input read as a.io_g, a.io_b, a.io_s say
// (raw_guidance_io, raw_plane_io); without it, all three float32.
// Everything after the loads is float32 whatever the inputs' storage.
template <Load kLoad, bool kStates, bool kIo = false>
__device__ __forceinline__ void march_tile(const MarchArgs& a) {
  static_assert(!kIo || kLoad == Load::kRaw, "only a first launch reads the raw inputs");
  constexpr bool kCentre = kLoad == Load::kPaddle;
  static_assert(!kCentre || !kStates, "the centre-tap march keeps no states");
  __shared__ Exchange ex;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = a.h, w = a.w, hw = h * w;
  const long long map = blockIdx.z;
  const int er0 = warp * kRows, ec0 = 2 * lane;          // extended row and column of own (0, 0)
  const int i0 = blockIdx.y * kTile - kHalo + er0;      // their image row
  const int j0 = blockIdx.x * kTile - kHalo + ec0;      // and column
  PaddleLayout lay{};
  if constexpr (kCentre) lay = paddle_layout(a, map, hw);
  const float* x_img = a.x_in + (kCentre ? lay.x_off : map * hw);
  float g[kRows][2][8], e[kRows][2], x[kRows][2];
  if constexpr (kLoad == Load::kPaddle) {
    const float* g_map = a.gates + lay.g_off;
    const bool vec_g = lay.gds == 1 && (reinterpret_cast<uintptr_t>(a.gates) & 15) == 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
        e[r][c] = paddle_pixel(g_map, lay, i, j, h, w, vec_g, g[r][c]);
        x[r][c] = load_or_zero_px(x_img, i, j, h, w, lay.ps);
      }
    }
  } else if constexpr (kLoad == Load::kRaw) {
    const bool has_sparse = a.mask != nullptr;
    float x0[kRows][2], sp[kRows][2] = {};
    if constexpr (kIo) {
      raw_guidance_io(a.io_g, a.gates, map, i0, j0, h, w, g);
      raw_plane_io(a.io_b, a.base, map, i0, j0, h, w, x0);
      if (has_sparse) raw_plane_io(a.io_s, a.mask, map, i0, j0, h, w, sp);
    } else {
      raw_guidance<float, false>(a.gates, map, i0, j0, h, w, g);
      raw_plane<float, false>(a.base, map, i0, j0, h, w, x0);
      if (has_sparse) raw_plane<float, false>(a.mask, map, i0, j0, h, w, sp);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
        const bool in = inside(i, j, h, w);
        x[r][c] = x0[r][c];  // x_0 is blur, as the input reads it
        const float base = fold_pixel(g[r][c], x0[r][c], sp[r][c], has_sparse, a.norm_abs);
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
    march_step<false, kCentre>(g, e, x, ex, s & 1, warp, lane);
    if (kStates && own) {
      const int t = a.t0 + s + 1;
      float* dst = t < a.total ? a.states + (long long)(t - 1) * a.plane : a.x_out;
      store_pairs(dst + map * hw, x, i0, j0, h, w, vec);
    }
  }
  if constexpr (kCentre) {
    if (own) store_pairs_px(a.x_out + lay.x_off, x, i0, j0, h, w, lay.ps);
  } else {
    if (!kStates && own) store_pairs(a.x_out + map * hw, x, i0, j0, h, w, false);
  }
}

using MarchKernel = void (*)(MarchArgs);

// `steps` forward steps in tile_launches(steps) launches of k <= kHalo
// steps, the ragged one last.  The first launch runs `first` on `a` as the
// caller set it (its inputs; gates_out and base_out written where given);
// each later one runs `later` on gates_out (as Load::kFolded) and base_out
// where the first wrote them, else on the first's a.gates, a.mask and
// a.base.
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
      if (a.gates_out != nullptr) {
        a.gates = a.gates_out;
        a.mask = nullptr;
      }
      a.base = a.base_out != nullptr ? a.base_out : a.base;
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
