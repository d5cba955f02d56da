// The reverse tiles: the adjoint of the column march (cspn2d_march.cuh) on
// a forward's kept states, shared by cspn2d_bwd.cu (the 2D CSPN backward,
// PERF row 2) and cspn2d_halo_seg_bwd.cu (the sharded segment's backward,
// PERF row 5).  With G_d the forward's folded gates and x_0 its first
// state, the sweep computes, for t = T-1 .. 0 with v = d x_{t+1}:
//
//   bbar[p]    += v[p]
//   Gbar_d[p]  += v[p] x_t[p + off_d]
//   v'[q]       = sum_d G_d[q - off_d] v[q - off_d]      (= d x_t)
//
// as tile_launches(T) launches of K <= kHalo steps (the ragged one first,
// so that the last ends at t = 0) on the march's 64x64 extended tiles:
//   - load: each extended pixel q gathers the transposed stencil
//     A_d[q] = G_d[q - off_d] (0 where q or q - off_d lies outside the
//     image) into registers once a launch, and v; the launch's K states
//     x_t (the interior and a 1-pixel ring) are copied into shared memory
//     (cp.async) while the adjoint runs;
//   - the adjoint v'[q] = sum_d A_d[q] v[q - off_d] is the forward's column
//     march with mirrored offsets, and goes stale from the tile's edge one
//     ring a step as the forward does; each step keeps the interior's v in
//     shared memory;
//   - cotangents in registers: after the adjoint each interior thread sums
//     its pixels' bbar += v and Gbar_d += v x_t[p + off_d] over the K steps
//     (each sum in the per-step reverse chain's order), from 0 in the first
//     launch and from device memory in a later one, and writes them once.
// Every launch is in gather form: a thread writes only its own pixels, so
// there are no atomics and a second run is bit for bit the first.

#pragma once

#include <cuda_runtime.h>

#include "cspn2d_march.cuh"  // kExt, kHalo, kTile, kRows, kMarchThreads, Exchange, march_step

namespace {

// A 4-byte asynchronous copy global -> shared, zero-filled where !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A reverse tile's dynamic shared memory: the adjoint state v of the
// interior at each of the launch's steps, [kHalo][kTile][kTile / 2] float2
// (a lane's two columns, so that a warp's lanes touch consecutive
// float2s), then x_t over the interior and a 1-pixel ring at each step,
// [kHalo][kTile + 2][kTile + 2] floats (copied in with cp.async while the
// adjoint runs).
constexpr size_t kReverseSmemBytes = sizeof(float2) * kHalo * kTile * (kTile / 2) +
                                     sizeof(float) * kHalo * (kTile + 2) * (kTile + 2);
static_assert(kHalo % kRows == 0 && kHalo % 2 == 0, "a warp's band and a lane's pair lie "
              "wholly inside the interior or wholly outside it");

// Reverse steps t = t_hi - 1 .. t_hi - k (k <= kHalo) on the tile
// (blockIdx.x, blockIdx.y) of map blockIdx.z: v_in = d x_{t_hi} -> v_out =
// d x_{t_hi - k} on the interior, and the interior's gate and base
// cotangents, started at 0 (first) or read from gbar/bbar, accumulated
// over the k steps and written back.  x_t is x0 for t = 0, else
// states[t - 1]; gates are the forward's folded gates G_d.
//
// The adjoint runs first, each step keeping the interior's v in shared
// memory; then each interior thread accumulates its pixels' cotangents in
// registers over the k steps, in the per-step order:
//   bbar[p] += v[p];  Gbar_d[p] += v[p] x_t[p + off_d]  (d = 0..7).
__device__ __forceinline__ void reverse_tile(const float* __restrict__ gates,   // [N,8,H,W]
                                             const float* __restrict__ x0,      // [N,H,W]
                                             const float* __restrict__ states,  // [T-1,N,H,W]
                                             const float* __restrict__ v_in,    // [N,H,W]
                                             float* __restrict__ v_out,         // [N,H,W]
                                             float* __restrict__ gbar,          // [N,8,H,W]
                                             float* __restrict__ bbar,          // [N,H,W]
                                             int n, int h, int w, int t_hi, int k, int first) {
  constexpr int kPairs = kTile / 2;
  constexpr int kXSide = kTile + 2;
  __shared__ Exchange ex;
  extern __shared__ float2 vs[];  // [kHalo][kTile][kPairs], then x_t [kHalo][kXSide][kXSide]
  float* xs = reinterpret_cast<float*>(vs + kHalo * kTile * kPairs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = h * w;
  const long long map = blockIdx.z;
  const long long plane = (long long)n * hw;
  const int er0 = warp * kRows, ec0 = 2 * lane;
  const int i0 = blockIdx.y * kTile - kHalo + er0;
  const int j0 = blockIdx.x * kTile - kHalo + ec0;
  const float* g_img = gates + map * 8 * hw;
  // warp-uniform: the band holds interior rows; per lane: its pair does
  const bool band_in = er0 >= kHalo && er0 < kExt - kHalo;
  const bool pair_in = ec0 >= kHalo && ec0 < kExt - kHalo;
  const int ir0 = er0 - kHalo, pr = lane - kHalo / 2;

  // x_t of the interior and its ring for the k steps, every thread a share,
  // in flight while the adjoint runs
  {
    const int xi0 = blockIdx.y * kTile - 1, xj0 = blockIdx.x * kTile - 1;  // image (row, col) of xs[.][0]
    for (int e = threadIdx.x; e < kXSide * kXSide; e += kMarchThreads) {
      const int xr = e / kXSide, xc = e - xr * kXSide;
      const int i = xi0 + xr, j = xj0 + xc;
      const bool ok = inside(i, j, h, w);
      const int at = ok ? i * w + j : 0;
      for (int s = 0; s < k; ++s) {
        const int t = t_hi - 1 - s;
        const float* x_img = (t == 0 ? x0 : states + (long long)(t - 1) * plane) + map * hw;
        cp_async4(xs + s * kXSide * kXSide + e, x_img + at, ok);
      }
    }
    cp_async_commit();
  }

  float a[kRows][2][8], v[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + r, j = j0 + c;
      const bool in = inside(i, j, h, w);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const float ad = load_or_zero(g_img + d * hw, i - ref_dy(d), j - ref_dx(d), h, w);
        a[r][c][d] = in ? ad : 0.0f;
      }
      v[r][c] = load_or_zero(v_in + map * hw, i, j, h, w);
    }
  }

  const float zero[kRows][2] = {};  // the adjoint has no base
  for (int s = 0; s < k; ++s) {
    if (band_in && pair_in) {  // v = d x_{t+1}, t = t_hi - 1 - s, for the cotangents
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        vs[(s * kTile + ir0 + r) * kPairs + pr] = make_float2(v[r][0], v[r][1]);
      }
    }
    march_step<true>(a, zero, v, ex, s & 1, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's share of the states and of v has landed
  if (!(band_in && pair_in)) return;

  // per own pixel (r, c): bbar, then Gbar_d, d = 0..7
  float acc[kRows][2][9];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float* src = q == 0 ? bbar + map * hw : gbar + map * 8 * hw + (q - 1) * hw;
        // this launch writes them back: no read-only path
        acc[r][c][q] = first ? 0.0f : load_or_zero<false>(src, i, j0 + c, h, w);
      }
    }
  }
  for (int s = 0; s < k; ++s) {
    // pixel (r, c) reads x_t at xs row ir0 + r + 1 + dy, column 2 pr + c + 1 + dx:
    // columns 2 pr .. 2 pr + 3 of the rows ir0 .. ir0 + kRows + 1, two float2 each
    const float* xb = xs + s * kXSide * kXSide + ir0 * kXSide + 2 * pr;
    float xw[kRows + 2][4];
#pragma unroll
    for (int xr = 0; xr < kRows + 2; ++xr) {
      const float2 lo = *reinterpret_cast<const float2*>(xb + xr * kXSide);
      const float2 hi = *reinterpret_cast<const float2*>(xb + xr * kXSide + 2);
      xw[xr][0] = lo.x;
      xw[xr][1] = lo.y;
      xw[xr][2] = hi.x;
      xw[xr][3] = hi.y;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 vv = vs[(s * kTile + ir0 + r) * kPairs + pr];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float vp = c == 0 ? vv.x : vv.y;
        acc[r][c][0] += vp;
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          acc[r][c][1 + d] = fmaf(vp, xw[r + 1 + ref_dy(d)][c + 1 + ref_dx(d)], acc[r][c][1 + d]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + c;
      if (!inside(i, j, h, w)) continue;
      const int p = i * w + j;
      v_out[map * hw + p] = v[r][c];
      bbar[map * hw + p] = acc[r][c][0];
#pragma unroll
      for (int d = 0; d < 8; ++d) gbar[map * 8 * hw + d * hw + p] = acc[r][c][1 + d];
    }
  }
}

// The reverse sweep: tile_launches(steps) launches of `kernel` (a
// __global__ wrapper of reverse_tile, blockDim kMarchThreads, with
// kReverseSmemBytes of dynamic shared memory) from v = ct, the ragged one
// first; v ping-pongs between v_scratch and v_out so that the last launch
// writes d x_0 into v_out.  gbar and bbar need no clearing: the first
// launch starts them at 0.  Returns the first CUDA error, else
// cudaSuccess.
template <typename Kernel>
cudaError_t reverse_tiles(Kernel kernel, const float* gates, const float* x0, const float* states,
                          const float* ct, float* v_scratch, float* v_out, float* gbar,
                          float* bbar, int n, int h, int w, int steps, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kReverseSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  const int launches = tile_launches(steps);
  const float* v = ct;
  int t_hi = steps;
  for (int l = 0; l < launches; ++l) {
    const int k = l == 0 ? steps - (launches - 1) * kHalo : kHalo;
    float* v_next = (launches - 1 - l) % 2 == 0 ? v_out : v_scratch;
    kernel<<<grid, kMarchThreads, kReverseSmemBytes, s>>>(gates, x0, states, v, v_next, gbar,
                                                          bbar, n, h, w, t_hi, k, l == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    v = v_next;
    t_hi -= k;
  }
  return cudaSuccess;
}

}  // namespace
