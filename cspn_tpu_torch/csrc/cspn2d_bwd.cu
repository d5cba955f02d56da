// 2D CSPN backward (the exact adjoint of csrc/cspn2d_fwd.cu) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_bwd_kernel (and
// _bwd_kernel_nosparse, _bwd_kernel_grid, _bwd_kernel_grid_nosparse),
// launched there by _cspn2d_bwd_pallas.  Given the forward's inputs and the
// cotangent v of its output it returns d guidance and d blur in f32, what
// autograd of cspn_tpu_torch/ops/cspn_ref.py:cspn2d_reference returns.
// With G_d = keep * gate_d (the forward's folded gates) and x_0 = blur:
//
//   forward   x_{t+1}[p] = sum_d G_d[p] x_t[p + off_d] + base[p]
//   reverse   for t = T-1 .. 0, with v = d x_{t+1}:
//               bbar[p]    += v[p]
//               Gbar_d[p]  += v[p] x_t[p + off_d]          (keep applied last)
//               v'[q]       = sum_d G_d[q - off_d] v[q - off_d]   (= d x_t)
//   epilogue  dblur   = v_0 + bbar (keep (1 - gsum) + m)
//             gsumbar = -bbar keep x0,  ghatbar_d = keep Gbar_d + gsumbar
//             through gate_d = B_d / sum_e |B_e| (quotient rule, inv = 0
//             where the sum is 0; signs of the raw guidance under 8sum_abs)
//             dguid_d[q] = Bbar_d[q - off_d]                (unshift)
//
// Every launch is in gather form: a thread writes only its own pixels.
//
// What bounds it on this card.  The fused op must read 8 guidance planes,
// blur, sparse and the cotangent and write 8 + 1 planes: 20 f32 planes per
// image, 5.5 MB at 228x304, about 1.7 us per image at the H100 SXM's
// 3.35 TB/s; on the forward's kept states it must also read the 23 states
// x_1..x_{T-1}: 43 planes.  Its arithmetic is ~17 flops per pixel per step
// for the replay and ~33 for the reverse step (8 FMA for the gate
// cotangents, 8 for the adjoint stencil, the bbar add), ~1.2 us per image
// at 24 steps and 67 TFLOP/s of f32: the op is memory-bound.
//
// What this design does about it (an earlier version ran one gather-form
// launch a reverse step, each a pass over ~29 planes with the 9 cotangent
// accumulators read and written in device memory every step, and two
// epilogue launches).  The reverse sweep runs as ceil(T/K) launches of
// reverse_tile_kernel on the tiled forward's tiles (cspn2d_march.cuh: a
// 64x64 extended tile, interior 64 - 2K, K = 12 steps a launch; the first launch takes the ragged remainder so that the last
// ends at t = 0):
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
//     (each sum in the per-step reverse chain's order), from 0 in the
//     first launch and from device memory in a later one, and writes them
//     once: 2 read-modify-writes of the 9 planes at K = 12 where there
//     were 24;
//   - one epilogue launch (epilogue_kernel) folds the old two: a block
//     computes the quotient rule at its tile's pixels and a 1-pixel ring
//     into shared memory, then each guidance pixel q gathers
//     dguid_d[q] = Bbar_d[q - off_d] from it.
// No atomics: a second backward is bit for bit the first.  On kept states
// a backward is ceil(T/K) + 1 launches (3 at T = 24, K = 12; 26 before);
// the replay adds its prep and T - 1 step launches (cspn2d_common.cuh).
// A block holds one tile (512 threads at <= 128 registers), so its loads
// and its arithmetic do not overlap; at KITTI b4 the bytes moved, ~55
// planes a launch over the halo (gates over 2.56x the interior, K states,
// the accumulators), bound it.  The epilogue folded into the last reverse
// launch (the accumulators on a ring more, the guidance gathered there)
// measured slower than this separate pass at every shape of the paths.
// What it leaves open: bf16 gates, overlapping a tile's loads with its
// arithmetic.

#include "cspn2d_common.cuh"  // kDy/kDx, kThreads, inside, prep, step
#include "cspn2d_march.cuh"   // kHalo, kTile, kRows, kMarchThreads, Exchange, march_step

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
// over the k steps and written back.  x_t is blur for t = 0, else
// states[t - 1]; gates are the forward's folded keep * gate_d.
//
// The adjoint runs first, each step keeping the interior's v in shared
// memory; then each interior thread accumulates its pixels' cotangents in
// registers over the k steps, in the per-step kernel's order:
//   bbar[p] += v[p];  Gbar_d[p] += v[p] x_t[p + off_d]  (d = 0..7).
__global__ void __launch_bounds__(kMarchThreads, 1)
    reverse_tile_kernel(const float* __restrict__ gates,   // [N,8,H,W]
                        const float* __restrict__ blur,    // [N,H,W]
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
        const float* x_img = (t == 0 ? blur : states + (long long)(t - 1) * plane) + map * hw;
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

// The epilogue's tile: kEpiW x kEpiH guidance pixels a block, and the
// quotient rule on them and a 1-pixel ring.
constexpr int kEpiW = 32, kEpiH = 16;
constexpr int kEpiThreads = 256;

// Per pixel r of the tile and its ring: the cotangent of the raw gathered
// guidance Bbar_d[r] (B_d[r] = g_d[r + off_d]) into shared memory, and
// dblur[r] for the tile's own pixels; then per guidance pixel q of the
// tile: dguid_d[q] = Bbar_d[q - off_d] (0 where q - off_d lies outside).
__global__ void __launch_bounds__(kEpiThreads)
    epilogue_kernel(const float* __restrict__ guid,    // [N,8,H,W]
                    const float* __restrict__ blur,    // [N,H,W]
                    const float* __restrict__ sparse,  // [N,H,W] or null
                    const float* __restrict__ v0,      // d x_0 [N,H,W]
                    const float* __restrict__ bbar,    // [N,H,W]
                    const float* __restrict__ gbar,    // [N,8,H,W]
                    float* __restrict__ dguid,         // [N,8,H,W]
                    float* __restrict__ dblur,         // [N,H,W]
                    int h, int w, int norm_abs) {
  __shared__ float raw[8][kEpiH + 2][kEpiW + 2];
  const int hw = h * w;
  const long long n = blockIdx.z;
  const int ti = blockIdx.y * kEpiH, tj = blockIdx.x * kEpiW;
  const float* g_img = guid + n * 8 * hw;

  for (int e = threadIdx.x; e < (kEpiH + 2) * (kEpiW + 2); e += kEpiThreads) {
    const int ri = e / (kEpiW + 2), rj = e - ri * (kEpiW + 2);
    const int i = ti + ri - 1, j = tj + rj - 1;
    if (!inside(i, j, h, w)) continue;  // never read: q - off_d outside the image gives 0
    float a[8];  // signed raw guidance gathered from the neighbours
    float denom = 0.0f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int qi = i + kDy[d];
      const int qj = j + kDx[d];
      a[d] = load_or_zero(g_img + d * hw, qi, qj, h, w);
      denom += fabsf(a[d]);
    }
    const float inv = denom > 0.0f ? 1.0f / denom : 0.0f;
    float ge[8];  // the effective gates the forward used
    float gsum = 0.0f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const float gn = a[d] * inv;
      ge[d] = norm_abs ? fabsf(gn) : gn;
      gsum += ge[d];
    }
    const long long p = n * hw + i * w + j;
    const float x0 = blur[p];
    float keep = 1.0f;
    float m = 0.0f;
    if (sparse != nullptr) {
      const float s = sparse[p];
      m = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
      keep = 1.0f - m;
    }
    const float bb = bbar[p];
    if (ri >= 1 && ri <= kEpiH && rj >= 1 && rj <= kEpiW) {
      dblur[p] = v0[p] + bb * (keep * (1.0f - gsum) + m);
    }
    const float gsumbar = -bb * keep * x0;
    const float* gb_px = gbar + n * 8 * hw + i * w + j;
    float gh[8];
    float t_sum = 0.0f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      gh[d] = keep * gb_px[d * hw] + gsumbar;
      t_sum += gh[d] * ge[d];
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const float sg = (a[d] > 0.0f) ? 1.0f : ((a[d] < 0.0f) ? -1.0f : 0.0f);
      raw[d][ri][rj] = norm_abs ? sg * (gh[d] - t_sum) * inv : (gh[d] - sg * t_sum) * inv;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kEpiH * kEpiW; e += kEpiThreads) {
    const int qi = e / kEpiW, qj = e - qi * kEpiW;
    const int i = ti + qi, j = tj + qj;
    if (!inside(i, j, h, w)) continue;
    float* dst = dguid + n * 8 * hw + i * w + j;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int ri = i - kDy[d], rj = j - kDx[d];
      dst[d * hw] = inside(ri, rj, h, w) ? raw[d][qi + 1 - kDy[d]][qj + 1 - kDx[d]] : 0.0f;
    }
  }
}

// The reverse sweep: tile_launches(steps) launches of
// reverse_tile_kernel from v = ct, the ragged one first, the last writing
// d x_0 into v_scratch; returns its plane (or null after a failed launch,
// with *err set).
const float* reverse_tiles(const float* gates, const float* blur, const float* states,
                           const float* ct, float* v_scratch, float* gbar, float* bbar, int n,
                           int h, int w, int steps, cudaStream_t s, cudaError_t* err) {
  *err = cudaFuncSetAttribute(reverse_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kReverseSmemBytes);
  if (*err != cudaSuccess) return nullptr;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  const size_t plane = (size_t)n * h * w;
  const int launches = tile_launches(steps);
  const float* v = ct;
  int t_hi = steps;
  for (int l = 0; l < launches; ++l) {
    const int k = l == 0 ? steps - (launches - 1) * kHalo : kHalo;
    float* v_next = v_scratch + (size_t)(l % 2) * plane;
    reverse_tile_kernel<<<grid, kMarchThreads, kReverseSmemBytes, s>>>(
        gates, blur, states, v, v_next, gbar, bbar, n, h, w, t_hi, k, l == 0);
    if ((*err = cudaGetLastError()) != cudaSuccess) return nullptr;
    v = v_next;
    t_hi -= k;
  }
  return v;
}

}  // namespace

// Runs the whole backward on `stream`.  The caller allocates every buffer
// (contiguous f32):
//   guid [n,8,h,w], blur/ct [n,h,w] (sparse [n,h,w] or null),
//   dguid [n,8,h,w], dblur [n,h,w] (outputs),
//   gate_scratch/gbar_scratch [n,8,h,w], base_scratch/bbar_scratch [n,h,w],
//   v_scratch [2,n,h,w], state_scratch [max(steps-1,0),n,h,w].
// With have_states, gate_scratch and state_scratch hold what the forward
// kept (cspn2d_fwd.cu given `states`), and prep and the replay are skipped
// (base_scratch is then unused).
// Launches: steps == 0: a copy and a memset; else 1 prep and steps-1
// replay steps (neither with have_states), ceil(steps / kHalo) reverse
// tiles and 1 epilogue.  Returns the first CUDA error of a launch or
// copy, else 0.
extern "C" int cspn2d_bwd_f32(const float* guid, const float* blur,
                              const float* sparse, const float* ct,
                              float* dguid, float* dblur, float* gate_scratch,
                              float* gbar_scratch, float* base_scratch,
                              float* bbar_scratch, float* v_scratch,
                              float* state_scratch, int n, int h, int w,
                              int steps, int norm_abs, int have_states, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = (size_t)n * h * w;
  cudaError_t err;
  if (steps <= 0) {  // out = blur: d blur = ct, d guidance = 0
    err = cudaMemcpyAsync(dblur, ct, sizeof(float) * plane,
                          cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemsetAsync(dguid, 0, sizeof(float) * 8 * plane, s));
  }
  if (!have_states) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, n);
    prep_kernel<<<grid, kThreads, 0, s>>>(guid, blur, sparse, gate_scratch,
                                          base_scratch, h, w, norm_abs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    // replay: state_scratch[t-1] = x_t for t = 1 .. steps-1 (x_0 is blur)
    for (int t = 1; t < steps; ++t) {
      const float* src = t == 1 ? blur : state_scratch + (size_t)(t - 2) * plane;
      step_kernel<<<grid, kThreads, 0, s>>>(gate_scratch, base_scratch, src,
                                            state_scratch + (size_t)(t - 1) * plane, h, w);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  const float* v0 = reverse_tiles(gate_scratch, blur, state_scratch, ct, v_scratch, gbar_scratch,
                                  bbar_scratch, n, h, w, steps, s, &err);
  if (v0 == nullptr) return static_cast<int>(err);
  const dim3 egrid((w + kEpiW - 1) / kEpiW, (h + kEpiH - 1) / kEpiH, n);
  epilogue_kernel<<<egrid, kEpiThreads, 0, s>>>(guid, blur, sparse, v0, bbar_scratch,
                                                gbar_scratch, dguid, dblur, h, w, norm_abs);
  return static_cast<int>(cudaGetLastError());
}
