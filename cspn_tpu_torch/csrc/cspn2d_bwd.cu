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
// reverse_tile_kernel (cspn2d_reverse.cuh: the adjoint of the column
// march on its 64x64 extended tiles, interior 64 - 2K, K = 12 steps a
// launch, the transposed stencil gathered once a launch, the cotangents
// summed in registers and written once a launch: 2 read-modify-writes of
// the 9 planes at K = 12 where there were 24), then one epilogue launch
// (epilogue_kernel) folds the old two: a block computes the quotient rule
// at its tile's pixels and a 1-pixel ring into shared memory, then each
// guidance pixel q gathers dguid_d[q] = Bbar_d[q - off_d] from it.
// No atomics: a second backward is bit for bit the first.  On kept states
// a backward is ceil(T/K) + 1 launches (3 at T = 24, K = 12; 26 with one
// launch a reverse step).  Without them it replays first with the forward
// that keeps its states (cspn2d_march.cuh: march_launches, the code of
// cspn2d_fwd.cu) over T - 1 steps: ceil((T-1)/K) launches (at least one,
// which folds the gates), 5 launches in all at T = 24 (27 with a replay
// launch a step).  The replayed states and gates are the forward's bit
// for bit, so both routes give the same values.
// A block holds one tile (512 threads at <= 128 registers), so its loads
// and its arithmetic do not overlap; at KITTI b4 the bytes moved, ~55
// planes a launch over the halo (gates over 2.56x the interior, K states,
// the accumulators), bound it.  The epilogue folded into the last reverse
// launch (the accumulators on a ring more, the guidance gathered there)
// measured slower than this separate pass at every shape of the paths.
// What it leaves open: bf16 gates, overlapping a tile's loads with its
// arithmetic.

#include "cspn2d_common.cuh"   // kDy/kDx, inside, load_or_zero
#include "cspn2d_march.cuh"    // MarchArgs, march_tile, march_launches, kHalo
#include "cspn2d_reverse.cuh"  // reverse_tile, reverse_tiles, kReverseSmemBytes

namespace {

// The replay's launches (march_tile keeping the states, as cspn2d_fwd.cu's
// forward): kFold the first, folding the raw guidance; !kFold the later.
template <bool kFold>
__global__ void __launch_bounds__(kMarchThreads, 1) replay_tile_kernel(MarchArgs a) {
  march_tile<kFold ? Load::kRaw : Load::kFolded, true>(a);
}

// One launch of the reverse sweep (cspn2d_reverse.cuh:reverse_tile).
__global__ void __launch_bounds__(kMarchThreads, 1)
    reverse_tile_kernel(const float* __restrict__ gates, const float* __restrict__ blur,
                        const float* __restrict__ states, const float* __restrict__ v_in,
                        float* __restrict__ v_out, float* __restrict__ gbar,
                        float* __restrict__ bbar, int n, int h, int w, int t_hi, int k,
                        int first) {
  reverse_tile(gates, blur, states, v_in, v_out, gbar, bbar, n, h, w, t_hi, k, first);
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

}  // namespace

// Runs the whole backward on `stream`.  The caller allocates every buffer
// (contiguous f32):
//   guid [n,8,h,w], blur/ct [n,h,w] (sparse [n,h,w] or null),
//   dguid [n,8,h,w], dblur [n,h,w] (outputs),
//   gate_scratch/gbar_scratch [n,8,h,w], base_scratch/bbar_scratch [n,h,w],
//   v_scratch [2,n,h,w], state_scratch [max(steps-1,0),n,h,w].
// With have_states, gate_scratch and state_scratch hold what the forward
// kept (cspn2d_fwd.cu), and the replay is skipped (base_scratch is then
// unused).
// Launches: steps == 0: a copy and a memset; else max(1, ceil((steps-1) /
// kHalo)) replay launches (none with have_states), ceil(steps / kHalo)
// reverse tiles and 1 epilogue.  Returns the first CUDA error of a launch
// or copy, else 0.
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
  if (!have_states) {  // state_scratch[t-1] = x_t for t = 1 .. steps-1, and the folded gates
    MarchArgs a{};
    a.gates = guid;
    a.base = blur;
    a.mask = sparse;
    a.gates_out = gate_scratch;
    a.base_out = steps - 1 > kHalo ? base_scratch : nullptr;
    a.x_in = blur;
    a.x_out = steps > 1 ? state_scratch + (size_t)(steps - 2) * plane : nullptr;
    a.states = state_scratch;
    a.h = h;
    a.w = w;
    a.norm_abs = norm_abs;
    err = march_launches(replay_tile_kernel<true>, replay_tile_kernel<false>, a, n, steps - 1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* v0 = v_scratch + plane;
  err = reverse_tiles(reverse_tile_kernel, gate_scratch, blur, state_scratch, ct, v_scratch, v0,
                      gbar_scratch, bbar_scratch, n, h, w, steps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 egrid((w + kEpiW - 1) / kEpiW, (h + kEpiH - 1) / kEpiH, n);
  epilogue_kernel<<<egrid, kEpiThreads, 0, s>>>(guid, blur, sparse, v0, bbar_scratch,
                                                gbar_scratch, dguid, dblur, h, w, norm_abs);
  return static_cast<int>(cudaGetLastError());
}
