// The CSPN step-body probe for Hopper (sm_90a): is bf16 arithmetic or bf16
// gate storage faster than f32 for the stencil's inner loop?
//
// Replaces the TPU probe scripts/vpu_probe.py:make_probe.kernel.  It runs
// that probe's loop body `iters` times, all on chip, on one block of gates
// and state per SM: for each row i and column j of the block,
//
//   u_dx[i,j] = sum_{d: dx_d = dx} g_d[i,j] * x[i + dy_d, j]     (dx = 1, 0, -1)
//   y[i,j]    = u_0[i,j] + u_1[i,j+1] + u_-1[i,j-1]
//   x[i,j]   <- y[i,j] * 0.124
//
// with rows and columns outside the block 0 and the gates in the reference
// order (OFFSETS_2D_REFERENCE): 8 products of distinct gate planes against
// three row offsets, and two column shifts of the partial sums.  The sums
// run as the probe's: u_1 = (g0 x[i+1] + g3 x[i]) + g5 x[i-1], u_0 = g1 x[i+1]
// + g6 x[i-1], u_-1 = (g2 x[i+1] + g4 x[i]) + g7 x[i-1], each product after
// the first fused into its add; the plain version (utils/step_probe.py)
// computes the same with torch.addcmul.
//
// Block.  The TPU probe's [256,512] f32 state does not fit one SM (its 8
// gate planes are 4 MB), so a block is [8,512]: 512 threads, one per
// column, each holding its column's 8 rows of state and 64 gates in
// registers; the column shifts are warp shuffles, with the values that
// cross a warp edge passing through shared memory (one __syncthreads() per
// iteration).  The caller launches one block per SM, each on its own
// block of gates and state.
//
// Dtype pairs (gates / state), as the TPU probe's:
//   f32 / f32:   f32 FMA;
//   bf16 / f32:  gates stored as bf16 pairs, converted to f32 at each use;
//   bf16 / bf16: the state as bf16 pairs of rows (2i, 2i+1), packed bf16x2
//                FMA (__hfma2), half the instructions of the f32 step.
//
// What bounds it.  Nothing off chip: the gates and state are read once
// and the result written once.  The FP32 pipe (128 lanes a clock per SM),
// the shuffle pipe (two shuffles per pixel per iteration) and the
// per-iteration barrier bound it; the two-point slope over `iters` reads
// the time of one iteration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 512;
constexpr int kWarps = kCols / 32;
constexpr float kScale = 0.124f;
constexpr unsigned kAll = 0xffffffffu;

// Gates g0..g7 in reference order, (dy, dx):
// (1,1) (1,0) (1,-1) (0,1) (0,-1) (-1,1) (-1,0) (-1,-1).

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(unsigned v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// The column shift of u_1 (from column j + 1) and u_-1 (from column j - 1):
// shuffles inside a warp, shared memory across warp edges, 0 at the block
// edges.  `edge` is this iteration's [2][kWarps][n] buffer.
template <int N>
__device__ __forceinline__ void shift_columns(const unsigned (&u1)[N], const unsigned (&um1)[N],
                                              unsigned (&from_right)[N],
                                              unsigned (&from_left)[N], unsigned* edge) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) edge[warp * N + r] = u1[r];
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < N; ++r) edge[(kWarps + warp) * N + r] = um1[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < N; ++r) {
    from_right[r] = __shfl_down_sync(kAll, u1[r], 1);
    from_left[r] = __shfl_up_sync(kAll, um1[r], 1);
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < N; ++r) from_right[r] = warp + 1 < kWarps ? edge[(warp + 1) * N + r] : 0u;
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) from_left[r] = warp > 0 ? edge[(kWarps + warp - 1) * N + r] : 0u;
  }
}

// f32 state; gates f32 (kGateBf16 = false) or bf16 pairs of rows.
template <bool kGateBf16>
__global__ void __launch_bounds__(kCols, 1)
    step_probe_f32_kernel(const void* __restrict__ g_in, const float* __restrict__ x_in,
                          float* __restrict__ out, int iters) {
  __shared__ unsigned edge[2][2 * kWarps * kRows];
  const int col = threadIdx.x;
  const long long b = blockIdx.x;
  float x[kRows];
  float g[kGateBf16 ? 1 : 8][kGateBf16 ? 1 : kRows];
  __nv_bfloat162 gp[kGateBf16 ? 8 : 1][kGateBf16 ? kRows / 2 : 1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) x[r] = x_in[(b * kRows + r) * kCols + col];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long at = ((b * 8 + d) * kRows + r) * kCols + col;
      if constexpr (kGateBf16) {
        const __nv_bfloat16 v = static_cast<const __nv_bfloat16*>(g_in)[at];
        if (r % 2 == 0) gp[d][r / 2].x = v; else gp[d][r / 2].y = v;
      } else {
        g[d][r] = static_cast<const float*>(g_in)[at];
      }
    }
  }
  auto gate = [&](int d, int r) -> float {
    if constexpr (kGateBf16)
      return r % 2 == 0 ? __low2float(gp[d][r / 2]) : __high2float(gp[d][r / 2]);
    else
      return g[d][r];
  };
  for (int it = 0; it < iters; ++it) {
    unsigned u1[kRows], um1[kRows], fr[kRows], fl[kRows];
    float u0[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xp = r + 1 < kRows ? x[r + 1] : 0.0f;
      const float xm = r > 0 ? x[r - 1] : 0.0f;
      u1[r] = __float_as_uint(fmaf(gate(5, r), xm, fmaf(gate(3, r), x[r], gate(0, r) * xp)));
      u0[r] = fmaf(gate(6, r), xm, gate(1, r) * xp);
      um1[r] = __float_as_uint(fmaf(gate(7, r), xm, fmaf(gate(4, r), x[r], gate(2, r) * xp)));
    }
    shift_columns<kRows>(u1, um1, fr, fl, edge[it & 1]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      x[r] = ((u0[r] + __uint_as_float(fr[r])) + __uint_as_float(fl[r])) * kScale;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[(b * kRows + r) * kCols + col] = x[r];
}

// bf16 gates and state, rows packed in pairs (2k, 2k+1).
__global__ void __launch_bounds__(kCols, 1)
    step_probe_bf16_kernel(const __nv_bfloat16* __restrict__ g_in,
                           const __nv_bfloat16* __restrict__ x_in,
                           __nv_bfloat16* __restrict__ out, int iters) {
  constexpr int kPairs = kRows / 2;
  __shared__ unsigned edge[2][2 * kWarps * kPairs];
  const int col = threadIdx.x;
  const long long b = blockIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const __nv_bfloat162 scale = __bfloat162bfloat162(__float2bfloat16(kScale));
  __nv_bfloat162 x[kPairs], g[8][kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    x[k] = __halves2bfloat162(x_in[(b * kRows + 2 * k) * kCols + col],
                              x_in[(b * kRows + 2 * k + 1) * kCols + col]);
#pragma unroll
    for (int d = 0; d < 8; ++d)
      g[d][k] = __halves2bfloat162(g_in[((b * 8 + d) * kRows + 2 * k) * kCols + col],
                                   g_in[((b * 8 + d) * kRows + 2 * k + 1) * kCols + col]);
  }
  for (int it = 0; it < iters; ++it) {
    unsigned u1[kPairs], um1[kPairs], fr[kPairs], fl[kPairs];
    __nv_bfloat162 u0[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      // rows (2k+1, 2k+2) and (2k-1, 2k): the pairs shifted by one row
      const __nv_bfloat162 xp =
          __halves2bfloat162(__high2bfloat16(x[k]), k + 1 < kPairs ? __low2bfloat16(x[k + 1]) : zero);
      const __nv_bfloat162 xm =
          __halves2bfloat162(k > 0 ? __high2bfloat16(x[k - 1]) : zero, __low2bfloat16(x[k]));
      u1[k] = as_u32(__hfma2(g[5][k], xm, __hfma2(g[3][k], x[k], __hmul2(g[0][k], xp))));
      u0[k] = __hfma2(g[6][k], xm, __hmul2(g[1][k], xp));
      um1[k] = as_u32(__hfma2(g[7][k], xm, __hfma2(g[4][k], x[k], __hmul2(g[2][k], xp))));
    }
    shift_columns<kPairs>(u1, um1, fr, fl, edge[it & 1]);
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
      x[k] = __hmul2(__hadd2(__hadd2(u0[k], as_bf2(fr[k])), as_bf2(fl[k])), scale);
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    out[(b * kRows + 2 * k) * kCols + col] = __low2bfloat16(x[k]);
    out[(b * kRows + 2 * k + 1) * kCols + col] = __high2bfloat16(x[k]);
  }
}

}  // namespace

// Runs the probe on `stream`: `blocks` blocks of [8,512], `iters`
// iterations each.  g [blocks,8,8,512] (bf16 when gate_bf16, else f32),
// x/out [blocks,8,512] (bf16 when state_bf16, else f32); bf16 state needs
// bf16 gates.  Returns cudaGetLastError() after the launch, else 0.
extern "C" int step_probe(const void* g, const void* x, void* out, int blocks, int iters,
                          int gate_bf16, int state_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state_bf16 && !gate_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (state_bf16) {
    step_probe_bf16_kernel<<<blocks, kCols, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), iters);
  } else if (gate_bf16) {
    step_probe_f32_kernel<true><<<blocks, kCols, 0, s>>>(g, static_cast<const float*>(x),
                                                         static_cast<float*>(out), iters);
  } else {
    step_probe_f32_kernel<false><<<blocks, kCols, 0, s>>>(g, static_cast<const float*>(x),
                                                          static_cast<float*>(out), iters);
  }
  return static_cast<int>(cudaGetLastError());
}
