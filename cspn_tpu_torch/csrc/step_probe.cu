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
// gate planes are 4 MB), so a block is [8,512]: 256 threads, each owning
// two adjacent columns x 8 rows of state and their 128 gates in registers
// (the column march's lane layout, cspn2d_march.cuh), loaded and stored as
// float2 (bf16x2 for bf16).  The row neighbours are registers of the same
// thread; of the two column shifts a pixel pair needs, one neighbour is in
// the thread's own registers and the other one warp shuffle away, so a
// shuffle serves two pixels; the values that cross a warp edge pass
// through a double-buffered shared buffer (one __syncthreads() per
// iteration).  An iteration first computes the sums the neighbouring
// lanes need and shuffles them while it computes the rest (the f32 slope
// 5% below shuffling after all sums; PERF.md).  The caller launches one
// block per SM, each on its own block of gates and state.
//
// Dtype pairs (gates / state), as the TPU probe's:
//   f32 / f32:   f32 FMA;
//   bf16 / f32:  gates stored as bf16 pairs of columns, converted to f32
//                at each use;
//   bf16 / bf16: the state as bf16 pairs of columns (2t, 2t+1), packed
//                bf16x2 FMA (__hfma2), half the instructions of the f32
//                step.
//
// What bounds it.  Nothing off chip: the gates and state are read once
// and the result written once.  An f32 pixel-iteration is 11 FP32
// instructions (16 flops: 5 FMA, 3 products, 2 adds, the rescale): 352
// clocks of the SM's 128 FP32 lanes for a block of 4,096 pixels, 0.178 us
// at 1.98 GHz, against 0.129 us for its 16 flops at 67 TFLOP/s (which
// counts every instruction as an FMA).  Beside it run 16 shuffles a
// thread (128 warp shuffles, ~128 clocks at 32 lanes a clock; 256 in an
// earlier version with one column a thread, 512 threads and two shuffles
// a pixel) and the per-iteration barrier; bf16 gates add one conversion a
// gate use on the integer pipe.  The two-point slope over `iters` reads
// the time of one iteration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 512;
constexpr int kThreads = kCols / 2;  // a thread owns columns 2t, 2t + 1
constexpr int kWarps = kThreads / 32;
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

// The warp-edge words of one iteration: [0][warp] the u_1 of a warp's
// first column (for the last lane of the warp to its left), [1][warp] the
// u_-1 of its last column (for the first lane of the warp to its right),
// kRows 32-bit words each.
struct Edges {
  uint4 w[2][kWarps][kRows / 4];
};

// The column shifts of one iteration, in two halves, so that a thread's
// other arithmetic runs while the shuffles are in flight.  send_columns:
// in, each row's u_1 of the thread's first column (u1_first) and u_-1 of
// its second (um1_second), as 32-bit words; the warp's edge lanes publish
// theirs in `e`; out, u_1 of the column right of the pair (from_right:
// lane + 1's u1_first) and u_-1 of the column left of it (from_left: lane
// - 1's um1_second), by shuffles.  receive_edges: after the barrier, the
// warp's edge lanes take those from the neighbouring warps instead, 0
// beyond the block's first and last columns.
__device__ __forceinline__ void send_columns(const unsigned (&u1_first)[kRows],
                                             const unsigned (&um1_second)[kRows],
                                             unsigned (&from_right)[kRows],
                                             unsigned (&from_left)[kRows], Edges& e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    e.w[0][warp][0] = make_uint4(u1_first[0], u1_first[1], u1_first[2], u1_first[3]);
    e.w[0][warp][1] = make_uint4(u1_first[4], u1_first[5], u1_first[6], u1_first[7]);
  }
  if (lane == 31) {
    e.w[1][warp][0] = make_uint4(um1_second[0], um1_second[1], um1_second[2], um1_second[3]);
    e.w[1][warp][1] = make_uint4(um1_second[4], um1_second[5], um1_second[6], um1_second[7]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    from_right[r] = __shfl_down_sync(kAll, u1_first[r], 1);
    from_left[r] = __shfl_up_sync(kAll, um1_second[r], 1);
  }
}

__device__ __forceinline__ void receive_edges(unsigned (&from_right)[kRows],
                                              unsigned (&from_left)[kRows], const Edges& e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 31) {
    const uint4 a = warp + 1 < kWarps ? e.w[0][warp + 1][0] : make_uint4(0u, 0u, 0u, 0u);
    const uint4 b = warp + 1 < kWarps ? e.w[0][warp + 1][1] : make_uint4(0u, 0u, 0u, 0u);
    from_right[0] = a.x, from_right[1] = a.y, from_right[2] = a.z, from_right[3] = a.w;
    from_right[4] = b.x, from_right[5] = b.y, from_right[6] = b.z, from_right[7] = b.w;
  }
  if (lane == 0) {
    const uint4 a = warp > 0 ? e.w[1][warp - 1][0] : make_uint4(0u, 0u, 0u, 0u);
    const uint4 b = warp > 0 ? e.w[1][warp - 1][1] : make_uint4(0u, 0u, 0u, 0u);
    from_left[0] = a.x, from_left[1] = a.y, from_left[2] = a.z, from_left[3] = a.w;
    from_left[4] = b.x, from_left[5] = b.y, from_left[6] = b.z, from_left[7] = b.w;
  }
}

// f32 state; gates f32 (kGateBf16 = false) or bf16 pairs of columns.
template <bool kGateBf16>
__global__ void __launch_bounds__(kThreads, 1)
    step_probe_f32_kernel(const void* __restrict__ g_in, const float* __restrict__ x_in,
                          float* __restrict__ out, int iters) {
  __shared__ Edges edges[2];
  const int col = 2 * threadIdx.x;
  const long long b = blockIdx.x;
  float x[kRows][2];
  float2 g[kGateBf16 ? 1 : 8][kGateBf16 ? 1 : kRows];
  __nv_bfloat162 gp[kGateBf16 ? 8 : 1][kGateBf16 ? kRows : 1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float2 v = *reinterpret_cast<const float2*>(x_in + (b * kRows + r) * kCols + col);
    x[r][0] = v.x, x[r][1] = v.y;
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long at = ((b * 8 + d) * kRows + r) * kCols + col;
      if constexpr (kGateBf16)
        gp[d][r] = *reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(g_in) + at);
      else
        g[d][r] = *reinterpret_cast<const float2*>(static_cast<const float*>(g_in) + at);
    }
  }
  auto gate = [&](int d, int r, int c) -> float {
    if constexpr (kGateBf16)
      return c == 0 ? __low2float(gp[d][r]) : __high2float(gp[d][r]);
    else
      return c == 0 ? g[d][r].x : g[d][r].y;
  };
  for (int it = 0; it < iters; ++it) {
    // first the sums the neighbouring lanes need, then their shuffles,
    // then the rest of the row sums while those are in flight
    unsigned u1_first[kRows], um1_second[kRows], fr[kRows], fl[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xp0 = r + 1 < kRows ? x[r + 1][0] : 0.0f, xm0 = r > 0 ? x[r - 1][0] : 0.0f;
      const float xp1 = r + 1 < kRows ? x[r + 1][1] : 0.0f, xm1 = r > 0 ? x[r - 1][1] : 0.0f;
      u1_first[r] = __float_as_uint(
          fmaf(gate(5, r, 0), xm0, fmaf(gate(3, r, 0), x[r][0], gate(0, r, 0) * xp0)));
      um1_second[r] = __float_as_uint(
          fmaf(gate(7, r, 1), xm1, fmaf(gate(4, r, 1), x[r][1], gate(2, r, 1) * xp1)));
    }
    send_columns(u1_first, um1_second, fr, fl, edges[it & 1]);
    float u0[kRows][2], u1_second[kRows], um1_first[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float xp = r + 1 < kRows ? x[r + 1][c] : 0.0f;
        const float xm = r > 0 ? x[r - 1][c] : 0.0f;
        u0[r][c] = fmaf(gate(6, r, c), xm, gate(1, r, c) * xp);
        if (c == 1)
          u1_second[r] = fmaf(gate(5, r, c), xm, fmaf(gate(3, r, c), x[r][c], gate(0, r, c) * xp));
        else
          um1_first[r] = fmaf(gate(7, r, c), xm, fmaf(gate(4, r, c), x[r][c], gate(2, r, c) * xp));
      }
    }
    receive_edges(fr, fl, edges[it & 1]);
    // y[j] = (u_0[j] + u_1[j + 1]) + u_-1[j - 1]
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      x[r][0] = ((u0[r][0] + u1_second[r]) + __uint_as_float(fl[r])) * kScale;
      x[r][1] = ((u0[r][1] + __uint_as_float(fr[r])) + um1_first[r]) * kScale;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<float2*>(out + (b * kRows + r) * kCols + col) = make_float2(x[r][0], x[r][1]);
}

// bf16 gates and state, each row's two columns packed (2t low, 2t + 1 high).
__global__ void __launch_bounds__(kThreads, 1)
    step_probe_bf16_kernel(const __nv_bfloat16* __restrict__ g_in,
                           const __nv_bfloat16* __restrict__ x_in,
                           __nv_bfloat16* __restrict__ out, int iters) {
  __shared__ Edges edges[2];
  const int col = 2 * threadIdx.x;
  const long long b = blockIdx.x;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
  const __nv_bfloat162 scale = __float2bfloat162_rn(kScale);
  __nv_bfloat162 x[kRows], g[8][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    x[r] = *reinterpret_cast<const __nv_bfloat162*>(x_in + (b * kRows + r) * kCols + col);
#pragma unroll
    for (int d = 0; d < 8; ++d)
      g[d][r] = *reinterpret_cast<const __nv_bfloat162*>(
          g_in + ((b * 8 + d) * kRows + r) * kCols + col);
  }
  for (int it = 0; it < iters; ++it) {
    // the sums the neighbouring lanes need (both columns' u_1 and u_-1,
    // packed), their shuffles, then u_0 while those are in flight
    unsigned u1[kRows], um1[kRows], fr[kRows], fl[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const __nv_bfloat162 xp = r + 1 < kRows ? x[r + 1] : zero;
      const __nv_bfloat162 xm = r > 0 ? x[r - 1] : zero;
      u1[r] = as_u32(__hfma2(g[5][r], xm, __hfma2(g[3][r], x[r], __hmul2(g[0][r], xp))));
      um1[r] = as_u32(__hfma2(g[7][r], xm, __hfma2(g[4][r], x[r], __hmul2(g[2][r], xp))));
    }
    // the words carry both columns: lane + 1's low half is u_1 right of
    // the pair, lane - 1's high half u_-1 left of it
    send_columns(u1, um1, fr, fl, edges[it & 1]);
    __nv_bfloat162 u0[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const __nv_bfloat162 xp = r + 1 < kRows ? x[r + 1] : zero;
      const __nv_bfloat162 xm = r > 0 ? x[r - 1] : zero;
      u0[r] = __hfma2(g[6][r], xm, __hmul2(g[1][r], xp));
    }
    receive_edges(fr, fl, edges[it & 1]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // u_1 at (2t + 1, 2t + 2): own high half, then fr's low half;
      // u_-1 at (2t - 1, 2t): fl's high half, then own low half
      const __nv_bfloat162 right = as_bf2(__byte_perm(u1[r], fr[r], 0x5432));
      const __nv_bfloat162 left = as_bf2(__byte_perm(fl[r], um1[r], 0x5432));
      x[r] = __hmul2(__hadd2(__hadd2(u0[r], right), left), scale);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<__nv_bfloat162*>(out + (b * kRows + r) * kCols + col) = x[r];
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
    step_probe_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), iters);
  } else if (gate_bf16) {
    step_probe_f32_kernel<true><<<blocks, kThreads, 0, s>>>(g, static_cast<const float*>(x),
                                                         static_cast<float*>(out), iters);
  } else {
    step_probe_f32_kernel<false><<<blocks, kThreads, 0, s>>>(g, static_cast<const float*>(x),
                                                          static_cast<float*>(out), iters);
  }
  return static_cast<int>(cudaGetLastError());
}
