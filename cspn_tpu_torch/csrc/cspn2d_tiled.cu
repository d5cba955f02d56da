// Tiled multi-step 2D CSPN forward (pytorch reference semantics) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn_pallas.py:_fwd_dma_kernel (and
// _fwd_dma_kernel_nosparse), launched there by _cspn2d_tiled_impl for
// frames past the whole-image kernel's VMEM budget.  It computes exactly
// what cspn2d_fwd.cu computes, cspn_tpu_torch/ops/cspn_ref.py:
// cspn2d_reference (see cspn2d_fwd.cu for the formula), with the same
// values: the gates folded by the same code (cspn2d_common.cuh:fold_pixel)
// and, per pixel and step, the same FMA chain in the same order (an
// out-of-image neighbour adds g * 0 where the per-step kernel skips it).
//
// What bounds it on this card.  The fused op reads 8 guidance planes, blur
// and sparse and writes one plane: 11 f32 planes, 75.3 MB for a batch of
// four 352x1216 KITTI frames, 0.0225 ms at the H100 SXM's 3.35 TB/s.  Its
// arithmetic is ~17 flops per pixel per step, 0.0105 ms at 67 TFLOP/s of
// f32 for 24 steps: bytes bound it.
//
// Why a second forward kernel.  The per-step kernel (cspn2d_fwd.cu) reads
// 8 gate planes, base and x and writes y at every step: 11 planes a step.
// This one runs K steps a launch on chip, so ops/cspn_cuda.py:use_tiled
// sends every forward here that no backward follows; a forward that
// cspn2d_bwd follows runs the per-step kernel, which keeps its states for
// the backward.
//
// What this design does about it (an earlier version ran a prep launch
// and 32x32 tiles with the state in shared memory: 9 shared loads a
// pixel-step and 13x the bound).  A block owns a 64x64 extended tile
// (cspn2d_march.cuh): an interior of 64 - 2K with a K-deep halo, K steps a
// launch, ceil(steps/K) launches, K = 12 a compile-time constant (chosen
// by timing K = 8 and 12 at the paths' shapes; PERF.md).  There is no prep launch: the
// first launch reads the raw guidance of its extended tile and a 1-pixel
// ring, blur and sparse (all of a thread's loads issued before any
// arithmetic), folds the gates and base of its pixels in registers
// (fold_pixel) and writes the interior's folded gates and base once to
// scratch; a later launch reads them there (re-folding at every launch
// cost more than that copy).  Each thread marches its 2 columns x 4 rows
// with the state in registers: per pixel-step 8 FMA and about 1.5 warp
// shuffles; shared memory carries only the two rows a warp shows its
// neighbours.  Traffic per launch: ~10 input planes over
// (64 / (64 - 2K))^2 the interior (2.56x at K = 12), part of it from the
// L2 where neighbouring tiles overlap, one output plane, and the first
// launch's 9 folded planes.  A block holds one tile (512 threads at <= 128
// registers), so its loads, its fold and its steps do not overlap: that,
// and the halo's re-reads, keep it ~10x its bound.  What it leaves open:
// bf16 gates, and a forward that writes its states (so that training
// could run it too).

#include "cspn2d_common.cuh"  // gather_pixel, fold_pixel, load_or_zero, inside
#include "cspn2d_march.cuh"   // kExt, kHalo, kTile, kRows, kMarchThreads, march_step

namespace {

// Runs k <= kHalo steps on the tile (blockIdx.x, blockIdx.y) of map
// blockIdx.z, reading x_in and writing the interior of x_out.  Every load
// first, unconditional (load_or_zero), so that a thread's loads are in
// flight together; then the arithmetic in registers.
//   kFold (the first launch; x_in is blur): reads the raw guidance
//     [N,8,H,W] around its pixels, blur and sparse ([N,H,W] or null),
//     folds each pixel's gates and base in registers (fold_pixel; a pixel
//     outside the image folds zeros and is then zeroed) and, with `folded`
//     not null, writes them for its interior pixels into folded [N,9,H,W]
//     (8 gate planes, then base) for the later launches;
//   !kFold: reads each pixel's folded gates and base from `folded`.
template <bool kFold>
__global__ void __launch_bounds__(kMarchThreads, 1)
    cspn2d_tiled_kernel(const float* __restrict__ guid, const float* __restrict__ blur,
                        const float* __restrict__ sparse, float* __restrict__ folded,
                        const float* __restrict__ x_in, float* __restrict__ x_out, int h, int w,
                        int k, int norm_abs) {
  __shared__ Exchange ex;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = h * w;
  const long long map = blockIdx.z;
  const int er0 = warp * kRows, ec0 = 2 * lane;          // extended row and column of own (0, 0)
  const int i0 = blockIdx.y * kTile - kHalo + er0;      // their image row
  const int j0 = blockIdx.x * kTile - kHalo + ec0;      // and column
  const float* x_img = x_in + map * hw;
  float* f_img = folded != nullptr ? folded + map * 9 * hw : nullptr;
  float g[kRows][2][8], e[kRows][2], x[kRows][2];
  if (kFold) {
    const float* g_img = guid + map * 8 * hw;
    const float* blur_img = blur + map * hw;
    const float* sparse_img = sparse != nullptr ? sparse + map * hw : nullptr;
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
        const float base = fold_pixel(g[r][c], x0[r][c], sp[r][c], sparse_img != nullptr, norm_abs);
        e[r][c] = in ? base : 0.0f;
#pragma unroll
        for (int d = 0; d < 8; ++d) g[r][c][d] = in ? g[r][c][d] : 0.0f;
        if (f_img != nullptr && in && in_interior(er0 + r, ec0 + c)) {
#pragma unroll
          for (int d = 0; d < 8; ++d) f_img[d * hw + i * w + j] = g[r][c][d];
          f_img[8 * hw + i * w + j] = e[r][c];
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
#pragma unroll
        for (int d = 0; d < 8; ++d) g[r][c][d] = load_or_zero(f_img + d * hw, i, j, h, w);
        e[r][c] = load_or_zero(f_img + 8 * hw, i, j, h, w);
        x[r][c] = load_or_zero(x_img, i, j, h, w);
      }
    }
  }
  for (int s = 0; s < k; ++s) march_step<false>(g, e, x, ex, s & 1, warp, lane);
  float* out_img = x_out + map * hw;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + r, j = j0 + c;
      if (in_interior(er0 + r, ec0 + c) && inside(i, j, h, w)) out_img[i * w + j] = x[r][c];
    }
  }
}

}  // namespace

// Runs the whole forward on `stream`: ceil(steps / kHalo) tile launches.
// The caller allocates every buffer (contiguous f32): guid [n,8,h,w],
// blur/out/x_scratch [n,h,w], folded [n,9,h,w] (the first launch's folded
// gates and base, read by the later ones); sparse may be null.  Returns
// cudaGetLastError() after the first launch that fails, else 0.
extern "C" int cspn2d_tiled_f32(const float* guid, const float* blur, const float* sparse,
                                float* out, float* folded, float* x_scratch, int n, int h, int w,
                                int steps, int norm_abs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, blur, sizeof(float) * (size_t)n * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  const int launches = tile_launches(steps);
  const float* src = blur;
  for (int l = 0; l < launches; ++l) {
    const int k = (l + 1) * kHalo <= steps ? kHalo : steps - l * kHalo;
    float* dst = ((launches - 1 - l) % 2 == 0) ? out : x_scratch;  // the last writes out
    if (l == 0) {
      cspn2d_tiled_kernel<true><<<grid, kMarchThreads, 0, s>>>(
          guid, blur, sparse, launches > 1 ? folded : nullptr, src, dst, h, w, k, norm_abs);
    } else {
      cspn2d_tiled_kernel<false><<<grid, kMarchThreads, 0, s>>>(
          guid, blur, sparse, folded, src, dst, h, w, k, norm_abs);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
