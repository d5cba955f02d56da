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
// out-of-image neighbour adds g * 0).
//
// Its inputs, as _fwd_kernel's (cspn_pallas.py:252-255), may ride HBM as
// bf16 (cspn2d_tiled_io): guidance, blur and sparse each float32 or bf16,
// upcast at first use; float32 ones under the bf16 I/O dtype are rounded
// to bf16 in registers as they are loaded (cspn2d_common.cuh:io_value),
// the same round-to-nearest-even as Tensor.to(torch.bfloat16), so no cast
// runs before the kernel.  Everything after the loads is float32 and the
// same code at either storage: the fold, the folded gates and base the
// later launches read, the steps, the float32 output.
//
// What bounds it on this card.  The fused op reads 8 guidance planes, blur
// and sparse and writes one plane: 11 f32 planes, 44 bytes a pixel, 75.3
// MB for a batch of four 352x1216 KITTI frames, 0.0225 ms at the H100
// SXM's 3.35 TB/s; with bf16 inputs 24 bytes a pixel, 41.1 MB, 0.0123 ms.
// Its arithmetic is ~17 flops per pixel per step, 0.0105 ms at 67 TFLOP/s
// of f32 for 24 steps: bytes bound it at float32, and nearly as much the
// FMAs as the bytes at bf16.
//
// Why a second forward kernel.  cspn2d_fwd.cu runs the same march and
// also stores every state x_1..x_{T-1} and the folded gates for the
// backward (ops/cspn_cuda.py:use_tiled sends a forward there that
// cspn2d_bwd follows); this one stores only the output, for every forward
// that no backward follows.
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
// (fold_pixel) and writes the interior's folded gates ([N,8,H,W], the
// layout the backward's reverse tiles read) and base ([N,H,W]) once to
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
// a later launch still reads the folded gates in float32.

#include "cspn2d_march.cuh"  // MarchArgs, march_tile, march_launches, tile_launches

namespace {

// Runs k <= kHalo steps on one tile (march_tile, storing only x_out).
//   kFold (the first launch; x_0 is blur): folds each pixel's gates and
//     base from the raw guidance, blur and sparse (kIo: each read as
//     a.io_g, a.io_b, a.io_s say, float32 or bf16) and, where later
//     launches follow, writes the interior's into gates_out / base_out;
//   !kFold: reads each pixel's folded gates and base.
template <bool kFold, bool kIo = false>
__global__ void __launch_bounds__(kMarchThreads, 1) cspn2d_tiled_kernel(MarchArgs a) {
  march_tile<kFold ? Load::kRaw : Load::kFolded, false, kIo>(a);
}

// The forward on `a`'s raw inputs: `first` (a first-launch kernel) then
// cspn2d_tiled_kernel<false>, ceil(steps / kHalo) launches; at steps <= 0
// one launch of `first` running no step, which writes x_0 (blur as the
// kernel reads it), where `copy` is false, else a copy of blur.
cudaError_t run_tiled(MarchKernel first, MarchArgs a, const void* blur, float* out,
                      float* folded_gates, float* folded_base, float* x_scratch, int n,
                      int steps, bool copy, cudaStream_t s) {
  if (steps <= 0 && copy) {
    return cudaMemcpyAsync(out, blur, sizeof(float) * (size_t)n * a.h * a.w,
                           cudaMemcpyDeviceToDevice, s);
  }
  if (steps <= 0) {
    a.x_out = out;
    first<<<dim3((a.w + kTile - 1) / kTile, (a.h + kTile - 1) / kTile, n), kMarchThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  const bool later = tile_launches(steps) > 1;  // the folded copy is read only by later launches
  a.gates_out = later ? folded_gates : nullptr;
  a.base_out = later ? folded_base : nullptr;
  a.x_out = out;
  return march_launches(first, cspn2d_tiled_kernel<false>, a, n, steps, s, x_scratch);
}

MarchArgs tiled_args(const void* guid, const void* blur, const void* sparse, int h, int w,
                     int norm_abs) {
  MarchArgs a{};
  a.gates = static_cast<const float*>(guid);
  a.base = static_cast<const float*>(blur);
  a.mask = static_cast<const float*>(sparse);
  a.x_in = a.base;
  a.h = h;
  a.w = w;
  a.norm_abs = norm_abs;
  return a;
}

}  // namespace

// Runs the whole forward on `stream`: ceil(steps / kHalo) tile launches.
// The caller allocates every buffer (contiguous f32): guid [n,8,h,w],
// blur/out/x_scratch/folded_base [n,h,w], folded_gates [n,8,h,w] (the
// first launch's folded gates and base, read by the later ones); sparse
// may be null.  Returns cudaGetLastError() after the first launch that
// fails, else 0.
extern "C" int cspn2d_tiled_f32(const float* guid, const float* blur, const float* sparse,
                                float* out, float* folded_gates, float* folded_base,
                                float* x_scratch, int n, int h, int w, int steps, int norm_abs,
                                void* stream) {
  return static_cast<int>(run_tiled(cspn2d_tiled_kernel<true>,
                                    tiled_args(guid, blur, sparse, h, w, norm_abs), blur, out,
                                    folded_gates, folded_base, x_scratch, n, steps, true,
                                    static_cast<cudaStream_t>(stream)));
}

// cspn2d_tiled_f32 on inputs each stored as its IoCode says (guid_io,
// blur_io, sparse_io: float32 as it is, float32 rounded to bf16 in
// registers, or bf16; contiguous, the same shapes), the output and the
// scratch buffers float32.  At steps <= 0 one launch writes blur as the
// kernel reads it.
extern "C" int cspn2d_tiled_io(const void* guid, const void* blur, const void* sparse,
                               int guid_io, int blur_io, int sparse_io, float* out,
                               float* folded_gates, float* folded_base, float* x_scratch, int n,
                               int h, int w, int steps, int norm_abs, void* stream) {
  MarchArgs a = tiled_args(guid, blur, sparse, h, w, norm_abs);
  a.io_g = guid_io;
  a.io_b = blur_io;
  a.io_s = sparse_io;
  return static_cast<int>(run_tiled(cspn2d_tiled_kernel<true, true>, a, blur, out, folded_gates,
                                    folded_base, x_scratch, n, steps, false,
                                    static_cast<cudaStream_t>(stream)));
}
