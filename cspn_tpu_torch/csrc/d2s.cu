// 2x depth-to-space and its adjoint (space-to-depth) for the subpixel
// decoder, for Hopper (sm_90a).
//
// Replaces the TPU kernels cspn_tpu/ops/d2s_pallas.py:_d2s_kernel (launched
// by _d2s_impl) and _s2d_kernel (launched by _s2d_impl, the backward of the
// custom VJP _d2s).  NCHW, with the JAX package's px-major phase channels
// and a crop to (oh, ow) <= (2h, 2w):
//
//   d2s: out[n, c, 2y+py, 2x+px] = in[n, (px*2+py)*C + c, y, x]
//   s2d: g[n, (px*2+py)*C + c, y, x] = ct[n, c, 2y+py, 2x+px],
//        or 0 where 2y+py >= oh or 2x+px >= ow (the adjoint of the crop).
//
// What bounds it on this card.  Both kernels move values and compute
// nothing, so bytes bound them: d2s must read and write the N*C*oh*ow
// values it keeps, s2d read those and write N*4C*h*w.  The nine d2s calls
// of a b8 nyu_eval forward (ResNet-50, 228x304) keep 54.2 M f32 values:
// 433 MB, 0.13 ms at the H100 SXM's 3.35 TB/s.
//
// What this design does about it.  A gather with one thread per output
// element in a grid-stride loop: neighbouring threads write neighbouring
// addresses, so every store is coalesced; a warp's d2s loads fall in two
// input rows (px = 0 and 1), its s2d loads on every other element of one
// cotangent row, which the L2 serves to the warp that reads the other
// half.  The element type is a template over 2-, 4- and 8-byte unsigned
// integers: the kernels move bits, so they are exact for every dtype of
// those sizes (bf16, f32, f64).  Not carried over from the TPU kernels:
// their permutation matmuls on the MXU, which Mosaic needed for want of
// lane/sublane shape casts.  Left open: vector loads and stores, and
// taking the phase-split convs' four outputs directly instead of their
// concatenation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100 SXM; the loop strides over the rest

// One output element per loop turn; index arithmetic in 32 bits (the
// wrapper refuses tensors of 2^31 elements or more).
template <typename T>
__global__ void d2s_copy_kernel(const T* __restrict__ in, T* __restrict__ out, unsigned c,
                                unsigned h, unsigned w, unsigned oh, unsigned ow,
                                unsigned total) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned row = i / ow, ox = i - row * ow;
    const unsigned plane = row / oh, oy = row - plane * oh;  // plane = n*C + ch
    const unsigned n = plane / c;
    const unsigned phase = (ox & 1u) * 2u + (oy & 1u);
    // input plane n*4C + phase*C + ch = plane + 3*n*C + phase*C
    const unsigned src_plane = plane + (3u * n + phase) * c;
    out[i] = in[(src_plane * h + (oy >> 1)) * w + (ox >> 1)];
  }
}

template <typename T>
__global__ void s2d_copy_kernel(const T* __restrict__ ct, T* __restrict__ out, unsigned c,
                                unsigned h, unsigned w, unsigned oh, unsigned ow,
                                unsigned total) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned row = i / w, x = i - row * w;
    const unsigned plane = row / h, y = row - plane * h;  // plane = n*4C + phase*C + ch
    const unsigned nc4 = plane / c, ch = plane - nc4 * c;  // nc4 = n*4 + phase
    const unsigned n = nc4 >> 2, phase = nc4 & 3u;
    const unsigned oy = 2u * y + (phase & 1u), ox = 2u * x + (phase >> 1);
    out[i] = (oy < oh && ox < ow) ? ct[((n * c + ch) * oh + oy) * ow + ox] : T(0);
  }
}

template <typename T>
int launch_d2s(const void* in, void* out, int n, int c, int h, int w, int oh, int ow,
               cudaStream_t s) {
  const unsigned total = (unsigned)n * c * oh * ow;
  if (total == 0) return 0;
  const unsigned blocks = (total + kThreads - 1) / kThreads;
  d2s_copy_kernel<T><<<blocks < kMaxBlocks ? blocks : kMaxBlocks, kThreads, 0, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), c, h, w, oh, ow, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_s2d(const void* ct, void* out, int n, int c, int h, int w, int oh, int ow,
               cudaStream_t s) {
  const unsigned total = (unsigned)n * 4u * c * h * w;
  if (total == 0) return 0;
  const unsigned blocks = (total + kThreads - 1) / kThreads;
  s2d_copy_kernel<T><<<blocks < kMaxBlocks ? blocks : kMaxBlocks, kThreads, 0, s>>>(
      static_cast<const T*>(ct), static_cast<T*>(out), c, h, w, oh, ow, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in [n, 4c, h, w] -> out [n, c, oh, ow], both contiguous, elements of
// `elem_bytes` bytes (2, 4 or 8); one launch on `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for another
// element size.
extern "C" int d2s(const void* in, void* out, int n, int c, int h, int w, int oh, int ow,
                   int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return launch_d2s<uint16_t>(in, out, n, c, h, w, oh, ow, s);
    case 4: return launch_d2s<uint32_t>(in, out, n, c, h, w, oh, ow, s);
    case 8: return launch_d2s<uint64_t>(in, out, n, c, h, w, oh, ow, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ct [n, c, oh, ow] -> out [n, 4c, h, w], zeros past the crop; as d2s.
extern "C" int s2d(const void* ct, void* out, int n, int c, int h, int w, int oh, int ow,
                   int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return launch_s2d<uint16_t>(ct, out, n, c, h, w, oh, ow, s);
    case 4: return launch_s2d<uint32_t>(ct, out, n, c, h, w, oh, ow, s);
    case 8: return launch_s2d<uint64_t>(ct, out, n, c, h, w, oh, ow, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
