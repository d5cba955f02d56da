// The int8 convolution's glue for Hopper (sm_90a): the per-sample abs-max
// of the activation, its quantization fused with the padding and the
// im2col, and the dequantization of the int32 product.
//
// Replaces no TPU kernel.  The JAX package leaves its int8 conv to XLA
// (cspn_tpu/utils/quant.py:89-96, `lax.conv_general_dilated` with int32
// accumulation), which fuses the quantization into the convolution.  The
// port multiplies with `torch._int_mm` (cuBLASLt, s8 x s8 -> s32) on an
// im2col matrix, and before these kernels it built that matrix and the
// scales with ~14 PyTorch passes a conv (utils/quant.py:quantize_tensor,
// _taps, int8_matmul's padding, int8_conv_prequant's dequantization):
// abs, amax, a float32 copy, a division, round, clamp and an int8 cast of
// the input; a permuted and padded copy of it and `torch.stack` of the
// taps; and a float32 copy, a product and a bf16 cast of the output.
// ops/quant_cuda.py launches these three kernels instead, and every value
// they write equals, bit for bit, what those passes compute on the card:
//
//   act_absmax:   scale[n] = bf16(max(amax_n, bf16(1e-12)) * fl(1/127)),
//                 amax_n = max |x[n]| (bf16): quantize_tensor's scale, with
//                 `/ 127.0` as PyTorch computes a division by a host scalar
//                 on the card, a product with its float32 reciprocal;
//   int8_taps:    A[(n, oh, ow), (i, j, c)] = q(x[n, c, oh*s + i - ph0,
//                 ow*s + j - pw0]), q(v) = clamp(rint(v / scale), -127,
//                 127) with the IEEE float32 quotient, 0 outside the image,
//                 in the pad rows (to 17: `_int_mm` takes more than 16)
//                 and in the pad columns (to K', a multiple of 8);
//   int8_dequant: y[n, oh, ow, o] = bf16(float(acc) * (xs[n] * ws[o])),
//                 the scales' product rounded to bf16 where both are bf16
//                 (the dynamic route), float32 where one is (the static);
//                 with its epilogue, relu?(bn(y) [+ residual]) in place of
//                 y: the serving BN's bf16 chain bf16(bf16(bf16(y -
//                 mean[o]) * mul[o]) + bias[o]) (models/resnet.py:
//                 NormInPromotedDtype, each op rounded as PyTorch's bf16
//                 elementwise kernels round it), then bf16(t + residual),
//                 then torch.relu's max(t, 0) with NaN passed.
//
// The activation is bf16 in channels-last memory (NHWC): the previous
// conv's dequantized output, normalized and rectified in its epilogue.
// The wrapper copies an input in another layout into it first.
//
// What bounds it on this card.  Bytes: the kernels do a few integer and
// float operations a byte.  A conv's ideal traffic is its bf16 input read
// once, the taps written once (kh*kw bytes an input value: the im2col
// that `_int_mm` needs), and the int32 product read and the bf16 output
// written once: at nyu_eval's 228x304 ResNet-50 CSPN-UNet, 64 convs (82
// products), ~0.58 GB a frame with the product's own A read and int32
// write, against ~1.94 GB a frame for the PyTorch passes.
//
// What this design does about it.  Each kernel moves each byte once,
// 16 bytes a thread where the shape allows it, and keeps every
// intermediate in registers.  act_absmax reads the input once (16-byte
// vectors, half-word integer maxima of |x|'s bits) into a float32 [N]
// buffer by atomics, and the last block to finish forms the N scales; the
// wrapper's buffer is zeroed by a memset in the same stream, so the pair
// is captured in a CUDA graph like any launch.  int8_taps gives a thread
// 16 (C a multiple of 16) or 8 (of 8) channels of one tap of one output
// pixel: one or two 16-byte loads of the bf16 input, quantized in
// registers, one 16- or 8-byte store into A; other C take a scalar path, 8
// columns a thread.  The kh*kw reads of an input value come from the L2
// after the first, so device memory sees the input about once.  A 1x1
// stride-1 conv is the kh = kw = 1 case: A is the quantized NHWC input.
// int8_dequant gives a thread 8 output channels of one pixel: two 16-byte
// loads of int32, one 16-byte store of bf16 (scalar stores where O is no
// multiple of 8), written NHWC-contiguous, the layout the PyTorch route
// gave.  Its epilogue (compile-time flags: BN, residual, ReLU) reads the
// BN's three [O] parameters and the residual's 8 channels (NHWC) with one
// 16-byte load each, as it reads the weight scales, and keeps each rounded
// step in a register: the three strided bf16 passes of the BN, the
// residual add and the ReLU that followed it, each a read and a write of
// the whole output, are gone.  The [O] vectors stay packed until used:
// over a nyu b128 forward's 82 dequantizations the kernel took 9.19 ms
// with them loaded a value at a time, 8.83 with 16-byte loads into float32
// arrays, 8.35 packed, against 5.90 by its bytes and 5.82 for the kernel
// without the epilogue (H100 SXM; rounding two values a conversion gained
// nothing).  Indices are divided by multiply-high (FastDiv) with divisors
// fixed a launch.  What it leaves open: the taps themselves (kh*kw bytes
// an input value, written and read back by the product), which only an
// implicit-GEMM kernel reading the input in its main loop would remove.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinRows = 17;          // `_int_mm` on the card takes more than 16 rows
constexpr long long kAbsmaxBlocks = 1024;  // blocks an abs-max launch aims at, over its samples
constexpr long long kAbsmaxMinElems = 8192;  // the fewest values a block reduces

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (d >= 1).
struct FastDiv {
  unsigned d, mul, shift;
};

FastDiv make_fastdiv(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned p = 0;
    while ((1u << p) < d) ++p;  // ceil(log2 d)
    f.mul = static_cast<unsigned>(((1ull << (31 + p)) + d - 1) / d);
    f.shift = p - 1;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shift);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// A bf16 value's float32, from the 16 bits in the low or high half of a word.
__device__ __forceinline__ float lo_bf16(unsigned word) { return __uint_as_float(word << 16); }
__device__ __forceinline__ float hi_bf16(unsigned word) { return __uint_as_float(word & 0xffff0000u); }

// quantize_tensor's q: rint(v / scale) clipped to +-127, v / scale the
// IEEE float32 quotient, and NaN cast to 0, as the PyTorch route's float ->
// int8 conversion gives it.  The quotient is not a division: `inv` is the
// correctly rounded 1 / scale (once a thread), q0 = v * inv is within an
// ulp of v / scale, and one correction by the exact remainder (two FMAs)
// gives the correctly rounded quotient (Markstein's theorem) wherever it
// and the remainder are normal.  Where they are not, the quotient is below
// 2^-100 and rounds to 0 either way; where |q0| >= 256 only its sign
// matters.  (IEEE division checks its operands' range and takes a slow
// path for a zero, half of a ReLU's output: at a nyu b128 3x3 conv on such
// an input it took 0.645 ms against this quotient's 0.264, H100 SXM.)
__device__ __forceinline__ int quantize(float v, float scale, float inv) {
  const float q0 = __fmul_rn(v, inv);
  if (!(fabsf(q0) < 256.0f)) return q0 != q0 ? 0 : q0 > 0.0f ? 127 : -127;
  const float q = rintf(__fmaf_rn(__fmaf_rn(-q0, scale, v), inv, q0));
  if (q != q) return 0;
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// Four int8 values, the first in the lowest byte.
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (static_cast<unsigned>(a) & 0xffu) | ((static_cast<unsigned>(b) & 0xffu) << 8) |
         ((static_cast<unsigned>(c) & 0xffu) << 16) | (static_cast<unsigned>(d) << 24);
}

// Eight bf16 values (one 16-byte load) quantized into two words.
__device__ __forceinline__ uint2 quantize8(const uint4 v, float s, float inv) {
  return make_uint2(pack4(quantize(lo_bf16(v.x), s, inv), quantize(hi_bf16(v.x), s, inv),
                          quantize(lo_bf16(v.y), s, inv), quantize(hi_bf16(v.y), s, inv)),
                    pack4(quantize(lo_bf16(v.z), s, inv), quantize(hi_bf16(v.z), s, inv),
                          quantize(lo_bf16(v.w), s, inv), quantize(hi_bf16(v.w), s, inv)));
}

// quantize_tensor's scale from the sample's abs-max: clamp_min(1e-12) in
// bf16 (NaN passes), then `/ 127.0`, which PyTorch computes on the card as
// a product with the float32 reciprocal of 127 (a division by a host
// scalar), rounded to bf16.
__device__ __forceinline__ __nv_bfloat16 act_scale(float amax) {
  const float lo = __bfloat162float(__float2bfloat16_rn(1e-12f));
  const float c = amax != amax ? amax : fmaxf(amax, lo);
  return __float2bfloat16_rn(__fmul_rn(c, 1.0f / 127.0f));
}

// One block reduces values [lo, lo + per_block) of sample blockIdx.y into
// work[sample] (the float32 bits of the bf16 abs-max: non-negative, so
// their unsigned order is their order; a NaN's bits exceed infinity's).
// The last block of the launch to finish (work[n] counts them) writes the
// n scales.
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const uint16_t* __restrict__ x, long long sample_elems, long long per_block,
                  unsigned* __restrict__ work, int n, __nv_bfloat16* __restrict__ scale) {
  const int sample = blockIdx.y;
  const long long lo = blockIdx.x * per_block;
  const long long len = min(per_block, sample_elems - lo);
  const uint16_t* p = x + sample * sample_elems + lo;
  unsigned m = 0, m2 = 0;  // |x|'s bits; m2 in each half-word
  long long head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 2;
  head = min(head, len);
  for (long long i = threadIdx.x; i < head; i += kThreads) m = max(m, p[i] & 0x7fffu);
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const long long vectors = (len - head) / 8;
  for (long long i = threadIdx.x; i < vectors; i += kThreads) {
    const uint4 q = __ldg(v + i);
    m2 = __vmaxu2(m2, q.x & 0x7fff7fffu);
    m2 = __vmaxu2(m2, q.y & 0x7fff7fffu);
    m2 = __vmaxu2(m2, q.z & 0x7fff7fffu);
    m2 = __vmaxu2(m2, q.w & 0x7fff7fffu);
  }
  for (long long i = head + vectors * 8 + threadIdx.x; i < len; i += kThreads)
    m = max(m, p[i] & 0x7fffu);
  m = max(m, max(m2 & 0xffffu, m2 >> 16));
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ bool last;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) m = max(m, warp_max[i]);
    atomicMax(work + sample, m << 16);
    __threadfence();
    last = atomicAdd(work + n, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n; i += kThreads)
    scale[i] = act_scale(__uint_as_float(*reinterpret_cast<volatile unsigned*>(work + i)));
}

// A taps launch's shapes.  A thread takes one group: V columns (V = 16 or
// 8 channels of one tap, C a multiple of V; V = 0: 8 columns of any taps)
// of one row of A.
struct TapsGeom {
  int h, w, c, kw, stride, ph0, pw0, ho, wo, m, k, k_pad, groups;
  FastDiv row;   // groups a row
  FastDiv tap;   // groups a tap (C / V)
  FastDiv wo_d, ho_d, kw_d;
};

template <int V, typename S>
__global__ void __launch_bounds__(kThreads)
    taps_kernel(const __nv_bfloat16* __restrict__ x, const S* __restrict__ scale, int per_sample,
                int8_t* __restrict__ a, const TapsGeom g) {
  const int gi = blockIdx.x * kThreads + threadIdx.x;
  if (gi >= g.groups) return;
  const int r = fdiv(gi, g.row);
  const int grp = gi - r * static_cast<int>(g.row.d);
  constexpr int kCols = V == 16 ? 16 : 8;
  int8_t* out = a + static_cast<long long>(r) * g.k_pad + grp * kCols;
  if (r >= g.m) {  // a pad row
    if constexpr (kCols == 16) *reinterpret_cast<uint4*>(out) = make_uint4(0, 0, 0, 0);
    else *reinterpret_cast<uint2*>(out) = make_uint2(0, 0);
    return;
  }
  const int t = fdiv(r, g.wo_d), ow = r - t * g.wo;
  const int nn = fdiv(t, g.ho_d), oh = t - nn * g.ho;
  const float s = to_float(scale[per_sample ? nn : 0]), inv = __frcp_rn(s);
  const int ih0 = oh * g.stride - g.ph0, iw0 = ow * g.stride - g.pw0;
  if constexpr (V == 0) {  // any C: each column on its own
    int q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = grp * 8 + e;
      q[e] = 0;
      if (k < g.k) {
        const int tap = k / g.c, c = k - tap * g.c;
        const int i = tap / g.kw, j = tap - i * g.kw;
        const int ih = ih0 + i, iw = iw0 + j;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          q[e] = quantize(__bfloat162float(
                              x[((static_cast<long long>(nn) * g.h + ih) * g.w + iw) * g.c + c]),
                          s, inv);
      }
    }
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  } else {
    const int tap = fdiv(grp, g.tap);
    const int c0 = (grp - tap * static_cast<int>(g.tap.d)) * V;
    const int i = fdiv(tap, g.kw_d), j = tap - i * g.kw;
    const int ih = ih0 + i, iw = iw0 + j;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;  // bf16 zeros quantize to 0
    if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
      const uint4* src = reinterpret_cast<const uint4*>(
          x + ((static_cast<long long>(nn) * g.h + ih) * g.w + iw) * g.c + c0);
      lo = __ldg(src);
      if constexpr (V == 16) hi = __ldg(src + 1);
    }
    const uint2 q0 = quantize8(lo, s, inv);
    if constexpr (V == 16) {
      const uint2 q1 = quantize8(hi, s, inv);
      *reinterpret_cast<uint4*>(out) = make_uint4(q0.x, q0.y, q1.x, q1.y);
    } else {
      *reinterpret_cast<uint2*>(out) = q0;
    }
  }
}

// A dequantize launch's shapes: a thread takes 8 output channels of one
// row (pixel) of the product.
struct DequantGeom {
  int m, o, o_pad, groups;
  FastDiv row;   // groups a row, ceil(O / 8)
  FastDiv howo;  // rows a sample
  int vec;       // O a multiple of 8 and the [O] vectors 16-byte aligned: vector loads
};

// Eight values of an [O] vector from channel o0, kept as loaded (bf16
// pairs in words, or float32) and read as float32 where they are used:
// one 16-byte load (two for float32) where `vec`, else one value at a
// time, the channels past O read as the last.
struct Bf16x8 {
  uint4 q;
  __device__ __forceinline__ float operator[](int e) const {
    const unsigned w = e < 2 ? q.x : e < 4 ? q.y : e < 6 ? q.z : q.w;
    return e & 1 ? hi_bf16(w) : lo_bf16(w);
  }
};

struct F32x8 {
  float4 a, b;
  __device__ __forceinline__ float operator[](int e) const {
    const float4& h = e < 4 ? a : b;
    const int i = e & 3;
    return i == 0 ? h.x : i == 1 ? h.y : i == 2 ? h.z : h.w;
  }
};

__device__ __forceinline__ Bf16x8 load8(const __nv_bfloat16* p, int o0, int o, int vec) {
  if (vec) return {__ldg(reinterpret_cast<const uint4*>(p + o0))};
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = u[min(o0 + 2 * i, o - 1)] | static_cast<unsigned>(u[min(o0 + 2 * i + 1, o - 1)]) << 16;
  return {make_uint4(w[0], w[1], w[2], w[3])};
}

__device__ __forceinline__ F32x8 load8(const float* p, int o0, int o, int vec) {
  if (vec) {
    const float4* v = reinterpret_cast<const float4*>(p + o0);
    return {__ldg(v), __ldg(v + 1)};
  }
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = p[min(o0 + e, o - 1)];
  return {make_float4(f[0], f[1], f[2], f[3]), make_float4(f[4], f[5], f[6], f[7])};
}

// The epilogue's operands: the serving BN's bf16 parameters [O] (mul =
// rsqrt(var + eps) * weight, as the BN forms it) and the residual [m, O]
// (NHWC, 16-byte aligned), where kMode asks for them.
struct Epilogue {
  const __nv_bfloat16* mean;
  const __nv_bfloat16* mul;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* residual;
};

// kMode's bits: the BN, then the residual added, then the ReLU.
constexpr int kBn = 1, kResidual = 2, kRelu = 4;

// A float32 result rounded to bf16, as each of PyTorch's bf16 elementwise
// ops rounds its float32 one, and read back.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename XS, typename WS, int kMode>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int* __restrict__ acc, const XS* __restrict__ xs, int xs_per_sample,
                   const WS* __restrict__ ws, const Epilogue ep, __nv_bfloat16* __restrict__ out,
                   const DequantGeom g) {
  // the scales' product rounds to bf16 where both are bf16, as PyTorch's
  // `xs * ws` of two bf16 tensors does
  constexpr bool kRound = sizeof(XS) == 2 && sizeof(WS) == 2;
  const int gi = blockIdx.x * kThreads + threadIdx.x;
  if (gi >= g.groups) return;
  const int r = fdiv(gi, g.row);
  const int o0 = (gi - r * static_cast<int>(g.row.d)) * 8;
  const int4* src = reinterpret_cast<const int4*>(acc + static_cast<long long>(r) * g.o_pad + o0);
  const int4 a0 = __ldg(src), a1 = __ldg(src + 1);
  const int v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float x_scale = to_float(xs[xs_per_sample ? fdiv(r, g.howo) : 0]);
  const auto w_scale = load8(ws, o0, g.o, g.vec);
  Bf16x8 mean{}, mul{}, bias{};
  if constexpr ((kMode & kBn) != 0) {
    mean = load8(ep.mean, o0, g.o, g.vec);
    mul = load8(ep.mul, o0, g.o, g.vec);
    bias = load8(ep.bias, o0, g.o, g.vec);
  }
  const long long at = static_cast<long long>(r) * g.o + o0;
  alignas(16) __nv_bfloat16 res[8];
  if constexpr ((kMode & kResidual) != 0) {
    if (g.o % 8 == 0) {
      *reinterpret_cast<uint4*>(res) = __ldg(reinterpret_cast<const uint4*>(ep.residual + at));
    } else {
      for (int e = 0; e < 8; ++e) res[e] = ep.residual[at + min(e, g.o - 1 - o0)];
    }
  }
  alignas(16) __nv_bfloat16 y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float p = __fmul_rn(x_scale, w_scale[e]);
    if constexpr (kRound) p = bf16_round(p);
    float t = __fmul_rn(__int2float_rn(v[e]), p);
    if constexpr ((kMode & kBn) != 0) {
      // NormInPromotedDtype's bf16 chain, each op rounded in turn
      t = bf16_round(__fsub_rn(bf16_round(t), mean[e]));
      t = bf16_round(__fmul_rn(t, mul[e]));
      t = bf16_round(__fadd_rn(t, bias[e]));
    }
    if constexpr ((kMode & kResidual) != 0) t = bf16_round(__fadd_rn(t, __bfloat162float(res[e])));
    // torch.relu: NaN passes, else max(t, 0)
    if constexpr ((kMode & kRelu) != 0) t = t != t ? t : fmaxf(t, 0.0f);
    y[e] = __float2bfloat16_rn(t);
  }
  __nv_bfloat16* dst = out + at;
  if (g.o % 8 == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(y);
  } else {
    for (int e = 0; e < 8 && o0 + e < g.o; ++e) dst[e] = y[e];
  }
}

int blocks(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

template <int V, typename S>
int launch_taps(const void* x, const void* scale, int per_sample, void* a, const TapsGeom& g,
                cudaStream_t s) {
  taps_kernel<V, S><<<blocks(g.groups), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const S*>(scale), per_sample,
      static_cast<int8_t*>(a), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename XS, typename WS, int kMode>
int launch_dequant_mode(const void* acc, const void* xs, int xs_per_sample, const void* ws,
                        const Epilogue& ep, void* out, const DequantGeom& g, cudaStream_t s) {
  dequant_kernel<XS, WS, kMode><<<blocks(g.groups), kThreads, 0, s>>>(
      static_cast<const int*>(acc), static_cast<const XS*>(xs), xs_per_sample,
      static_cast<const WS*>(ws), ep, static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of an epilogue: `mode` one of none, BN, BN + ReLU, BN +
// residual, BN + residual + ReLU.
template <typename XS, typename WS>
int launch_dequant(const void* acc, const void* xs, int xs_per_sample, const void* ws,
                   const Epilogue& ep, int mode, void* out, const DequantGeom& g, cudaStream_t s) {
  constexpr int kBnRelu = kBn | kRelu, kBnRes = kBn | kResidual, kAll = kBn | kResidual | kRelu;
  switch (mode) {
    case 0: return launch_dequant_mode<XS, WS, 0>(acc, xs, xs_per_sample, ws, ep, out, g, s);
    case kBn: return launch_dequant_mode<XS, WS, kBn>(acc, xs, xs_per_sample, ws, ep, out, g, s);
    case kBnRelu:
      return launch_dequant_mode<XS, WS, kBnRelu>(acc, xs, xs_per_sample, ws, ep, out, g, s);
    case kBnRes:
      return launch_dequant_mode<XS, WS, kBnRes>(acc, xs, xs_per_sample, ws, ep, out, g, s);
    case kAll: return launch_dequant_mode<XS, WS, kAll>(acc, xs, xs_per_sample, ws, ep, out, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n samples of sample_elems bf16 values each, contiguous (any layout
// within a sample); work: n + 1 unsigned words of scratch; scale: n bf16
// out.  Zeroes work and launches once on `stream`.  Returns the last
// cudaError_t, or cudaErrorInvalidValue for an empty input or n past a
// grid's y extent.
extern "C" int act_absmax(const void* x, long long sample_elems, int n, void* work, void* scale,
                          void* stream) {
  if (sample_elems <= 0 || n <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = cudaMemsetAsync(work, 0, (n + 1ull) * sizeof(unsigned), s))
    return static_cast<int>(e);
  const long long split = kAbsmaxBlocks / n > 1 ? kAbsmaxBlocks / n : 1;  // blocks a sample
  long long per_block = (sample_elems + split - 1) / split;
  per_block = per_block > kAbsmaxMinElems ? per_block : kAbsmaxMinElems;
  per_block = (per_block + 7) / 8 * 8;  // blocks start where their sample's vectors do
  const long long per_sample = (sample_elems + per_block - 1) / per_block;
  absmax_kernel<<<dim3(static_cast<unsigned>(per_sample), n), kThreads, 0, s>>>(
      static_cast<const uint16_t*>(x), sample_elems, per_block, static_cast<unsigned*>(work), n,
      static_cast<__nv_bfloat16*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// x: [n, h, w, c] bf16 (NHWC, contiguous); scale: bf16 (scale_f32 0) or
// float32 (1), one a sample (per_sample 1) or one for all; a: [m_pad,
// k_pad] int8 out, m_pad = max(n*ho*wo, 17), k_pad >= kh*kw*c a multiple
// of 8.  One launch on `stream`.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes outside those (or past 32-bit groups).
extern "C" int int8_taps(const void* x, const void* scale, int scale_f32, int per_sample, void* a,
                         int n, int h, int w, int c, int kh, int kw, int stride, int ph0, int pw0,
                         int ho, int wo, int m_pad, int k_pad, void* stream) {
  const long long m = static_cast<long long>(n) * ho * wo;
  const long long k = static_cast<long long>(kh) * kw * c;
  if (n <= 0 || c <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || ho <= 0 || wo <= 0 ||
      k_pad % 8 != 0 || k_pad < k || m_pad != (m > kMinRows ? m : kMinRows))
    return static_cast<int>(cudaErrorInvalidValue);
  // the vector paths: 16-byte loads, and no pad columns
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && k_pad == k;
  const int v = !vec ? 0 : c % 16 == 0 ? 16 : c % 8 == 0 ? 8 : 0;
  const int cols = v == 16 ? 16 : 8;
  const long long groups = static_cast<long long>(m_pad) * (k_pad / cols);
  if (groups >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  TapsGeom g{h, w, c, kw, stride, ph0, pw0, ho, wo, static_cast<int>(m), static_cast<int>(k),
             k_pad, static_cast<int>(groups), make_fastdiv(k_pad / cols),
             make_fastdiv(v ? c / v : 1), make_fastdiv(wo), make_fastdiv(ho), make_fastdiv(kw)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale_f32) {
    if (v == 16) return launch_taps<16, float>(x, scale, per_sample, a, g, s);
    if (v == 8) return launch_taps<8, float>(x, scale, per_sample, a, g, s);
    return launch_taps<0, float>(x, scale, per_sample, a, g, s);
  }
  if (v == 16) return launch_taps<16, __nv_bfloat16>(x, scale, per_sample, a, g, s);
  if (v == 8) return launch_taps<8, __nv_bfloat16>(x, scale, per_sample, a, g, s);
  return launch_taps<0, __nv_bfloat16>(x, scale, per_sample, a, g, s);
}

// acc: [>= m, o_pad] int32 (row-major, o_pad a multiple of 8); xs: bf16
// (xs_f32 0) or float32 (1), one a sample of howo rows (xs_per_sample 1)
// or one for all; ws: [o] bf16 (ws_f32 0) or float32 (1); mean, mul,
// bias: [o] bf16, or all null for no BN; residual: [m, o] bf16 (16-byte
// aligned) or null; relu 0 or 1; out: [m, o] bf16.  The epilogue's
// residual and ReLU take the BN.  One launch on `stream`.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes or an epilogue
// outside those.
extern "C" int int8_dequant(const void* acc, int o_pad, const void* xs, int xs_f32,
                            int xs_per_sample, const void* ws, int ws_f32, const void* mean,
                            const void* mul, const void* bias, const void* residual, int relu,
                            void* out, int m, int howo, int o, void* stream) {
  if (m <= 0 || o <= 0 || howo <= 0 || o_pad % 8 != 0 || o_pad < o)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bn = mean && mul && bias;
  if (!bn && (mean || mul || bias || residual || relu))
    return static_cast<int>(cudaErrorInvalidValue);
  if (residual && (o % 8 == 0) && reinterpret_cast<uintptr_t>(residual) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = static_cast<long long>(m) * ((o + 7) / 8);
  if (groups >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return !p || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = o % 8 == 0 && aligned(ws) && aligned(mean) && aligned(mul) && aligned(bias);
  const DequantGeom g{m, o, o_pad, static_cast<int>(groups), make_fastdiv((o + 7) / 8),
                      make_fastdiv(howo), vec};
  const Epilogue ep{static_cast<const __nv_bfloat16*>(mean), static_cast<const __nv_bfloat16*>(mul),
                    static_cast<const __nv_bfloat16*>(bias),
                    static_cast<const __nv_bfloat16*>(residual)};
  const int mode = (bn ? kBn : 0) | (residual ? kResidual : 0) | (relu ? kRelu : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xs_f32) {
    return ws_f32 ? launch_dequant<float, float>(acc, xs, xs_per_sample, ws, ep, mode, out, g, s)
                  : launch_dequant<float, __nv_bfloat16>(acc, xs, xs_per_sample, ws, ep, mode, out,
                                                         g, s);
  }
  return ws_f32 ? launch_dequant<__nv_bfloat16, float>(acc, xs, xs_per_sample, ws, ep, mode, out,
                                                       g, s)
                : launch_dequant<__nv_bfloat16, __nv_bfloat16>(acc, xs, xs_per_sample, ws, ep,
                                                               mode, out, g, s);
}
