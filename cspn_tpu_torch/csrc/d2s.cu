// 2x depth-to-space and its adjoint (space-to-depth) for the subpixel
// decoder, for Hopper (sm_90a).
//
// Replaces the TPU kernels cspn_tpu/ops/d2s_pallas.py:_d2s_kernel (launched
// by _d2s_impl) and _s2d_kernel (launched by _s2d_impl, the backward of the
// custom VJP _d2s).  NCHW, the four phases px-major (phase k = px*2 + py),
// a crop to (oh, ow) <= (2h, 2w):
//
//   d2s: out[n, c, 2y+py, 2x+px] = P_k[n, c, y, x]
//   s2d: G_k[n, c, y, x] = ct[n, c, 2y+py, 2x+px],
//        or 0 where 2y+py >= oh or 2x+px >= ow (the adjoint of the crop).
//
// P_k and G_k are given as four base pointers and a sample stride in
// elements: the four phase convs' own [N, C, h, w] outputs (stride C*h*w),
// so that nothing concatenates them first, or one [N, 4C, h, w] tensor
// (phase k at offset k*C*h*w, stride 4C*h*w).
//
// What bounds it on this card.  Both kernels move values and compute
// nothing, so bytes bound them: d2s must read and write the N*C*oh*ow
// values the crop keeps, s2d read those and write N*4C*h*w.  The nine d2s
// calls of a b8 nyu_eval forward (ResNet-50, 228x304) keep 54.2 M values:
// 217 MB read and written at bf16, 0.065 ms at the H100 SXM's 3.35 TB/s.
//
// What this design does about it.  A block takes a tile: one sample's
// range of R input rows (c, y).  For each phase those rows are one
// contiguous span, and their output rows (c, 2y) and (c, 2y+1) inside the
// crop are one contiguous span of whole rows, since the rows of one channel
// follow each other in the output as in the input.  The block copies its
// spans in with cp.async (d2s: the four phase spans; s2d: the cotangent
// span), interleaves them within shared memory a 16-byte vector of the
// output (or cotangent) span a thread, and after a barrier writes its
// output spans out with 16-byte stores.  Interleaving within shared memory
// first, and storing after, measured faster than storing each vector as it
// was gathered.  A thread finds the row and column of its vector's first
// value by a multiply-high division (FastDiv, divisor fixed per launch);
// a vector inside one output row takes its values alternately from the
// two phases of the row's py, from column ox / 2 on, and one that crosses
// a row steps through them with counters.  d2s gathers a vector's values
// (neighbouring threads 8 bytes apart in a phase: a 2-way bank conflict),
// s2d scatters a cotangent vector's values into the four phase spans laid
// out as in device memory (again 2-way) and copies those out whole:
// gathering each phase from the cotangent instead would read every other
// value, 32 bytes apart from thread to thread, an 8-way conflict.  Where
// the crop cut, s2d scatters nothing and the phase buffers start at zero.
// Rows of 19, 38 or 76 bf16 values and phase offsets of h*w values are not
// 16-byte aligned, so each span keeps its offset within 16 bytes in shared
// memory: the copies in are whole 16-byte vectors, from the vector that
// holds a span's first value to the one that holds its last (the bytes of
// those two outside the span lie in the same 16-byte granule of the same
// allocation, and are read and never used); the stores are whole vectors
// but at a span's two ends, where they go value by value.  R keeps a
// phase's span near 4 KB and is cut further so that a stage gives at least
// 4 blocks per SM where it has the rows: layer1 of a b1 forward has 0.29 M
// values.  These sizes measured best among 2, 4 and 8 KB spans, 4 and 8
// blocks per SM and 128, 256 and 512 threads; a persistent grid copying
// the next tile in while writing the current one measured slower.  The
// element type is a template over 2-, 4- and 8-byte unsigned integers: the
// kernels move bits, so they are exact for every dtype of those sizes
// (bf16, f32, f64).  TMA (cp.async.bulk) is not used: it needs 16-byte-
// aligned addresses and sizes, which these spans lack.  Not carried over
// from the TPU kernels: their permutation matmuls on the MXU, which Mosaic
// needed for want of lane/sublane shape casts.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;
constexpr int kSpanBytes = 4096;  // a phase's span in a tile, about
constexpr int kBlocksPerSm = 4;   // the least a stage is cut into, per SM, where it has the rows
constexpr int kMaxSmem = 232448;  // shared memory a block may take on an H100

// n / d for n < 2^31 by a multiply-high and a shift (d >= 1).
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

// A launch's shapes: a block takes sample blockIdx.x / tiles and input
// rows [r0, r0 + rows_per_tile) of its rows = C*h.
struct Geom {
  unsigned long long sample_stride;  // elements between samples of a phase
  int c, h, w, oh, ow, rows, rows_per_tile, tiles;
  int cap;     // elements of one phase span's shared-memory buffer
  int cap_ct;  // elements of the output (d2s) or cotangent (s2d) span's buffer
  FastDiv div_h, div_oh, div_ow, div_tiles;
};

template <typename T>
struct Ptrs {
  T* p[4];
};

// Offset of an element address within its 16-byte vector, in elements.
template <typename T>
__device__ __forceinline__ int lead_of(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) % kVecBytes) / sizeof(T));
}

// The first output row (c*oh + oy, within a sample) of input row r = c*h + y.
__device__ __forceinline__ int first_out_row(int r, const Geom& g) {
  const int c = fdiv(r, g.div_h), y = r - c * g.h;
  return c * g.oh + min(2 * y, g.oh);
}

// The first vector a thread takes of a span whose vectors follow `before`
// others in the block's work: the block's threads deal the vectors of its
// spans round in one sequence.
__device__ __forceinline__ int first_vector(int before) {
  return (static_cast<int>(threadIdx.x) - before % kThreads + kThreads) % kThreads;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of a span of `len` elements at `src` into dst, whole
// 16-byte vectors from the one holding src[0] to the one holding
// src[len - 1], so that dst[lead_of(src) + i] = src[i]; the block's threads
// take its vectors from the `before`th on.  Returns the span's vectors.
template <typename T>
__device__ __forceinline__ int stage_span(const T* src, T* dst, int len, int before) {
  constexpr int V = kVecBytes / sizeof(T);
  const int lead = lead_of(src);
  const T* first = src - lead;  // 16-byte aligned: the vector holding src[0]
  const int vectors = (lead + len + V - 1) / V;
  for (int q = first_vector(before); q < vectors; q += kThreads)
    cp_async16(dst + q * V, first + q * V);
  return vectors;
}

// The values of vector q of an output span of `len` elements at `dst`
// (first element `lead` into its vector), as one store where the vector
// lies wholly inside the span, value by value at its ends.
template <typename T>
__device__ __forceinline__ void store_vector(T* dst, int lead, int len, int q, const uint4& v) {
  constexpr int V = kVecBytes / sizeof(T);
  const int i0 = q * V - lead;
  if (i0 >= 0 && i0 + V <= len) {
    *reinterpret_cast<uint4*>(dst + i0) = v;
  } else {
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = i0 + j;
      if (i >= 0 && i < len) dst[i] = e[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) d2s_kernel(Ptrs<const T> in, T* __restrict__ out,
                                                       Geom g) {
  constexpr int V = kVecBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* s = reinterpret_cast<T*>(smem_bytes);
  const int n = fdiv(blockIdx.x, g.div_tiles);
  const int r0 = (blockIdx.x - n * g.tiles) * g.rows_per_tile;
  const int r1 = min(r0 + g.rows_per_tile, g.rows);
  const int len = (r1 - r0) * g.w;

  int lead[4], before = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T* src = in.p[k] + n * g.sample_stride + static_cast<size_t>(r0) * g.w;
    lead[k] = lead_of(src);
    before += stage_span(src, s + k * g.cap, len, before);
  }
  cp_async_wait_all();
  __syncthreads();

  const int orow0 = first_out_row(r0, g);
  const int olen = (first_out_row(r1, g) - orow0) * g.ow;
  T* dst = out + static_cast<size_t>(n) * g.c * g.oh * g.ow + static_cast<size_t>(orow0) * g.ow;
  const int olead = lead_of(dst);
  const int vectors = (olead + olen + V - 1) / V;
  T* const obuf = s + 4 * g.cap;  // the output span, gathered here before it is stored
  // shared-memory offsets of the phases' spans: px = 0 reads phase py, px = 1 phase 2 + py
  const int off0 = lead[0], off1 = g.cap + lead[1], off2 = 2 * g.cap + lead[2],
            off3 = 3 * g.cap + lead[3];
  for (int q = threadIdx.x; q < vectors; q += kThreads) {
    const int i0 = q * V - olead;
    const int ib = max(i0, 0);
    const int row = fdiv(ib, g.div_ow);
    int ox = ib - row * g.ow;
    int c = fdiv(orow0 + row, g.div_oh);
    int oy = orow0 + row - c * g.oh;
    int base = (c * g.h + (oy >> 1) - r0) * g.w;
    int even = (oy & 1) ? off1 : off0, odd = (oy & 1) ? off3 : off2;
    union {
      uint4 v;
      T e[V];
    } u;
    if (i0 >= 0 && i0 + V <= olen && ox + V <= g.ow) {
      // a whole vector inside one output row: its values alternate between
      // the two phases of the row's py, from column ox / 2 on
      const T* a = s + ((ox & 1) ? odd : even) + base + (ox >> 1);
      const T* b = s + ((ox & 1) ? even + 1 : odd) + base + (ox >> 1);
#pragma unroll
      for (int m = 0; m < V / 2; ++m) {
        u.e[2 * m] = a[m];
        u.e[2 * m + 1] = b[m];
      }
      reinterpret_cast<uint4*>(obuf)[q] = u.v;
      continue;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i0 + j >= ib && i0 + j < olen) {
        u.e[j] = s[((ox & 1) ? odd : even) + base + (ox >> 1)];
        if (++ox == g.ow) {
          ox = 0;
          if (++oy == g.oh) {
            oy = 0;
            ++c;
          }
          base = (c * g.h + (oy >> 1) - r0) * g.w;
          even = (oy & 1) ? off1 : off0;
          odd = (oy & 1) ? off3 : off2;
        }
      }
    }
    reinterpret_cast<uint4*>(obuf)[q] = u.v;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < vectors; q += kThreads)
    store_vector(dst, olead, olen, q, reinterpret_cast<const uint4*>(obuf)[q]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) s2d_kernel(const T* __restrict__ ct, Ptrs<T> out,
                                                       Geom g) {
  constexpr int V = kVecBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* s = reinterpret_cast<T*>(smem_bytes);
  const int n = fdiv(blockIdx.x, g.div_tiles);
  const int r0 = (blockIdx.x - n * g.tiles) * g.rows_per_tile;
  const int r1 = min(r0 + g.rows_per_tile, g.rows);
  const int len = (r1 - r0) * g.w;

  T* dst[4];
  int lead[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dst[k] = out.p[k] + n * g.sample_stride + static_cast<size_t>(r0) * g.w;
    lead[k] = lead_of(dst[k]);
  }
  // the cotangent's span, a vector a thread, scattered value by value into
  // the four phase spans in shared memory, each at its destination's
  // offset within 16 bytes
  const int orow0 = first_out_row(r0, g);
  const int olen = (first_out_row(r1, g) - orow0) * g.ow;
  const T* src = ct + static_cast<size_t>(n) * g.c * g.oh * g.ow + static_cast<size_t>(orow0) * g.ow;
  const int slead = lead_of(src);
  T* const ctbuf = s + 4 * g.cap;
  const int svectors = stage_span(src, ctbuf, olen, 0);
  const int off0 = lead[0], off1 = g.cap + lead[1], off2 = 2 * g.cap + lead[2],
            off3 = 3 * g.cap + lead[3];
  // where the crop cut, nothing is scattered: those places read zeros
  // (rows y >= (oh - py + 1) / 2 and columns x >= (ow - px + 1) / 2 of a
  // phase), so the phase buffers start at zero
  if (g.oh < 2 * g.h || g.ow < 2 * g.w) {
    for (int q = threadIdx.x; q < g.cap / V * 4; q += kThreads)
      reinterpret_cast<uint4*>(s)[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int q = threadIdx.x; q < svectors; q += kThreads) {
    const int i0 = q * V - slead;
    const int ib = max(i0, 0);
    union {
      uint4 v;
      T e[V];
    } u;
    u.v = *reinterpret_cast<const uint4*>(ctbuf + q * V);
    const int row = fdiv(ib, g.div_ow);
    int ox = ib - row * g.ow;
    int c = fdiv(orow0 + row, g.div_oh);
    int oy = orow0 + row - c * g.oh;
    int base = (c * g.h + (oy >> 1) - r0) * g.w;
    int even = (oy & 1) ? off1 : off0, odd = (oy & 1) ? off3 : off2;
    if (i0 >= 0 && i0 + V <= olen && ox + V <= g.ow) {
      // a whole vector inside one cotangent row: its values alternate
      // between the two phases of the row's py, from column ox / 2 on
      T* a = s + ((ox & 1) ? odd : even) + base + (ox >> 1);
      T* b = s + ((ox & 1) ? even + 1 : odd) + base + (ox >> 1);
#pragma unroll
      for (int m = 0; m < V / 2; ++m) {
        a[m] = u.e[2 * m];
        b[m] = u.e[2 * m + 1];
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i0 + j >= ib && i0 + j < olen) {
        s[((ox & 1) ? odd : even) + base + (ox >> 1)] = u.e[j];
        if (++ox == g.ow) {
          ox = 0;
          if (++oy == g.oh) {
            oy = 0;
            ++c;
          }
          base = (c * g.h + (oy >> 1) - r0) * g.w;
          even = (oy & 1) ? off1 : off0;
          odd = (oy & 1) ? off3 : off2;
        }
      }
    }
  }
  __syncthreads();

  // each phase span out a vector a thread
  int before = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int vectors = (lead[k] + len + V - 1) / V;
    for (int q = first_vector(before); q < vectors; q += kThreads)
      store_vector(dst[k], lead[k], len, q, *reinterpret_cast<const uint4*>(s + k * g.cap + q * V));
    before += vectors;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        count > 0)
      sms = count;
    else
      return 132;
  }
  return sms;
}

// The launch's shapes for elements of `bytes` bytes; {} with tiles 0 where
// one row does not fit a block's shared memory.
Geom make_geom(int n, int c, int h, int w, int oh, int ow, long long sample_stride, int bytes) {
  const int V = kVecBytes / bytes;
  Geom g{};
  g.sample_stride = static_cast<unsigned long long>(sample_stride);
  g.c = c, g.h = h, g.w = w, g.oh = oh, g.ow = ow, g.rows = c * h;
  const long long total_rows = static_cast<long long>(n) * g.rows;
  const long long by_span = (kSpanBytes / bytes) / w;
  const long long by_blocks = (total_rows + kBlocksPerSm * sm_count() - 1) / (kBlocksPerSm * sm_count());
  long long r = by_span < by_blocks ? by_span : by_blocks;
  if (r < 1) r = 1;
  g.rows_per_tile = static_cast<int>(r);
  g.tiles = (g.rows + g.rows_per_tile - 1) / g.rows_per_tile;
  // a span's buffer: its elements after its lead, in whole vectors so
  // that the next buffer is aligned (a tile's output rows are at most 2R)
  g.cap = (g.rows_per_tile * w + V - 1 + V - 1) / V * V;
  g.cap_ct = (2 * g.rows_per_tile * ow + V - 1 + V - 1) / V * V;
  g.div_h = make_fastdiv(h), g.div_oh = make_fastdiv(oh), g.div_ow = make_fastdiv(ow);
  g.div_tiles = make_fastdiv(g.tiles);
  if ((4ll * g.cap + g.cap_ct) * bytes > kMaxSmem) g.tiles = 0;
  return g;
}

template <typename K>
cudaError_t reserve_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_d2s(const void* const* in, void* out, int n, int c, int h, int w, int oh, int ow,
               long long sample_stride, cudaStream_t s) {
  if (static_cast<long long>(n) * c * oh * ow == 0) return 0;
  const Geom g = make_geom(n, c, h, w, oh, ow, sample_stride, sizeof(T));
  if (g.tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (4ull * g.cap + g.cap_ct) * sizeof(T);
  if (cudaError_t e = reserve_smem(d2s_kernel<T>, smem)) return static_cast<int>(e);
  Ptrs<const T> p;
  for (int k = 0; k < 4; ++k) p.p[k] = static_cast<const T*>(in[k]);
  d2s_kernel<T><<<g.tiles * n, kThreads, smem, s>>>(p, static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_s2d(const void* ct, void* const* out, int n, int c, int h, int w, int oh, int ow,
               long long sample_stride, cudaStream_t s) {
  if (static_cast<long long>(n) * c * h * w == 0) return 0;
  const Geom g = make_geom(n, c, h, w, oh, ow, sample_stride, sizeof(T));
  if (g.tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (4ull * g.cap + g.cap_ct) * sizeof(T);
  if (cudaError_t e = reserve_smem(s2d_kernel<T>, smem)) return static_cast<int>(e);
  Ptrs<T> p;
  for (int k = 0; k < 4; ++k) p.p[k] = static_cast<T*>(out[k]);
  s2d_kernel<T><<<g.tiles * n, kThreads, smem, s>>>(static_cast<const T*>(ct), p, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four phases P_0..P_3 (each [n, c, h, w] at `in[k]`, samples
// `sample_stride` elements apart) -> out [n, c, oh, ow], contiguous,
// elements of `elem_bytes` bytes (2, 4 or 8); one launch on `stream`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another element size or a row too wide for a block's shared memory.
extern "C" int d2s(const void* in0, const void* in1, const void* in2, const void* in3, void* out,
                   int n, int c, int h, int w, int oh, int ow, long long sample_stride,
                   int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[4] = {in0, in1, in2, in3};
  switch (elem_bytes) {
    case 2: return launch_d2s<uint16_t>(in, out, n, c, h, w, oh, ow, sample_stride, s);
    case 4: return launch_d2s<uint32_t>(in, out, n, c, h, w, oh, ow, sample_stride, s);
    case 8: return launch_d2s<uint64_t>(in, out, n, c, h, w, oh, ow, sample_stride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ct [n, c, oh, ow], contiguous -> the four phase gradients G_0..G_3 (each
// [n, c, h, w] at `out[k]`, samples `sample_stride` elements apart), zeros
// past the crop; as d2s.
extern "C" int s2d(const void* ct, void* out0, void* out1, void* out2, void* out3, int n, int c,
                   int h, int w, int oh, int ow, long long sample_stride, int elem_bytes,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* out[4] = {out0, out1, out2, out3};
  switch (elem_bytes) {
    case 2: return launch_s2d<uint16_t>(ct, out, n, c, h, w, oh, ow, sample_stride, s);
    case 4: return launch_s2d<uint32_t>(ct, out, n, c, h, w, oh, ow, sample_stride, s);
    case 8: return launch_s2d<uint64_t>(ct, out, n, c, h, w, oh, ow, sample_stride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
