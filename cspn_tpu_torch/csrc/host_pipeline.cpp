// Native host-side sample assembly for the input pipeline, and the PNG
// row unfiltering of the port's PNG reader.
//
// The per-sample tensor assembly that follows the geometric transforms --
// ImageNet normalization, depth scaling, Bernoulli sparse-depth sampling
// (both NYU total-pixel and KITTI valid-pixel denominators,
// nyu_dataset_loader.py:141 / kitti_dataset_loader.py:138) and RGBD packing
// -- done in one multithreaded fused pass instead of several numpy
// temporaries; the whole augmentation chain in one pass (cspn_aug_pack);
// and the five PNG row filters' inverse (cspn_png_unfilter), which is
// sequential along a row.
//
// The same C interface and random streams as the JAX package's host library,
// so both give the same samples bit for bit when built with the same flags.
// Exposed as a plain C API consumed via ctypes (cspn_tpu_torch/data/native.py);
// built with g++ by cspn_tpu_torch/ops/_build.py (HOST_FLAGS), no external
// dependencies.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 -- deterministic, seedable, threadable PRNG
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d65a6b49087a25ULL;
  return z ^ (z >> 31);
}

static inline float uniform01(uint64_t& s) {
  return (float)(splitmix64(s) >> 40) * (1.0f / 16777216.0f);
}

// Per-row stream origin.  NOT seed ^ (golden * row): that starts every
// row's stream on the SAME arithmetic sequence of states (state of row i,
// draw j ~ golden * (i + j)), so draws were near-identical along image
// anti-diagonals -- Bernoulli counts measured 16 sigma off.  Running the
// splitmix finalizer over the combined value scrambles the origins.
static inline uint64_t row_stream(uint64_t seed, uint64_t row) {
  uint64_t z = seed + 0x9e3779b97f4a7c15ULL * (row + 1);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d65a6b49087a25ULL;
  return z ^ (z >> 31);
}

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

void pack_rows(const uint8_t* rgb, const float* depth, int h, int w,
               int row_begin, int row_end, float inv_scale, float p_sample,
               uint64_t seed, float* out_rgbd, float* out_depth) {
  const float inv255 = 1.0f / 255.0f;
  for (int i = row_begin; i < row_end; ++i) {
    uint64_t s = row_stream(seed, (uint64_t)i);
    const uint8_t* rrow = rgb + (size_t)i * w * 3;
    const float* drow = depth + (size_t)i * w;
    float* orow = out_rgbd + (size_t)i * w * 4;
    float* odrow = out_depth + (size_t)i * w;
    for (int j = 0; j < w; ++j) {
      for (int c = 0; c < 3; ++c) {
        orow[j * 4 + c] =
            ((float)rrow[j * 3 + c] * inv255 - kMean[c]) / kStd[c];
      }
      float d = drow[j] * inv_scale;
      odrow[j] = d;
      float mask = uniform01(s) < p_sample ? 1.0f : 0.0f;
      orow[j * 4 + 3] = d * mask;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Fused augmentation: PIL-equivalent resize (separable antialiased bilinear)
// + rotate (NEAREST, same canvas, zero fill) + center-crop + h-flip +
// ColorJitter (ImageEnhance semantics) + normalize + depth-scale + Bernoulli
// sparse sample + RGBD pack, without any PIL round-trips.  This replaces the
// per-sample PIL chain (nyu_dataset_loader.py:80-109 semantics) whose Python
// cost capped the loader at ~50 samples/s/core (result/loader_bench.json).
//
// Parity notes vs PIL (tests/test_native_aug.py):
//   - resize follows PIL's triangle-filter rule (support scales with the
//     downscale factor) with float weights and per-pass u8 rounding; PIL
//     uses int16 fixed-point coefficients, so u8 results may differ by
//     1 LSB on filter-boundary pixels;
//   - rotation is NEAREST over the inverse affine at pixel centers,
//     matching PIL's Image.rotate(expand=False) mapping;
//   - jitter ops are applied per pixel in the given order with u8
//     rounding between ops (ImageEnhance stores u8 between ops); the
//     contrast op's gray reference is the PIL integer L mean of the
//     full rotated canvas, including zero-filled corners, with ops
//     preceding contrast applied first -- same as running ImageEnhance
//     on the rotated image.

namespace {

static inline uint8_t clip_u8(float v) {
  // round-half-up with clamp; (int) truncation == floor for v >= 0
  int i = (int)(std::max(v, 0.0f) + 0.5f);
  return (uint8_t)(i > 255 ? 255 : i);
}

static inline int fast_floor(double v) {
  int i = (int)v;
  return i - (v < (double)i);
}

// PIL convert("L") integer luma
static inline int pil_luma(int r, int g, int b) {
  return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16;
}

struct ResampleWeights {
  std::vector<int> xmin, ksz;  // per output index: start + tap count
  std::vector<float> coef;     // [out, kmax] contiguous, zero padded
  int kmax;
};

// PIL-style bilinear (triangle) weights, antialiased on downscale.
static ResampleWeights make_weights(int in, int out) {
  ResampleWeights w;
  w.xmin.resize(out);
  w.ksz.resize(out);
  double scale = (double)in / out;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // bilinear support = 1
  double ss = 1.0 / filterscale;
  w.kmax = (int)std::ceil(support) * 2 + 1;
  w.coef.assign((size_t)out * w.kmax, 0.0f);
  for (int xx = 0; xx < out; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in) xmax = in;
    double total = 0.0;
    float* k = w.coef.data() + (size_t)xx * w.kmax;
    for (int x = xmin; x < xmax; ++x) {
      double t = std::abs((x - center + 0.5) * ss);
      double v = t < 1.0 ? 1.0 - t : 0.0;
      k[x - xmin] = (float)v;
      total += v;
    }
    if (total > 0.0) {
      for (int t = 0; t < xmax - xmin; ++t) k[t] = (float)(k[t] / total);
    }
    w.xmin[xx] = xmin;
    w.ksz[xx] = xmax - xmin;
  }
  return w;
}

// Strided u8 RGB source view (supports HWC, planar CHW, and numpy slices
// without a contiguous copy).  Strides in ELEMENTS.
struct SrcU8 {
  const uint8_t* p;
  long rs, cs, chs;  // row, column, channel strides
  inline const uint8_t* at(int y, int x) const {
    return p + (long)y * rs + (long)x * cs;
  }
};

// Separable resize of a u8 RGB image (strided source, HWC dest), u8
// rounding after each pass (PIL resizes horizontally then vertically).
static void resize_u8(SrcU8 src, int h, int w, int rh, int rw,
                      std::vector<uint8_t>& dst) {
  ResampleWeights wx = make_weights(w, rw);
  ResampleWeights wy = make_weights(h, rh);
  std::vector<uint8_t> tmp((size_t)h * rw * 3);
  const long cs = src.cs, chs = src.chs;
  // specialized horizontal passes: constant strides let the compiler
  // vectorize the tap loop (the generic runtime-stride form measured ~2x
  // slower end to end)
  for (int i = 0; i < h; ++i) {
    const uint8_t* row = src.at(i, 0);
    uint8_t* orow = tmp.data() + (size_t)i * rw * 3;
    const float* kc = wx.coef.data();
    if (cs == 3 && chs == 1) {  // interleaved HWC
      for (int xx = 0; xx < rw; ++xx, kc += wx.kmax) {
        const uint8_t* p = row + (long)wx.xmin[xx] * 3;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        int n = wx.ksz[xx];
        for (int t = 0; t < n; ++t, p += 3) {
          float k = kc[t];
          a0 += k * p[0];
          a1 += k * p[1];
          a2 += k * p[2];
        }
        orow[0] = clip_u8(a0);
        orow[1] = clip_u8(a1);
        orow[2] = clip_u8(a2);
        orow += 3;
      }
    } else if (cs == 1) {  // planar CHW (h5 layout)
      const uint8_t *p0 = row, *p1 = row + chs, *p2 = row + 2 * chs;
      for (int xx = 0; xx < rw; ++xx, kc += wx.kmax) {
        int x0 = wx.xmin[xx], n = wx.ksz[xx];
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        for (int t = 0; t < n; ++t) {
          float k = kc[t];
          a0 += k * p0[x0 + t];
          a1 += k * p1[x0 + t];
          a2 += k * p2[x0 + t];
        }
        orow[0] = clip_u8(a0);
        orow[1] = clip_u8(a1);
        orow[2] = clip_u8(a2);
        orow += 3;
      }
    } else {  // generic strided view
      for (int xx = 0; xx < rw; ++xx, kc += wx.kmax) {
        const uint8_t* p = row + (long)wx.xmin[xx] * cs;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        int n = wx.ksz[xx];
        for (int t = 0; t < n; ++t, p += cs) {
          float k = kc[t];
          a0 += k * p[0];
          a1 += k * p[chs];
          a2 += k * p[2 * chs];
        }
        orow[0] = clip_u8(a0);
        orow[1] = clip_u8(a1);
        orow[2] = clip_u8(a2);
        orow += 3;
      }
    }
  }
  dst.resize((size_t)rh * rw * 3);
  std::vector<float> acc((size_t)rw * 3);
  for (int yy = 0; yy < rh; ++yy) {
    const float* kc = wy.coef.data() + (size_t)yy * wy.kmax;
    int y0 = wy.xmin[yy], n = wy.ksz[yy];
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int t = 0; t < n; ++t) {
      float k = kc[t];
      const uint8_t* row = tmp.data() + (size_t)(y0 + t) * rw * 3;
      for (size_t x = 0; x < (size_t)rw * 3; ++x) acc[x] += k * row[x];
    }
    uint8_t* orow = dst.data() + (size_t)yy * rw * 3;
    for (size_t x = 0; x < (size_t)rw * 3; ++x) orow[x] = clip_u8(acc[x]);
  }
}

// Separable resize of an f32 plane (PIL mode-'F': float accumulate, no
// rounding between passes).  Strided source (strides in elements).
static void resize_f32(const float* src, long rs, long cs, int h, int w,
                       int rh, int rw, std::vector<float>& dst) {
  ResampleWeights wx = make_weights(w, rw);
  ResampleWeights wy = make_weights(h, rh);
  std::vector<float> tmp((size_t)h * rw);
  for (int i = 0; i < h; ++i) {
    const float* row = src + (long)i * rs;
    float* orow = tmp.data() + (size_t)i * rw;
    const float* kc = wx.coef.data();
    for (int xx = 0; xx < rw; ++xx, kc += wx.kmax) {
      const float* p = row + (long)wx.xmin[xx] * cs;
      float a = 0.0f;
      int n = wx.ksz[xx];
      for (int t = 0; t < n; ++t) a += kc[t] * p[(long)t * cs];
      orow[xx] = a;
    }
  }
  dst.assign((size_t)rh * rw, 0.0f);
  for (int yy = 0; yy < rh; ++yy) {
    const float* kc = wy.coef.data() + (size_t)yy * wy.kmax;
    int y0 = wy.xmin[yy], n = wy.ksz[yy];
    float* orow = dst.data() + (size_t)yy * rw;
    for (int t = 0; t < n; ++t) {
      float k = kc[t];
      const float* row = tmp.data() + (size_t)(y0 + t) * rw;
      for (int x = 0; x < rw; ++x) orow[x] += k * row[x];
    }
  }
}

// Inverse mapping of PIL Image.rotate(angle, NEAREST, expand=False):
// output pixel center (x+0.5, y+0.5) -> source coords; NEAREST = floor.
struct RotMap {
  double a, b, c, d, e, f;  // xin = a*xx + b*yy + c ; yin = d*xx + e*yy + f
  bool identity;
};

static RotMap make_rotmap(double angle_deg, int w, int h) {
  RotMap m;
  if (angle_deg == 0.0) {
    m.identity = true;
    m.a = m.e = 1.0;
    m.b = m.d = 0.0;
    m.c = m.f = 0.0;
    return m;
  }
  m.identity = false;
  double rot = -angle_deg * M_PI / 180.0;  // PIL matrix uses -angle
  double cx = w / 2.0, cy = h / 2.0;
  m.a = std::cos(rot);
  m.b = std::sin(rot);
  m.d = -std::sin(rot);
  m.e = std::cos(rot);
  m.c = cx - m.a * cx - m.b * cy;
  m.f = cy - m.d * cx - m.e * cy;
  return m;
}

struct JitterOp {
  int op;    // 0=brightness, 1=contrast, 2=saturation
  float f;
};

// Apply jitter ops to one u8 RGB pixel (u8 rounding between ops, as PIL
// ImageEnhance does).  `gray_mean` is the contrast reference gray.
static inline void apply_jitter(int& r, int& g, int& b, const JitterOp* ops,
                                int n_ops, int gray_mean) {
  for (int t = 0; t < n_ops; ++t) {
    float f = ops[t].f;
    switch (ops[t].op) {
      case 0:  // brightness: blend(black, img, f)
        r = clip_u8(f * r);
        g = clip_u8(f * g);
        b = clip_u8(f * b);
        break;
      case 1:  // contrast: blend(mean-gray, img, f)
        r = clip_u8(gray_mean + f * (r - gray_mean));
        g = clip_u8(gray_mean + f * (g - gray_mean));
        b = clip_u8(gray_mean + f * (b - gray_mean));
        break;
      case 2: {  // saturation: blend(L(img), img, f)
        int l = pil_luma(r, g, b);
        r = clip_u8(l + f * (r - l));
        g = clip_u8(l + f * (g - l));
        b = clip_u8(l + f * (b - l));
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

// Count depth values > threshold (valid-pixel denominator for KITTI).
int64_t cspn_count_valid(const float* depth, int64_t n, float threshold) {
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) count += depth[i] > threshold;
  return count;
}

// Fused normalize + depth-scale + Bernoulli sparse sample + RGBD pack.
//   rgb:       [h, w, 3] uint8 (post geometric transforms)
//   depth:     [h, w] float32
//   inv_scale: depth is multiplied by this (reference's depth /= s)
//   p_sample:  Bernoulli probability for the sparse mask
//   seed:      sampling seed (deterministic per (seed, row))
//   out_rgbd:  [h, w, 4] float32, out_depth: [h, w] float32
void cspn_pack_sample(const uint8_t* rgb, const float* depth, int h, int w,
                      float inv_scale, float p_sample, uint64_t seed,
                      float* out_rgbd, float* out_depth, int num_threads) {
  if (num_threads <= 1 || h < 64) {
    pack_rows(rgb, depth, h, w, 0, h, inv_scale, p_sample, seed, out_rgbd,
              out_depth);
    return;
  }
  std::vector<std::thread> threads;
  int chunk = (h + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int b = t * chunk, e = std::min(h, b + chunk);
    if (b >= e) break;
    threads.emplace_back(pack_rows, rgb, depth, h, w, b, e, inv_scale,
                         p_sample, seed, out_rgbd, out_depth);
  }
  for (auto& th : threads) th.join();
}

// Batch variant: B samples with contiguous layouts, one thread per sample.
void cspn_pack_batch(const uint8_t* rgb, const float* depth, int b, int h,
                     int w, const float* inv_scales, const float* p_samples,
                     const uint64_t* seeds, float* out_rgbd, float* out_depth,
                     int num_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= b) return;
      pack_rows(rgb + (size_t)i * h * w * 3, depth + (size_t)i * h * w, h, w,
                0, h, inv_scales[i], p_samples[i], seeds[i],
                out_rgbd + (size_t)i * h * w * 4, out_depth + (size_t)i * h * w);
    }
  };
  int nt = std::max(1, std::min(num_threads, b));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Fused train/val augmentation + pack.  See the comment block above.
//   rgb:        [h0, w0, 3] uint8 with ELEMENT strides (r_rs, r_cs, r_chs)
//               -- supports HWC, planar CHW (h5 layout) and numpy slices
//               (box pre-crop) without a contiguous copy
//   depth:      [h0, w0] float32 with element strides (d_rs, d_cs)
//   rh, rw:     resize target (pass h0, w0 to skip resizing)
//   angle_deg:  rotation (0 = skip), PIL rotate(expand=False) semantics
//   oh, ow:     center-crop output size (round-half-even offsets, as
//               torchvision CenterCrop / int(round(.)) in Python)
//   flip:       nonzero = horizontal flip (applied after the crop)
//   jit_ops/jit_factors[n_jit]: ColorJitter ops in application order
//               (0=brightness, 1=contrast, 2=saturation)
//   inv_scale:  depth multiplier (reference depth /= s)
//   n_sample:   sparse sample count; denom_mode 0 = /total pixels (NYU),
//               1 = /valid pixels (KITTI, depth > 1e-4)
//   out_rgbd:   [oh, ow, 4] f32; out_depth: [oh, ow] f32
// Returns 0 on success, nonzero on bad arguments.
int cspn_aug_pack(const uint8_t* rgb, long r_rs, long r_cs, long r_chs,
                  const float* depth, long d_rs, long d_cs, int h0, int w0,
                  int rh, int rw, float angle_deg, int oh, int ow, int flip,
                  const int* jit_ops, const float* jit_factors, int n_jit,
                  float inv_scale, int n_sample, int denom_mode, uint64_t seed,
                  float* out_rgbd, float* out_depth) {
  if (h0 <= 0 || w0 <= 0 || rh <= 0 || rw <= 0 || oh <= 0 || ow <= 0 ||
      oh > rh || ow > rw || n_jit < 0 || n_jit > 3)
    return 1;

  // 1. resize (PIL separable triangle filter)
  std::vector<uint8_t> rgb_buf;
  std::vector<float> depth_buf;
  SrcU8 v8 = {rgb, r_rs, r_cs, r_chs};
  const float* fd = depth;
  long fd_rs = d_rs, fd_cs = d_cs;
  if (rh != h0 || rw != w0) {
    resize_u8(v8, h0, w0, rh, rw, rgb_buf);
    resize_f32(depth, d_rs, d_cs, h0, w0, rh, rw, depth_buf);
    v8 = {rgb_buf.data(), (long)rw * 3, 3, 1};
    fd = depth_buf.data();
    fd_rs = rw;
    fd_cs = 1;
  }

  RotMap m = make_rotmap(angle_deg, rw, rh);
  std::vector<JitterOp> ops(n_jit);
  int contrast_idx = -1;
  for (int t = 0; t < n_jit; ++t) {
    ops[t] = {jit_ops[t], jit_factors[t]};
    if (jit_ops[t] == 1 && contrast_idx < 0) contrast_idx = t;
  }

  // 2. contrast reference gray: PIL integer-L mean over the FULL rotated
  // canvas (zero corners included), with the ops preceding contrast
  // applied first
  int gray_mean = 0;
  if (contrast_idx >= 0) {
    // channel-uniform prior ops (brightness) compose into one u8 LUT;
    // only a prior saturation op (cross-channel) needs full per-pixel math
    bool lutable = true;
    for (int t = 0; t < contrast_idx; ++t)
      if (ops[t].op == 2) lutable = false;
    uint8_t lut[256];
    if (lutable) {
      for (int v = 0; v < 256; ++v) {
        int r = v, g = v, b = v;
        apply_jitter(r, g, b, ops.data(), contrast_idx, 0);
        lut[v] = (uint8_t)r;
      }
    }
    double lsum = 0.0;
    for (int y = 0; y < rh; ++y) {
      double yy = y + 0.5;
      double xin = m.a * 0.5 + m.b * yy + m.c;
      double yin = m.d * 0.5 + m.e * yy + m.f;
      for (int x = 0; x < rw; ++x, xin += m.a, yin += m.d) {
        int sx = m.identity ? x : fast_floor(xin);
        int sy = m.identity ? y : fast_floor(yin);
        int r = 0, g = 0, b = 0;
        if (sx >= 0 && sx < rw && sy >= 0 && sy < rh) {
          const uint8_t* p = v8.at(sy, sx);
          r = p[0];
          g = p[v8.chs];
          b = p[2 * v8.chs];
        }
        if (lutable) {
          lsum += pil_luma(lut[r], lut[g], lut[b]);
        } else {
          apply_jitter(r, g, b, ops.data(), contrast_idx, 0);
          lsum += pil_luma(r, g, b);
        }
      }
    }
    gray_mean = (int)(lsum / ((double)rh * rw) + 0.5);
  }

  // 3. crop offsets (round half to even, matching Python round())
  auto crop_off = [](int full, int out) {
    int diff = full - out;
    int lo = diff / 2;
    if (diff % 2 == 0) return lo;
    return (lo % 2 == 0) ? lo : lo + 1;
  };
  int top = crop_off(rh, oh), left = crop_off(rw, ow);

  // 4. geometry + jitter + normalize into the output buffers
  const float inv255 = 1.0f / 255.0f;
  // flip reverses the x walk over the cropped region (flip after crop)
  const int x0 = flip ? left + ow - 1 : left;
  const double xstep = flip ? -1.0 : 1.0;
  for (int y = 0; y < oh; ++y) {
    float* orow = out_rgbd + (size_t)y * ow * 4;
    float* odrow = out_depth + (size_t)y * ow;
    int cyp = top + y;
    double yy = cyp + 0.5;
    double xin = m.a * (x0 + 0.5) + m.b * yy + m.c;
    double yin = m.d * (x0 + 0.5) + m.e * yy + m.f;
    int cxp = x0;
    for (int x = 0; x < ow;
         ++x, xin += xstep * m.a, yin += xstep * m.d, cxp += (int)xstep) {
      int sx = m.identity ? cxp : fast_floor(xin);
      int sy = m.identity ? cyp : fast_floor(yin);
      int r = 0, g = 0, b = 0;
      float d = 0.0f;
      if (sx >= 0 && sx < rw && sy >= 0 && sy < rh) {
        const uint8_t* p = v8.at(sy, sx);
        r = p[0];
        g = p[v8.chs];
        b = p[2 * v8.chs];
        d = fd[(long)sy * fd_rs + (long)sx * fd_cs];
      }
      if (n_jit) apply_jitter(r, g, b, ops.data(), n_jit, gray_mean);
      orow[x * 4 + 0] = ((float)r * inv255 - kMean[0]) / kStd[0];
      orow[x * 4 + 1] = ((float)g * inv255 - kMean[1]) / kStd[1];
      orow[x * 4 + 2] = ((float)b * inv255 - kMean[2]) / kStd[2];
      odrow[x] = d * inv_scale;
    }
  }

  // 5. Bernoulli sparse channel (deterministic per (seed, row), same
  // stream family as cspn_pack_sample)
  double denom = (double)oh * ow;
  if (denom_mode == 1) {
    int64_t valid = 0;
    for (int64_t i = 0; i < (int64_t)oh * ow; ++i)
      valid += out_depth[i] > 1e-4f;
    denom = (double)std::max<int64_t>(valid, 1);
  }
  float p = (float)std::min(1.0, n_sample / std::max(denom, 1.0));
  for (int i = 0; i < oh; ++i) {
    uint64_t s = row_stream(seed, (uint64_t)i);
    float* orow = out_rgbd + (size_t)i * ow * 4;
    const float* drow = out_depth + (size_t)i * ow;
    for (int j = 0; j < ow; ++j) {
      float mask = uniform01(s) < p ? 1.0f : 0.0f;
      orow[j * 4 + 3] = drow[j] * mask;
    }
  }
  return 0;
}

// Inverse of the PNG row filters (PNG spec section 9) of a non-interlaced
// image.
//   raw:    h rows of 1 + stride bytes: the filter type (0 None, 1 Sub, 2 Up,
//           3 Average, 4 Paeth), then the filtered bytes
//   stride: bytes a row after its filter byte; bpp: bytes a pixel (>= 1)
//   out:    h rows of stride bytes
// Returns 0, or 1 + the row index of the first row with an unknown filter.
int cspn_png_unfilter(const uint8_t* raw, int h, long stride, int bpp,
                      uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + (size_t)y * (stride + 1);
    const uint8_t* src = in + 1;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    switch (in[0]) {
      case 0:
        std::memcpy(cur, src, (size_t)stride);
        break;
      case 1:
        for (long x = 0; x < stride; ++x)
          cur[x] = (uint8_t)(src[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (long x = 0; x < stride; ++x)
          cur[x] = (uint8_t)(src[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = prev ? prev[x] : 0;
          cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = prev ? prev[x] : 0;
          int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(src[x] + pred);
        }
        break;
      default:
        return 1 + y;
    }
  }
  return 0;
}

}  // extern "C"
