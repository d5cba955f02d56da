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
// Every launch is in gather form: a thread writes only its own pixel.
//
// What bounds it on this card.  The fused op must read 8 guidance planes,
// blur, sparse and the cotangent and write 8 + 1 planes: 20 f32 planes per
// image, 5.5 MB at 228x304, about 1.7 us per image at the H100 SXM's
// 3.35 TB/s.  Its arithmetic is ~17 flops per pixel per step for the replay
// and ~33 for the reverse step (8 FMA for the gate cotangents, 8 for the
// adjoint stencil, the bbar add), ~1.2 us per image at 24 steps and
// 67 TFLOP/s of f32: the op is memory-bound.
//
// What this design does about it: little, on purpose; it is the simple,
// correct first version.  The TPU kernel keeps its checkpoints in 96 MB of
// VMEM, replays <= 4-step segments and packs lanes; none of that is carried
// over.  Here the replay writes every state x_1..x_{T-1} to device memory
// (23 planes at 24 steps, 51 MB at b8 228x304), then T reverse launches read
// them back, each moving ~30 planes (8 gates, 8 gate cotangents read and
// written, x, v, v', bbar).  In training the forward keeps its states and
// gates instead (have_states), and the prep and replay launches drop out.  So the traffic is ~40x the fused bound, much of
// it from the 50 MB L2.  The roads left open are those of the forward: fuse
// K steps per launch on row tiles with K-row halos, or keep a tile's gates
// and cotangents on chip in one persistent kernel.

#include "cspn2d_common.cuh"  // kDy/kDx, kThreads, inside, prep, step, reverse_step

namespace {

// Epilogue 1, per pixel p: dblur, and the cotangent of the raw gathered
// guidance B_d[p] = g_d[p + off_d], written over gbar.
__global__ void epilogue_kernel(const float* __restrict__ guid,    // [N,8,H,W]
                                const float* __restrict__ blur,    // [N,H,W]
                                const float* __restrict__ sparse,  // [N,H,W] or null
                                const float* __restrict__ v0,      // d x_0 [N,H,W]
                                const float* __restrict__ bbar,    // [N,H,W]
                                float* __restrict__ gbar,          // [N,8,H,W] in/out
                                float* __restrict__ dblur,         // [N,H,W]
                                int h, int w, int norm_abs) {
  const int hw = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const int i = idx / w;
  const int j = idx - i * w;
  const float* g_img = guid + n * 8 * hw;

  float a[8];  // signed raw guidance gathered from the neighbours
  float denom = 0.0f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int qi = i + kDy[d];
    const int qj = j + kDx[d];
    a[d] = inside(qi, qj, h, w) ? g_img[d * hw + qi * w + qj] : 0.0f;
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
  const long long p = n * hw + idx;
  const float x0 = blur[p];
  float keep = 1.0f;
  float m = 0.0f;
  if (sparse != nullptr) {
    const float s = sparse[p];
    m = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
    keep = 1.0f - m;
  }
  const float bb = bbar[p];
  dblur[p] = v0[p] + bb * (keep * (1.0f - gsum) + m);
  const float gsumbar = -bb * keep * x0;

  float* gb_px = gbar + n * 8 * hw + idx;
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
    gb_px[d * hw] = norm_abs ? sg * (gh[d] - t_sum) * inv : (gh[d] - sg * t_sum) * inv;
  }
}

// Epilogue 2, per guidance pixel q: dguid_d[q] = Bbar_d[q - off_d].
__global__ void unshift_kernel(const float* __restrict__ bbar_raw,  // [N,8,H,W]
                               float* __restrict__ dguid,           // [N,8,H,W]
                               int h, int w) {
  const int hw = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long n = blockIdx.y;
  const int i = idx / w;
  const int j = idx - i * w;
  const float* src = bbar_raw + n * 8 * hw;
  float* dst = dguid + n * 8 * hw + idx;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int ri = i - kDy[d];
    const int rj = j - kDx[d];
    dst[d * hw] = inside(ri, rj, h, w) ? src[d * hw + ri * w + rj] : 0.0f;
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
// kept (cspn2d_fwd.cu given `states`), and prep and the replay are skipped.
// Launches: steps == 0: a copy and a memset; else 1 prep, steps-1 replay
// steps (neither with have_states), steps reverse steps and 2 epilogue
// launches.
// Returns the first CUDA error of a launch or copy, else 0.
extern "C" int cspn2d_bwd_f32(const float* guid, const float* blur,
                              const float* sparse, const float* ct,
                              float* dguid, float* dblur, float* gate_scratch,
                              float* gbar_scratch, float* base_scratch,
                              float* bbar_scratch, float* v_scratch,
                              float* state_scratch, int n, int h, int w,
                              int steps, int norm_abs, int have_states,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = (size_t)n * h * w;
  cudaError_t err;
  if (steps <= 0) {  // out = blur: d blur = ct, d guidance = 0
    err = cudaMemcpyAsync(dblur, ct, sizeof(float) * plane,
                          cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemsetAsync(dguid, 0, sizeof(float) * 8 * plane, s));
  }
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  auto state = [&](int t) -> const float* {
    return t == 0 ? blur : state_scratch + (size_t)(t - 1) * plane;
  };
  // with have_states, the forward (cspn2d_fwd.cu given `states`) already
  // wrote prep's gates to gate_scratch and x_1 .. x_{steps-1} to
  // state_scratch; base_scratch is then unused
  if (!have_states) {
    prep_kernel<<<grid, kThreads, 0, s>>>(guid, blur, sparse, gate_scratch,
                                          base_scratch, h, w, norm_abs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // replay: state_scratch[t-1] = x_t for t = 1 .. steps-1 (x_0 is blur)
  for (int t = 1; t < steps && !have_states; ++t) {
    step_kernel<<<grid, kThreads, 0, s>>>(gate_scratch, base_scratch, state(t - 1),
                                          state_scratch + (size_t)(t - 1) * plane, h, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if ((err = cudaMemsetAsync(gbar_scratch, 0, sizeof(float) * 8 * plane, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaMemsetAsync(bbar_scratch, 0, sizeof(float) * plane, s)) != cudaSuccess)
    return static_cast<int>(err);
  // reverse sweep; v ping-pongs between the two v_scratch planes
  const float* v = ct;
  for (int t = steps - 1; t >= 0; --t) {
    float* v_next = v_scratch + (size_t)(t % 2) * plane;
    reverse_step_kernel<<<grid, kThreads, 0, s>>>(gate_scratch, state(t), v, v_next,
                                                  gbar_scratch, bbar_scratch, h, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    v = v_next;
  }
  epilogue_kernel<<<grid, kThreads, 0, s>>>(guid, blur, sparse, v, bbar_scratch,
                                            gbar_scratch, dblur, h, w, norm_abs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  unshift_kernel<<<grid, kThreads, 0, s>>>(gbar_scratch, dguid, h, w);
  return static_cast<int>(cudaGetLastError());
}
