// 3D CSPN backward (the exact adjoint of csrc/cspn3d_fwd.cu at fixed
// gates) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn3d_pallas.py:_bwd3_kernel,
// launched there by affinity_propagate3d_fused_bwd.  Given the normalized
// gates w [M,26,D,H,W], x_0, the forward's states x_1..x_{T-1} and the
// cotangent v_T of x_T it returns (wbar, x0bar), what autograd of `steps`
// plain steps (ops/cspn_ref.py:propagate_nd_reference) returns.  With
// c = 1 - sum_d w_d (all 26 gates, border ones too):
//
//   reverse   v_t[q]   = c[q] v_{t+1}[q] + sum_d w_d[q - off_d] v_{t+1}[q - off_d]
//   gates     wbar_d[p] = sum_t v_{t+1}[p] (x_t[p + off_d] - x_t[p])
//             (x_t[p + off_d] = 0 outside the volume)
//   x0bar     = v_0
//
// cspn3d_bwd_bf16 reads the gates in bf16, as the TPU backward does by
// default (gate_dtype bf16, cspn3d_pallas.py:448,484-491): the adjoint
// above at the rounded gates, c summed from them in f32 (the exact adjoint
// of cspn3d_fwd_bf16); the gate cotangents come from the f32 states and do
// not read the gates, so the pass is the same kernel.
//
// Both launches are in gather form: a thread writes only its own voxel, so
// there are no atomics and the result is deterministic.
//
// What bounds it on this card.  The fused op must read 26 gate planes, x_0
// and the cotangent and write 26 + 1 planes: 55 f32 planes, 346 MB for the
// stereo model's b4 48x64x128 volume, 0.103 ms at the H100 SXM's
// 3.35 TB/s.  Its arithmetic, ~54 flops per voxel per step of the forward,
// of the reverse sweep and of the gate cotangents (~6.1 GFLOP at 24 steps,
// 0.091 ms at 67 TFLOP/s of f32), is below that: bytes bound it.  The
// first version of this file replayed the forward (23 launches), wrote
// the centre weight (one launch) and ran one launch per reverse step, each
// rereading 26 gate planes around its voxels: 49 launches, ~9.5 GB at b4,
// 3.84 ms on an H100.
//
// What this design does about it.  Two launches.  (1) The reverse sweep is
// the forward's persistent cooperative kernel run as its adjoint
// (cspn3d_common.cuh:sweep): a block reads, once per volume, the gates
// w_d[q - off_d] that its voxels q gather (the transposed stencil) into
// shared memory and sums its voxels' own gates into c, then steps v_T ->
// v_0 with one grid barrier a step, writing v_1..v_{T-1} and x0bar.  There
// is no replay: the forward kept x_1..x_{T-1} (ops/cspn3d_cuda.py keeps
// them when a backward will follow), and no centre launch.  (2) The gate
// cotangents are one gather pass: a thread walks t = 0..T-1 for its voxel
// with 26 register accumulators, reading v_{t+1}[p] and x_t around p, and
// writes each wbar plane once (~75 planes, 466 MB at b4); 26 accumulators
// a voxel would not fit beside the window in the sweep.  On an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 3) the b4 backward takes 1.32 ms, 2.9x
// faster than the 49-launch version and 13x its bound: the reverse sweep
// 0.86 ms, the gate pass 0.42 ms.  Not carried over: the TPU kernel's
// lane-unshifted gate layout, its XLA-side centre input (from the
// unrounded gates, where this one sums the gates it reads), its H/W
// padding and its checkpoints every <= 4 steps (VMEM).  What it leaves
// open: folding the gate cotangents into the sweep.

#include "cspn3d_common.cuh"  // sweep, launch_sweep, CSPN3D_FOR_SMEM_PLANES, off_*, inside3

namespace {

template <int kSmem, bool kLoop, typename G>
__global__ void __launch_bounds__(kSweepThreads, 1)
    cspn3d_adj_sweep_kernel(const G* __restrict__ gates, const float* ct, float* x0bar,
                            float* vs, int m, int d, int h, int w, int steps, int nslots,
                            int parts, int cols) {
  sweep<kSmem, true, kLoop, G>(gates, ct, x0bar, vs, m, d, h, w, steps, nslots, parts, cols);
}

// wbar_d[p] = sum_t v_{t+1}[p] (x_t[p + off_d] - x_t[p]), 26 accumulators
// per voxel; x_0 = x0, x_t = states[t-1]; v_{t+1} = vs[t] for t < T-1 and
// ct for t = T-1.
// Four blocks an SM (64 registers a thread): each thread's walk over t
// waits on device memory at every step, and the warps in flight hide it.
__global__ void __launch_bounds__(kThreads3d, 4) cspn3d_gate_grad_kernel(const float* __restrict__ x0,      // [M,D,H,W]
                                        const float* __restrict__ states,  // [T-1,M,D,H,W]
                                        const float* __restrict__ vs,      // [T-1,M,D,H,W]
                                        const float* __restrict__ ct,      // [M,D,H,W]
                                        float* __restrict__ wbar,          // [M,26,D,H,W]
                                        int m_count, int d, int h, int w, int steps) {
  const long long vol = (long long)d * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vol) return;
  const long long m = blockIdx.y;
  const long long plane = (long long)m_count * vol;
  const int k = (int)(idx % w);
  const long long r = idx / w;
  const int j = (int)(r % h);
  const int i = (int)(r / h);

  float acc[kGates3d];
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) acc[dd] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const float* xt = (t == 0 ? x0 : states + (t - 1) * plane) + m * vol;
    const float* vt = (t == steps - 1 ? ct : vs + t * plane) + m * vol;
    const float vv = vt[idx];
    const float xc = xt[idx];
#pragma unroll
    for (int dd = 0; dd < kGates3d; ++dd) {
      const int z = i + off_z(dd), yy = j + off_y(dd), xx = k + off_x(dd);
      const float nb = inside3(z, yy, xx, d, h, w) ? xt[((long long)z * h + yy) * w + xx] : 0.0f;
      acc[dd] = fmaf(vv, nb - xc, acc[dd]);
    }
  }
  float* out = wbar + m * kGates3d * vol + idx;
#pragma unroll
  for (int dd = 0; dd < kGates3d; ++dd) out[dd * vol] = acc[dd];
}

template <typename G>
cudaError_t launch_adjoint(int n_smem, const G* gates, const float* ct, float* x0bar,
                           float* vs, int m, int d, int h, int w, int steps, int grid, int parts,
                           int cols, cudaStream_t s) {
  const bool loop = grid < (d + kSlab - 1) / kSlab * parts;
#define CSPN3D_ADJ(S, L)                                                                      \
  launch_sweep(cspn3d_adj_sweep_kernel<S, L, G>, S, gates, ct, x0bar, vs, m, d, h, w, steps, \
               steps - 1, grid, parts, cols, s)
  CSPN3D_FOR_SMEM_PLANES(loop, n_smem, CSPN3D_ADJ)
#undef CSPN3D_ADJ
}

template <typename G>
int run_bwd(const G* gates, const float* x0, const float* states, const float* ct, float* wbar,
            float* x0bar, float* vs, int m, int d, int h, int w, int steps, int grid, int parts,
            int cols, int n_smem, cudaStream_t s) {
  const long long vol = (long long)d * h * w;
  const long long plane = (long long)m * vol;
  cudaError_t err;
  if (steps <= 0) {  // out = x0: x0bar = ct, wbar = 0
    err = cudaMemcpyAsync(x0bar, ct, sizeof(float) * plane, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemsetAsync(wbar, 0, sizeof(float) * kGates3d * plane, s));
  }
  err = launch_adjoint(n_smem, gates, ct, x0bar, vs, m, d, h, w, steps, grid, parts, cols, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pass_grid((unsigned)((vol + kThreads3d - 1) / kThreads3d), m);
  cspn3d_gate_grad_kernel<<<pass_grid, kThreads3d, 0, s>>>(x0, states, vs, ct, wbar, m, d, h, w,
                                                           steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the whole backward on `stream`.  The caller allocates every buffer
// (contiguous f32, the gates bf16 for cspn3d_bwd_bf16):
//   gates [m,26,d,h,w], x0/ct [m,d,h,w], states [max(steps-1,0),m,d,h,w]
//   (the forward's x_1..x_{T-1}) (inputs),
//   wbar [m,26,d,h,w], x0bar [m,d,h,w] (outputs),
//   vs [max(steps-1,0),m,d,h,w] (scratch: v_1..v_{T-1}).
// (grid, parts, cols, n_smem) is plan_volume's plan at the gates' element
// size.  Launches: steps == 0:
// a copy and a memset; else the reverse sweep (cooperative) and the
// gate-cotangent pass.  Returns the first CUDA error, else 0.
extern "C" int cspn3d_bwd_f32(const float* gates, const float* x0, const float* states,
                              const float* ct, float* wbar, float* x0bar, float* vs, int m, int d,
                              int h, int w, int steps, int grid, int parts, int cols, int n_smem,
                              void* stream) {
  return run_bwd(gates, x0, states, ct, wbar, x0bar, vs, m, d, h, w, steps, grid, parts, cols,
                 n_smem, static_cast<cudaStream_t>(stream));
}

extern "C" int cspn3d_bwd_bf16(const __nv_bfloat16* gates, const float* x0, const float* states,
                               const float* ct, float* wbar, float* x0bar, float* vs, int m,
                               int d, int h, int w, int steps, int grid, int parts, int cols,
                               int n_smem, void* stream) {
  return run_bwd(gates, x0, states, ct, wbar, x0bar, vs, m, d, h, w, steps, grid, parts, cols,
                 n_smem, static_cast<cudaStream_t>(stream));
}
