// 3D CSPN forward (paddle affinity_propagate semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel cspn_tpu/ops/cspn3d_pallas.py:_seg_kernel,
// launched there by _run_segment for affinity_propagate3d_fused.  It
// computes `steps` iterations of
// cspn_tpu_torch/ops/cspn_ref.py:affinity_propagate_reference on fixed
// gates, the function JAX runs with gate_dtype=float32: for each volume m
// and voxel p, with the 26 offsets off_d of neighbor_offsets(3, 3),
//
//   x_{t+1}[p] = (1 - sum_d w_d[p]) x_t[p] + sum_d w_d[p] x_t[p + off_d]
//
// out-of-volume neighbours contributing 0 while their gates still count in
// the centre weight (cspn3d_pallas.py:295-297, :521).  The gates arrive
// normalized (abs and per-voxel sum-normalization stay in PyTorch, as JAX
// leaves them to XLA); all arithmetic is f32.  cspn3d_fwd_bf16 reads the
// gates in bf16, the TPU kernel's default (gate_dtype None,
// cspn3d_pallas.py:188-191,230): the same function on the rounded gates,
// its centre weight 1 - sum_d w_d summed from them in f32, as _seg_kernel
// sums it from its bf16 gate buffer.
//
// What bounds it on this card.  The fused op must read 26 gate planes and
// x_0 and write one plane: 28 f32 planes, 176 MB for the stereo model's
// b4 48x64x128 volume, 0.053 ms at the H100 SXM's 3.35 TB/s.  Its
// arithmetic is ~54 flops per voxel per step (27 FMA), 2.0 GFLOP at 24
// steps, 0.030 ms at 67 TFLOP/s of f32: bytes bound the function.  A
// schedule that rereads the gates at every step (one launch per step, the
// first version of this file) moves 24x those bytes, since the 164 MB of
// b4 gates exceed the 50 MB L2: 1.58 ms on an H100.
//
// What this design does about it.  The gates stay on chip across steps,
// as the TPU kernel keeps a volume in VMEM for all of them: one stereo
// volume's 26 gate planes are 40.9 MB, ~310 KB per SM, against 227 KB of
// shared memory per SM.  One persistent cooperative launch
// (cspn3d_common.cuh:sweep) runs the whole forward: each of ~132 blocks owns
// a brick of 4 z-planes x ~745 columns of every volume and reads its
// gates from HBM once per volume, 18 planes (and the centre weight) into
// shared memory and, at the stereo shape, 8 planes left in device memory
// that each step reads from L2.  Each step a thread marches up its column
// with the 3x3x3 window of the state in registers: one plane of three rows
// loaded a voxel, the rows' sides taken from the neighbouring lanes; it
// writes the next state, and the grid synchronizes.  A forward that a
// backward follows keeps its states (x_1..x_{T-1}), and the backward reads
// them in place of a replay; any other forward writes them into two
// buffers in turn, which stay in L2.  A volume with more bricks than the
// card has SMs runs on a looping instantiation, where a block takes
// several bricks and reads every gate from L2 or HBM at each step: one
// deeper than 4 x SMs, or one whose z-plane exceeds what 132 bricks' centre
// weights in shared memory cover (at D = 48 over ~160 K columns, e.g. the
// stereo model at 1600x1920; at 1080x1920 a brick a block still holds
// its centre weights, every gate read from L2).  On an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 3) the b4 forward takes 0.78 ms, 2.0x faster
// than the per-step version and 15x its bound: 96 volume-steps of ~7 us,
// of which ~4 us is the grid barrier and a step's latency (the slope on a
// grid with one warp of work a block), the rest the stencil and the 8
// planes read from L2.  With bf16 gates the bound's bytes fall to 15 f32
// planes' worth (26 of 2 bytes, x_0 and the output), 93 MB, 0.028 ms; a
// brick's 26 planes fit shared memory beside the centre weight (15 words a
// voxel), so no gate is read from L2 during the steps.  Not carried over
// from the TPU kernel: its lane-unshifted gates, H/W padding to 8/128 and
// K-step H-tile segments.  What it leaves open: fewer barriers (several
// steps a barrier on bricks with a halo), and the gate normalization in
// front of the kernel (several PyTorch passes).

#include "cspn3d_common.cuh"  // sweep, launch_sweep, CSPN3D_FOR_SMEM_PLANES

namespace {

template <int kSmem, bool kLoop, typename G>
__global__ void __launch_bounds__(kSweepThreads, 1)
    cspn3d_fwd_sweep_kernel(const G* __restrict__ gates, const float* x0, float* out,
                            float* states, int m, int d, int h, int w, int steps, int nslots,
                            int parts, int cols) {
  sweep<kSmem, false, kLoop, G>(gates, x0, out, states, m, d, h, w, steps, nslots, parts, cols);
}

template <typename G>
int run_fwd(const G* gates, const float* x0, float* out, float* states, int m, int d, int h,
            int w, int steps, int nslots, int grid, int parts, int cols, int n_smem,
            cudaStream_t s) {
  if (steps <= 0) {
    return static_cast<int>(cudaMemcpyAsync(out, x0, sizeof(float) * (size_t)m * d * h * w,
                                            cudaMemcpyDeviceToDevice, s));
  }
  const bool loop = grid < (d + kSlab - 1) / kSlab * parts;
#define CSPN3D_FWD(S, L)                                                                      \
  launch_sweep(cspn3d_fwd_sweep_kernel<S, L, G>, S, gates, x0, out, states, m, d, h, w, steps, \
               nslots, grid, parts, cols, s)
  CSPN3D_FOR_SMEM_PLANES(loop, n_smem, CSPN3D_FWD)
#undef CSPN3D_FWD
}

}  // namespace

// The device's SM count and the shared memory a block may opt in to, for
// ops/cspn3d_cuda.py:plan_volume.
extern "C" int cspn3d_device_limits(int* sms, int* smem_optin) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(err);
}

// Runs the whole forward on `stream`: one cooperative launch (a copy when
// steps == 0).  The caller allocates every buffer (contiguous): gates
// [m,26,d,h,w] (f32, or bf16 for cspn3d_fwd_bf16), x0/out [m,d,h,w] f32,
// states [nslots,m,d,h,w] f32: nslots = steps-1 keeps x_1..x_{T-1} for the
// backward, nslots = 2 (or steps-1 if less) lets them go, two buffers in
// turn.  (grid, parts, cols, n_smem) is plan_volume's plan at the gates'
// element size.  Returns the launch's cudaError_t, else 0.
extern "C" int cspn3d_fwd_f32(const float* gates, const float* x0, float* out, float* states,
                              int m, int d, int h, int w, int steps, int nslots, int grid,
                              int parts, int cols, int n_smem, void* stream) {
  return run_fwd(gates, x0, out, states, m, d, h, w, steps, nslots, grid, parts, cols, n_smem,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int cspn3d_fwd_bf16(const __nv_bfloat16* gates, const float* x0, float* out,
                               float* states, int m, int d, int h, int w, int steps, int nslots,
                               int grid, int parts, int cols, int n_smem, void* stream) {
  return run_fwd(gates, x0, out, states, m, d, h, w, steps, nslots, grid, parts, cols, n_smem,
                 static_cast<cudaStream_t>(stream));
}
