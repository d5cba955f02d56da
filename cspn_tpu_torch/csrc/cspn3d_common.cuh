// The 3D CSPN's persistent sweep, shared by cspn3d_fwd.cu (the forward:
// x_{t+1} from x_t) and cspn3d_bwd.cu (the backward's reverse sweep:
// v_t from v_{t+1}), and the neighbourhood both gather from.  See
// cspn3d_fwd.cu for the function and for what bounds the schedule.
//
// One cooperative launch runs every step of every volume.  A volume is cut
// into bricks: slabs of kSlab z-planes, each cut into `parts` runs of `cols`
// columns (flattened y, x).  Block b owns brick b and, where a volume has
// more bricks than the grid has blocks, bricks b + gridDim.x, ...  Per
// volume it reads its first brick's 26 gate planes from HBM once: planes
// [0, n_smem) into shared memory beside the centre weight c, voxel-major;
// the rest, and every gate of a further brick, stay in device memory and
// are read from L2 at each step.  A thread reads and writes only its own
// shared-memory slots, so the block needs no barrier of its own.  Each
// step a thread marches up its column with the state's 3x3x3 window in
// registers (one plane loaded a voxel, from L1 or L2) and writes the next
// state; the grid synchronizes between steps.
// ops/cspn3d_cuda.py:plan_volume computes (grid, parts, cols, n_smem) and
// the wrapper passes them in.
//
// The gates are float32 or bf16 (G; bf16 is the JAX TPU route's default
// gate dtype, cspn3d_pallas.py:188-191): read as stored and widened to
// float32 at use; states, sums and the centre weight are float32 either
// way.  At bf16 a voxel's shared-memory slot packs two gates a word
// (slot_words), so more planes fit: all 26 of the stereo model's b4 volume.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads3d = 256;     // the gate-cotangent pass's block
constexpr int kGates3d = 26;
// the sweep's block, one per SM: 768 threads leave 85 registers a thread,
// which the z-march's 27-value window needs (at 1024 threads, 64, it spilled)
constexpr int kSweepThreads = 768;
constexpr int kSlab = 4;             // z-planes a sweep block owns

// Offset d of neighbor_offsets(3, 3) (ops/neighbors.py): the 27 points of
// the centred 3-cube in raster order (dz slowest), the centre (13) skipped.
// With #pragma unroll over d these fold to constants.
__device__ __forceinline__ int off_index(int d) { return d < 13 ? d : d + 1; }
__device__ __forceinline__ int off_z(int d) { return off_index(d) / 9 - 1; }
__device__ __forceinline__ int off_y(int d) { return (off_index(d) / 3) % 3 - 1; }
__device__ __forceinline__ int off_x(int d) { return off_index(d) % 3 - 1; }

__device__ __forceinline__ bool inside3(int z, int y, int x, int d, int h, int w) {
  return z >= 0 && z < d && y >= 0 && y < h && x >= 0 && x < w;
}

// A gate widened to float32, and a float32 value stored as a gate (exact
// for a value read from a gate of that type).
__device__ __forceinline__ float gate_f(float g) { return g; }
__device__ __forceinline__ float gate_f(__nv_bfloat16 g) { return __bfloat162float(g); }
template <typename G>
__device__ __forceinline__ G to_gate(float v);
template <>
__device__ __forceinline__ float to_gate<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_gate<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 4-byte words of shared memory one voxel takes: its float32 centre
// weight, then kSmem gates of type G (two bf16 a word), padded to an odd
// count so that the 32 lanes of a warp, on consecutive voxels, hit 32 banks
// (ops/cspn3d_cuda.py:slot_words).
template <typename G>
__host__ __device__ constexpr int slot_words(int smem) {
  return sizeof(G) == 4 ? smem + 1 : (1 + smem / 2) | 1;
}

// Gate dd of a voxel's shared-memory slot, widened: float32 one a word,
// bf16 read as the aligned pair that holds it.
template <typename G>
__device__ __forceinline__ float slot_gate(const float* slot, int dd);
template <>
__device__ __forceinline__ float slot_gate<float>(const float* slot, int dd) {
  return slot[1 + dd];
}
template <>
__device__ __forceinline__ float slot_gate<__nv_bfloat16>(const float* slot, int dd) {
  const __nv_bfloat162 pair = reinterpret_cast<const __nv_bfloat162*>(slot + 1)[dd >> 1];
  return (dd & 1) ? __high2float(pair) : __low2float(pair);
}

// a / b and a % b for 0 <= a < 2^22 through the float reciprocal inv_b:
// the product is off by less than 1, so one correction makes it exact
// (a brick held on chip has its columns below 2^22: launch_sweep checks)
__device__ __forceinline__ int divmod(int a, int b, float inv_b, int& rem) {
  int q = __float2int_rz(__int2float_rn(a) * inv_b);
  int r = a - q * b;
  if (r < 0) {
    --q;
    r += b;
  } else if (r >= b) {
    ++q;
    r -= b;
  }
  rem = r;
  return q;
}

// The 9 values of plane z of the state around column col (rows y-1, y,
// y+1, each at x-1, x, x+1, row-major), zero outside the volume.  The
// centre of each row is loaded; its sides come from the neighbouring lanes,
// which hold the columns col-1 and col+1, and lanes 0 and 31 load the one
// side they lack.  Every lane of the warp calls it with the same z.
__device__ __forceinline__ void load_plane(const float* src, int z, int col, int hw, int w, int d,
                                           bool colv, bool ylo, bool yhi, bool xlo, bool xhi,
                                           int lane, float (&v)[9]) {
  const bool zok = colv && z >= 0 && z < d;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const bool ok = zok && (dy < 0 ? ylo : dy > 0 ? yhi : true);
    const float* row = src + z * hw + col + dy * w;  // the row's value at x
    const float xc = ok ? __ldca(row) : 0.0f;
    const bool need_l = lane == 0 && xlo, need_r = lane == 31 && xhi;
    const float e = ok && (need_l || need_r) ? __ldca(row + (need_l ? -1 : 1)) : 0.0f;
    const float up = __shfl_up_sync(0xffffffffu, xc, 1);
    const float dn = __shfl_down_sync(0xffffffffu, xc, 1);
    v[3 * (dy + 1)] = xlo ? (lane == 0 ? e : up) : 0.0f;
    v[3 * (dy + 1) + 1] = xc;
    v[3 * (dy + 1) + 2] = xhi ? (lane == 31 ? e : dn) : 0.0f;
  }
}

// One step of one brick: the voxels of z-planes [z0, z0 + kSlab) and
// columns [part0, part0 + cols) of the volume at src/dst (gates at gm).
// Forward (kAdjoint false):
//   x_{t+1}[p] = c[p] x_t[p] + sum_d w_d[p] x_t[p + off_d]
// adjoint: v_t[q] = c[q] v_{t+1}[q] + sum_d w_d[q - off_d] v_{t+1}[q - off_d]
// with c = 1 - sum_d w_d (all 26 gates as read, widened, summed in d
// order) and a neighbour outside the volume contributing 0.  kOnChip: the
// brick the block holds in shared memory (sg: per voxel c and kSmem gates,
// slot_words<G>(kSmem) words a voxel), the other gates read from L2; else
// (kSmem 0) every gate and c come from device memory, in the same order,
// so the result is the same.  A thread owns one column and marches up the
// brick with the 3x3x3 window of the state around its voxel in registers,
// loading one plane of it per voxel.
template <int kSmem, bool kAdjoint, bool kOnChip, typename G>
__device__ __forceinline__ void brick_step(const G* __restrict__ gm, const float* sg,
                                           const float* src, float* dst, int z0, int part0,
                                           int cols, int d, int h, int w) {
  constexpr int kStride = slot_words<G>(kSmem);
  const int hw = h * w;
  const int vol = hw * d;  // < 2^31: launch_sweep checks
  const int lane = threadIdx.x & 31;
  // whole warps: a lane past the part still loads its column for its
  // neighbours' shuffles, and stores nothing
  for (int t = threadIdx.x; (t & ~31) < cols; t += kSweepThreads) {
    const int col = part0 + t;
    const bool colv = col < hw, own = t < cols && colv;
    int k, jj;
    if (kOnChip) {
      jj = divmod(col, w, 1.0f / w, k);
    } else {
      jj = col / w;
      k = col - jj * w;
    }
    const bool ylo = jj > 0, yhi = jj < h - 1, xlo = k > 0, xhi = k < w - 1;
    float lo[9], mid[9], hi[9];  // planes z-1, z, z+1 around the column
    load_plane(src, z0 - 1, col, hw, w, d, colv, ylo, yhi, xlo, xhi, lane, lo);
    load_plane(src, z0, col, hw, w, d, colv, ylo, yhi, xlo, xhi, lane, mid);
#pragma unroll
    for (int zz = 0; zz < kSlab; ++zz) {
      const int z = z0 + zz;
      if (z >= d) break;  // the whole block
      load_plane(src, z + 1, col, hw, w, d, colv, ylo, yhi, xlo, xhi, lane, hi);
      const float* slot = sg + (zz * cols + t) * kStride;
      const bool zlo = z > 0, zhi = z < d - 1;
      float acc;
      if (kOnChip) {
        acc = own ? slot[0] * mid[4] : 0.0f;
      } else {
        float gsum = 0.0f;
#pragma unroll
        for (int dd = 0; dd < kGates3d; ++dd) {
          gsum += own ? gate_f(__ldg(gm + (long long)dd * vol + z * hw + col)) : 0.0f;
        }
        acc = own ? (1.0f - gsum) * mid[4] : 0.0f;
      }
#pragma unroll
      for (int n = 0; n < 27; ++n) {
        if (n == 13) continue;
        const int dd = n < 13 ? n : n - 1;
        const int oz = n / 9 - 1, oy = n / 3 % 3 - 1, ox = n % 3 - 1;
        // the neighbour at p + off (forward) or q - off (adjoint)
        const int sz = kAdjoint ? -oz : oz, sy = kAdjoint ? -oy : oy, sx = kAdjoint ? -ox : ox;
        const float* pl = sz < 0 ? lo : sz > 0 ? hi : mid;
        const float nb = pl[3 * (sy + 1) + sx + 1];
        float g;
        if (kOnChip && dd < kSmem) {
          g = own ? slot_gate<G>(slot, dd) : 0.0f;
        } else if (!kAdjoint) {
          g = own ? gate_f(__ldg(gm + (long long)dd * vol + z * hw + col)) : 0.0f;
        } else {  // w_d at the source voxel, which must lie inside
          const bool ok = own && (sz < 0 ? zlo : sz > 0 ? zhi : true) &&
                          (sy < 0 ? ylo : sy > 0 ? yhi : true) &&
                          (sx < 0 ? xlo : sx > 0 ? xhi : true);
          g = ok ? gate_f(__ldg(gm + (long long)dd * vol + (z + sz) * hw + col + sy * w + sx))
                 : 0.0f;
        }
        acc = fmaf(g, nb, acc);
      }
      if (own) dst[z * hw + col] = acc;
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        lo[e] = mid[e];
        mid[e] = hi[e];
      }
    }
  }
}

// Runs `steps` steps (brick_step) on each of m_count volumes, from src0 =
// x_0 (forward) or v_T (adjoint).  Step i writes `out` if it is the last,
// else states[slot % nslots] with slot i (forward: x_{i+1}) or steps-2-i
// (adjoint: v_{T-1-i}).  nslots is steps-1 where every state is kept, else
// 2: two buffers in turn.
//
// The volume's bricks (slabs of kSlab z-planes, each cut into `parts` runs
// of `cols` columns; brick b is slab b / parts, part b % parts) are dealt
// out to the grid.  !kLoop: block b runs brick b, and per volume reads its
// gates from HBM once, kSmem planes of them into shared memory beside the
// centre weight (the adjoint's w_d[q - off_d], the centre weight from the
// voxel's own).  kLoop (kSmem 0; a volume with more bricks than the grid
// has blocks, too deep or too wide): block b runs bricks b, b + gridDim.x,
// ..., every gate read from device memory at each step.  A thread reads
// and writes only its own shared-memory slots, so the block needs no
// barrier of its own.
//
// The states are written and read by other blocks within the launch, so
// their loads never use the read-only path; the grid barrier between steps
// orders them (its fences make the next step's loads, L1-cached or not,
// see this step's stores).  kSmem, the gate planes in shared memory, is a
// constant of the instantiation, so that where a gate comes from is
// decided at compile time.
template <int kSmem, bool kAdjoint, bool kLoop, typename G>
__device__ __forceinline__ void sweep(const G* __restrict__ gates,  // [M,26,D,H,W]
                                      const float* src0, float* out, float* states,
                                      int m_count, int d, int h, int w, int steps, int nslots,
                                      int parts, int cols) {
  static_assert(!kLoop || kSmem == 0, "a looping sweep holds no gates in shared memory");
  // per owned voxel its centre weight and kSmem gates, voxel-major: an odd
  // stride in words, so that the 32 lanes of a warp hit 32 banks
  constexpr int kStride = slot_words<G>(kSmem);
  extern __shared__ float sg[];  // [kSlab][cols][kStride]
  const int hw = h * w;
  const int vol = hw * d;  // < 2^31: launch_sweep checks
  const long long plane = (long long)m_count * vol;
  const int bricks = (d + kSlab - 1) / kSlab * parts;
  const int z0 = blockIdx.x / parts * kSlab;
  const int part0 = blockIdx.x % parts * cols;

  for (int m = 0; m < m_count; ++m) {
    const G* gm = gates + (long long)m * kGates3d * vol;
    for (int t = threadIdx.x; !kLoop && t < cols; t += kSweepThreads) {
      const int col = part0 + t;
      if (col >= hw) break;
      int k;
      const int jj = divmod(col, w, 1.0f / w, k);
#pragma unroll
      for (int zz = 0; zz < kSlab; ++zz) {
        const int z = z0 + zz;
        if (z >= d) break;
        const int idx = z * hw + col;
        float* slot = sg + (zz * cols + t) * kStride;
        float gsum = 0.0f;
#pragma unroll
        for (int dd = 0; dd < kGates3d; ++dd) {
          const G own_g = gm[(long long)dd * vol + idx];
          gsum += gate_f(own_g);
          if (dd < kSmem) {
            G v = own_g;
            if (kAdjoint) {
              const int sz = z - off_z(dd), sy = jj - off_y(dd), sx = k - off_x(dd);
              v = inside3(sz, sy, sx, d, h, w) ? gm[(long long)dd * vol + (sz * h + sy) * w + sx]
                                               : to_gate<G>(0.0f);
            }
            reinterpret_cast<G*>(slot + 1)[dd] = v;
          }
        }
        slot[0] = 1.0f - gsum;
      }
    }

    for (int step = 0; step < steps; ++step) {
      // the adjoint keeps every state (nslots = steps - 1)
      const float* src = step == 0 ? src0
                       : states + (kAdjoint ? steps - 1 - step : (step - 1) % nslots) * plane;
      float* dst = step == steps - 1 ? out
                 : states + (kAdjoint ? steps - 2 - step : step % nslots) * plane;
      src += (long long)m * vol;
      dst += (long long)m * vol;
      if (!kLoop) {
        brick_step<kSmem, kAdjoint, true, G>(gm, sg, src, dst, z0, part0, cols, d, h, w);
      } else {
        for (int b = blockIdx.x; b < bricks; b += gridDim.x) {
          brick_step<0, kAdjoint, false, G>(gm, sg, src, dst, b / parts * kSlab,
                                            b % parts * cols, cols, d, h, w);
        }
      }
      if (step < steps - 1) cg::this_grid().sync();  // the cooperative launch's grid barrier
    }
  }
}

// Launches `kernel` (its instantiation at n_smem gate planes in shared
// memory, or the looping one at 0) cooperatively on `grid` blocks; refuses
// a plan it cannot run.
template <typename Kernel, typename G>
cudaError_t launch_sweep(Kernel kernel, int n_smem, const G* gates, const float* src0,
                         float* out, float* states, int m, int d, int h, int w, int steps,
                         int nslots, int grid, int parts, int cols, cudaStream_t stream) {
  const long long hw = (long long)h * w;
  const long long bricks = (long long)(d + kSlab - 1) / kSlab * parts;
  // voxel indices within a volume are ints
  if (hw * d >= (1LL << 31) || parts <= 0 || cols <= 0 || parts * (long long)cols < hw ||
      (parts - 1) * (long long)cols >= hw || grid <= 0 || grid > bricks ||
      (steps > 1 && nslots <= 0) || (grid < bricks && n_smem != 0) ||
      (grid == bricks && hw >= (1 << 22))) {
    return cudaErrorInvalidValue;
  }
  // the looping sweep keeps nothing in shared memory
  const size_t smem =
      grid < bricks ? 0 : sizeof(float) * (size_t)slot_words<G>(n_smem) * kSlab * cols;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &src0, &out, &states, &m, &d, &h, &w, &steps, &nslots, &parts, &cols};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kSweepThreads), args,
                                     smem, stream);
}

// The gate planes in shared memory that the sweep is built for
// (ops/cspn3d_cuda.py:SMEM_PLANES); `launch(S, false)` is called with S one
// of them, `launch(0, true)` where the grid has fewer blocks than the
// volume has bricks, and another n_smem is refused.
#define CSPN3D_FOR_SMEM_PLANES(loop, n_smem, launch) \
  if (loop) return launch(0, true);                   \
  switch (n_smem) {                                   \
    case 26: return launch(26, false);                \
    case 24: return launch(24, false);                \
    case 22: return launch(22, false);                \
    case 20: return launch(20, false);                \
    case 18: return launch(18, false);                \
    case 16: return launch(16, false);                \
    case 14: return launch(14, false);                \
    case 12: return launch(12, false);                \
    case 10: return launch(10, false);                \
    case 8: return launch(8, false);                  \
    case 6: return launch(6, false);                  \
    case 4: return launch(4, false);                  \
    case 2: return launch(2, false);                  \
    case 0: return launch(0, false);                  \
    default: return cudaErrorInvalidValue;            \
  }

}  // namespace
