// symmetric_acc_kernel: half-pair (Newton's third law) softened gravity for
// Hopper (sm_90a), f32.
//
// Replaces n_body_problem_tpu/ops/pallas_symmetric.py:_symmetric_kernel in
// its "f32" mode, and plays the role of the reference's VERSION 3 kernel
// cal_acc_advanced (kernel.cu:703-774): every unordered pair is evaluated
// once, the action goes to the row body and the reaction to the column body.
//
// What it computes: acc (N, 3) = the same sum as allpairs_acc_kernel with
// pos_i == pos_j, from N (N - 1) / 2 pair evaluations instead of N^2.
//
// What bounds it on the card: instruction issue on the FP32 pipe. A pair both
// ways is about 17 FP32 instructions and one MUFU rsqrt, against O(N) bytes.
// Whatever else a pair costs comes on top: the reaction has to cross threads,
// and a shared-memory float atomicAdd (a compare-and-swap loop) three times
// a pair cost more than the pair itself. On an NVIDIA H100 80GB HBM3 at
// 700.00 W this kernel takes 1.76 ms at 65,536 bodies, 1.41 times what the
// card needs to issue 19.5 instructions a pair at 1,980 MHz (1.25 ms); the
// all-pairs kernel stands at about the same share of its own floor.
//
// What the design does about that:
// - Bodies are cut into K = N / 512 tiles. A thread keeps R = 4 row bodies
//   and their actions in registers (128 threads x 4 = one row tile), so one
//   16-byte shared load of a column body serves four pairs.
// - The reaction rides a rotation inside the warp, as in vip.cu: at step k
//   of a 32-column sub-panel lane l meets column (l + k) mod 32, adds its
//   four rows' reaction on it to three registers and takes the running sums
//   of the next column from lane l + 1. After 32 steps lane l holds the
//   warp's reaction on column l: three shuffles for four pairs, no atomic.
//   Each warp writes its sums to its own row of shared memory; the block
//   adds the four rows in a fixed order.
// - A block takes one row tile i on one diagonal s of the staggered coverage
//   (row tile i meets column tile (i + s) mod K, s = 0 .. K/2;
//   pallas_symmetric.py:13-18): block b has i = b mod K and s = b / K, as
//   block_tiles in ops/cuda_symmetric.py says. Its action and its reaction go
//   to global memory once each, so a global atomicAdd comes once in about 85
//   pairs. Longer blocks (a strip of diagonals with the next column tile
//   prefetched, the action flushed once a strip) were tried and were no
//   faster at any size: the card balances many short blocks better.
// - s = 0 is the strict upper triangle of the tile (masked by index); for
//   even K the last diagonal pairs every tile twice, so only rows i < K/2
//   take it (pallas_symmetric.py:157-161).
//
// The TPU kernel's MXU devices (tile-centred [x y z 1] reaction panels,
// bf16 splits) are not carried over: the reaction is summed directly as
// -sum_i m_i' u_ij d_ij.
//
// Blocks add their sums into the zeroed output with global atomicAdd, so the
// order of the sums changes from run to run and the result is not bitwise
// reproducible; it agrees with the all-pairs sum to float32 rounding.

#include <cuda_runtime.h>

#include "pairs.cuh"

namespace {

constexpr int kThreads = 128;       // threads a block
constexpr int kRows = 4;            // row bodies a thread
constexpr int kT = kThreads * kRows;  // bodies a tile (KERNEL_TILE in ops/cuda_symmetric.py)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// One row tile against one column tile in shared memory. Thread t holds rows
// q * kThreads + t of the tile; `red` is this warp's (3, kT) reaction rows.
template <bool kDiag>
__device__ __forceinline__ void tile_pass(const float4 (&me)[kRows], float (&ax)[kRows],
                                          float (&ay)[kRows], float (&az)[kRows],
                                          const float4* __restrict__ col,
                                          float* __restrict__ red, int t, int lane,
                                          float c2, float eps2) {
  for (int sub = 0; sub < kT; sub += 32) {
    float rx = 0.f, ry = 0.f, rz = 0.f;
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int c = sub + ((lane + k) & 31);
      const float4 o = col[c];
      float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        // Subtract first, scale the squared distance after.
        const float dx = o.x - me[q].x;
        const float dy = o.y - me[q].y;
        const float dz = o.z - me[q].z;
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        const float inv = rsqrt_normal(fmaf(r2, c2, eps2));
        float u = inv * inv * inv;
        // The diagonal tile takes the strict upper triangle: column > row.
        if (kDiag && c <= q * kThreads + t) u = 0.f;
        const float wa = o.w * u;      // action weight: m_c' u
        const float wb = me[q].w * u;  // reaction weight: m_r' u
        ax[q] = fmaf(wa, dx, ax[q]);
        ay[q] = fmaf(wa, dy, ay[q]);
        az[q] = fmaf(wa, dz, az[q]);
        tx = q ? fmaf(wb, dx, tx) : wb * dx;
        ty = q ? fmaf(wb, dy, ty) : wb * dy;
        tz = q ? fmaf(wb, dz, tz) : wb * dz;
      }
      // Hand the column's sum to the lane that meets it next step.
      rx = __shfl_sync(kAll, rx - tx, (lane + 1) & 31);
      ry = __shfl_sync(kAll, ry - ty, (lane + 1) & 31);
      rz = __shfl_sync(kAll, rz - tz, (lane + 1) & 31);
    }
    red[0 * kT + sub + lane] = rx;
    red[1 * kT + sub + lane] = ry;
    red[2 * kT + sub + lane] = rz;
  }
}

__global__ void __launch_bounds__(kThreads)
symmetric_acc_kernel(const float4* __restrict__ body, int k_tiles,
                     float* __restrict__ out, float c2, float eps2) {
  __shared__ float4 col[kT];               // the column tile
  __shared__ float red[kWarps][3 * kT];    // each warp's reaction sums
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i = blockIdx.x % k_tiles;
  const int s = blockIdx.x / k_tiles;
  // Even K: the last diagonal belongs to the rows i < K/2 only.
  if (!(k_tiles & 1) && s == k_tiles / 2 && i >= s) return;
  const int j = i + s >= k_tiles ? i + s - k_tiles : i + s;

  float4 me[kRows];
  float ax[kRows], ay[kRows], az[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    me[q] = body[i * kT + q * kThreads + t];
    col[q * kThreads + t] = body[j * kT + q * kThreads + t];
    ax[q] = ay[q] = az[q] = 0.f;
  }
  __syncthreads();
  if (s == 0)
    tile_pass<true>(me, ax, ay, az, col, red[warp], t, lane, c2, eps2);
  else
    tile_pass<false>(me, ax, ay, az, col, red[warp], t, lane, c2, eps2);
  __syncthreads();
  float* col_out = out + 3 * (j * kT);
  float* row_out = out + 3 * (i * kT);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int c = q * kThreads + t;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float sum = red[0][a * kT + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w][a * kT + c];
      atomicAdd(col_out + 3 * c + a, sum);
    }
    atomicAdd(row_out + 3 * c + 0, ax[q]);
    atomicAdd(row_out + 3 * c + 1, ay[q]);
    atomicAdd(row_out + 3 * c + 2, az[q]);
  }
}

}  // namespace

// body: (n, 4) float32 rows (x, y, z, G c^3 m) with n a multiple of 512;
// out: (n, 3) float32, zeroed by the caller. One block for each of the
// K = n / 512 row tiles on each of the K / 2 + 1 diagonals (symmetric_blocks
// in ops/cuda_symmetric.py). Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_symmetric_acc(const float* body, int n, float* out, float c2,
                                   float eps2, void* stream) {
  if (n <= 0) return 0;
  const long long k = n / kT;
  if (n % kT || k * (k / 2 + 1) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  symmetric_acc_kernel<<<static_cast<unsigned>(k * (k / 2 + 1)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(body), static_cast<int>(k), out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
