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
// and a shared-memory float atomic add (a compare-and-swap loop) three times
// a pair cost more than the pair itself. On an NVIDIA H100 80GB HBM3 at
// 700.00 W this kernel takes 1.75 ms of device time at 65,536 bodies, 1.39
// times what the card needs to issue 19.5 instructions a pair at 1,980 MHz
// (1.25 ms); the all-pairs kernel stands at about the same share of its own
// floor.
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
//   block_tiles in ops/cuda_symmetric.py says. Longer blocks (a strip of
//   diagonals with the next column tile prefetched, the action flushed once
//   a strip) were tried and were no faster at any size: the card balances
//   many short blocks better.
// - s = 0 is the strict upper triangle of the tile (masked by index); for
//   even K the last diagonal pairs every tile twice, so only rows i < K/2
//   take it (pallas_symmetric.py:157-161).
//
// The TPU kernel's MXU devices (tile-centred [x y z 1] reaction panels,
// bf16 splits) are not carried over: the reaction is summed directly as
// -sum_i m_i' u_ij d_ij.
//
// The output in a fixed order, with no atomics. The TPU's grid runs in
// order, so the JAX kernel carries its sums from step to step; here blocks
// run in any order, and adding their sums with global atomics would give
// other last bits on every launch. Instead each block stores its sums into
// slots, (K, N, 3) float32 scratch from the caller: slot u of tile t holds
// the force on tile t's bodies from tile u's (symmetric_slots in
// ops/cuda_symmetric.py). Block (i, s) stores its action into slot j of
// tile i and its reaction into slot i of tile j; on s = 0 both land in
// slot i of tile i, as action + reaction. Every slot has exactly one
// writer (the blocks of an even K's last diagonal that do nothing leave no
// slot empty: their pairs are the other half's). A second kernel,
// symmetric_sum_kernel, adds each body's K slots in slot order. So every
// launch gives the same bits. The cost is bytes: the slots are written
// once and read once, 24 K N bytes. On the same card the sum takes 0.041 ms
// at 65,536 bodies (2.3 % of a call of 1.83 ms, against 1.80 ms for the
// kernel that added with atomics, timed in turns) and 0.53 ms at 262,144
// (1.9 % of 28.1 ms, against 27.5); the pair kernel itself is as fast as
// before (kernel_compare).

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
                     float* __restrict__ slots, float c2, float eps2) {
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
  // Slot u of tile t is slots[u][t * kT .. (t + 1) * kT][3].
  const size_t n3 = static_cast<size_t>(3) * k_tiles * kT;
  float* row_out = slots + j * n3 + 3 * (i * kT);   // tile i, slot j: the action
  float* col_out = slots + i * n3 + 3 * (j * kT);   // tile j, slot i: the reaction
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int c = q * kThreads + t;
    float react[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float sum = red[0][a * kT + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w][a * kT + c];
      react[a] = sum;
    }
    if (s == 0) {  // i == j: one slot, the action and then the reaction
      row_out[3 * c + 0] = ax[q] + react[0];
      row_out[3 * c + 1] = ay[q] + react[1];
      row_out[3 * c + 2] = az[q] + react[2];
    } else {
      row_out[3 * c + 0] = ax[q];
      row_out[3 * c + 1] = ay[q];
      row_out[3 * c + 2] = az[q];
      col_out[3 * c + 0] = react[0];
      col_out[3 * c + 1] = react[1];
      col_out[3 * c + 2] = react[2];
    }
  }
}

// out[e] = the sum of slots[u][e] over u = 0 .. k-1, in slot order, e < n3.
// The loads are independent of the running sum, so the unrolled loop keeps
// several in flight; the adds stay in order.
__global__ void symmetric_sum_kernel(const float* __restrict__ slots, int k, int n3,
                                     float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n3) return;
  const float* p = slots + e;
  float sum = p[0];
#pragma unroll 8
  for (int u = 1; u < k; ++u) sum += p[static_cast<size_t>(u) * n3];
  out[e] = sum;
}

}  // namespace

// slots: (k, n3 / 3, 3) float32, every element written since it was
// allocated; out: (n3 / 3, 3) float32. Sums the k slots of every element in
// slot order into out, on `stream`; returns cudaGetLastError(). The f32 and
// the bf16x3/mixed kernels' second launch.
extern "C" int nbody_symmetric_sum(const float* slots, int k, int n3, float* out,
                                   void* stream) {
  if (n3 <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  symmetric_sum_kernel<<<(n3 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, k, n3, out);
  return static_cast<int>(cudaGetLastError());
}

// body: (n, 4) float32 rows (x, y, z, G c^3 m) with n a multiple of 512;
// slots: (n / 512, n, 3) float32 scratch; out: (n, 3) float32, which need
// not be zeroed. One block for each of the K = n / 512 row tiles on each of
// the K / 2 + 1 diagonals (symmetric_blocks in ops/cuda_symmetric.py), then
// the slots' sum. Launches both on `stream`; returns cudaGetLastError().
extern "C" int nbody_symmetric_acc(const float* body, int n, float* slots, float* out,
                                   float c2, float eps2, void* stream) {
  if (n <= 0) return 0;
  const long long k = n / kT;
  if (n % kT || k * (k / 2 + 1) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  symmetric_acc_kernel<<<static_cast<unsigned>(k * (k / 2 + 1)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(body), static_cast<int>(k), slots, c2, eps2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return nbody_symmetric_sum(slots, static_cast<int>(k), 3 * n, out, stream);
}
