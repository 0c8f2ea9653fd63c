// vip_both_kernel + vip_sum_kernel: the treecode's two-way VIP sweep for
// Hopper (sm_90a).
//
// Replaces n_body_problem_tpu/ops/treecode.py:_vip_kernel (:805), the TPU
// kernel behind _vip_both_pallas_cols (:877).
//
// What it computes: one pass over the N x W pairs of every body (rows) with
// the W "VIP" bodies (panel) gives both directions (Newton's third law):
//   u = rsqrt(c^2 |d|^2 + eps2)^3,  d = p_j - p_i,
//   action_i   =  sum_j m_j' u d     (the panel's pull on every row)
//   reaction_j = -sum_i m_i' u d     (every row's pull on each VIP: the
//                                     VIPs' complete acceleration)
// with masses pre-scaled by G c^3 in the wrapper.
//
// What bounds it on the card: instruction issue on the FP32 pipe, as in the
// symmetric kernel: a pair both ways is 17 FP32 instructions and the MUFU
// rsqrt, and the reaction is a sum over all N rows for each of the W VIPs,
// which on the TPU's sequential grid was a resident accumulator and here has
// to cross threads, warps and blocks.
//
// What the design does about that:
// - A thread keeps R = 4 row bodies and their actions in registers (128
//   threads, 512 rows a block), so one 16-byte shared load of a VIP serves
//   four pairs, and the reaction rotation below costs three shuffles for
//   four pairs: at step k of a 32-VIP sub-panel lane l meets VIP
//   (l + k) mod 32, adds its four rows' reaction on it and takes the running
//   sums of the next VIP from lane l + 1, so after 32 steps lane l holds the
//   warp's reaction on VIP l. The bare rsqrt (pairs.cuh); the wrapper
//   requires a normal eps2.
// - The grid is cut both ways (vip_split in ops/cuda_treecode.py): blockIdx.x
//   is a group of 512 rows, blockIdx.y a piece of the panel, staged 256 VIPs
//   at a time. A block's four warps add their reactions in warp order and
//   write one partial a (row group, VIP); with several pieces the actions
//   go to one partial a (piece, row).
// - vip_sum_kernel adds the partials in a fixed order: the actions over the
//   pieces in piece order, and the reactions over the row groups with 256
//   threads for every 32 VIP components, eight warps each summing every
//   eighth group in group order, then the eight sums in warp order.
// Nothing is atomic, so both outputs are bitwise the same on every run.

#include <cuda_runtime.h>

#include "pairs.cuh"

namespace {

constexpr int kThreads = 128;               // threads a block
constexpr int kRows = 4;                    // row bodies a thread
constexpr int kGroup = kThreads * kRows;    // rows a block (VIP_ROWS in ops/cuda_treecode.py)
constexpr int kStage = 256;                 // VIPs staged per shared-memory pass
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 256;            // vip_sum_kernel's block
constexpr int kSumWarps = kSumThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// Eight blocks of 128 threads a multiprocessor (at most 64 registers): the
// 1,024 blocks vip_split gives 524,288 bodies are then one wave.
__global__ void __launch_bounds__(kThreads, 8)
vip_both_kernel(const float4* __restrict__ rows, int n, const float4* __restrict__ panel,
                int w, int piece, float* __restrict__ react_part,
                float* __restrict__ action, float c2, float eps2) {
  // Each 32-VIP sub-panel twice in a row, so that lane l meets VIP
  // (l + k) mod 32 at entry l + k: one address a lane, offsets fixed by k.
  __shared__ float4 pan[kStage / 32][64];
  __shared__ float red[kWarps][3][kStage];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row0 = blockIdx.x * kGroup + t;
  float4 me[kRows];
  float ax[kRows], ay[kRows], az[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    // Rows past n take part as massless bodies at the origin.
    const int i = row0 + q * kThreads;
    me[q] = i < n ? rows[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    ax[q] = ay[q] = az[q] = 0.f;
  }
  const int next = (lane + 1) & 31;
  const int v0 = blockIdx.y * piece;
  const int v1 = min(w, v0 + piece);
  float* part = react_part + static_cast<size_t>(blockIdx.x) * 3 * w;
  for (int base = v0; base < v1; base += kStage) {
    const int cnt = min(kStage, v1 - base);
#pragma unroll
    for (int m = 0; m < kStage / kThreads; ++m) {
      const int j = m * kThreads + t;
      const float4 v = j < cnt ? panel[base + j] : make_float4(0.f, 0.f, 0.f, 0.f);
      pan[j / 32][j % 32] = v;
      pan[j / 32][j % 32 + 32] = v;
    }
    __syncthreads();
    for (int sub = 0; sub < cnt; sub += 32) {
      const float4* mine = &pan[sub / 32][lane];
      float rx = 0.f, ry = 0.f, rz = 0.f;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float4 b = mine[k];
        float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float dx = b.x - me[q].x;
          const float dy = b.y - me[q].y;
          const float dz = b.z - me[q].z;
          const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
          const float inv = rsqrt_normal(fmaf(r2, c2, eps2));
          const float u = inv * inv * inv;
          const float wa = b.w * u;      // action weight
          const float wr = me[q].w * u;  // reaction weight
          ax[q] = fmaf(wa, dx, ax[q]);
          ay[q] = fmaf(wa, dy, ay[q]);
          az[q] = fmaf(wa, dz, az[q]);
          tx = q ? fmaf(wr, dx, tx) : wr * dx;
          ty = q ? fmaf(wr, dy, ty) : wr * dy;
          tz = q ? fmaf(wr, dz, tz) : wr * dz;
        }
        // Hand this VIP's sum to the lane that meets it next step.
        rx = __shfl_sync(kAll, rx - tx, next);
        ry = __shfl_sync(kAll, ry - ty, next);
        rz = __shfl_sync(kAll, rz - tz, next);
      }
      red[warp][0][sub + lane] = rx;
      red[warp][1][sub + lane] = ry;
      red[warp][2][sub + lane] = rz;
    }
    __syncthreads();
    // The four warps' sums in warp order, one partial a (row group, VIP).
    // The next pass's staging touches `pan` only; its __syncthreads keeps
    // `red` until every thread has read it.
    for (int k = t; k < 3 * cnt; k += kThreads) {
      const int a = k / cnt;
      const int j = k - a * cnt;
      float s = red[0][a][j];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s += red[q][a][j];
      part[3 * (base + j) + a] = s;
    }
  }
  float* act = action + static_cast<size_t>(blockIdx.y) * n * 3;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + q * kThreads;
    if (i < n) {
      act[3 * i + 0] = ax[q];
      act[3 * i + 1] = ay[q];
      act[3 * i + 2] = az[q];
    }
  }
}

// Blocks [0, act_blocks): action[k] = sum over pieces p of act_part[p][k],
// k < n3, in piece order. The others: react[k] = sum over row groups g of
// react_part[g][k], k < w3, 32 consecutive k a block; warp j adds the groups
// j, j + 8, ... in order, then the eight warps' sums are added in warp order.
__global__ void __launch_bounds__(kSumThreads)
vip_sum_kernel(const float* __restrict__ act_part, int pieces, int n3,
               float* __restrict__ action, int act_blocks,
               const float* __restrict__ react_part, int groups, int w3,
               float* __restrict__ react) {
  if (static_cast<int>(blockIdx.x) < act_blocks) {
    const int k = blockIdx.x * kSumThreads + threadIdx.x;
    if (k >= n3) return;
    float s = act_part[k];
    for (int p = 1; p < pieces; ++p) s += act_part[static_cast<size_t>(p) * n3 + k];
    action[k] = s;
    return;
  }
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = (blockIdx.x - act_blocks) * 32 + lane;
  float s = 0.f;
  if (k < w3) {
    for (int g = warp; g < groups; g += kSumWarps)
      s += react_part[static_cast<size_t>(g) * w3 + k];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && k < w3) {
    float r = sums[0][lane];
#pragma unroll
    for (int j = 1; j < kSumWarps; ++j) r += sums[j][lane];
    react[k] = r;
  }
}

}  // namespace

// rows: (n, 4) and panel: (w, 4) float32 [x y z G c^3 m]; the grid is
// `groups` = ceil(n / 512) row groups x `pieces` pieces of `piece` VIPs, a
// multiple of 32 (vip_split in ops/cuda_treecode.py). react_part: (groups,
// w, 3) float32 scratch; act_part: (pieces, n, 3) float32 scratch, read only
// when pieces > 1; action: (n, 3) and react: (w, 3) float32. Launches the
// pair kernel and, when w > 0, the summing kernel on `stream`; returns
// cudaGetLastError().
extern "C" int nbody_vip_both(const float* rows, int n, const float* panel, int w,
                              int pieces, int piece, float* react_part, float* act_part,
                              float* action, float* react, float c2, float eps2,
                              void* stream) {
  if (n <= 0) return 0;
  if (w < 0 || pieces < 1 || pieces > 65535 || piece < 32 || piece % 32 ||
      static_cast<long long>(pieces) * piece < w ||
      (w > 0 && static_cast<long long>(pieces - 1) * piece >= w))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (n + kGroup - 1) / kGroup;
  vip_both_kernel<<<dim3(groups, pieces), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(rows), n, reinterpret_cast<const float4*>(panel),
      w, piece, react_part, pieces > 1 ? act_part : action, c2, eps2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w == 0) return static_cast<int>(err);
  const int n3 = 3 * n, w3 = 3 * w;
  const int act_blocks = pieces > 1 ? (n3 + kSumThreads - 1) / kSumThreads : 0;
  vip_sum_kernel<<<act_blocks + (w3 + 31) / 32, kSumThreads, 0, s>>>(
      act_part, pieces, n3, action, act_blocks, react_part, groups, w3, react);
  return static_cast<int>(cudaGetLastError());
}
