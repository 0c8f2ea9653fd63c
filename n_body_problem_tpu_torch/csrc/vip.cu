// vip_both_kernel + vip_react_sum_kernel: the treecode's two-way VIP sweep
// for Hopper (sm_90a).
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
// What bounds it on the card: arithmetic for the action, as in the
// all-pairs kernel; the reaction is a sum over all N rows for each of the W
// VIPs, which on the TPU's sequential grid was a resident accumulator and
// here has to cross threads, warps and blocks.
//
// What the design does about that: one thread per row body (256 a block),
// the panel staged 256 bodies at a time in shared memory. Within a warp the
// reaction sums ride a rotation: at step k of a 32-VIP sub-panel, lane l
// computes VIP (l + k) mod 32 and then takes the running reaction sum from
// lane l + 1, so after 32 steps lane l holds the warp's sum for VIP l —
// three shuffles a pair, no atomics. The 8 warps' sums are added in a fixed
// order through shared memory into one partial per (block, VIP); a second
// small kernel sums the partials over the blocks in a fixed order. Nothing
// is atomic, so both outputs are bitwise the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;   // row bodies a block (VIP_ROWS in ops/cuda_treecode.py)
constexpr int kPanel = 256;  // VIP bodies staged per shared-memory pass
constexpr int kWarps = kRows / 32;
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kRows)
vip_both_kernel(const float4* __restrict__ rows, int n, const float4* __restrict__ panel,
                int w, float* __restrict__ partial, float* __restrict__ action,
                float c2, float eps2) {
  __shared__ float4 pan[kPanel];
  __shared__ float red[kWarps][kPanel][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRows + threadIdx.x;
  // Rows past n take part in the shuffles as massless bodies.
  const float4 me = i < n ? rows[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < w; base += kPanel) {
    const int j = base + threadIdx.x;
    pan[threadIdx.x] = j < w ? panel[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int sub = 0; sub < kPanel; sub += 32) {
      float rx = 0.f, ry = 0.f, rz = 0.f;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float4 b = pan[sub + ((lane + k) & 31)];
        const float dx = b.x - me.x;
        const float dy = b.y - me.y;
        const float dz = b.z - me.z;
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        const float inv = rsqrtf(fmaf(r2, c2, eps2));
        const float u = inv * inv * inv;
        const float wa = b.w * u;   // action weight
        const float wr = me.w * u;  // reaction weight
        ax = fmaf(wa, dx, ax);
        ay = fmaf(wa, dy, ay);
        az = fmaf(wa, dz, az);
        rx = fmaf(-wr, dx, rx);
        ry = fmaf(-wr, dy, ry);
        rz = fmaf(-wr, dz, rz);
        // Hand the sum to the lane that computes this VIP next step.
        rx = __shfl_sync(kAll, rx, (lane + 1) & 31);
        ry = __shfl_sync(kAll, ry, (lane + 1) & 31);
        rz = __shfl_sync(kAll, rz, (lane + 1) & 31);
      }
      red[warp][sub + lane][0] = rx;
      red[warp][sub + lane][1] = ry;
      red[warp][sub + lane][2] = rz;
    }
    __syncthreads();
    if (j < w) {
      float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        sx += red[q][threadIdx.x][0];
        sy += red[q][threadIdx.x][1];
        sz += red[q][threadIdx.x][2];
      }
      float* p = partial + (static_cast<size_t>(blockIdx.x) * w + j) * 3;
      p[0] = sx;
      p[1] = sy;
      p[2] = sz;
    }
    __syncthreads();
  }
  if (i < n) {
    action[3 * i + 0] = ax;
    action[3 * i + 1] = ay;
    action[3 * i + 2] = az;
  }
}

// react[k] = sum over blocks b of partial[b][k], k < 3 w, in block order.
__global__ void vip_react_sum_kernel(const float* __restrict__ partial, int blocks,
                                     int w3, float* __restrict__ react) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= w3) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * w3 + k];
  react[k] = s;
}

}  // namespace

// rows: (n, 4) and panel: (w, 4) float32 [x y z G c^3 m]; partial:
// (ceil(n / 256), w, 3) float32 scratch; action: (n, 3) and react: (w, 3)
// float32. Launches both kernels on `stream`; returns cudaGetLastError().
extern "C" int nbody_vip_both(const float* rows, int n, const float* panel, int w,
                              float* partial, float* action, float* react,
                              float c2, float eps2, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kRows - 1) / kRows;
  vip_both_kernel<<<blocks, kRows, 0, s>>>(
      reinterpret_cast<const float4*>(rows), n, reinterpret_cast<const float4*>(panel),
      w, partial, action, c2, eps2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w <= 0) return static_cast<int>(err);
  const int w3 = 3 * w;
  vip_react_sum_kernel<<<(w3 + 255) / 256, 256, 0, s>>>(partial, blocks, w3, react);
  return static_cast<int>(cudaGetLastError());
}
