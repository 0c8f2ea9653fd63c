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
// What bounds it on the card: arithmetic, as for the all-pairs kernel (about
// 13 FP32 instructions and one MUFU rsqrt per pair, O(N) bytes), plus three
// shared-memory atomic adds per pair for the reaction.
//
// Design. Bodies are cut into K = N / 128 tiles. One block of 128 threads
// takes one unordered tile pair, in the reference's staggered-diagonal
// coverage (pallas_symmetric.py:13-18): block b is diagonal s = b / K and
// row tile i = b % K, paired with column tile j = (i + s) mod K, for
// s = 0 .. K/2. For even K the last diagonal pairs every tile twice, so
// only rows i < K/2 take it. That gives exactly K (K + 1) / 2 blocks and
// every unordered pair once. On the diagonal tile (s = 0) only the strict
// upper triangle is evaluated (pallas_symmetric.py:157-161).
//
// Thread t holds row body i*128 + t in registers and sums its action there.
// The column tile sits in shared memory beside a float3 reaction
// accumulator. Thread t visits columns in the staggered order (t + k) mod
// 128, so the threads of a warp hit distinct slots at each step; warps do
// not run in lockstep with each other, so the reaction is added with
// shared-memory atomicAdd. At the end the block adds its 128 row actions and
// 128 column reactions into the zeroed output with global atomicAdd.
//
// The TPU kernel's MXU devices (tile-centred [x y z 1] reaction panels,
// bf16 splits) are not carried over: the reaction is summed directly as
// -sum_i m_i' u_ij d_ij.
//
// Atomics make the order of the sums change from run to run, so the result
// is not bitwise reproducible; it agrees with the all-pairs sum to float32
// rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;  // bodies per tile = threads per block

__global__ void __launch_bounds__(kT)
symmetric_acc_kernel(const float4* __restrict__ body, int k_tiles,
                     float* __restrict__ out, float c2, float eps2) {
  __shared__ float4 col[kT];
  __shared__ float rx[kT], ry[kT], rz[kT];
  const int b = blockIdx.x;
  const int s = b / k_tiles;
  const int i = b - s * k_tiles;
  int j = i + s;
  if (j >= k_tiles) j -= k_tiles;
  const int t = threadIdx.x;

  const float4 me = body[i * kT + t];
  col[t] = body[j * kT + t];
  rx[t] = 0.f;
  ry[t] = 0.f;
  rz[t] = 0.f;
  __syncthreads();

  // On the diagonal tile, column (t + k) is above the diagonal iff
  // 1 <= k < kT - t; off the diagonal every column is taken.
  const bool diag = s == 0;
  const int k_begin = diag ? 1 : 0;
  const int k_end = diag ? kT - t : kT;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int k = k_begin; k < k_end; ++k) {
    const int c = (t + k) & (kT - 1);
    const float4 o = col[c];
    // Subtract first, scale the squared distance after.
    const float dx = o.x - me.x;
    const float dy = o.y - me.y;
    const float dz = o.z - me.z;
    const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
    const float inv = rsqrtf(fmaf(r2, c2, eps2));
    const float u = inv * inv * inv;
    const float wa = o.w * u;   // action weight: m_c' u
    const float wb = me.w * u;  // reaction weight: m_t' u
    ax = fmaf(wa, dx, ax);
    ay = fmaf(wa, dy, ay);
    az = fmaf(wa, dz, az);
    atomicAdd(&rx[c], -wb * dx);
    atomicAdd(&ry[c], -wb * dy);
    atomicAdd(&rz[c], -wb * dz);
  }
  __syncthreads();

  float* row_out = out + 3 * (i * kT + t);
  atomicAdd(row_out + 0, ax);
  atomicAdd(row_out + 1, ay);
  atomicAdd(row_out + 2, az);
  float* col_out = out + 3 * (j * kT + t);
  atomicAdd(col_out + 0, rx[t]);
  atomicAdd(col_out + 1, ry[t]);
  atomicAdd(col_out + 2, rz[t]);
}

}  // namespace

// body: (n, 4) float32 rows (x, y, z, G c^3 m) with n a multiple of 128;
// out: (n, 3) float32, zeroed by the caller. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int nbody_symmetric_acc(const float* body, int n, float* out,
                                   float c2, float eps2, void* stream) {
  if (n <= 0) return 0;
  if (n % kT) return static_cast<int>(cudaErrorInvalidValue);
  const int k = n / kT;
  const long long blocks = static_cast<long long>(k) * (k + 1) / 2;
  symmetric_acc_kernel<<<static_cast<unsigned>(blocks), kT, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(body), k, out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
