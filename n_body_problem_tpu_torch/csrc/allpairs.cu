// allpairs_acc_kernel: blocked all-pairs softened gravity for Hopper (sm_90a).
//
// Replaces n_body_problem_tpu/ops/pallas_force.py:_force_kernel (the TPU
// Pallas kernel behind pallas_block_acc / pallas_acc), and plays the role of
// the reference's VERSION 1 shared-memory kernel (kernel.cu:828-884).
//
// What it computes: acc (Ni, 3) of the row bodies due to every column body,
//   d = p_j - p_i;  w = m_j' * rsqrt(|d|^2 c^2 + eps2)^3;  acc_i = sum_j w d,
// with m_j' = G c^3 m_j pre-scaled by the wrapper. Row and column sets are
// separate arrays (the block form), so the multi-GPU ring can reuse it.
//
// What bounds it on the card: arithmetic. Each pair costs about 13 FP32
// FMA-pipe instructions plus one MUFU rsqrt, against O(N) bytes of input
// for O(N^2) pairs, so it is compute-bound at any N worth a kernel.
//
// What the design does about that: one thread per row body keeps its
// position and its three running sums in registers. The block stages
// 256 column bodies at a time in shared memory as float4 (x, y, z, m'), and
// every thread reads each staged body as a broadcast (no bank conflicts),
// so the inner loop is loads from shared memory and FMAs only. Self pairs
// (d = 0) and zero-mass padding (w = 0) add exactly nothing, so there is no
// mask; the column tail past Nj is staged as zero-mass bodies.
//
// The loop order is fixed and nothing is atomic, so the result is bitwise
// the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // row bodies per block, one per thread
constexpr int kTile = 256;     // column bodies staged per shared-memory pass

__global__ void __launch_bounds__(kThreads)
allpairs_acc_kernel(const float* __restrict__ pos_i, int ni,
                    const float4* __restrict__ cols, int nj,
                    float* __restrict__ out, float c2, float eps2) {
  __shared__ float4 tile[kTile];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < ni;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) {
    xi = pos_i[3 * row + 0];
    yi = pos_i[3 * row + 1];
    zi = pos_i[3 * row + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < nj; base += kTile) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < nj ? cols[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 b = tile[k];
      // Subtract first, scale the squared distance after (pallas_force.py:54-58).
      const float dx = b.x - xi;
      const float dy = b.y - yi;
      const float dz = b.z - zi;
      const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      const float inv = rsqrtf(fmaf(r2, c2, eps2));
      const float w = b.w * (inv * inv * inv);
      ax = fmaf(w, dx, ax);
      ay = fmaf(w, dy, ay);
      az = fmaf(w, dz, az);
    }
    __syncthreads();
  }
  if (live) {
    out[3 * row + 0] = ax;
    out[3 * row + 1] = ay;
    out[3 * row + 2] = az;
  }
}

}  // namespace

// pos_i: (ni, 3) float32; cols: (nj, 4) float32 rows (x, y, z, G c^3 m);
// out: (ni, 3) float32. Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_allpairs_acc(const float* pos_i, int ni, const float* cols,
                                  int nj, float* out, float c2, float eps2,
                                  void* stream) {
  if (ni <= 0) return 0;
  const int blocks = (ni + kThreads - 1) / kThreads;
  allpairs_acc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos_i, ni, reinterpret_cast<const float4*>(cols), nj, out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable text of a CUDA error code returned by an entry point.
extern "C" const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
