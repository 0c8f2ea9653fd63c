// gather_panels_kernel: the dense treecode's near-panel gather for Hopper
// (sm_90a).
//
// Replaces n_body_problem_tpu/ops/treecode.py:_gather_kernel (:617), the
// TPU kernel behind _gather_panels_pallas (:632).
//
// What it computes: a copy. For target tile k, the M source tiles
// near_idx[k, 0..M) of T body rows [x y z m'] each are laid side by side as
// one panel of M T rows: out[k, m T + b] = bodies[near_idx[k, m] T + b].
// The panels are (K, M T, 4) float32, so the near-panel kernel reads 16-byte
// rows.
//
// What bounds it on the card: bytes. It writes K M T 16-byte rows once and
// reads the much smaller body array, which stays in L2.
//
// What the design does about that: one thread per 16-byte output row, in
// output order, so a warp writes 512 contiguous bytes and reads whole source
// rows of T consecutive bodies. The TPU kernel cut the near list into
// segments that fit its scalar memory; a block here reads its own index, so
// one launch covers every panel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_panels_kernel(const float4* __restrict__ bodies, int tile,
                     const int* __restrict__ near_idx, int rows,
                     float4* __restrict__ out) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += gridDim.x * blockDim.x) {
    const int slot = r / tile;            // k M + m
    const int b = r - slot * tile;
    out[r] = bodies[static_cast<size_t>(near_idx[slot]) * tile + b];
  }
}

}  // namespace

// bodies: (>= K_src T, 4) float32 rows, source tile j = rows [j T, (j+1) T);
// near_idx: (k, m_near) int32 in [0, K_src); out: (k, m_near T, 4) float32.
// k * m_near * tile < 2^31. Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_gather_panels(const float* bodies, int tile, const int* near_idx,
                                   int k, int m_near, float* out, void* stream) {
  const long long rows = static_cast<long long>(k) * m_near * tile;
  if (rows <= 0) return 0;
  if (tile <= 0 || rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kThreads - 1) / kThreads;
  gather_panels_kernel<<<static_cast<int>(blocks < 65536 * 16 ? blocks : 65536 * 16),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), tile, near_idx, static_cast<int>(rows),
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
