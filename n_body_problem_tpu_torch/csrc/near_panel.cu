// near_panel_kernel: the dense treecode's exact near field for Hopper
// (sm_90a).
//
// Replaces n_body_problem_tpu/ops/treecode.py:_near_kernel (:718), the TPU
// kernel behind _near_field_pallas (:760).
//
// What it computes: for every target tile k (T consecutive Morton bodies)
// the exact softened pull of its gathered panel of W = M T body rows
// [x y z m'] (gather.cu), m' = G c^3 m pre-scaled (zero for VIP bodies):
//   d = p_j - p_i;  w = m_j' rsqrt(|d|^2 c^2 + eps2)^3;  acc_i += w d.
//
// What bounds it on the card: arithmetic, as in the all-pairs kernel: about
// 13 FMA-pipe instructions and one MUFU rsqrt per pair, against 16 bytes per
// panel body that the T bodies of the tile share.
//
// What the design does about that: one block per target tile with S = 128 / T
// threads per target body (S = 1 when T does not divide 128), so a tile of
// 32 bodies still runs four warps. The block stages 2,048 panel rows (32 KB)
// at a time in shared memory with coalesced loads; slice s of the threads
// takes the s-th of S equal parts of each staged stretch and reads it as
// broadcasts. The S partial sums are added in slice order at the end. No
// atomics and a fixed order: bitwise the same on every run. The gather stays
// a kernel of its own (as on the TPU), so each kernel has its own check.

#include <cuda_runtime.h>

namespace {

constexpr int kStage = 2048;  // panel rows staged a pass
constexpr int kBlock = 128;   // threads a block when T divides it

__global__ void __launch_bounds__(1024)
near_panel_kernel(const float4* __restrict__ bodies, int tile,
                  const float4* __restrict__ panels, int width,
                  float* __restrict__ out, float c2, float eps2) {
  __shared__ float4 stage[kStage];
  __shared__ float part[3][kBlock];
  const int splits = blockDim.x / tile;
  const int b = threadIdx.x % tile;       // body in the tile
  const int s = threadIdx.x / tile;       // slice of the panel
  const int i = blockIdx.x * tile + b;
  const float4 me = bodies[i];
  const float4* pan = panels + static_cast<size_t>(blockIdx.x) * width;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int c0 = 0; c0 < width; c0 += kStage) {
    const int len = min(kStage, width - c0);
    for (int k = threadIdx.x; k < len; k += blockDim.x) stage[k] = pan[c0 + k];
    __syncthreads();
    const int lo = len * s / splits, hi = len * (s + 1) / splits;
#pragma unroll 8
    for (int j = lo; j < hi; ++j) {
      const float4 p = stage[j];
      // Subtract first, scale the squared distance after (treecode.py:734-739).
      const float dx = p.x - me.x;
      const float dy = p.y - me.y;
      const float dz = p.z - me.z;
      const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      const float inv = rsqrtf(fmaf(r2, c2, eps2));
      const float w = p.w * (inv * inv * inv);
      ax = fmaf(w, dx, ax);
      ay = fmaf(w, dy, ay);
      az = fmaf(w, dz, az);
    }
    __syncthreads();
  }
  if (splits > 1) {
    part[0][threadIdx.x] = ax;
    part[1][threadIdx.x] = ay;
    part[2][threadIdx.x] = az;
    __syncthreads();
    if (s) return;
    for (int q = 1; q < splits; ++q) {
      ax += part[0][q * tile + b];
      ay += part[1][q * tile + b];
      az += part[2][q * tile + b];
    }
  }
  out[3 * i + 0] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
}

}  // namespace

// bodies: (>= k tile, 4) float32 rows whose xyz are the targets; panels:
// (k, width, 4) float32; out: (k tile, 3) float32. tile is a multiple of 32
// and at most 1,024. Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_near_panel(const float* bodies, int tile, const float* panels, int k,
                                int width, float* out, float c2, float eps2,
                                void* stream) {
  if (k <= 0) return 0;
  if (tile <= 0 || tile % 32 || tile > 1024 || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = kBlock % tile == 0 ? kBlock : tile;
  near_panel_kernel<<<k, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), tile,
      reinterpret_cast<const float4*>(panels), width, out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
