// near_field_kernel: the treecode's exact near field for Hopper (sm_90a).
//
// Replaces n_body_problem_tpu/ops/treecode.py:_near_flat_kernel (:1286),
// the TPU kernel behind _near_field_flat_cols (:1352).
//
// What it computes: for every target row t (T = tile consecutive Morton
// bodies) the exact softened pull of the source tiles its work chunks name,
//   d = p_j - p_i;  w = m_j' rsqrt(|d|^2 c^2 + eps2)^3;  acc_i += w d,
// with m_j' = G c^3 m_j pre-scaled (and zero for VIP bodies) by the wrapper.
// Chunk p holds `entries` source tiles flat_src[p E:(p+1) E] of src_tile
// bodies each for target row chunk_tgt[p]. The chunks of one target are
// contiguous and chunk_tgt is non-decreasing, with the sentinel K_t on the
// unused tail; a source id of K_s names the zero tile after the last body.
//
// What bounds it on the card: arithmetic, as in the all-pairs kernel: about
// 13 FMA-pipe instructions and one MUFU rsqrt per pair, against 16 bytes
// per source body staged once per chunk for the whole row of T threads.
//
// What the design does about that: one block per target row and one thread
// per target body; the block finds its own chunk range by binary search in
// chunk_tgt, so the sentinel tail costs nothing and no atomics are needed.
// Each chunk's source bodies (at most 2,048, float4) are staged in shared
// memory and read as broadcasts; sentinel entries are neither loaded nor
// computed. The loop order is fixed, so the result is bitwise the same on
// every run, as the TPU kernel's sequential grid made it.

#include <cuda_runtime.h>

#include "lists.cuh"

namespace {

constexpr int kChunkBodies = 2048;  // CHUNK_LANES in ops/treecode.py

__global__ void __launch_bounds__(1024)
near_field_kernel(const float4* __restrict__ bodies, int src_tile, int entries,
                  int k_s, const int* __restrict__ flat_src,
                  const int* __restrict__ chunk_tgt, int n_chunks,
                  float* __restrict__ out, float c2, float eps2) {
  __shared__ float4 src[kChunkBodies];
  const int t = blockIdx.x;
  const int i = t * blockDim.x + threadIdx.x;
  const float4 me = bodies[i];
  const int c0 = lower_bound(chunk_tgt, n_chunks, t);
  const int c1 = lower_bound(chunk_tgt, n_chunks, t + 1);
  const int lanes = entries * src_tile;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int c = c0; c < c1; ++c) {
    const int* ids = flat_src + static_cast<size_t>(c) * entries;
    for (int k = threadIdx.x; k < lanes; k += blockDim.x) {
      const int e = k / src_tile;
      const int s = ids[e];
      if (s != k_s) src[k] = bodies[static_cast<size_t>(s) * src_tile + (k - e * src_tile)];
    }
    __syncthreads();
    for (int e = 0; e < entries; ++e) {
      if (ids[e] == k_s) continue;  // the zero tile adds nothing
      const float4* tile = src + e * src_tile;
#pragma unroll 8
      for (int j = 0; j < src_tile; ++j) {
        const float4 b = tile[j];
        // Subtract first, scale the squared distance after (treecode.py:1316-1321).
        const float dx = b.x - me.x;
        const float dy = b.y - me.y;
        const float dz = b.z - me.z;
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        const float inv = rsqrtf(fmaf(r2, c2, eps2));
        const float w = b.w * (inv * inv * inv);
        ax = fmaf(w, dx, ax);
        ay = fmaf(w, dy, ay);
        az = fmaf(w, dz, az);
      }
    }
    __syncthreads();
  }
  out[3 * i + 0] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
}

}  // namespace

// bodies: (n + src_tile, 4) float32 [x y z G c^3 m_tree], zero tile last;
// flat_src: (>= n_chunks * entries,) int32; chunk_tgt: (n_chunks,) int32;
// out: (n, 3) float32. tile (threads a block) divides n, is a multiple of
// 32 and at most 1,024; entries * src_tile <= 2,048. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int nbody_near_field(const float* bodies, int n, int tile, int src_tile,
                                int entries, const int* flat_src, const int* chunk_tgt,
                                int n_chunks, float* out, float c2, float eps2,
                                void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile > 1024 || n % tile || entries * src_tile > kChunkBodies)
    return static_cast<int>(cudaErrorInvalidValue);
  near_field_kernel<<<n / tile, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), src_tile, entries, n / src_tile,
      flat_src, chunk_tgt, n_chunks, out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
