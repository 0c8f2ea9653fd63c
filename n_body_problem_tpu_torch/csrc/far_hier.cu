// far_field_kernel: the treecode's hierarchical far field for Hopper (sm_90a).
//
// Replaces both n_body_problem_tpu/ops/treecode.py:_far_hier_kernel (:2164)
// and _far_hier_kernel_vmem (:2226), the TPU kernels behind
// _far_field_hier_cols (:2302). The two differ only in where the TPU keeps
// the node-summary panel (VMEM below 3 MiB, one HBM DMA per entry above);
// here the panel stays in device memory and is read through L2, whatever
// its size, so one kernel takes the place of both.
//
// What it computes: for every target row t (T = tile bodies) the softened
// monopole + quadrupole pull of the FAR_ENTRIES = 64 tree nodes each of its
// work chunks names (far_src[p 64:(p+1) 64] for target far_tgt[p]):
//   u = (c^2 |d|^2 + eps2)^-1/2,  d = com - y,  S d = quad . d,
//   acc += G c [ (m c^2 u^3 - 1.5 c^4 tr(S) u^5 + 7.5 c^6 d'Sd u^7) d
//                - 3 c^4 u^5 S d ]                     (treecode.py:2187-2211)
// Node rows are 12 floats: cx cy cz m qxx qyy qzz qxy qxz qyz tr 0; the zero
// sentinel row contributes exactly nothing.
//
// What bounds it on the card: arithmetic (about 45 FP32 instructions and
// one MUFU rsqrt per body-node pair); the 3 KB of node rows a chunk reads
// are shared by the T threads of the row.
//
// What the design does about that: one block per target row, one thread per
// target body; the block finds its chunk range by binary search in far_tgt
// (non-decreasing, sentinel K_t last), stages the chunk's 64 node rows in
// shared memory as float4 and reads them as broadcasts. No atomics and a
// fixed order: bitwise the same on every run.

#include <cuda_runtime.h>

#include "lists.cuh"

namespace {

constexpr int kEntries = 64;  // FAR_ENTRIES in ops/treecode.py

__global__ void __launch_bounds__(1024)
far_field_kernel(const float4* __restrict__ bodies, const float4* __restrict__ summ,
                 const int* __restrict__ far_src, const int* __restrict__ far_tgt,
                 int n_chunks, float* __restrict__ out, float c2, float eps2,
                 float gc) {
  __shared__ float4 node[kEntries * 3];
  const int t = blockIdx.x;
  const int i = t * blockDim.x + threadIdx.x;
  const float4 me = bodies[i];
  const int c0 = lower_bound(far_tgt, n_chunks, t);
  const int c1 = lower_bound(far_tgt, n_chunks, t + 1);
  const float c4 = c2 * c2;
  const float mono = c2 * gc;          // m c^2 u^3
  const float trace = -1.5f * c4 * gc;  // -1.5 c^4 tr u^5
  const float quad = 7.5f * c4 * c2 * gc;  // 7.5 c^6 d'Sd u^7
  const float sd = -3.f * c4 * gc;     // -3 c^4 u^5 S d
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int c = c0; c < c1; ++c) {
    const int* ids = far_src + static_cast<size_t>(c) * kEntries;
    for (int k = threadIdx.x; k < kEntries * 3; k += blockDim.x)
      node[k] = summ[static_cast<size_t>(ids[k / 3]) * 3 + k % 3];
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < kEntries; ++e) {
      const float4 a = node[3 * e];      // cx cy cz m
      const float4 b = node[3 * e + 1];  // qxx qyy qzz qxy
      const float4 q = node[3 * e + 2];  // qxz qyz tr 0
      const float dx = a.x - me.x;
      const float dy = a.y - me.y;
      const float dz = a.z - me.z;
      const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      const float u = rsqrtf(fmaf(c2, r2, eps2));
      const float u2 = u * u;
      const float u3 = u2 * u;
      const float u5 = u3 * u2;
      const float u7 = u5 * u2;
      const float sdx = fmaf(b.x, dx, fmaf(b.w, dy, q.x * dz));
      const float sdy = fmaf(b.w, dx, fmaf(b.y, dy, q.y * dz));
      const float sdz = fmaf(q.x, dx, fmaf(q.y, dy, b.z * dz));
      const float dsd = fmaf(dx, sdx, fmaf(dy, sdy, dz * sdz));
      const float wd = fmaf(mono * a.w, u3, fmaf(trace * q.z, u5, quad * dsd * u7));
      const float ws = sd * u5;
      ax = fmaf(wd, dx, fmaf(ws, sdx, ax));
      ay = fmaf(wd, dy, fmaf(ws, sdy, ay));
      az = fmaf(wd, dz, fmaf(ws, sdz, az));
    }
    __syncthreads();
  }
  out[3 * i + 0] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
}

}  // namespace

// bodies: (>= n, 4) float32 rows whose xyz are the targets; summ:
// (K_total + 1, 12) float32 node rows; far_src: (>= n_chunks * 64,) int32;
// far_tgt: (n_chunks,) int32; out: (n, 3) float32; gc = G c. tile (threads
// a block) divides n, is a multiple of 32 and at most 1,024. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int nbody_far_field(const float* bodies, int n, int tile, const float* summ,
                               const int* far_src, const int* far_tgt, int n_chunks,
                               float* out, float c2, float eps2, float gc,
                               void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile > 1024 || n % tile) return static_cast<int>(cudaErrorInvalidValue);
  far_field_kernel<<<n / tile, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), reinterpret_cast<const float4*>(summ),
      far_src, far_tgt, n_chunks, out, c2, eps2, gc);
  return static_cast<int>(cudaGetLastError());
}
