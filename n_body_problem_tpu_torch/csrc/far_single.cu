// far_single_kernel: the treecode's single-level far field for Hopper (sm_90a).
//
// Replaces n_body_problem_tpu/ops/treecode.py:_far_kernel (:436), the TPU
// kernel behind _far_field_pallas_cols (:505), which the single-level flat
// path and the dense path call.
//
// What it computes: every target body against all K_s level-0 source-tile
// summaries, softened monopole + quadrupole (treecode.py:459-486):
//   u = (c^2 |d|^2 + eps2)^-1/2,  d = com - y,  S d = quad . d,
//   acc += G c [ (m c^2 u^3 - 1.5 c^4 tr(S) u^5 + 7.5 c^6 d'Sd u^7) d
//                - 3 c^4 u^5 S d ],
// except the source tiles that the near mask of the body's target row marks
// (the near field and the VIP sweep cover those). Summary rows are 12
// floats: cx cy cz m qxx qyy qzz qxy qxz qyz tr 0.
//
// What bounds it on the card: arithmetic, about 40 FP32 operations and one
// MUFU rsqrt per body-tile pair; the summaries (48 B a tile) and the mask
// bytes are read once per block and shared by all its bodies.
//
// What the design does about that: one thread per target body, 128 threads
// a block (128 / T target rows of T bodies; one row when T does not divide
// 128). The block stages 64 summary rows and the matching mask bytes of its
// rows in shared memory at a time and reads them as broadcasts. T is a
// multiple of 32, so a warp lies in one target row and a masked tile is
// skipped by a warp-uniform branch: the same sum as the TPU's multiply by
// (1 - mask). The TPU padded the tile axis to 128 lanes; nothing here needs
// that. No atomics and a fixed order: bitwise the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kStage = 64;    // summary rows staged a pass
constexpr int kBlock = 128;   // threads a block when T divides it
constexpr int kMaxRows = kBlock / 32;

__global__ void __launch_bounds__(1024)
far_single_kernel(const float4* __restrict__ bodies, int n, int tile,
                  const float4* __restrict__ summ, int k_s,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ out, float c2, float eps2, float gc) {
  __shared__ float4 node[kStage * 3];
  __shared__ unsigned char masked[kMaxRows * kStage];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int rows = blockDim.x / tile;                  // target rows a block
  const int row0 = blockIdx.x * rows;                   // its first row
  const int k_t = n / tile;
  const unsigned char* mine = masked + (threadIdx.x / tile) * kStage;
  const float4 me = live ? bodies[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float c4 = c2 * c2;
  const float mono = c2 * gc;               // m c^2 u^3
  const float trace = -1.5f * c4 * gc;      // -1.5 c^4 tr u^5
  const float quad = 7.5f * c4 * c2 * gc;   // 7.5 c^6 d'Sd u^7
  const float sd = -3.f * c4 * gc;          // -3 c^4 u^5 S d
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j0 = 0; j0 < k_s; j0 += kStage) {
    const int cnt = min(kStage, k_s - j0);
    for (int k = threadIdx.x; k < cnt * 3; k += blockDim.x)
      node[k] = summ[static_cast<size_t>(j0) * 3 + k];
    for (int k = threadIdx.x; k < rows * cnt; k += blockDim.x) {
      const int r = k / cnt, e = k - r * cnt;
      masked[r * kStage + e] = row0 + r < k_t
          ? mask[static_cast<size_t>(row0 + r) * k_s + j0 + e] : 1;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < cnt; ++e) {
      if (mine[e]) continue;               // warp-uniform: one row a warp
      const float4 a = node[3 * e];        // cx cy cz m
      const float4 b = node[3 * e + 1];    // qxx qyy qzz qxy
      const float4 q = node[3 * e + 2];    // qxz qyz tr 0
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
  if (live) {
    out[3 * i + 0] = ax;
    out[3 * i + 1] = ay;
    out[3 * i + 2] = az;
  }
}

}  // namespace

// bodies: (>= n, 4) float32 rows whose xyz are the targets; summ: (>= k_s,
// 12) float32 level-0 summary rows; mask: (n / tile, k_s) bytes, nonzero for
// a near tile; out: (n, 3) float32; gc = G c. tile divides n, is a multiple
// of 32 and at most 1,024. Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_far_single(const float* bodies, int n, int tile, const float* summ,
                                int k_s, const unsigned char* mask, float* out,
                                float c2, float eps2, float gc, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile % 32 || tile > 1024 || n % tile || k_s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = kBlock % tile == 0 ? kBlock : tile;
  far_single_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), n, tile,
      reinterpret_cast<const float4*>(summ), k_s, mask, out, c2, eps2, gc);
  return static_cast<int>(cudaGetLastError());
}
