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
// What bounds it on the card: instruction issue on the FP32 pipe. A term is
// 33 instructions with the MUFU rsqrt, and the 3 KB of node rows a chunk
// reads are shared by the T targets of the row.
//
// What the design does about that:
// - A thread holds two targets, so the three 16-byte shared loads of a
//   node's row serve two terms: with one target a thread those loads keep
//   the shared memory's port as busy as the FP32 pipe.
// - A block is `sub` targets of one row (sub / 2 threads) times `parts`
//   (far_split in ops/cuda_treecode.py); part p takes the entries p,
//   p + parts, ... of every stage of the row's chunks, and the parts' sums
//   are added in part order through shared memory.
// - The row's node rows are staged `stage_chunks` chunks at a time in two
//   shared buffers. The ids of stage s + 2 and the node rows of stage s + 1
//   are loaded into registers before stage s is summed, and stored after
//   it, so the two-level gather waits behind a stage of terms; one
//   __syncthreads a stage.
// - The node's constants are scaled as they are stored: m by G c^3, tr by
//   -1.5 G c^5, the quadrupole by -3 G c^5, so a term is u^3 (m' + u^2 (tr' -
//   2.5 c^2 u^2 d'S'd)) d + u^5 S'd: 33 instructions with the bare rsqrt
//   (scale_node_quad and far_term in nodes.cuh, which the single-level far
//   kernel shares); the wrapper requires a normal eps2.
// No atomics and a fixed order: bitwise the same on every run.

#include <cuda_runtime.h>

#include "lists.cuh"
#include "nodes.cuh"

namespace {

constexpr int kEntries = 64;     // FAR_ENTRIES in ops/treecode.py
// kMaxThreads and kSlots are FAR_MAX_THREADS and FAR_SLOTS in
// ops/cuda_treecode.py, whose far_split keeps within them.
constexpr int kMaxThreads = 512;
constexpr int kTargets = 2;      // target bodies a thread
constexpr int kSlots = 2;        // node quads a thread stages a stage, at most

// Two blocks of 512 threads a multiprocessor (at most 64 registers).
__global__ void __launch_bounds__(kMaxThreads, 2)
far_field_kernel(const float4* __restrict__ bodies, const float4* __restrict__ summ,
                 const int* __restrict__ far_src, const int* __restrict__ far_tgt,
                 int n_chunks, int tile, int sub, int parts, int stage_chunks,
                 float* __restrict__ out, float c2, float eps2, float gc) {
  // Two stages of 3 x 64 x stage_chunks node quads, then 3 x 2 x threads floats.
  extern __shared__ float4 stage[];
  const int t = blockIdx.x / (tile / sub);  // the target row of this block's bodies
  const int threads = blockDim.x;
  const int half = sub / kTargets;          // threads of a part
  const int p = threadIdx.x / half;         // part of the row's entries
  const int b = threadIdx.x - p * half;
  const int i = blockIdx.x * sub + b;       // this thread's targets: i and i + half
  const float4 me0 = bodies[i];
  const float4 me1 = bodies[i + half];
  const int c0 = lower_bound(far_tgt, n_chunks, t);
  const int c1 = lower_bound(far_tgt, n_chunks, t + 1);
  const int* ids = far_src + static_cast<size_t>(c0) * kEntries;
  const int total = (c1 - c0) * kEntries;
  const int per = stage_chunks * kEntries;  // entries a stage
  const int quads = 3 * per;                // node quads a stage
  const int n_stages = (total + per - 1) / per;
  const float c4 = c2 * c2;
  const float kq = -2.5f * c2;              // 7.5 c^6 / (-3 c^4)
  const float mono = c2 * gc;               // m' = G c^3 m
  const float trace = -1.5f * c4 * gc;      // tr' = -1.5 G c^5 tr
  const float quad = -3.f * c4 * gc;        // S' = -3 G c^5 S
  // This thread's node quads of a stage: k = threadIdx.x + j threads is the
  // (k % 3)-th quad of entry k / 3.
  int id[kSlots];
  float4 nxt[kSlots];
  const auto load_ids = [&](int st) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = threadIdx.x + j * threads;
      const int e = st * per + k / 3;
      id[j] = k < quads && e < total ? ids[e] : -1;
    }
  };
  const auto load_nodes = [&]() {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = threadIdx.x + j * threads;
      nxt[j] = id[j] >= 0 ? summ[static_cast<size_t>(id[j]) * 3 + k % 3]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const auto store = [&](float4* dst) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = threadIdx.x + j * threads;
      if (k >= quads) continue;
      dst[k] = scale_node_quad(nxt[j], k % 3, mono, quad, trace);
    }
  };

  if (n_stages > 0) {
    load_ids(0);
    load_nodes();
    if (n_stages > 1) load_ids(1);
    store(stage);
  }
  __syncthreads();
  float ax0 = 0.f, ay0 = 0.f, az0 = 0.f, ax1 = 0.f, ay1 = 0.f, az1 = 0.f;
  for (int s = 0; s < n_stages; ++s) {
    const float4* cur = stage + (s & 1) * quads;
    if (s + 1 < n_stages) {
      load_nodes();
      if (s + 2 < n_stages) load_ids(s + 2);
    }
    // This part's entries of the stage: p, p + parts, ... below cnt.
    const int cnt = min(per, total - s * per);
    const int mine = cnt > p ? (cnt - p + parts - 1) / parts : 0;
    const float4* node = cur + 3 * p;
#pragma unroll 2
    for (int m = 0; m < mine; ++m, node += 3 * parts) {
      const float4 a = node[0];  // cx cy cz m'
      const float4 q = node[1];  // qxx' qyy' qzz' qxy'
      const float4 r = node[2];  // qxz' qyz' tr' 0
      far_term(a, q, r, me0, c2, eps2, kq, ax0, ay0, az0);
      far_term(a, q, r, me1, c2, eps2, kq, ax1, ay1, az1);
    }
    if (s + 1 < n_stages) store(stage + ((s + 1) & 1) * quads);
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(stage + 2 * quads);  // (6, threads)
  const float mine6[6] = {ax0, ay0, az0, ax1, ay1, az1};
#pragma unroll
  for (int c = 0; c < 6; ++c) red[c * threads + threadIdx.x] = mine6[c];
  __syncthreads();
  if (p) return;
  for (int q = 1; q < parts; ++q) {
    const float* o = red + q * half + b;
    ax0 += o[0 * threads];
    ay0 += o[1 * threads];
    az0 += o[2 * threads];
    ax1 += o[3 * threads];
    ay1 += o[4 * threads];
    az1 += o[5 * threads];
  }
  out[3 * i + 0] = ax0;
  out[3 * i + 1] = ay0;
  out[3 * i + 2] = az0;
  out[3 * (i + half) + 0] = ax1;
  out[3 * (i + half) + 1] = ay1;
  out[3 * (i + half) + 2] = az1;
}

}  // namespace

// bodies: (>= n, 4) float32 rows whose xyz are the targets; summ:
// (K_total + 1, 12) float32 node rows; far_src: (>= n_chunks * 64,) int32;
// far_tgt: (n_chunks,) int32; out: (n, 3) float32; gc = G c. tile divides n;
// sub divides tile and is a multiple of 32; a block is sub / 2 x parts <= 512
// threads, a multiple of 32, two targets a thread, and stages stage_chunks
// chunks at a time, at most two node quads a thread (far_split in
// ops/cuda_treecode.py). Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_far_field(const float* bodies, int n, int tile, int sub, int parts,
                               int stage_chunks, const float* summ, const int* far_src,
                               const int* far_tgt, int n_chunks, float* out, float c2,
                               float eps2, float gc, void* stream) {
  if (n <= 0) return 0;
  const int threads = sub / kTargets * parts;
  if (tile <= 0 || n % tile || sub <= 0 || sub % 32 || tile % sub || parts < 1 ||
      threads > kMaxThreads || threads % 32 || stage_chunks < 1 ||
      3 * kEntries * stage_chunks > kSlots * threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(2) * 3 * kEntries * stage_chunks * sizeof(float4) +
                       3 * kTargets * threads * sizeof(float);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        far_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  far_field_kernel<<<n / sub, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), reinterpret_cast<const float4*>(summ),
      far_src, far_tgt, n_chunks, tile, sub, parts, stage_chunks, out, c2, eps2, gc);
  return static_cast<int>(cudaGetLastError());
}
