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
// What bounds it on the card: instruction issue on the FP32 pipe. A term is
// 33 instructions with the MUFU rsqrt (far_term in nodes.cuh, as in the
// hierarchical far kernel), and the 48 bytes of a summary row are shared by
// the T targets of the row.
//
// What the design does about that:
// - A block is one target row: T / 2 threads of two targets each, times
//   `parts` (single_split in ops/cuda_treecode.py), so the three 16-byte
//   shared loads of a node serve two terms and the card has enough warps.
// - The near mask is read once a stage, not once a term: the block reads
//   `per` mask entries a thread, and a warp ballot and a shuffle scan over
//   the warps' counts give each unmasked summary its slot in index order.
//   Only those summaries are staged, their constants scaled as they are
//   stored (m by G c^3, tr by -1.5 G c^5, S by -3 G c^5), so a masked tile
//   costs its mask byte and the term loop has no test. Part p takes the
//   staged rows p, p + parts, ...; the parts' sums are added in part order
//   through shared memory.
// - The next stage's mask bytes and summary rows (masked or not: no load
//   waits on a mask byte) are loaded into registers before this stage is
//   summed, and stored after the next stage's counts are in: two
//   __syncthreads a stage. At most 64 registers a thread, so that four
//   blocks of 256 threads share a multiprocessor.
// - The bare rsqrt instruction; the wrapper requires a normal eps2.
// The slots follow the mask in index order and nothing is atomic, so the
// result is bitwise the same on every run, as the TPU's multiply by
// (1 - mask) made it. The TPU padded the tile axis to 128 lanes; nothing
// here needs that.

#include <cuda_runtime.h>

#include "nodes.cuh"

namespace {

// kMaxThreads and kMaxPer are SINGLE_MAX_THREADS and SINGLE_MAX_ENTRIES in
// ops/cuda_treecode.py, whose single_split keeps within them: (kMaxThreads
// / 32) x kMaxPer warp counts fit one warp's scan.
constexpr int kMaxThreads = 512;
constexpr int kMaxPer = 2;       // mask entries a thread reads a stage, at most
constexpr int kTargets = 2;      // target bodies a thread

// Two blocks of 512 threads a multiprocessor (at most 64 registers).
__global__ void __launch_bounds__(kMaxThreads, 2)
far_single_kernel(const float4* __restrict__ bodies, int tile, int parts, int per,
                  const float4* __restrict__ summ, int k_s,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ out, float c2, float eps2, float gc) {
  // per x threads staged node rows of three quads; after the sweep, the
  // parts' sums.
  extern __shared__ float4 node[];
  __shared__ int count[32];  // unmasked entries of each (read j, warp) of a stage
  const int threads = blockDim.x;
  const int half = tile / kTargets;          // threads of a part
  const bool worker = threadIdx.x < half * parts;  // the block is rounded up to whole warps
  const int p = threadIdx.x / half;          // part of the row's summaries
  const int b = threadIdx.x - p * half;
  const int row = blockIdx.x;
  const size_t i = static_cast<size_t>(row) * tile + b;  // targets i and i + half
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 me0 = worker ? bodies[i] : zero;
  const float4 me1 = worker ? bodies[i + half] : zero;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = threads >> 5;
  const int win = per * threads;             // mask entries a stage
  const int n_stages = (k_s + win - 1) / win;
  const unsigned char* mrow = mask + static_cast<size_t>(row) * k_s;
  const float c4 = c2 * c2;
  const float kq = -2.5f * c2;               // 7.5 c^6 / (-3 c^4)
  const float mono = c2 * gc;                // m' = G c^3 m
  const float trace = -1.5f * c4 * gc;       // tr' = -1.5 G c^5 tr
  const float quad = -3.f * c4 * gc;         // S' = -3 G c^5 S
  // This thread's entries of a stage: e = s win + j threads + threadIdx.x.
  unsigned char near[kMaxPer];   // nonzero: masked, or past K_s
  float4 nxt[kMaxPer][3];
  const auto load = [&](int s) {
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
      const int e = s * win + j * threads + threadIdx.x;
      const bool in = j < per && e < k_s;
      near[j] = in ? mrow[e] : 1;
      if (in) {
        const float4* src = summ + static_cast<size_t>(e) * 3;
        nxt[j][0] = src[0];
        nxt[j][1] = src[1];
        nxt[j][2] = src[2];
      }
    }
  };

  float ax0 = 0.f, ay0 = 0.f, az0 = 0.f, ax1 = 0.f, ay1 = 0.f, az1 = 0.f;
  if (n_stages > 0) load(0);
  for (int s = 0; s < n_stages; ++s) {
    bool live[kMaxPer];
    unsigned bal[kMaxPer];
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
      live[j] = !near[j];
      bal[j] = __ballot_sync(0xffffffffu, live[j]);
      if (lane == 0 && j < per) count[j * warps + warp] = __popc(bal[j]);
    }
    // The counts are in, and every thread is done with the last stage's rows.
    __syncthreads();
    // Entries in index order are (j, warp, lane): an inclusive scan of the
    // per x warps counts, one a lane.
    const int c = lane < per * warps ? count[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
      const int first = __shfl_sync(0xffffffffu, incl - c, (j * warps + warp) & 31);
      if (live[j]) {
        float4* dst = node + 3 * (first + __popc(bal[j] & below));
        dst[0] = scale_node_quad(nxt[j][0], 0, mono, quad, trace);
        dst[1] = scale_node_quad(nxt[j][1], 1, mono, quad, trace);
        dst[2] = scale_node_quad(nxt[j][2], 2, mono, quad, trace);
      }
    }
    if (s + 1 < n_stages) load(s + 1);
    __syncthreads();
    if (worker) {
      // This part's staged rows: p, p + parts, ... below total.
      const int mine = total > p ? (total - 1 - p) / parts + 1 : 0;
      const float4* nd = node + 3 * p;
#pragma unroll 2
      for (int m = 0; m < mine; ++m, nd += 3 * parts) {
        const float4 a = nd[0];  // cx cy cz m'
        const float4 q = nd[1];  // qxx' qyy' qzz' qxy'
        const float4 r = nd[2];  // qxz' qyz' tr' 0
        far_term(a, q, r, me0, c2, eps2, kq, ax0, ay0, az0);
        far_term(a, q, r, me1, c2, eps2, kq, ax1, ay1, az1);
      }
    }
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(node);  // (parts, T, 3)
  if (worker) {
    float* r0 = red + (static_cast<size_t>(p) * tile + b) * 3;
    float* r1 = r0 + 3 * half;
    r0[0] = ax0;
    r0[1] = ay0;
    r0[2] = az0;
    r1[0] = ax1;
    r1[1] = ay1;
    r1[2] = az1;
  }
  __syncthreads();
  const int n3 = 3 * tile;
  float* o = out + static_cast<size_t>(row) * n3;
  for (int k = threadIdx.x; k < n3; k += threads) {
    float sum = red[k];
    for (int q = 1; q < parts; ++q) sum += red[q * n3 + k];
    o[k] = sum;
  }
}

}  // namespace

// bodies: (>= n, 4) float32 rows whose xyz are the targets; summ: (>= k_s,
// 12) float32 level-0 summary rows; mask: (n / tile, k_s) bytes, nonzero for
// a near tile; out: (n, 3) float32; gc = G c. tile divides n, is a multiple
// of 32 and at most 1,024. A block is one target row: tile / 2 x parts
// threads, rounded up to whole warps, at most 512; each reads `per` (1 or 2)
// mask entries a stage (single_split in ops/cuda_treecode.py). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int nbody_far_single(const float* bodies, int n, int tile, int parts, int per,
                                const float* summ, int k_s, const unsigned char* mask,
                                float* out, float c2, float eps2, float gc, void* stream) {
  if (n <= 0) return 0;
  const int threads = (tile / kTargets * parts + 31) / 32 * 32;
  if (tile <= 0 || tile % 32 || tile > 1024 || n % tile || k_s < 0 || parts < 1 ||
      threads > kMaxThreads || per < 1 || per > kMaxPer)
    return static_cast<int>(cudaErrorInvalidValue);
  // The staged rows (48 bytes each) hold the parts' sums (24 bytes a
  // thread); beside them the kernel's static 32 counts.
  const size_t shmem = static_cast<size_t>(per) * threads * 3 * sizeof(float4);
  if (shmem + 32 * sizeof(int) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        far_single_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  far_single_kernel<<<n / tile, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), tile, parts, per,
      reinterpret_cast<const float4*>(summ), k_s, mask, out, c2, eps2, gc);
  return static_cast<int>(cudaGetLastError());
}
