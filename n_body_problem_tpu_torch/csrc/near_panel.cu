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
// It is the all-pairs kernel's block form with a column set of its own for
// each row tile.
//
// What bounds it on the card: instruction issue on the FP32 pipe, as in the
// all-pairs kernel: 13 FP32 instructions and one MUFU rsqrt a pair, against
// 16 bytes a panel row that the T targets of the tile share. The panels
// (K W rows, 136 MB at 20,480 bodies) stream from device memory once.
//
// What the design does about that:
// - A thread holds four targets of the tile (pull_rows in pairs.cuh, the
//   all-pairs kernel's pair loop), so one 16-byte shared load serves four
//   pairs; T / 4 threads hold the whole tile.
// - A block is one target tile times `parts` (panel_split in
//   ops/cuda_treecode.py): part p takes the panel rows p, p + parts, ... of
//   every stage, so the parts of one warp read neighbouring rows. The
//   parts' sums are added in part order through shared memory.
// - The panel is staged `stage` rows at a time in two shared buffers with
//   cp.async (pairs.cuh): the copy of stage s + 1 is under way while stage s
//   is summed. One __syncthreads a stage.
// - The bare rsqrt instruction; the wrapper requires a normal eps2.
// The split and every order of summation are fixed by (T, W) and nothing is
// atomic, so the result is bitwise the same on every run. The gather stays a
// kernel of its own (as on the TPU), so each kernel has its own check.

#include <cuda_runtime.h>

#include "pairs.cuh"

namespace {

// kRows and kMaxThreads are PANEL_ROWS and PANEL_MAX_THREADS in
// ops/cuda_treecode.py, whose panel_split keeps within them.
constexpr int kRows = 4;
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
near_panel_kernel(const float4* __restrict__ bodies, int tile, const float4* __restrict__ panels,
                  int width, int parts, int stage, float* __restrict__ out, float c2,
                  float eps2) {
  // Two stages of `stage` panel rows; after the sweep, the parts' sums.
  extern __shared__ float4 buf[];
  const int group = tile / kRows;           // threads of a part
  const int p = threadIdx.x / group;        // part of the panel
  const int g = threadIdx.x - p * group;    // targets g, g + group, ... of the tile
  const float4* me = bodies + static_cast<size_t>(blockIdx.x) * tile + g;
  float xi[kRows], yi[kRows], zi[kRows], ax[kRows], ay[kRows], az[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float4 v = me[q * group];
    xi[q] = v.x;
    yi[q] = v.y;
    zi[q] = v.z;
    ax[q] = ay[q] = az[q] = 0.f;
  }
  const float4* pan = panels + static_cast<size_t>(blockIdx.x) * width;
  const int n_stages = (width + stage - 1) / stage;
  // Rows [s stage, (s + 1) stage) of the panel into `dst`, 16 bytes a copy.
  const auto fetch = [&](int s, float4* dst) {
    const int c0 = s * stage;
    const int cnt = min(stage, width - c0);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) cp_async16(dst + j, pan + c0 + j);
    cp_async_commit();
  };

  if (n_stages > 0) fetch(0, buf);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    // Stage s has landed for every thread, and every thread is done with
    // the other buffer.
    __syncthreads();
    if (s + 1 < n_stages) fetch(s + 1, buf + ((s + 1) & 1) * stage);
    // This part's rows of the stage: p, p + parts, ... below cnt.
    const int cnt = min(stage, width - s * stage);
    const int mine = cnt > p ? (cnt - 1 - p) / parts + 1 : 0;
    const float4* col = buf + (s & 1) * stage + p;
#pragma unroll 4
    for (int m = 0; m < mine; ++m, col += parts)
      pull_rows<kRows>(*col, xi, yi, zi, ax, ay, az, c2, eps2);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(buf);  // (parts, T, 3)
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float* r = red + (p * tile + g + q * group) * 3;
    r[0] = ax[q];
    r[1] = ay[q];
    r[2] = az[q];
  }
  __syncthreads();
  const int n3 = 3 * tile;
  float* o = out + static_cast<size_t>(blockIdx.x) * n3;
  for (int k = threadIdx.x; k < n3; k += blockDim.x) {
    float sum = red[k];
    for (int q = 1; q < parts; ++q) sum += red[q * n3 + k];
    o[k] = sum;
  }
}

}  // namespace

// bodies: (>= k tile, 4) float32 rows whose xyz are the targets; panels:
// (k, width, 4) float32; out: (k tile, 3) float32. tile is a multiple of 32
// and at most 1,024; a block is tile / 4 x parts <= 512 threads and stages
// `stage` panel rows at a time (panel_split in ops/cuda_treecode.py).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_near_panel(const float* bodies, int tile, const float* panels, int k,
                                int width, int parts, int stage, float* out, float c2,
                                float eps2, void* stream) {
  if (k <= 0) return 0;
  const int threads = tile / kRows * parts;
  if (tile <= 0 || tile % 32 || tile > 1024 || width < 0 || parts < 1 ||
      threads > kMaxThreads || stage < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t stages = static_cast<size_t>(2) * stage * sizeof(float4);
  const size_t sums = static_cast<size_t>(3) * tile * parts * sizeof(float);
  const size_t shmem = stages > sums ? stages : sums;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        near_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  near_panel_kernel<<<k, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bodies), tile, reinterpret_cast<const float4*>(panels),
      width, parts, stage, out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
