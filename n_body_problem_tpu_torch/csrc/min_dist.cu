// min_tile_dist_kernel: the acceptance build's minimum distances for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes the same function in
// plain jnp (n_body_problem_tpu/ops/treecode.py:_min_tile_dist, :163), and
// XLA fuses its elementwise chain into the minimum, so only the (K_t, K_l)
// result reaches memory. PyTorch runs the chain eagerly: at 1,048,576 bodies
// the port's plain version wrote eight (8,192 x 16,384) float32 matrices a
// chunk through device memory, 94 % of a rebuild. This kernel is that
// fusion, written out.
//
// What it computes: for target tile i (bodies [i T, (i+1) T) of the n
// targets, T = `tile`) and node j of the k_l centres,
//   out[i, j] = sqrt(min_b |c_j - y_b|^2),
// with d^2 formed as the plain version forms it: dx = cx - x (and y, z),
// then (dx*dx + dy*dy) + dz*dz, each operation rounded on its own. A
// minimum is exact and the square root correctly rounded, so the result is
// bitwise ops/cuda_treecode.py:min_tile_dist_plain's. A NaN in a tile's
// bodies or a node's centre gives NaN, as torch.amin does.
//
// What bounds it on the card: FP32 instruction issue. A distance is nine
// instructions (three subtractions, three multiplies, two adds and the
// minimum). No FMA, by design: contracting dx*dx + dy*dy into one would
// round once where the twin rounds twice, and the lists built from these
// distances would part from the CPU's and the JAX package's. The
// (K_t, K_l) output is written once, a fraction of the time.
//
// What the design does about that:
// - A block is one target tile against blockDim.x x kNodes nodes; each
//   thread holds kNodes centres and their running minima in registers. The
//   tile's bodies are staged in shared memory as float4 rows, read by all
//   threads at one address (a broadcast, no bank conflict), so one shared
//   load serves kNodes distances.
// - Thread t of the block takes nodes base + t + r blockDim.x, so the
//   centres' loads and the output's stores of each r coalesce.
// - __fsub_rn / __fmul_rn / __fadd_rn keep nvcc's -fmad=true from
//   contracting. The fast loop takes fminf, one instruction; a block whose
//   tile holds a non-finite coordinate, or a thread with a non-finite
//   centre, takes a loop that carries a NaN through instead (only those can
//   give one: finite differences never do).
// - The output is indexed in 64 bits: K_t x K_l passes 2^31 at 4,194,304
//   bodies. The kernel allocates nothing and never synchronises with the
//   host, so the treecode's graphs capture it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 64;
constexpr int kNodes = 4;         // centres a thread
constexpr int kStage = 256;       // tile bodies staged at a time
constexpr long long kFewBlocks = 4096;  // fewer than this: smaller blocks, more of them

constexpr float kMaxFloat = 3.40282347e38f;

// False for an infinity or a NaN (a NaN fails every comparison).
__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return fabsf(x) <= kMaxFloat && fabsf(y) <= kMaxFloat && fabsf(z) <= kMaxFloat;
}

template <bool kNaN>
__device__ __forceinline__ void sweep(const float4* __restrict__ body, int count,
                                      const float (&px)[kNodes], const float (&py)[kNodes],
                                      const float (&pz)[kNodes], float (&m)[kNodes]) {
#pragma unroll 4
  for (int b = 0; b < count; ++b) {
    const float4 p = body[b];
#pragma unroll
    for (int r = 0; r < kNodes; ++r) {
      const float dx = __fsub_rn(px[r], p.x);
      const float dy = __fsub_rn(py[r], p.y);
      const float dz = __fsub_rn(pz[r], p.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if constexpr (kNaN) {
        m[r] = (d2 < m[r] || d2 != d2) ? d2 : m[r];
      } else {
        m[r] = fminf(m[r], d2);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
min_tile_dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ z, int tile, const float* __restrict__ cx,
                     const float* __restrict__ cy, const float* __restrict__ cz, int k_l,
                     float* __restrict__ out) {
  __shared__ float4 body[kStage];
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const int base = blockIdx.y * blockDim.x * kNodes + threadIdx.x;

  float px[kNodes], py[kNodes], pz[kNodes], m[kNodes];
  bool bad = false;
#pragma unroll
  for (int r = 0; r < kNodes; ++r) {
    const int j = min(base + r * static_cast<int>(blockDim.x), k_l - 1);
    px[r] = cx[j];
    py[r] = cy[j];
    pz[r] = cz[j];
    m[r] = __int_as_float(0x7f800000);  // +inf
    bad |= !finite3(px[r], py[r], pz[r]);
  }
  bool odd = false;
  for (int b = threadIdx.x; b < tile; b += blockDim.x) {
    odd |= !finite3(x[first + b], y[first + b], z[first + b]);
  }
  const bool nan_path = __syncthreads_or(odd) || bad;

  for (int s = 0; s < tile; s += kStage) {
    const int count = min(kStage, tile - s);
    __syncthreads();
    for (int b = threadIdx.x; b < count; b += blockDim.x) {
      const long long i = first + s + b;
      body[b] = make_float4(x[i], y[i], z[i], 0.f);
    }
    __syncthreads();
    if (nan_path) {
      sweep<true>(body, count, px, py, pz, m);
    } else {
      sweep<false>(body, count, px, py, pz, m);
    }
  }

  float* row = out + static_cast<long long>(blockIdx.x) * k_l;
#pragma unroll
  for (int r = 0; r < kNodes; ++r) {
    const int j = base + r * static_cast<int>(blockDim.x);
    if (j < k_l) row[j] = __fsqrt_rn(m[r]);
  }
}

}  // namespace

// x, y, z: (n,) float32 target bodies, n a multiple of tile; cx, cy, cz:
// (k_l,) float32 centres; out: (n / tile, k_l) float32. Launches one kernel
// on `stream` (none when there is nothing to compute); returns
// cudaGetLastError().
extern "C" int nbody_min_tile_dist(const float* x, const float* y, const float* z, int n,
                                   int tile, const float* cx, const float* cy, const float* cz,
                                   int k_l, float* out, void* stream) {
  if (tile <= 0 || n < 0 || k_l < 0 || n % tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_t = n / tile;
  if (k_t == 0 || k_l == 0) return 0;
  // The largest block that still gives the card kFewBlocks blocks, down to
  // kMinThreads: the coarse levels and small N have few nodes a row.
  int threads = kMaxThreads;
  auto columns = [&](int t) { return (k_l + t * kNodes - 1) / (t * kNodes); };
  while (threads > kMinThreads &&
         static_cast<long long>(k_t) * columns(threads) < kFewBlocks) {
    threads /= 2;
  }
  const dim3 grid(k_t, columns(threads));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  min_tile_dist_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, tile, cx, cy, cz, k_l, out);
  return static_cast<int>(cudaGetLastError());
}
