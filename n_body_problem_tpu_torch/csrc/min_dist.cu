// min_tile_dist_kernel: the acceptance build's minimum distances for Hopper
// (sm_90a); min_dist_open_kernel: the same distances with a hierarchy
// level's opening test in their output pass.
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
//
// The opening test (min_dist_open_kernel). The hierarchical build turns each
// level's distances into the MAC's opens, its far-list key and, at level 0,
// the near ranking's scores. In PyTorch that is about ten elementwise passes
// over every (K_t, K_l) matrix, each a read and a write of gigabytes at the
// large shapes; here each distance is turned into all three before it leaves
// the register, and min_d itself is never written. For target row i (rows
// row_offset onwards of the sources' tiling) and node j, with
// d = max(min_d, tiny), NaN kept:
//   score = amp_j / d^5 / a_med                    (kMac kFlat: amp m r^3)
//         = amp_j / e^5 / a_med, e = max(d - r_j, tiny)  (kHier: amp m rms^2 r)
//         = r_j / d                                (kGeometric)
//   +inf where (i + row_offset) / row_div == j / col_div (they share bodies);
//   opens = score > thresh, far = m_j / (d d), score0 = score (level 0).
// Each operation is rounded on its own in the order of the plain twin
// (ops/cuda_treecode.py:open_test_plain): d^5 = ((d d)(d d)) d, then the two
// divisions; no FMA. So the three outputs are bitwise the twin's, and the
// lists built from them the CPU's. tiny, thresh: the twin's float32 scalars;
// a_med: a device scalar (no host read, so graphs capture the launch).

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

// The thread's kNodes running minima of d^2 (nodes base + r blockDim.x,
// clamped to the last node past k_l) over target tile blockIdx.x.
__device__ __forceinline__ void tile_minima(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            const float* __restrict__ z, int tile,
                                            const float* __restrict__ cx,
                                            const float* __restrict__ cy,
                                            const float* __restrict__ cz, int k_l, int base,
                                            float4* body, float (&m)[kNodes]) {
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  float px[kNodes], py[kNodes], pz[kNodes];
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
}

__global__ void __launch_bounds__(kMaxThreads)
min_tile_dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ z, int tile, const float* __restrict__ cx,
                     const float* __restrict__ cy, const float* __restrict__ cz, int k_l,
                     float* __restrict__ out) {
  __shared__ float4 body[kStage];
  const int base = blockIdx.y * blockDim.x * kNodes + threadIdx.x;
  float m[kNodes];
  tile_minima(x, y, z, tile, cx, cy, cz, k_l, base, body, m);

  float* row = out + static_cast<long long>(blockIdx.x) * k_l;
#pragma unroll
  for (int r = 0; r < kNodes; ++r) {
    const int j = base + r * static_cast<int>(blockDim.x);
    if (j < k_l) row[j] = __fsqrt_rn(m[r]);
  }
}

// The MAC modes of min_dist_open_kernel (ops/cuda_treecode.py:OPEN_MACS).
constexpr int kGeometric = 0;
constexpr int kFlat = 1;
constexpr int kHier = 2;

// A level's opening test: its per-node operands, scalars and outputs.
struct OpenTest {
  const float* amp;     // (k_l,) MAC numerator; unread by kGeometric
  const float* radius;  // (k_l,) node radii; unread by kFlat
  const float* mass;    // (k_l,) node masses, the far key's numerator
  const float* a_med;   // device scalar, the MAC's scale; unread by kGeometric
  float thresh;
  float tiny;
  long long row_offset;
  int row_div;
  int col_div;
  bool* opens;          // (n / tile, k_l) outputs
  float* far;
  float* score;         // level 0 only
};

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

template <int kMac, bool kScore>
__global__ void __launch_bounds__(kMaxThreads)
min_dist_open_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ z, int tile, const float* __restrict__ cx,
                     const float* __restrict__ cy, const float* __restrict__ cz, int k_l,
                     OpenTest p) {
  __shared__ float4 body[kStage];
  const int base = blockIdx.y * blockDim.x * kNodes + threadIdx.x;
  float m[kNodes];
  tile_minima(x, y, z, tile, cx, cy, cz, k_l, base, body, m);

  const long long at = static_cast<long long>(blockIdx.x) * k_l;
  const long long self = (blockIdx.x + p.row_offset) / p.row_div;
  const float a_med = kMac == kGeometric ? 0.f : __ldg(p.a_med);
#pragma unroll
  for (int r = 0; r < kNodes; ++r) {
    const int j = base + r * static_cast<int>(blockDim.x);
    if (j >= k_l) continue;
    const float d = clamp_min(__fsqrt_rn(m[r]), p.tiny);
    float score;
    if constexpr (kMac == kGeometric) {
      score = __fdiv_rn(__ldg(p.radius + j), d);
    } else {
      const float e = kMac == kHier ? clamp_min(__fsub_rn(d, __ldg(p.radius + j)), p.tiny) : d;
      const float e2 = __fmul_rn(e, e);
      score = __fdiv_rn(__fdiv_rn(__ldg(p.amp + j), __fmul_rn(__fmul_rn(e2, e2), e)), a_med);
    }
    if (j / p.col_div == self) score = __int_as_float(0x7f800000);  // +inf
    p.opens[at + j] = score > p.thresh;
    p.far[at + j] = __fdiv_rn(__ldg(p.mass + j), __fmul_rn(d, d));
    if constexpr (kScore) p.score[at + j] = score;
  }
}

// The grid of either kernel: one block a target tile times enough blocks of
// kNodes nodes a thread to cover k_l; the largest block that still gives the
// card kFewBlocks blocks, down to kMinThreads (the coarse levels and small N
// have few nodes a row). False when the grid is too tall.
bool grid_for(int k_t, int k_l, dim3* grid, int* threads) {
  int t = kMaxThreads;
  auto columns = [&](int u) { return (k_l + u * kNodes - 1) / (u * kNodes); };
  while (t > kMinThreads && static_cast<long long>(k_t) * columns(t) < kFewBlocks) t /= 2;
  *grid = dim3(k_t, columns(t));
  *threads = t;
  return grid->y <= 65535;
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
  dim3 grid;
  int threads;
  if (!grid_for(k_t, k_l, &grid, &threads)) return static_cast<int>(cudaErrorInvalidValue);
  min_tile_dist_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, tile, cx, cy, cz, k_l, out);
  return static_cast<int>(cudaGetLastError());
}

// The distances of nbody_min_tile_dist turned into a level's opening test
// (see the top of this file): mac 0 geometric, 1 flat, 2 hierarchical;
// opens (n / tile, k_l) bool, far and (unless null) score (n / tile, k_l)
// float32. Launches one kernel on `stream` (none when there is nothing to
// compute); returns cudaGetLastError().
extern "C" int nbody_min_dist_open(const float* x, const float* y, const float* z, int n,
                                   int tile, const float* cx, const float* cy, const float* cz,
                                   int k_l, int mac, const float* amp, const float* radius,
                                   const float* mass, const float* a_med, float thresh,
                                   float tiny, long long row_offset, int row_div, int col_div,
                                   bool* opens, float* far, float* score, void* stream) {
  if (tile <= 0 || n < 0 || k_l < 0 || n % tile || row_offset < 0 || row_div <= 0 ||
      col_div <= 0 || mac < kGeometric || mac > kHier) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_t = n / tile;
  if (k_t == 0 || k_l == 0) return 0;
  dim3 grid;
  int threads;
  if (!grid_for(k_t, k_l, &grid, &threads)) return static_cast<int>(cudaErrorInvalidValue);
  const OpenTest p{amp, radius, mass, a_med, thresh, tiny, row_offset, row_div, col_div,
                   opens, far, score};
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, threads, 0, s>>>(x, y, z, tile, cx, cy, cz, k_l, p);
  };
  const bool scored = score != nullptr;
  if (mac == kFlat) {
    scored ? launch(min_dist_open_kernel<kFlat, true>) : launch(min_dist_open_kernel<kFlat, false>);
  } else if (mac == kHier) {
    scored ? launch(min_dist_open_kernel<kHier, true>) : launch(min_dist_open_kernel<kHier, false>);
  } else {
    scored ? launch(min_dist_open_kernel<kGeometric, true>)
           : launch(min_dist_open_kernel<kGeometric, false>);
  }
  return static_cast<int>(cudaGetLastError());
}
