// allpairs_acc_kernel: blocked all-pairs softened gravity for Hopper (sm_90a).
//
// Replaces n_body_problem_tpu/ops/pallas_force.py:_force_kernel (the TPU
// Pallas kernel behind pallas_block_acc / pallas_acc), and plays the role of
// the reference's VERSION 1 shared-memory kernel (kernel.cu:828-884).
//
// What it computes: acc (Ni, 3) of the row bodies due to every column body,
//   d = p_j - p_i;  w = m_j' * rsqrt(|d|^2 c^2 + eps2)^3;  acc_i = sum_j w d,
// with m_j' = G c^3 m_j pre-scaled by the wrapper. Row and column sets are
// separate arrays (the block form): the all-pairs solve, the treecode error
// probe (2,048 sampled rows against all N columns) and a multi-GPU ring step
// (N / devices rows) are the same call.
//
// What bounds it on the card: instruction issue on the FP32 pipe. A pair is
// 13 FP32 instructions and one MUFU rsqrt against O(N) bytes of input for
// O(N^2) pairs, and whatever else a pair costs comes on top: its share of a
// shared-memory load, and multiprocessors left idle by a grid that follows
// the rows alone (2,048 rows were 8 blocks for 132 multiprocessors). On an
// NVIDIA H100 80GB HBM3 at 700.00 W this kernel takes 2.45 ms at 65,536
// bodies (3.04 with one row body a thread and rsqrtf), 1.27 times what the
// card needs to issue 15 instructions a pair at 1,980 MHz (1.93 ms; its loop
// has 14.6), 37.2 ms at 262,144 (44.6), and 0.63 ms for 2,048 rows against
// 524,288 columns (16.1 on 8 blocks; floor 0.48).
//
// What the design does about that:
// - A thread keeps R = 4 row bodies and their twelve running sums in
//   registers, so one 16-byte broadcast load of a staged column body serves
//   four pairs, and the four pairs are independent work for the pipe
//   (pull_rows in pairs.cuh, which the near-panel kernel shares).
// - The bare rsqrt instruction (pairs.cuh) in place of rsqrtf(), which wraps
//   it in a denormal test and two multiplies; the wrapper requires a normal
//   eps2.
// - The columns are split as well as the rows (allpairs_split in
//   ops/cuda_force.py chooses both from Ni and Nj). Inside a block of 256
//   threads, `parts` groups of 256 / parts threads hold the same
//   1,024 / parts rows and each takes its own 1,024 / parts columns of every
//   1,024-column stage; the groups' sums are added in part order through
//   shared memory. Across blocks, blockIdx.y takes a contiguous piece of the
//   stages; with more than one piece each block writes its partial sums to
//   scratch (pieces, Ni, 3) and allpairs_sum_kernel adds the pieces in piece
//   order. With one piece there is one launch. Eight parts (128 rows a
//   block) were the fastest at every shape timed, also where the rows alone
//   fill the card; pieces are cut when the row blocks are fewer than two a
//   multiprocessor.
// - Self pairs (d = 0) and zero-mass padding (w = 0) add exactly nothing, so
//   there is no mask; the column tail past a piece's end is staged as
//   zero-mass bodies.
//
// Every order of summation is fixed by (Ni, Nj) and nothing is atomic, so the
// result is bitwise the same on every run.

#include <cuda_runtime.h>

#include "pairs.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kRows = 4;       // row bodies a thread
constexpr int kStage = 1024;   // column bodies staged per pass (ALLPAIRS_STAGE)

template <int kParts>
__global__ void __launch_bounds__(kThreads)
allpairs_acc_kernel(const float* __restrict__ pos_i, int ni,
                    const float4* __restrict__ cols, int nj, int stages_a_piece,
                    float* __restrict__ out, float c2, float eps2) {
  constexpr int kGroup = kThreads / kParts;   // threads a part
  constexpr int kBlockRows = kGroup * kRows;  // row bodies a block
  constexpr int kCols = kStage / kParts;      // columns of a stage a part takes
  __shared__ float4 tile[kStage];
  const int t = threadIdx.x;
  const int part = t / kGroup;
  const int g = t - part * kGroup;
  const int row0 = blockIdx.x * kBlockRows + g;

  float xi[kRows], yi[kRows], zi[kRows], ax[kRows], ay[kRows], az[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = row0 + q * kGroup;
    const bool live = row < ni;
    xi[q] = live ? pos_i[3 * row + 0] : 0.f;
    yi[q] = live ? pos_i[3 * row + 1] : 0.f;
    zi[q] = live ? pos_i[3 * row + 2] : 0.f;
    ax[q] = ay[q] = az[q] = 0.f;
  }

  const long long span = static_cast<long long>(stages_a_piece) * kStage;
  const long long first = blockIdx.y * span;
  const int last = static_cast<int>(first + span < nj ? first + span : nj);
  const float4* mine = tile + part * kCols;
  for (int base = static_cast<int>(first); base < last; base += kStage) {
#pragma unroll
    for (int m = 0; m < kStage / kThreads; ++m) {
      const int j = base + m * kThreads + t;
      tile[m * kThreads + t] = j < last ? cols[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kCols; ++k) pull_rows<kRows>(mine[k], xi, yi, zi, ax, ay, az, c2, eps2);
    __syncthreads();
  }

  if (kParts > 1) {
    // Parts 1 .. kParts-1 hand their sums to part 0, which adds them in order.
    float* red = reinterpret_cast<float*>(tile);  // (kParts - 1, 3, kBlockRows)
    if (part > 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        float* r = red + (part - 1) * 3 * kBlockRows + q * kGroup + g;
        r[0 * kBlockRows] = ax[q];
        r[1 * kBlockRows] = ay[q];
        r[2 * kBlockRows] = az[q];
      }
    }
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < kParts; ++p) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float* r = red + (p - 1) * 3 * kBlockRows + q * kGroup + g;
          ax[q] += r[0 * kBlockRows];
          ay[q] += r[1 * kBlockRows];
          az[q] += r[2 * kBlockRows];
        }
      }
    }
  }
  if (part == 0) {
    float* o = out + static_cast<size_t>(blockIdx.y) * ni * 3;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int row = row0 + q * kGroup;
      if (row < ni) {
        o[3 * row + 0] = ax[q];
        o[3 * row + 1] = ay[q];
        o[3 * row + 2] = az[q];
      }
    }
  }
}

// out[k] = sum over pieces p of partial[p][k], k < 3 ni, in piece order.
__global__ void allpairs_sum_kernel(const float* __restrict__ partial, int pieces,
                                    int n3, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n3) return;
  float s = partial[k];
  for (int p = 1; p < pieces; ++p) s += partial[static_cast<size_t>(p) * n3 + k];
  out[k] = s;
}

template <int kParts>
void launch(dim3 grid, cudaStream_t s, const float* pos_i, int ni, const float* cols,
            int nj, int stages_a_piece, float* out, float c2, float eps2) {
  allpairs_acc_kernel<kParts><<<grid, kThreads, 0, s>>>(
      pos_i, ni, reinterpret_cast<const float4*>(cols), nj, stages_a_piece, out, c2, eps2);
}

}  // namespace

// pos_i: (ni, 3) float32; cols: (nj, 4) float32 rows (x, y, z, G c^3 m);
// out: (ni, 3) float32. The schedule (allpairs_split in ops/cuda_force.py):
// `parts` in {1, 2, 4, 8} groups of threads a block (1,024 / parts rows a
// block), `pieces` column pieces of `stages_a_piece` stages of 1,024 columns
// each. With pieces > 1, `partial` is (pieces, ni, 3) float32 scratch and a
// second kernel sums it into out; with one piece it is not read. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int nbody_allpairs_acc(const float* pos_i, int ni, const float* cols,
                                  int nj, int parts, int stages_a_piece, int pieces,
                                  float* partial, float* out, float c2, float eps2,
                                  void* stream) {
  if (ni <= 0) return 0;
  if (pieces < 1 || pieces > 65535 || stages_a_piece < 1 ||
      static_cast<long long>(pieces) * stages_a_piece * kStage < nj)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block_rows = kThreads / parts * kRows;
  const dim3 grid((ni + block_rows - 1) / block_rows, pieces);
  float* dst = pieces > 1 ? partial : out;
  switch (parts) {
    case 1: launch<1>(grid, s, pos_i, ni, cols, nj, stages_a_piece, dst, c2, eps2); break;
    case 2: launch<2>(grid, s, pos_i, ni, cols, nj, stages_a_piece, dst, c2, eps2); break;
    case 4: launch<4>(grid, s, pos_i, ni, cols, nj, stages_a_piece, dst, c2, eps2); break;
    case 8: launch<8>(grid, s, pos_i, ni, cols, nj, stages_a_piece, dst, c2, eps2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pieces == 1) return static_cast<int>(err);
  const int n3 = 3 * ni;
  allpairs_sum_kernel<<<(n3 + 255) / 256, 256, 0, s>>>(partial, pieces, n3, out);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable text of a CUDA error code returned by an entry point.
extern "C" const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
