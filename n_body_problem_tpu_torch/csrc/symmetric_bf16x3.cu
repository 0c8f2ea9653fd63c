// symmetric_bf16x3_kernel: half-pair (Newton's third law) softened gravity
// for Hopper (sm_90a), with the reaction contracted on the tensor cores.
//
// Replaces n_body_problem_tpu/ops/pallas_symmetric.py:_symmetric_kernel in
// its "bf16x3" and "mixed" modes (_split_bf16 and _dot_bf16x3, :63-84; the
// reaction panel, :180-194; near_s, :268-273). One kernel serves both modes:
// diagonals s <= near_s take the reaction in exact f32, the others in three
// bf16 tensor-core passes, as the TPU kernel does.
//
// What it computes: the same function as symmetric_acc_plain's panel form
// in ops/cuda_symmetric.py. Bodies are cut into K = N / tile tiles (the
// configuration's pallas_sym_tile); row tile i meets column tile
// j = (i + s) mod K for s = 0 .. K/2, and for even K only rows i < K/2 take
// the last diagonal. The s = 0 tile takes its strict upper triangle. For
// every pair (a in row tile, b in column tile), with d = x_b - x_a and
// u = (c^2 |d|^2 + eps2)^(-3/2):
//   action on a   (always exact f32):  sum_b m_b' u d
//   reaction on b (fast diagonals):    s_b[0:3] - (x_b - c_i) s_b[3],
//     s_b = sum_a [x_a - c_i, 1] (m_a' u), contracted as hi*hi + hi*lo +
//     lo*hi with hi = bf16(v), lo = bf16(v - hi) for both factors (both
//     rounded to nearest even), c_i the row tile's mean position (given by
//     the caller);
//   reaction on b (f32 diagonals):     -sum_a m_a' u d.
// The roles matter: the bf16 error lands on the column body of a pair, and
// the panel is centred on the row tile, as on the TPU.
//
// What bounds it on the card: instruction issue on the FP32 pipe, not the
// tensor cores. A fast pair needs about 19 issue slots (13 FP32 and the MUFU
// rsqrt for the pair and its action, the reaction weight, three for the
// weight's hi/lo split, one for its share of the shared loads, the stores
// and the mma.sync), which is what the f32 kernel's direct reaction costs:
// on the TPU the panel moved work from a full vector unit to an idle matrix
// unit, here the 24 bf16 operations a pair are 40x under the tensor cores'
// rate and the split costs what the direct reaction would. So this kernel
// can reach the f32 kernel's time, not beat it; the fast modes are kept for
// parity with the JAX SimConfig. On an NVIDIA H100 80GB HBM3 at 700.00 W it
// takes 1.97 ms ("bf16x3") and 1.98 ms ("mixed") of device time at 65,536
// bodies with tile 512, 2.09 ms a call with the slots' sum (2.83 and 2.80
// for the first kernel, whose loop had 35.8 instructions a pair; this one's
// has 21.2), 1.62 times the 1.22 ms the card needs to issue 19 instructions
// a pair at 1,980 MHz; the f32 kernel takes 1.75 ms.
//
// Design. One block of `warps` warps takes one tile pair (i, j) of the
// staggered coverage; the column tile sits in shared memory. A warp owns
// 16-body row chunks of the row tile and, for each, walks the 16-body
// column strips, `kStep` strips a step. Per strip, thread (g = lane / 4,
// t = lane % 4) evaluates the 8 pairs that are its elements of the
// mma.m16n8k16 A fragment: column bodies g and g + 8 (the fragment's rows)
// against row bodies 2t, 2t+1, 2t+8, 2t+9 (its columns). The same u feed
//   - the action of its 4 row bodies, in registers across the strips, then
//     summed over the 8 lanes that share t with warp shuffles;
//   - A = m_a' u as bf16 hi/lo, times B = the centred row panel [x y z 1]
//     (16 row bodies x 8, four used) as bf16 hi/lo, built once per chunk
//     (each chunk belongs to one warp, so once a block) from the same 4 row
//     bodies, into f32 accumulators
//     (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, three a strip).
// What the first kernel lost its time on, and what this one does instead:
//   - the pair weight is contracted (fmaf for r^2 and c^2 r^2 + eps2) and
//     takes the bare rsqrt (pairs.cuh); it then differs from the plain
//     twin's in its last bit, 2^-24 where the mode's own error is 2^-16;
//   - the triangle mask and the choice between the panel and the direct
//     reaction are template parameters of the tile loop, chosen once a block,
//     not tests a pair;
//   - the strips of a step have independent accumulators and the mma.sync
//     are not volatile, so the chain of a strip (its running column sums
//     loaded from shared memory, three products on top of them, the sums
//     stored) overlaps the other strip's and the next pairs' arithmetic.
//     Starting the products from zero and adding them to the running sums in
//     f32 afterwards was measured too: further from the plain twin (0.29
//     against 0.23 of the mode's own error at 65,536 bodies, of a limit of
//     0.3) and 4 % slower, so the sums stay in the tensor cores' accumulators.
// Each warp keeps its column sums in its own shared-memory row of the tile
// (no atomics a pair); at the end the block sums the warps' rows in a fixed
// order and assembles the reaction.
//
// The output in a fixed order, with no atomics, as in symmetric.cu: the
// block stores its row actions into slot j of tile i and its column
// reactions into slot i of tile j of the caller's (K, N, 3) scratch (slot u
// of tile t: the force on tile t from tile u); on s = 0 both land in slot i
// of tile i, the action first. A row chunk belongs to one warp, so each row's
// action is stored once a block, after the shuffle sum over its 8 lanes; a
// column's reaction once, after the warps' sum. symmetric_sum_kernel
// (symmetric.cu) then adds each body's K slots in slot order, so every
// launch gives the same bits.
//
// No wgmma, TMA or warp specialisation: the tensor cores are not what
// bounds this kernel, the pair arithmetic is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "pairs.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kChunk = 16;          // bodies in a row chunk or column strip
constexpr int kMaxTile = 2048;
constexpr size_t kMaxShared = 227 * 1024;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// hi/lo bf16 split of (a, b), packed as the fragments want them: a in the
// low half. hi = bf16(v) and lo = bf16(v - hi), both rounded to nearest
// even (_split_bf16).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// d += A (16 x 16, bf16, row-major) * B (16 x 8, bf16, column-major), f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum_xor(float v, int from, int to) {
#pragma unroll
  for (int m = from; m <= to; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// One row tile (global, `rows`) against the column tile in shared memory
// (`col`), for warp `w` of `warps`. kDiag: the tile against itself, strict
// upper triangle. kFast: the reaction as the bf16x3 panel product, else
// direct in f32. `mine` is this warp's (tile) column sums.
template <bool kDiag, bool kFast, int kStep>
__device__ __forceinline__ void tile_pass(const float4* __restrict__ rows,
                                          const float4* __restrict__ col,
                                          float4* __restrict__ mine, float4 ci,
                                          int tile, int warps, int w, int lane,
                                          float* __restrict__ row_out, float c2,
                                          float eps2) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float2* mine2 = reinterpret_cast<float2*>(mine);
  const int strips = tile / kChunk;

  for (int rc = w; rc < strips; rc += warps) {
    // This thread's row bodies: the A fragment's columns and B's rows.
    int ra[4];
    float4 row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ra[k] = rc * kChunk + 2 * t + (k & 1) + ((k >> 1) << 3);
      row[k] = rows[ra[k]];
    }
    // B: component g of the centred row panel [x y z 1], hi and lo.
    uint32_t bh0 = 0, bh1 = 0, bl0 = 0, bl1 = 0;
    if (kFast && g < 4) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = g == 0   ? row[k].x - ci.x
               : g == 1 ? row[k].y - ci.y
               : g == 2 ? row[k].z - ci.z
                        : 1.f;
      }
      split2(v[0], v[1], bh0, bl0);
      split2(v[2], v[3], bh1, bl1);
    }
    float ax[4] = {0.f, 0.f, 0.f, 0.f};
    float ay[4] = {0.f, 0.f, 0.f, 0.f};
    float az[4] = {0.f, 0.f, 0.f, 0.f};

    // On the diagonal tile, strips left of the chunk hold no pair b > a.
    for (int cs = kDiag ? rc - rc % kStep : 0; cs < strips; cs += kStep) {
      float d[kStep][4];
      float rx[kStep][2], ry[kStep][2], rz[kStep][2];
#pragma unroll
      for (int v = 0; v < kStep; ++v) {
        float bw[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int cb = (cs + v) * kChunk + g + 8 * m;
          const float4 o = col[cb];
          rx[v][m] = ry[v][m] = rz[v][m] = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // Subtract first, scale the squared distance after.
            const float dx = o.x - row[k].x;
            const float dy = o.y - row[k].y;
            const float dz = o.z - row[k].z;
            const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
            const float inv = rsqrt_normal(fmaf(r2, c2, eps2));
            float u = inv * inv * inv;
            if (kDiag && cb <= ra[k]) u = 0.f;
            const float wa = o.w * u;  // action weight m_b' u
            ax[k] = fmaf(wa, dx, ax[k]);
            ay[k] = fmaf(wa, dy, ay[k]);
            az[k] = fmaf(wa, dz, az[k]);
            bw[m][k] = row[k].w * u;   // reaction weight m_a' u
            if (!kFast) {
              rx[v][m] = fmaf(-bw[m][k], dx, rx[v][m]);
              ry[v][m] = fmaf(-bw[m][k], dy, ry[v][m]);
              rz[v][m] = fmaf(-bw[m][k], dz, rz[v][m]);
            }
          }
        }
        if (kFast) {
          uint32_t ah[4], al[4];
          split2(bw[0][0], bw[0][1], ah[0], al[0]);
          split2(bw[1][0], bw[1][1], ah[1], al[1]);
          split2(bw[0][2], bw[0][3], ah[2], al[2]);
          split2(bw[1][2], bw[1][3], ah[3], al[3]);
          // D rows g, g+8 (column bodies), columns 2t, 2t+1: x y (t = 0) or
          // z and the weight sum (t = 1), on top of the warp's running sums;
          // lanes t >= 2 hold the unused four.
          const int cb = (cs + v) * kChunk + g;
          d[v][0] = d[v][1] = d[v][2] = d[v][3] = 0.f;
          if (t < 2) {
            const float2 p0 = mine2[cb * 2 + t];
            const float2 p1 = mine2[(cb + 8) * 2 + t];
            d[v][0] = p0.x;
            d[v][1] = p0.y;
            d[v][2] = p1.x;
            d[v][3] = p1.y;
          }
          mma_bf16(d[v], ah, bh0, bh1);
          mma_bf16(d[v], ah, bl0, bl1);
          mma_bf16(d[v], al, bh0, bh1);
        }
      }
      if (kFast) {
        if (t < 2) {
#pragma unroll
          for (int v = 0; v < kStep; ++v) {
            const int cb = (cs + v) * kChunk + g;
            mine2[cb * 2 + t] = make_float2(d[v][0], d[v][1]);
            mine2[(cb + 8) * 2 + t] = make_float2(d[v][2], d[v][3]);
          }
        }
      } else {
        // Sum the direct reaction over the 4 lanes that share g.
#pragma unroll
        for (int v = 0; v < kStep; ++v) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float sx = warp_sum_xor(rx[v][m], 1, 2);
            const float sy = warp_sum_xor(ry[v][m], 1, 2);
            const float sz = warp_sum_xor(rz[v][m], 1, 2);
            if (t == 0) {
              const int cb = (cs + v) * kChunk + g + 8 * m;
              float4 p = mine[cb];
              p.x += sx;
              p.y += sy;
              p.z += sz;
              mine[cb] = p;
            }
          }
        }
      }
    }
    // The chunk's actions: sum over the 8 lanes that share t.
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float sx = warp_sum_xor(ax[k], 4, 16);
      const float sy = warp_sum_xor(ay[k], 4, 16);
      const float sz = warp_sum_xor(az[k], 4, 16);
      if (g == 0) {
        float* o = row_out + 3 * ra[k];
        o[0] = sx;
        o[1] = sy;
        o[2] = sz;
      }
    }
  }
}

template <int kStep>
__global__ void __launch_bounds__(32 * kMaxWarps)
symmetric_bf16x3_kernel(const float4* __restrict__ body,
                        const float4* __restrict__ centers, int k_tiles,
                        int tile, int near_s, float* __restrict__ slots,
                        float c2, float eps2) {
  extern __shared__ float4 smem[];
  float4* col = smem;          // (tile) column bodies: x y z m'
  float4* part = smem + tile;  // (warps, tile) each warp's column sums
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int b = blockIdx.x;
  const int s = b / k_tiles;
  const int i = b - s * k_tiles;
  int j = i + s;
  if (j >= k_tiles) j -= k_tiles;
  const bool fast = s > near_s;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;

  for (int q = threadIdx.x; q < tile; q += threads) col[q] = body[j * tile + q];
  for (int q = threadIdx.x; q < warps * tile; q += threads)
    part[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const float4 ci = centers[i];
  const float4* rows = body + i * tile;
  float4* mine = part + w * tile;
  // Slot u of tile t is slots[u][t * tile .. (t + 1) * tile][3].
  const size_t n3 = static_cast<size_t>(3) * k_tiles * tile;
  float* row_out = slots + j * n3 + 3 * (i * tile);   // tile i, slot j: the action
  // The tile loop's form is the block's, chosen once.
  if (s == 0) {
    if (fast)
      tile_pass<true, true, kStep>(rows, col, mine, ci, tile, warps, w, lane, row_out, c2, eps2);
    else
      tile_pass<true, false, kStep>(rows, col, mine, ci, tile, warps, w, lane, row_out, c2, eps2);
  } else if (fast) {
    tile_pass<false, true, kStep>(rows, col, mine, ci, tile, warps, w, lane, row_out, c2, eps2);
  } else {
    tile_pass<false, false, kStep>(rows, col, mine, ci, tile, warps, w, lane, row_out, c2, eps2);
  }
  __syncthreads();

  // The column tile's reaction: the warps' sums in a fixed order. On s = 0
  // the slot is row_out, which holds this block's actions: the stores
  // above are visible to every thread of the block after __syncthreads.
  float* col_out = slots + i * n3 + 3 * (j * tile);   // tile j, slot i: the reaction
  for (int q = threadIdx.x; q < tile; q += threads) {
    float4 S = part[q];
    for (int v = 1; v < warps; ++v) {
      const float4 p = part[v * tile + q];
      S.x += p.x;
      S.y += p.y;
      S.z += p.z;
      S.w += p.w;
    }
    float rx = S.x, ry = S.y, rz = S.z;
    if (fast) {
      const float4 o = col[q];
      rx = S.x - (o.x - ci.x) * S.w;
      ry = S.y - (o.y - ci.y) * S.w;
      rz = S.z - (o.z - ci.z) * S.w;
    }
    float* o = col_out + 3 * q;
    if (s == 0) {
      o[0] += rx;
      o[1] += ry;
      o[2] += rz;
    } else {
      o[0] = rx;
      o[1] = ry;
      o[2] = rz;
    }
  }
}

template <int kStep>
int launch(unsigned blocks, int warps, size_t shmem, cudaStream_t s, const float4* body,
           const float4* centers, int k, int tile, int near_s, float* slots, float c2,
           float eps2) {
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        symmetric_bf16x3_kernel<kStep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  symmetric_bf16x3_kernel<kStep><<<blocks, 32 * warps, shmem, s>>>(
      body, centers, k, tile, near_s, slots, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// symmetric.cu: the slots' sum in slot order.
extern "C" int nbody_symmetric_sum(const float* slots, int k, int n3, float* out,
                                   void* stream);

// body: (n, 4) float32 rows (x, y, z, G c^3 m); centers: (n / tile, 4)
// float32, each tile's mean position (w unused); tile a multiple of 64 up to
// 2048 that divides n; diagonals s <= near_s take the f32 reaction. The
// block's shape (FAST_SHAPE in ops/cuda_symmetric.py): `warps` warps of
// 1 to 8 whose column sums fit shared memory, `step` in {1, 2, 4} column
// strips a step. slots: (n / tile, n, 3) float32 scratch; out: (n, 3)
// float32, which need not be zeroed. Launches the kernel and the slots' sum
// on `stream`; returns cudaGetLastError().
extern "C" int nbody_symmetric_bf16x3(const float* body, int n, int tile,
                                      const float* centers, int near_s, int warps,
                                      int step, float* slots, float* out, float c2,
                                      float eps2, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile % 64 || tile > kMaxTile || n % tile || warps < 1 ||
      warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(tile) * (1 + warps) * sizeof(float4);
  if (shmem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const int k = n / tile;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(k) * (k + 1) / 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(body);
  const float4* c4 = reinterpret_cast<const float4*>(centers);
  int rc;
  switch (step) {
    case 1:
      rc = launch<1>(blocks, warps, shmem, s, b4, c4, k, tile, near_s, slots, c2, eps2);
      break;
    case 2:
      rc = launch<2>(blocks, warps, shmem, s, b4, c4, k, tile, near_s, slots, c2, eps2);
      break;
    case 4:
      rc = launch<4>(blocks, warps, shmem, s, b4, c4, k, tile, near_s, slots, c2, eps2);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return nbody_symmetric_sum(slots, k, 3 * n, out, stream);
}
