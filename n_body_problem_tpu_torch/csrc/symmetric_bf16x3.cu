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
//     lo*hi with hi = bf16(v), lo = bf16(v - hi) for both factors,
//     c_i the row tile's mean position (given by the caller);
//   reaction on b (f32 diagonals):     -sum_a m_a' u d.
// The roles matter: the bf16 error lands on the column body of a pair, and
// the panel is centred on the row tile, as on the TPU.
//
// What bounds it on the card: FP32 arithmetic, about 21 operations and one
// MUFU rsqrt a pair (the pair, the action and the reaction weight) against
// 24 bf16 tensor-core operations a pair, 40x below that rate. O(N) bytes.
//
// Design. One block of 4 warps takes one tile pair (i, j), in the
// staggered coverage; the column tile sits in shared memory. A warp owns
// 16-body row chunks of the row tile and, for each, walks every 16-body
// column strip. Per strip, thread (g = lane / 4, t = lane % 4) evaluates
// the 8 pairs that are its elements of the mma.m16n8k16 A fragment:
// column bodies g and g + 8 (the fragment's rows) against row bodies 2t,
// 2t+1, 2t+8, 2t+9 (its columns). The same u feed
//   - the action of its 4 row bodies, in registers across the strips, then
//     summed over the 8 lanes that share t with warp shuffles;
//   - A = m_a' u as bf16 hi/lo, times B = the centred row panel [x y z 1]
//     (16 row bodies x 8, four used) as bf16 hi/lo, built once per chunk
//     from the same 4 row bodies, into f32 accumulators
//     (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, three a strip).
// Each warp keeps its column partial sums in its own shared-memory row of
// the tile (no atomics a pair); at the end the block sums the warps' rows
// in a fixed order, assembles the reaction, and adds its row actions and
// column reactions into the zeroed output with global atomicAdd.
//
// No wgmma, TMA or warp specialisation: the tensor cores are not what
// bounds this kernel, the pair arithmetic is.
//
// Global atomics make the order of the final sums change from run to run,
// so the result is not bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;          // bodies in a row chunk or column strip
constexpr int kMaxTile = 2048;      // shared memory: 80 bytes a body

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
  lo = bits(__floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y)));
}

// d += A (16 x 16, bf16, row-major) * B (16 x 8, bf16, column-major), f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// u = (c^2 r^2 + eps2)^(-3/2), each operation rounded on its own in the
// plain twin's order (no contraction), so both give the same weights.
__device__ __forceinline__ float pair_u(float dx, float dy, float dz, float c2,
                                        float eps2) {
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(r2, c2), eps2));
  return __fmul_rn(__fmul_rn(inv, inv), inv);
}

__device__ __forceinline__ float warp_sum_xor(float v, int from, int to) {
  for (int m = from; m <= to; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__global__ void __launch_bounds__(kThreads)
symmetric_bf16x3_kernel(const float4* __restrict__ body,
                        const float4* __restrict__ centers, int k_tiles,
                        int tile, int near_s, float* __restrict__ out,
                        float c2, float eps2) {
  extern __shared__ float4 smem[];
  float4* col = smem;          // (tile) column bodies: x y z m'
  float4* part = smem + tile;  // (kWarps, tile) each warp's column sums
  const int b = blockIdx.x;
  const int s = b / k_tiles;
  const int i = b - s * k_tiles;
  int j = i + s;
  if (j >= k_tiles) j -= k_tiles;
  const bool fast = s > near_s;
  const bool diag = s == 0;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int q = threadIdx.x; q < tile; q += kThreads) col[q] = body[j * tile + q];
  for (int q = threadIdx.x; q < kWarps * tile; q += kThreads)
    part[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const float4 ci = centers[i];
  float4* mine = part + w * tile;
  float2* mine2 = reinterpret_cast<float2*>(mine);
  const int strips = tile / kChunk;

  for (int rc = w; rc < strips; rc += kWarps) {
    // This thread's row bodies: the A fragment's columns and B's rows.
    int ra[4];
    float4 row[4];
    for (int k = 0; k < 4; ++k) {
      ra[k] = rc * kChunk + 2 * t + (k & 1) + ((k >> 1) << 3);
      row[k] = body[i * tile + ra[k]];
    }
    // B: component g of the centred row panel [x y z 1], hi and lo.
    uint32_t bh0 = 0, bh1 = 0, bl0 = 0, bl1 = 0;
    if (fast && g < 4) {
      float v[4];
      for (int k = 0; k < 4; ++k) {
        v[k] = g == 0   ? __fsub_rn(row[k].x, ci.x)
               : g == 1 ? __fsub_rn(row[k].y, ci.y)
               : g == 2 ? __fsub_rn(row[k].z, ci.z)
                        : 1.f;
      }
      split2(v[0], v[1], bh0, bl0);
      split2(v[2], v[3], bh1, bl1);
    }
    float ax[4] = {0.f, 0.f, 0.f, 0.f};
    float ay[4] = {0.f, 0.f, 0.f, 0.f};
    float az[4] = {0.f, 0.f, 0.f, 0.f};

    // On the diagonal tile, strips left of the chunk hold no pair b > a.
    for (int cs = diag ? rc : 0; cs < strips; ++cs) {
      const int cb[2] = {cs * kChunk + g, cs * kChunk + g + 8};
      float bw[2][4];
      float rx[2] = {0.f, 0.f}, ry[2] = {0.f, 0.f}, rz[2] = {0.f, 0.f};
      for (int m = 0; m < 2; ++m) {
        const float4 o = col[cb[m]];
        for (int k = 0; k < 4; ++k) {
          const float dx = __fsub_rn(o.x, row[k].x);
          const float dy = __fsub_rn(o.y, row[k].y);
          const float dz = __fsub_rn(o.z, row[k].z);
          float u = pair_u(dx, dy, dz, c2, eps2);
          if (diag && cb[m] <= ra[k]) u = 0.f;
          const float wa = __fmul_rn(o.w, u);  // action weight m_b' u
          ax[k] = fmaf(wa, dx, ax[k]);
          ay[k] = fmaf(wa, dy, ay[k]);
          az[k] = fmaf(wa, dz, az[k]);
          bw[m][k] = __fmul_rn(row[k].w, u);   // reaction weight m_a' u
          if (!fast) {
            rx[m] = fmaf(-bw[m][k], dx, rx[m]);
            ry[m] = fmaf(-bw[m][k], dy, ry[m]);
            rz[m] = fmaf(-bw[m][k], dz, rz[m]);
          }
        }
      }
      if (fast) {
        uint32_t ah[4], al[4];
        split2(bw[0][0], bw[0][1], ah[0], al[0]);
        split2(bw[1][0], bw[1][1], ah[1], al[1]);
        split2(bw[0][2], bw[0][3], ah[2], al[2]);
        split2(bw[1][2], bw[1][3], ah[3], al[3]);
        // D rows g, g+8 (column bodies), columns 2t, 2t+1: x y (t = 0) or
        // z and the weight sum (t = 1); lanes t >= 2 hold the unused four.
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < 2) {
          const float2 p0 = mine2[cb[0] * 2 + t];
          const float2 p1 = mine2[cb[1] * 2 + t];
          d[0] = p0.x; d[1] = p0.y; d[2] = p1.x; d[3] = p1.y;
        }
        mma_bf16(d, ah, bh0, bh1);
        mma_bf16(d, ah, bl0, bl1);
        mma_bf16(d, al, bh0, bh1);
        if (t < 2) {
          mine2[cb[0] * 2 + t] = make_float2(d[0], d[1]);
          mine2[cb[1] * 2 + t] = make_float2(d[2], d[3]);
        }
      } else {
        // Sum the direct reaction over the 4 lanes that share g.
        for (int m = 0; m < 2; ++m) {
          rx[m] = warp_sum_xor(rx[m], 1, 2);
          ry[m] = warp_sum_xor(ry[m], 1, 2);
          rz[m] = warp_sum_xor(rz[m], 1, 2);
        }
        if (t == 0) {
          for (int m = 0; m < 2; ++m) {
            float4 p = mine[cb[m]];
            p.x += rx[m];
            p.y += ry[m];
            p.z += rz[m];
            mine[cb[m]] = p;
          }
        }
      }
    }
    // The chunk's actions: sum over the 8 lanes that share t.
    for (int k = 0; k < 4; ++k) {
      const float sx = warp_sum_xor(ax[k], 4, 16);
      const float sy = warp_sum_xor(ay[k], 4, 16);
      const float sz = warp_sum_xor(az[k], 4, 16);
      if (g == 0) {
        float* o = out + 3 * (i * tile + ra[k]);
        atomicAdd(o + 0, sx);
        atomicAdd(o + 1, sy);
        atomicAdd(o + 2, sz);
      }
    }
  }
  __syncthreads();

  // The column tile's reaction: the warps' sums in a fixed order.
  for (int q = threadIdx.x; q < tile; q += kThreads) {
    float4 S = part[q];
    for (int v = 1; v < kWarps; ++v) {
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
    float* o = out + 3 * (j * tile + q);
    atomicAdd(o + 0, rx);
    atomicAdd(o + 1, ry);
    atomicAdd(o + 2, rz);
  }
}

}  // namespace

// body: (n, 4) float32 rows (x, y, z, G c^3 m); centers: (n / tile, 4)
// float32, each tile's mean position (w unused); tile a multiple of 64 up to
// 2048 that divides n; diagonals s <= near_s take the f32 reaction.
// out: (n, 3) float32, zeroed by the caller. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int nbody_symmetric_bf16x3(const float* body, int n, int tile,
                                      const float* centers, int near_s,
                                      float* out, float c2, float eps2,
                                      void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile % (kWarps * kChunk) || tile > kMaxTile || n % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = n / tile;
  const long long blocks = static_cast<long long>(k) * (k + 1) / 2;
  const size_t shmem = static_cast<size_t>(tile) * (1 + kWarps) * sizeof(float4);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        symmetric_bf16x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  symmetric_bf16x3_kernel<<<static_cast<unsigned>(blocks), kThreads, shmem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(body),
      reinterpret_cast<const float4*>(centers), k, tile, near_s, out, c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
