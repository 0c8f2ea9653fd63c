// near_field_kernel: the treecode's exact near field for Hopper (sm_90a).
//
// Replaces n_body_problem_tpu/ops/treecode.py:_near_flat_kernel (:1286),
// the TPU kernel behind _near_field_flat_cols (:1352).
//
// What it computes: for every target row t (T = tile consecutive target
// bodies, in Morton order) the exact softened pull of the source tiles its
// work chunks name,
//   d = p_j - p_i;  w = m_j' rsqrt(|d|^2 c^2 + eps2)^3;  acc_i += w d,
// with m_j' = G c^3 m_j pre-scaled (and zero for VIP bodies) by the wrapper.
// Chunk p holds `entries` source tiles flat_src[p E:(p+1) E] of src_tile
// bodies each for target row chunk_tgt[p]. The chunks of one target are
// contiguous and chunk_tgt is non-decreasing, with the sentinel K_t on the
// unused tail; a source id of K_s names the zero tile after the last body.
// Targets and sources are two arrays: one device passes its bodies as both;
// a rank of the sharded treecode passes its own rows as the targets (row
// ids local) and every rank's bodies as the sources (tile ids global).
//
// What bounds it on the card: instruction issue on the FP32 pipe, as in the
// all-pairs kernel: about 13 FP32 instructions, one MUFU rsqrt and one
// shared load a pair, against 16 bytes a source body staged once for the
// whole row. What it loses beyond that is warps: a row of 32 bodies is one
// warp, rows differ in their number of chunks, and a block that stages a
// whole chunk before it sums it leaves the SM idle while it loads. On an
// NVIDIA H100 80GB HBM3 at 700.00 W this kernel stands at 1.38 times its
// issue floor (15 instructions a pair at 1,980 MHz) at 524,288 bodies and
// at 1.5-1.6 times at 65,536, where the rows with the most chunks (15
// against a mean of 7.6) set the time of the last wave of blocks.
//
// What the design does about that:
// - The block size does not follow the row: a block is `sub` consecutive
//   targets of one row times `parts` (sub x parts threads,
//   ops/cuda_treecode.py:near_split), and part p takes the source entries
//   e = p, p + parts, ... of every staged piece for the same targets. The
//   parts' sums meet in shared memory and are added in part order. Rows of
//   more than 64 targets are cut into blocks of 64, which stage the row's
//   chunks once each: more and shorter blocks fill the card's last wave
//   better where the rows are few.
// - The row's chunks are contiguous, so its source ids are one run of
//   (c1 - c0) E entries, staged `piece` entries at a time in a two-stage
//   ring: each warp copies whole source tiles with cp.async (16 bytes a
//   lane) into the stage that the block will sum next, while it sums this
//   one. One __syncthreads a piece. Sentinel entries are neither loaded
//   nor summed.
// - The block finds its chunk range by binary search in chunk_tgt, so the
//   sentinel tail costs nothing; a row with no chunk writes zeros.
// The split and the order of every sum are fixed and nothing is atomic, so
// the result is bitwise the same on every run, as the TPU kernel's
// sequential grid made it.

#include <cuda_runtime.h>

#include "lists.cuh"
#include "pairs.cuh"

namespace {

constexpr int kChunkBodies = 2048;  // CHUNK_LANES in ops/treecode.py
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
near_field_kernel(const float4* __restrict__ targets, const float4* __restrict__ sources,
                  int tile, int sub, int src_tile,
                  int entries, int parts, int piece, int k_s,
                  const int* __restrict__ flat_src,
                  const int* __restrict__ chunk_tgt, int n_chunks,
                  float* __restrict__ out, float c2, float eps2) {
  extern __shared__ float4 stage[];  // 2 x piece x src_tile bodies, then 3 x threads floats
  const int t = blockIdx.x / (tile / sub);  // the target row of this block's bodies
  const int p = threadIdx.x / sub;          // part of the source entries
  const int b = threadIdx.x - p * sub;      // body of the block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int i = blockIdx.x * sub + b;
  const float4 me = targets[i];
  const int c0 = lower_bound(chunk_tgt, n_chunks, t);
  const int c1 = lower_bound(chunk_tgt, n_chunks, t + 1);
  // The row's source ids, chunk after chunk.
  const int* ids = flat_src + static_cast<size_t>(c0) * entries;
  const int total = (c1 - c0) * entries;
  const int stage_bodies = piece * src_tile;

  // Entries [e0, e0 + piece) of the row into `dst`, a warp a source tile.
  const auto fetch = [&](int e0, float4* dst) {
    const int cnt = min(piece, total - e0);
    for (int e = warp; e < cnt; e += n_warps) {
      const int s = ids[e0 + e];
      if (s == k_s) continue;
      const float4* src = sources + static_cast<size_t>(s) * src_tile;
      for (int j = lane; j < src_tile; j += 32) cp_async16(dst + e * src_tile + j, src + j);
    }
    cp_async_commit();
  };

  float ax = 0.f, ay = 0.f, az = 0.f;
  if (total > 0) fetch(0, stage);
  for (int e0 = 0, k = 0; e0 < total; e0 += piece, ++k) {
    const float4* cur = stage + (k & 1) * stage_bodies;
    cp_async_wait_all();
    // This piece has landed for every thread, and every thread is done with
    // the other stage.
    __syncthreads();
    if (e0 + piece < total) fetch(e0 + piece, stage + ((k + 1) & 1) * stage_bodies);
    const int cnt = min(piece, total - e0);
    for (int e = p; e < cnt; e += parts) {
      if (ids[e0 + e] == k_s) continue;  // the zero tile adds nothing
      const float4* src = cur + e * src_tile;
#pragma unroll 8
      for (int j = 0; j < src_tile; ++j) {
        const float4 o = src[j];
        // Subtract first, scale the squared distance after (treecode.py:1316-1321).
        const float dx = o.x - me.x;
        const float dy = o.y - me.y;
        const float dz = o.z - me.z;
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        const float inv = rsqrt_normal(fmaf(r2, c2, eps2));
        const float w = o.w * (inv * inv * inv);
        ax = fmaf(w, dx, ax);
        ay = fmaf(w, dy, ay);
        az = fmaf(w, dz, az);
      }
    }
  }
  if (parts > 1) {
    float* part = reinterpret_cast<float*>(stage + 2 * stage_bodies);
    const int nt = blockDim.x;
    part[0 * nt + threadIdx.x] = ax;
    part[1 * nt + threadIdx.x] = ay;
    part[2 * nt + threadIdx.x] = az;
    __syncthreads();
    if (p) return;
    for (int q = 1; q < parts; ++q) {
      ax += part[0 * nt + q * sub + b];
      ay += part[1 * nt + q * sub + b];
      az += part[2 * nt + q * sub + b];
    }
  }
  out[3 * i + 0] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
}

}  // namespace

// targets: (>= n_t, 4) float32, xyz read; sources: (n_s + src_tile, 4) float32
// [x y z G c^3 m_tree], zero tile last; flat_src: (>= n_chunks * entries,)
// int32 source tile ids in [0, n_s / src_tile]; chunk_tgt: (n_chunks,) int32
// target row ids; out: (n_t, 3) float32. tile divides n_t and src_tile n_s;
// sub divides tile and is a multiple of 32; a block is sub * parts <= 1,024
// threads and stages `piece` source tiles at a time (near_split in
// ops/cuda_treecode.py); entries * src_tile <= 2,048 and piece <= entries.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int nbody_near_field(const float* targets, int n_t, const float* sources, int n_s,
                                int tile, int sub, int src_tile, int entries, int parts,
                                int piece, const int* flat_src, const int* chunk_tgt,
                                int n_chunks, float* out, float c2, float eps2, void* stream) {
  if (n_t <= 0) return 0;
  if (tile <= 0 || n_t % tile || sub <= 0 || sub % 32 || tile % sub || src_tile <= 0 ||
      n_s <= 0 || n_s % src_tile || entries <= 0 || entries * src_tile > kChunkBodies ||
      parts <= 0 || sub * parts > kMaxThreads || piece <= 0 || piece > entries)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = sub * parts;
  const size_t shmem = static_cast<size_t>(2) * piece * src_tile * sizeof(float4) +
                       (parts > 1 ? 3 * threads * sizeof(float) : 0);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        near_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  near_field_kernel<<<n_t / sub, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(targets), reinterpret_cast<const float4*>(sources), tile,
      sub, src_tile, entries, parts, piece, n_s / src_tile, flat_src, chunk_tgt, n_chunks, out,
      c2, eps2);
  return static_cast<int>(cudaGetLastError());
}
