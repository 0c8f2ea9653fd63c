// top_k_kernel: the work lists' row selection for Hopper (sm_90a): the k
// largest entries of each row of a (rows, cols) float32 matrix, largest
// first, ties to the lower column.
//
// Replaces no TPU kernel. The JAX package leaves its row selection to
// lax.top_k (n_body_problem_tpu/ops/treecode.py:341, :1157; the VIP pick
// :212), which XLA lowers itself. The port's plain version sorted every
// whole row with torch.sort and kept the first k columns: a segmented radix
// sort that makes several passes over keys and int64 indices and writes both
// for every column, where the lists keep a few hundred to a few thousand of
// each row's 16,384-58,107 columns. This kernel selects instead of sorting.
//
// What it returns: bitwise ops/cuda_treecode.py:top_k_plain on the card,
// values and int64 indices: torch.sort(x, 1, descending=True, stable=True)
// cut to k columns. Each float maps to a 32-bit key whose unsigned order is
// torch.sort's order on the card (PyTorch 2.11, at every row length): -0.0
// takes +0.0's key (the two tie, and a tie goes to the lower column), a NaN
// sorts by its bits (a positive one above +inf, a negative one below -inf),
// a denormal keeps its bits. An entry is one 64-bit word, ~key, column and a
// -0.0 bit, whose order is the output's and which gives the value back.
//
// What bounds it on the card: bytes. A selection has to read each row once
// and write k values and indices: at the 1,048,576-body plan's lists
// (8,192 x 16,384 and 8,192 x 32,752) 1.61 GB in, 0.48 ms at 3.35 TB/s.
//
// What the design does about that:
// - One block a row, 32 to 1,024 threads (a quarter of one a column). The
//   first pass reads the row from device memory once, 16 bytes a thread a
//   load where the row is aligned, keeps its keys in shared memory (all of
//   them where they fit beside the entry buffers: every row of the cells but
//   the AGORA far lists', 30,156 of 58,107 columns there at k = 11,456) and
//   counts the top digit of each in a shared histogram, once a warp for the
//   lanes that share a bin (__match_any_sync: a row of sentinels is one bin).
// - Radix select from shared memory: the bin of the k-th largest key, then
//   the least and the greatest key in it, whose shared leading bits join the
//   prefix (a bin of one value, as the -1.0 sentinels that fill most rows,
//   ends the search there), then the next digit, until the k-th key is
//   known or its bin is taken whole. Digits of 11 bits on rows of 8,192
//   columns or more, 8 below.
// - One gather sweep: the entries taken whatever their column reserve slots
//   with one atomic add a warp; the first ties to the k-th key in column
//   order are ranked by a block scan a chunk, until enough are found.
// - The taken entries sorted in shared memory: runs of 256 by a bitonic
//   network in a warp's registers, then merge-path rounds, each thread
//   merging 8 outputs in registers; a slot is skipped every 8 so that lanes
//   reading entries 4 or 8 apart fall in different banks. A k past
//   kSmemPairs takes its buffers in the scratch the wrapper hands over.
//   Then the values and the indices, from the entries themselves.
// - The kernel allocates nothing and never synchronises with the host, so
//   the treecode's build graph captures it.
// On the card (PERF.md's kernel table) the latency-bound
// steps after the first pass, the sort first, take most of a block's time:
// 3.7 ms at the 1M lists against their 0.65 ms of bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 32;
// k above this takes its two entry buffers in the device scratch of
// nbody_top_k_scratch_bytes: two buffers of 12,864 entries (and their skew)
// fill a block's 227 KB.
constexpr int kSmemPairs = 12864;
// A block takes all of an H100's shared memory: the entries, a histogram and
// as much of its row's keys as fit (on the cells' inputs the whole 227 KB was
// faster than 113, 100, 75 or 56 KB and two blocks an SM).
constexpr int kSmemBytes = 232448;
constexpr int kWords = 128;       // block scan, the found bin, minima and maxima
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoBin = 0xffffffffu;
constexpr unsigned kZeroKey = 0x80000000u;  // the key of +0.0 and of -0.0

// The unsigned key whose order is torch.sort's order of the floats.
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if ((u << 1) == 0u) u = 0u;  // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// An entry as one 64-bit word whose ascending order is (key descending,
// column ascending): ~key, then the column, then whether the value is -0.0
// (the one bit the key does not keep; under the column, so it orders nothing).
__device__ __forceinline__ unsigned long long pair_of(unsigned key, unsigned col,
                                                      unsigned neg_zero) {
  return (static_cast<unsigned long long>(~key) << 32) | (col << 1) | neg_zero;
}

// Entry j of a buffer sits at sk(j): one slot skipped every 8, so that the
// lanes of a warp reading entries 4 or 8 apart (as the merge sort's do) fall
// in different banks. A buffer of k entries takes buffer_entries(k) slots.
__device__ __forceinline__ int sk(int j) { return j + (j >> 3); }
__host__ __device__ __forceinline__ int buffer_entries(int k) {
  return (k + (k >> 3) + 2) & ~1;
}

// The value an entry was made from, every bit.
__device__ __forceinline__ float value_of(unsigned long long p) {
  const unsigned key = ~static_cast<unsigned>(p >> 32);
  unsigned u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  if (p & 1ull) u = 0x80000000u;
  return __uint_as_float(u);
}

// Exclusive scan of v over the block in thread order; `total` gets the sum.
// Every thread of the block calls it.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* words, unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) words[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < warps ? words[lane] : 0u;
    unsigned wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += n;
    }
    if (lane < warps) words[lane] = wi - w;
    if (lane == 31) words[32] = wi;
  }
  __syncthreads();
  const unsigned excl = words[warp] + inc - v;
  total = words[32];
  __syncthreads();
  return excl;
}

// Adds the lanes that share a bin once a warp. Every lane of the warp calls
// it; a lane with nothing to count passes kNoBin.
__device__ __forceinline__ void count(unsigned* hist, unsigned bin) {
  if (!__any_sync(kFull, bin != kNoBin)) return;
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin != kNoBin && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
  }
}

// The row's key i: from the shared copy below `cached`, else from the row.
__device__ __forceinline__ unsigned key_at(const unsigned* keys, int cached, const float* xr,
                                           int i) {
  return i < cached ? keys[i] : order_key(xr[i]);
}

// Calls f(key, ok) for every key of the row, the shared copy 16 bytes a
// load. Every thread of the block calls it; f is called the same number of
// times in every lane of a warp, with ok false where there is no key.
template <typename F>
__device__ __forceinline__ void sweep(const unsigned* keys, int cached, const float* xr, int cols,
                                      F f) {
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  const int quads = cached >> 2;
  for (int base = 0; base < quads; base += blockDim.x) {
    const int q = base + threadIdx.x;
    const bool ok = q < quads;
    const uint4 w = ok ? keys4[q] : make_uint4(0u, 0u, 0u, 0u);
    f(w.x, ok);
    f(w.y, ok);
    f(w.z, ok);
    f(w.w, ok);
  }
  constexpr int kUnroll = 4;
  for (int base = cached; base < cols; base += kUnroll * blockDim.x) {
    unsigned kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      kv[u] = i < cols ? order_key(__ldg(xr + i)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(kv[u], base + u * blockDim.x + threadIdx.x < cols);
  }
}

// Compare-exchange: a gets the smaller word.
__device__ __forceinline__ void order2(unsigned long long& a, unsigned long long& b) {
  const unsigned long long lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Sorts the n distinct words of buffer a ascending; returns a or b,
// whichever holds them. A warp sorts each run of kWarpRun words in
// registers (kLane a lane, a bitonic network: across lanes by shuffles,
// within a lane in place); then runs are merged pairwise, kLane outputs a
// thread a round: a binary search finds where the thread's outputs start on
// the merge path, the kLane words from each run that can follow are loaded
// at once, and a bitonic half-cleaner and merge network in registers keeps
// the kLane smallest, in order.
constexpr int kLane = 8;
constexpr int kWarpRun = 32 * kLane;
__device__ unsigned long long* merge_sort(unsigned long long* a, unsigned long long* b, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int base = warp * kWarpRun; base < n; base += warps * kWarpRun) {
    unsigned long long v[kLane];
#pragma unroll
    for (int r = 0; r < kLane; ++r) {
      const int i = base + lane * kLane + r;
      v[r] = i < n ? a[sk(i)] : ~0ull;
    }
#pragma unroll
    for (int size = 2; size <= kWarpRun; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int r = 0; r < kLane; ++r) {
          const int i = lane * kLane + r;
          const bool up = (i & size) == 0;
          if (stride >= kLane) {
            const unsigned long long o = __shfl_xor_sync(kFull, v[r], stride / kLane);
            const bool lower = (i & stride) == 0;
            const bool keep_min = lower == up;
            v[r] = (v[r] < o) == keep_min ? v[r] : o;
          } else if ((r ^ stride) > r) {
            if (up) {
              order2(v[r], v[r ^ stride]);
            } else {
              order2(v[r ^ stride], v[r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kLane; ++r) {
      const int i = base + lane * kLane + r;
      if (i < n) a[sk(i)] = v[r];
    }
  }
  __syncthreads();
  unsigned long long* src = a;
  unsigned long long* dst = b;
  for (int len = kWarpRun; len < n; len *= 2) {
    for (int out = threadIdx.x * kLane; out < n; out += blockDim.x * kLane) {
      const int a0 = out / (2 * len) * (2 * len), b0 = a0 + len;
      const int a_len = min(len, n - a0), b_len = max(0, min(len, n - b0));
      const int diag = out - a0;
      int lo = max(0, diag - b_len), hi = min(diag, a_len);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (src[sk(a0 + mid)] < src[sk(b0 + diag - 1 - mid)]) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int ia = lo, ib = diag - lo;
      unsigned long long v[kLane], w[kLane];
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        v[i] = ia + i < a_len ? src[sk(a0 + ia + i)] : ~0ull;
        w[i] = ib + i < b_len ? src[sk(b0 + ib + i)] : ~0ull;
      }
      // v ascending, w ascending: v against w reversed keeps the kLane
      // smallest (a bitonic sequence), which three stages then sort.
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        v[i] = v[i] < w[kLane - 1 - i] ? v[i] : w[kLane - 1 - i];
      }
#pragma unroll
      for (int stride = kLane / 2; stride > 0; stride >>= 1) {
#pragma unroll
        for (int i = 0; i < kLane; ++i) {
          if ((i ^ stride) > i) order2(v[i], v[i ^ stride]);
        }
      }
      const int m = min(kLane, n - out);
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        if (i < m) dst[sk(out + i)] = v[i];
      }
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

template <int kBits>
__global__ void __launch_bounds__(kMaxThreads)
top_k_kernel(const float* __restrict__ x, int cols, long long ld, int k, int cached,
             int union_words, unsigned long long* __restrict__ scratch,
             float* __restrict__ values, long long* __restrict__ indices) {
  // Shared memory: the gathered entries (unless in the scratch), then a
  // region that holds the row's keys and the histogram while selecting and
  // the sort's second buffer after, then the scan's words.
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBins = 1 << kBits;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  const long long row = blockIdx.x;
  const float* xr = x + row * ld;
  const int kbuf = buffer_entries(k);

  unsigned long long* buf_a;
  unsigned long long* buf_b;
  unsigned* region;
  if (scratch) {
    buf_a = scratch + row * 2 * kbuf;
    buf_b = buf_a + kbuf;
    region = reinterpret_cast<unsigned*>(smem);
  } else {
    buf_a = reinterpret_cast<unsigned long long*>(smem);
    buf_b = buf_a + kbuf;   // the region, once selected
    region = reinterpret_cast<unsigned*>(buf_b);
  }
  unsigned* keys = region;
  unsigned* hist = region + cached;
  unsigned* words = region + union_words;

  // ---- pass 1: the row from device memory, its keys, the top digit
  int shift = 32 - kBits;
  unsigned digit = kBins - 1u;
  for (int b = tid; b < kBins; b += threads) hist[b] = 0u;
  __syncthreads();
  {
    const int head = min(cols, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(xr) & 15u))
                                                 & 15u) >> 2));
    const int quads = (cols - head) >> 2;
    const int tail = head + 4 * quads;
    if (tid < 32) {  // the unaligned head and the ragged tail: one warp
      for (int part = 0; part < 2; ++part) {
        const int i = (part == 0 ? 0 : tail) + tid;
        const bool ok = part == 0 ? tid < head : i < cols;
        unsigned key = 0u;
        if (ok) {
          key = order_key(xr[i]);
          if (i < cached) keys[i] = key;
        }
        count(hist, ok ? key >> shift : kNoBin);
      }
    }
    const float4* x4 = reinterpret_cast<const float4*>(xr + head);
    constexpr int kUnroll = 4;
    for (int base = 0; base < quads; base += kUnroll * threads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * threads + tid;
        v[u] = q < quads ? __ldg(x4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * threads + tid;
        const bool ok = q < quads;
        const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = head + 4 * q + e;
          unsigned key = 0u;
          if (ok) {
            key = order_key(f[e]);
            if (i < cached) keys[i] = key;
          }
          count(hist, ok ? key >> shift : kNoBin);
        }
      }
    }
  }
  __syncthreads();

  // ---- radix select: the k-th largest key, digit by digit
  unsigned mask = 0u, prefix = 0u, want = static_cast<unsigned>(k);
  bool all_ties = static_cast<unsigned>(cols) == want;
  while (!all_ties) {
    // The bin of the want-th largest key among those that share the prefix:
    // each thread sums a run of bins from the top, a block scan orders the
    // runs, and the thread whose run holds the crossing walks it.
    const int bins = static_cast<int>(digit) + 1;
    const int per = max(1, bins / threads);
    const int hi = bins - tid * per, lo = max(0, hi - per);
    unsigned sum = 0u;
    for (int b = lo; b < hi; ++b) sum += hist[b];
    unsigned total;
    const unsigned above = block_scan(sum, words, total);
    if (hi > lo && above < want && want <= above + sum) {
      unsigned acc = above;
      for (int b = hi - 1; b >= lo; --b) {
        if (acc + hist[b] >= want) {
          words[40] = static_cast<unsigned>(b);
          words[41] = acc;
          words[42] = hist[b];
          break;
        }
        acc += hist[b];
      }
    }
    __syncthreads();
    want -= words[41];
    prefix |= words[40] << shift;
    mask |= digit << shift;
    all_ties = words[42] == want;
    if (all_ties || shift == 0) break;

    // The least and the greatest key that share the prefix: the bits they
    // share join it (a bin of one value, as a row's sentinels, is then done).
    unsigned lo_key = kFull, hi_key = 0u;
    sweep(keys, cached, xr, cols, [&](unsigned key, bool ok) {
      if (ok && (key & mask) == prefix) {
        lo_key = min(lo_key, key);
        hi_key = max(hi_key, key);
      }
    });
    lo_key = __reduce_min_sync(kFull, lo_key);
    hi_key = __reduce_max_sync(kFull, hi_key);
    if (lane == 0) {
      words[64 + warp] = lo_key;
      words[96 + warp] = hi_key;
    }
    __syncthreads();
    for (int w = 0; w < warps; ++w) {
      lo_key = min(lo_key, words[64 + w]);
      hi_key = max(hi_key, words[96 + w]);
    }
    const unsigned diff = lo_key ^ hi_key;
    if (diff == 0u) {
      prefix = lo_key;
      mask = kFull;
      break;
    }
    const int free_bits = 32 - __clz(diff);   // bits below them differ
    mask = ~((1u << free_bits) - 1u);
    prefix = lo_key & mask;

    // The next digit of the keys that share the prefix.
    const int width = min(kBits, free_bits);
    shift = free_bits - width;
    digit = (1u << width) - 1u;
    for (int b = tid; b < kBins; b += threads) hist[b] = 0u;
    __syncthreads();
    const unsigned m = mask, pfx = prefix, dg = digit;
    const int sh = shift;
    sweep(keys, cached, xr, cols, [&](unsigned key, bool ok) {
      count(hist, ok && (key & m) == pfx ? (key >> sh) & dg : kNoBin);
    });
    __syncthreads();
  }
  // Taken: the entries whose masked key is above `prefix` (k - want of
  // them), and of those equal to it the first `want` in column order (all of
  // them when all_ties).

  // ---- gather: one sweep in chunks of four consecutive columns a thread.
  // The entries taken whatever their column (all of them when all_ties,
  // else those above the k-th key) reserve slots with one atomic add a warp;
  // the ties to the k-th key, of which the first `want` in column order are
  // taken, are ranked by a block scan a chunk until that many are found.
  const unsigned placed = all_ties ? static_cast<unsigned>(k) : static_cast<unsigned>(k) - want;
  unsigned* next_slot = words + 48;
  if (tid == 0) *next_slot = 0u;
  __syncthreads();
  unsigned run_tied = 0u;   // block-uniform
  for (int base = 0; base < cols; base += 4 * threads) {
    const int c = base + 4 * tid;
    unsigned kq[4];
    bool ok[4];
    if (c + 4 <= cached) {
      const uint4 w = reinterpret_cast<const uint4*>(keys)[c >> 2];
      kq[0] = w.x, kq[1] = w.y, kq[2] = w.z, kq[3] = w.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[e] = true;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[e] = c + e < cols;
        kq[e] = ok[e] ? key_at(keys, cached, xr, c + e) : 0u;
      }
    }
    bool take[4], tie[4];
    unsigned n_take = 0u, n_tie = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned m = kq[e] & mask;
      take[e] = ok[e] && (m > prefix || (all_ties && m == prefix));
      tie[e] = ok[e] && !all_ties && m == prefix;
      n_take += take[e];
      n_tie += tie[e];
    }
    unsigned inc = n_take;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += t;
    }
    unsigned first = 0u;
    if (lane == 31 && inc > 0u) first = atomicAdd(next_slot, inc);
    unsigned pos = __shfl_sync(kFull, first, 31) + inc - n_take;
    const bool ranking = run_tied < want;
    unsigned rank = 0u;
    if (ranking) {
      unsigned total;
      rank = run_tied + block_scan(n_tie, words, total);
      run_tied += total;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!take[e] && !(ranking && tie[e] && rank < want)) {
        rank += tie[e];
        continue;
      }
      const unsigned neg_zero = kq[e] == kZeroKey ? __float_as_uint(xr[c + e]) >> 31 : 0u;
      const unsigned long long p = pair_of(kq[e], c + e, neg_zero);
      if (take[e]) {
        buf_a[sk(pos++)] = p;
      } else {
        buf_a[sk(placed + rank++)] = p;
      }
    }
  }
  __syncthreads();

  // ---- sort: buf_a holds the entries taken whatever their column, in no
  // order, then (unless all_ties) the first ties in column order, which
  // stay where they are.
  const int n = static_cast<int>(placed);
  const unsigned long long* sorted = n > 1 ? merge_sort(buf_a, buf_b, n) : buf_a;

  // ---- the values (every bit of the row's) and the indices
  float* vr = values + row * k;
  long long* ir = indices + row * k;
  for (int j = tid; j < k; j += threads) {
    const unsigned long long p = j < n ? sorted[sk(j)] : buf_a[sk(j)];
    vr[j] = value_of(p);
    ir[j] = static_cast<long long>((static_cast<unsigned>(p) >> 1));
  }
}

template <int kBits>
int launch(const float* x, int rows, int cols, long long ld, int k, unsigned long long* scratch,
           float* values, long long* indices, cudaStream_t stream) {
  int threads = kMinThreads;
  while (threads < kMaxThreads && threads * 4 < cols) threads *= 2;
  if (k > kSmemPairs && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= kSmemPairs) scratch = nullptr;
  const long long pair_bytes = scratch ? 0 : static_cast<long long>(buffer_entries(k)) * 8;
  // The region: the keys and the histogram, or the second buffer, whichever
  // is larger; the keys as many as fit.
  const long long hist_words = 1LL << kBits;
  const long long sort_words = pair_bytes / 4;
  const long long room = (kSmemBytes - pair_bytes) / 4 - kWords;
  if (room < hist_words || room < sort_words) return static_cast<int>(cudaErrorInvalidValue);
  const long long fit = room - hist_words;
  const int cached = static_cast<int>(fit < cols ? fit : cols) & ~3;
  const long long union_words =
      cached + hist_words > sort_words ? cached + hist_words : sort_words;
  const size_t shmem = static_cast<size_t>(pair_bytes + (union_words + kWords) * 4);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        top_k_kernel<kBits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  top_k_kernel<kBits><<<rows, threads, shmem, stream>>>(
      x, cols, ld, k, cached, static_cast<int>(union_words), scratch, values, indices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of device scratch nbody_top_k needs for `rows` rows and k: 0 where
// the entry buffers fit in shared memory, else (rows, 2, buffer_entries(k))
// int64.
extern "C" long long nbody_top_k_scratch_bytes(int rows, int k) {
  if (rows <= 0 || k <= kSmemPairs) return 0;
  return static_cast<long long>(rows) * 2 * buffer_entries(k) * 8;
}

// x: (rows, cols) float32, row r at x + r ld, its columns contiguous,
// cols < 2^31; values: (rows, k) float32 and indices: (rows, k) int64,
// 1 <= k <= cols. scratch: nbody_top_k_scratch_bytes(rows, k) bytes of device
// memory, 8-byte aligned (null where that is 0). Launches one kernel on
// `stream` (none for no rows); returns cudaGetLastError().
extern "C" int nbody_top_k(const float* x, int rows, int cols, long long ld, int k,
                           unsigned long long* scratch, float* values, long long* indices,
                           void* stream) {
  if (rows < 0 || cols <= 0 || ld < cols || k < 1 || k > cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols >= 4 * 2048) {
    return launch<11>(x, rows, cols, ld, k, scratch, values, indices, s);
  }
  return launch<8>(x, rows, cols, ld, k, scratch, values, indices, s);
}
