// span_stamp_kernel: one record of the program's spans, written on the card.
//
// No TPU counterpart: the JAX package's spans are jax.profiler's. The
// port's treecode run is replayed from CUDA graphs (graphs.py), where no
// host code runs between the kernels, so a span boundary inside a replay is
// a node of its own: this kernel, launched by utils/profiling.py's Stamper
// while a graph is captured (or while a profiler records, outside a graph).
//
// What it writes: at slot cursor % capacity of the ring, kFields int64s:
// the span code (the phase's index times two, plus one at its end, or -1
// for the end of every open phase), %globaltimer in ns, and n_counters
// values copied from counters (zeros after them). The cursor is advanced
// on the card, so every replay of a graph writes records of its own and
// the host never waits; the host keeps the same count, since it knows how
// many stamps each graph holds.
//
// Cost: one thread, a load of the counters and one 96-byte record; about a
// launch's latency inside a graph.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 12;  // RECORD in utils/profiling.py
constexpr int kCounters = kFields - 2;

__global__ void span_stamp_kernel(long long* ring, unsigned long long* cursor, int capacity,
                                  int code, const long long* counters, int n_counters) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(cursor, 1ull) % capacity;
  long long* rec = ring + slot * kFields;
  rec[0] = code;
  rec[1] = static_cast<long long>(now);
  for (int i = 0; i < kCounters; ++i) rec[2 + i] = i < n_counters ? counters[i] : 0;
}

}  // namespace

extern "C" int nbody_span_stamp(long long* ring, unsigned long long* cursor, int capacity,
                                int code, const long long* counters, int n_counters,
                                void* stream) {
  if (capacity <= 0 || n_counters < 0 || n_counters > kCounters ||
      (n_counters > 0 && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, cursor, capacity,
                                                                   code, counters, n_counters);
  return static_cast<int>(cudaGetLastError());
}
