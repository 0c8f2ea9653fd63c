// Device helpers of the pair and treecode kernels.
#pragma once

// rsqrt(x) for normal x > 0 as the bare MUFU instruction. rsqrtf() wraps the
// same instruction in a test and two multiplies that rescale denormal
// inputs (three more issue slots a pair). The bare instruction flushes a
// denormal to zero and returns inf; c^2 |d|^2 + eps2 is never denormal for a
// normal eps2, which the wrappers require (require_normal_eps2 in
// ops/cuda_build.py), and there both give the same bits.
static __device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One source body b = [x y z m'] against the kRows row bodies a thread
// holds: acc_q += m' rsqrt(|d|^2 c^2 + eps2)^3 d, d = b - p_q, subtracting
// first and scaling the squared distance after (pallas_force.py:54-58,
// treecode.py:734-739). One 16-byte load of b serves kRows pairs, and the
// kRows pairs are independent work for the pipe. The all-pairs kernel and
// the near-panel kernel sum their pairs with it. b is taken by value, so that
// its four floats stay in registers after one 16-byte shared load.
template <int kRows>
static __device__ __forceinline__ void pull_rows(const float4 b, const float (&xi)[kRows],
                                                 const float (&yi)[kRows],
                                                 const float (&zi)[kRows], float (&ax)[kRows],
                                                 float (&ay)[kRows], float (&az)[kRows],
                                                 float c2, float eps2) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float dx = b.x - xi[q];
    const float dy = b.y - yi[q];
    const float dz = b.z - zi[q];
    const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
    const float inv = rsqrt_normal(fmaf(r2, c2, eps2));
    const float w = b.w * (inv * inv * inv);
    ax[q] = fmaf(w, dx, ax[q]);
    ay[q] = fmaf(w, dy, ay[q]);
    az[q] = fmaf(w, dz, az[q]);
  }
}

// A 16-byte copy from global to shared memory that does not wait; the copies
// a thread has committed are done after its cp_async_wait_all(), and visible
// to the block after the next __syncthreads().
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
