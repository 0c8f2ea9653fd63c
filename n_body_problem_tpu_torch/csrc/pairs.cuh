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
