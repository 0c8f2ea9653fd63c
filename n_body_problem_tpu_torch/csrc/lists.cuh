// Device helpers shared by the treecode kernels that walk compacted work
// lists (near.cu, far_hier.cu).
#pragma once

// First index in the non-decreasing a[0..n) whose value is >= key. A block
// finds its target row's chunk range [lower_bound(t), lower_bound(t + 1)).
static __device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}
