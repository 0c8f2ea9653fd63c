// Device helpers of the two far-field kernels (far_hier.cu, far_single.cu):
// a node-summary row scaled as it is staged, and one body-node term.
#pragma once

#include "pairs.cuh"

// Node rows are 12 floats, three quads: cx cy cz m | qxx qyy qzz qxy |
// qxz qyz tr 0. Quad `which` of a row, scaled for far_term: m by G c^3
// (mono), the quadrupole by -3 G c^5 (quad), tr by -1.5 G c^5 (trace).
static __device__ __forceinline__ float4 scale_node_quad(float4 v, int which, float mono,
                                                         float quad, float trace) {
  if (which == 0) {
    v.w *= mono;
  } else {
    v.x *= quad;
    v.y *= quad;
    v.z *= which == 1 ? quad : trace;
    v.w *= quad;  // qxy, or the row's zero twelfth float
  }
  return v;
}

// One body-node term into (ax, ay, az): the node's three quads a, q, r as
// staged (m', S' and tr' scaled), kq = -2.5 c^2. With u = (c^2 |d|^2 +
// eps2)^-1/2, d = com - y, it adds u^3 (m' + u^2 (tr' + kq u^2 d'S'd)) d +
// u^5 S'd, which is G c [(m c^2 u^3 - 1.5 c^4 tr u^5 + 7.5 c^6 d'Sd u^7) d -
// 3 c^4 u^5 S d] (treecode.py:459-486, 2187-2211): 33 instructions with the
// bare rsqrt; the wrappers require a normal eps2.
static __device__ __forceinline__ void far_term(const float4& a, const float4& q,
                                                const float4& r, const float4& me, float c2,
                                                float eps2, float kq, float& ax, float& ay,
                                                float& az) {
  const float dx = a.x - me.x;
  const float dy = a.y - me.y;
  const float dz = a.z - me.z;
  const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
  const float u = rsqrt_normal(fmaf(c2, r2, eps2));
  const float u2 = u * u;
  const float sdx = fmaf(q.x, dx, fmaf(q.w, dy, r.x * dz));  // S'd
  const float sdy = fmaf(q.w, dx, fmaf(q.y, dy, r.y * dz));
  const float sdz = fmaf(r.x, dx, fmaf(r.y, dy, q.z * dz));
  const float dsd = fmaf(dx, sdx, fmaf(dy, sdy, dz * sdz));  // d'S'd
  const float u3 = u2 * u;
  const float wd = u3 * fmaf(u2, fmaf(kq * u2, dsd, r.z), a.w);
  const float u5 = u3 * u2;
  ax = fmaf(wd, dx, fmaf(u5, sdx, ax));
  ay = fmaf(wd, dy, fmaf(u5, sdy, ay));
  az = fmaf(wd, dz, fmaf(u5, sdz, az));
}
