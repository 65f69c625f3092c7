// Shared helpers for the hand-written kernels: pinhole camera math in the
// exact operand order of multiviewstitch_tpu_torch/core/cameras.py, so a
// kernel built with -fmad=false rounds like its plain PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mvs {

// 16 floats, so a block stages cameras into shared memory field by field
struct Cam {
  float fx, fy, cx, cy;
  float R[9];
  float t[3];
};
constexpr int kCamFields = 16;

// Field f (0..15, in Cam's order) of camera m from K [N,3,3], R [N,3,3],
// t [N,3]
__device__ __forceinline__ float cam_field(const float* __restrict__ K,
                                           const float* __restrict__ R,
                                           const float* __restrict__ t, int m,
                                           int f) {
  if (f < 4) {
    const int k = f == 0 ? 0 : f == 1 ? 4 : f == 2 ? 2 : 5;  // fx fy cx cy
    return __ldg(K + 9 * m + k);
  }
  if (f < 13) return __ldg(R + 9 * m + (f - 4));
  return __ldg(t + 3 * m + (f - 13));
}

// cameras.unproject: pixel (u, v) at depth -> world point
__device__ __forceinline__ void unproject(const Cam& c, float u, float v,
                                          float depth, float* p) {
  float x = (u - c.cx) * depth / c.fx;
  float y = (v - c.cy) * depth / c.fy;
  float q0 = x - c.t[0];
  float q1 = y - c.t[1];
  float q2 = depth - c.t[2];
  const float* R = c.R;
  p[0] = R[0] * q0 + R[3] * q1 + R[6] * q2;
  p[1] = R[1] * q0 + R[4] * q1 + R[7] * q2;
  p[2] = R[2] * q0 + R[5] * q1 + R[8] * q2;
}

// cameras.project: world point -> continuous pixel (u, v) and camera z
// (and, if asked, the 1/z it multiplied by)
__device__ __forceinline__ void project(const Cam& c, const float* p,
                                        float* u, float* v, float* z,
                                        float* inv_zs = nullptr) {
  const float* R = c.R;
  float pc0 = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + c.t[0];
  float pc1 = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + c.t[1];
  float pc2 = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + c.t[2];
  float zs = fabsf(pc2) < 1e-12f ? 1e-12f : pc2;
  float inv_z = 1.0f / zs;
  *u = c.fx * pc0 * inv_z + c.cx;
  *v = c.fy * pc1 * inv_z + c.cy;
  *z = pc2;
  if (inv_zs) *inv_zs = inv_z;
}

// C++ (int)(x + 0.5) for the coordinates the tests use, kept in float so
// out-of-range values never overflow an int conversion
__device__ __forceinline__ float round_px(float x) { return floorf(x + 0.5f); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

}  // namespace mvs
