// Shared helpers for the hand-written kernels: pinhole camera math in the
// exact operand order of multiviewstitch_tpu_torch/core/cameras.py, so a
// kernel built with -fmad=false rounds like its plain PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mvs {

struct Cam {
  float fx, fy, cx, cy;
  float R[9];
  float t[3];
};

// K [3,3], R [3,3], t [3] rows of camera n
__device__ __forceinline__ Cam load_cam(const float* K, const float* R,
                                        const float* t, int n) {
  Cam c;
  const float* k = K + 9 * n;
  c.fx = k[0];
  c.fy = k[4];
  c.cx = k[2];
  c.cy = k[5];
  for (int i = 0; i < 9; ++i) c.R[i] = R[9 * n + i];
  for (int i = 0; i < 3; ++i) c.t[i] = t[3 * n + i];
  return c;
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
__device__ __forceinline__ void project(const Cam& c, const float* p,
                                        float* u, float* v, float* z) {
  const float* R = c.R;
  float pc0 = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + c.t[0];
  float pc1 = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + c.t[1];
  float pc2 = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + c.t[2];
  float zs = fabsf(pc2) < 1e-12f ? 1e-12f : pc2;
  float inv_z = 1.0f / zs;
  *u = c.fx * pc0 * inv_z + c.cx;
  *v = c.fy * pc1 * inv_z + c.cy;
  *z = pc2;
}

// C++ (int)(x + 0.5) for the coordinates the tests use, kept in float so
// out-of-range values never overflow an int conversion
__device__ __forceinline__ float round_px(float x) { return floorf(x + 0.5f); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

}  // namespace mvs
