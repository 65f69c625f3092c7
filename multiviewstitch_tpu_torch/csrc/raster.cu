// K3: z-max (largest 1/z wins) triangle rasterizer, one warp per
// (frame, face).
//
// Replaces: multiviewstitch_tpu/ops/pallas_raster.py:raster_faces and
// :raster_strips, and with them the XLA tile passes, the compacted
// scatter-max ladder and the full-frame pass of
// multiviewstitch_tpu/ops/rasterizer.py:render_disparity. The TPU kernels
// keep the z-buffer in VMEM and only take faces whose bbox is under a size
// class; everything else fell to the XLA ladder, whose capacities made
// giant close-up faces a special case ("overflow"). Here a warp walks its
// face's pixel bbox, clipped to the image, 32 pixels at a time, so any face
// size renders exactly and overflow does not exist.
//
// Bound on the H100: bytes moved, not FLOPs. Per covered pixel the work is
// ~20 flops and one 4-byte atomicMax; per face it is three vertex reads.
// Design: the z-test is an integer atomicMax on the float bits — only
// disp > 0 is ever written into a zeroed buffer, and for non-negative
// floats int order is float order — so there is no sort, no binning and no
// per-tile capacity, and a VGA frame's z-buffer (1.2 MB) stays in L2 while
// the atomics land. Faces with tiny bboxes leave most lanes of their warp
// idle; that is the first thing a later PR would fix (several faces per
// warp).
//
// Numerics: the edge functions, winding test and disparity interpolation
// use the operand order of rasterizer._raster_pass, and the build uses
// -fmad=false, so coverage at e == 0 and the interpolated values match the
// plain version raster_reference.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // faces per block

__global__ void raster_kernel(const float* __restrict__ uvz,
                              const int* __restrict__ faces,
                              const uint8_t* __restrict__ face_ok,
                              float* __restrict__ zbuf, int n_verts,
                              int n_faces, int h, int w) {
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int f = blockIdx.x * kWarps + warp;
  int n = blockIdx.y;
  if (f >= n_faces) return;
  if (!face_ok[(long long)n * n_faces + f]) return;

  const float* V = uvz + (long long)n * n_verts * 3;
  int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
  float u0 = V[3 * i0], v0 = V[3 * i0 + 1], z0 = V[3 * i0 + 2];
  float u1 = V[3 * i1], v1 = V[3 * i1 + 1], z1 = V[3 * i1 + 2];
  float u2 = V[3 * i2], v2 = V[3 * i2 + 1], z2 = V[3 * i2 + 2];

  float area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0);
  if (!(fabsf(area) > 1e-12f)) return;  // degenerate (or NaN) face

  float x0 = fmaxf(floorf(fminf(u0, fminf(u1, u2))), 0.f);
  float x1 = fminf(ceilf(fmaxf(u0, fmaxf(u1, u2))), (float)(w - 1));
  float y0 = fmaxf(floorf(fminf(v0, fminf(v1, v2))), 0.f);
  float y1 = fminf(ceilf(fmaxf(v0, fmaxf(v1, v2))), (float)(h - 1));
  if (!(x0 <= x1 && y0 <= y1)) return;  // entirely off-screen
  int ix0 = (int)x0, iy0 = (int)y0;
  int bw = (int)x1 - ix0 + 1;
  int count = bw * ((int)y1 - iy0 + 1);

  bool ccw = area >= 0.f;
  float* img = zbuf + (long long)n * h * w;
  for (int p = lane; p < count; p += 32) {
    int py = iy0 + p / bw;
    int px = ix0 + p % bw;
    float fx = (float)px, fy = (float)py;
    float e0 = (u1 - u0) * (fy - v0) - (v1 - v0) * (fx - u0);
    float e1 = (u2 - u1) * (fy - v1) - (v2 - v1) * (fx - u1);
    float e2 = (u0 - u2) * (fy - v2) - (v0 - v2) * (fx - u2);
    bool inside = ccw ? (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f)
                      : (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f);
    float w0 = e1 / area;
    float w1 = e2 / area;
    float w2 = e0 / area;
    float disp = w0 * z0 + w1 * z1 + w2 * z2;
    if (inside && disp > 0.f)
      atomicMax(reinterpret_cast<int*>(img + py * w + px),
                __float_as_int(disp));
  }
}

}  // namespace

extern "C" int mvs_raster(const float* uvz, const int* faces,
                          const uint8_t* face_ok, float* zbuf, int n_frames,
                          int n_verts, int n_faces, int h, int w,
                          void* stream) {
  if (n_frames == 0 || n_faces == 0) return 0;
  dim3 grid((n_faces + kWarps - 1) / kWarps, n_frames);
  raster_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      uvz, faces, face_ok, zbuf, n_verts, n_faces, h, w);
  return (int)cudaGetLastError();
}
