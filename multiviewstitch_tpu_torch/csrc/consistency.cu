// K1: cross-view depth-consistency filter on a 2-D tiled grid.
//
// Replaces: multiviewstitch_tpu/ops/pallas_gather.py:pallas_gather_banded
// (the integer 2D gather behind ops/consistency.py:_gather_px_frames) as
// used by check_consistency. The TPU kernel DMAs an 8-row band's source
// window into VMEM and marks targets outside it invalid; here each thread
// reads its neighbour pixels directly, so every target is served ("ok" is
// always true) and the whole filter — valid test, unproject, project into
// the -1/+1 frames, round, gather, round trip, pixel-error test — runs in
// registers with one disparity write.
//
// Neighbour frames: the offsets (default -1, +1; at most kMaxOffsets of
// them, each within +-kMaxHalo frames) ride in the launch by value; the
// block stages the 2*halo+1 cameras n-halo..n+halo (halo = max |offset|)
// in shared memory. A neighbour outside the sequence casts no vote, and
// the pixel survives only if every existing neighbour keeps it.
//
// Bound on the H100: bytes. The function reads each disparity once and
// writes it once (8 B a pixel: 157 MB, 47 us at 3.35 TB/s for 64 VGA
// frames); its float32 work is ~200 flops a valid pixel (one unprojection,
// then per neighbour two projections, one unprojection, two roundings and
// the error test), ~24 us at 67 TFLOP/s even if every pixel were valid.
// Design: a (32 x 8)-thread block covers 128 x 8 pixels of one frame
// (frame = blockIdx.z, so no thread divides to find its pixel); each
// thread takes 4 consecutive pixels with one 16-byte load and one 16-byte
// store when the row width is a multiple of 4 (a scalar path otherwise).
// The cameras the block needs (frames n-halo..n+halo) are staged once in
// shared memory. The neighbour gathers go through the read-only path
// (__ldg); their targets lie near the pixel's own position, so they hit L2.
//
// Numerics: built with -fmad=false, in the operand order of common.cuh,
// with IEEE divisions, so each multiply and add rounds like the separate
// PyTorch ops of check_consistency_reference and the output is
// bit-identical; floor(x+0.5) ties fall the same way.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kPix = 4;  // consecutive pixels a thread
constexpr int kMaxOffsets = 8;
constexpr int kMaxHalo = 16;

// The neighbour offsets, passed by value
struct Offsets {
  int n, halo;
  int v[kMaxOffsets];
};

// The filtered disparity of pixel (x, y) of frame n; cams[k] is frame
// n - halo + k.
__device__ __forceinline__ float check_pixel(
    float d, int x, int y, int n, int n_frames, const float* __restrict__ disp,
    size_t hw, int h, int w, const mvs::Cam* cams, const Offsets& offs,
    float min_dsp, float max_dsp, float err_sq) {
  bool keep = (d >= min_dsp) && (d <= max_dsp);
  if (!keep) return 0.0f;
  const mvs::Cam& cam = cams[offs.halo];
  float fu = (float)x, fv = (float)y;
  float p[3];
  mvs::unproject(cam, fu, fv, 1.0f / d, p);
  // unrolled over the fixed maximum so that offs.v is indexed by
  // constants: a runtime index would copy the struct to local memory
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    if (k >= offs.n || !keep) break;
    const int off = offs.v[k];
    int m = n + off;
    if (m < 0 || m >= n_frames) continue;  // missing neighbour: no vote
    const mvs::Cam& nc = cams[offs.halo + off];
    float un, vn, zn;
    mvs::project(nc, p, &un, &vn, &zn);
    float ru = mvs::round_px(un), rv = mvs::round_px(vn);
    bool inb1 = (ru >= 0.f) && (ru <= (float)(w - 1)) && (rv >= 0.f) &&
                (rv <= (float)(h - 1)) && (zn > 0.f);
    float uc = mvs::clampf(ru, 0.f, (float)(w - 1));
    float vc = mvs::clampf(rv, 0.f, (float)(h - 1));
    float dn = __ldg(disp + (size_t)m * hw + (int)vc * w + (int)uc);
    bool ref_valid = (dn >= min_dsp) && (dn <= max_dsp);
    float pn[3];
    mvs::unproject(nc, uc, vc, 1.0f / (ref_valid ? dn : 1.0f), pn);
    float ub, vb, zb;
    mvs::project(cam, pn, &ub, &vb, &zb);
    float rub = mvs::round_px(ub), rvb = mvs::round_px(vb);
    bool inb2 = (rub >= 0.f) && (rub <= (float)(w - 1)) && (rvb >= 0.f) &&
                (rvb <= (float)(h - 1));
    float du = fu - rub;
    float dv = fv - rvb;
    bool err_ok = du * du + dv * dv <= err_sq;
    keep = inb1 && ref_valid && inb2 && err_ok;
  }
  return keep ? d : 0.0f;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    consistency_kernel(const float* __restrict__ disp,
                       const float* __restrict__ K,
                       const float* __restrict__ R,
                       const float* __restrict__ t, float* __restrict__ out,
                       int n_frames, int h, int w, const Offsets offs,
                       float min_dsp, float max_dsp, float err_sq) {
  __shared__ mvs::Cam cams[2 * kMaxHalo + 1];
  const int n = blockIdx.z;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < (2 * offs.halo + 1) * mvs::kCamFields;
       i += kThreadsX * kThreadsY) {
    const int m = n - offs.halo + i / mvs::kCamFields;
    if (m >= 0 && m < n_frames)
      reinterpret_cast<float*>(cams)[i] =
          mvs::cam_field(K, R, t, m, i % mvs::kCamFields);
  }
  __syncthreads();

  const int y = blockIdx.y * kThreadsY + threadIdx.y;
  const int x0 = (blockIdx.x * kThreadsX + threadIdx.x) * kPix;
  if (y >= h || x0 >= w) return;
  const size_t hw = (size_t)h * w;
  const size_t at = (size_t)n * hw + (size_t)y * w + x0;
  float d[kPix], o[kPix];
  if (kVec) {  // w % 4 == 0 and 16-byte aligned rows: x0 + 3 < w
    const float4 v = __ldg(reinterpret_cast<const float4*>(disp + at));
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      d[i] = x0 + i < w ? __ldg(disp + at + i) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i)
    o[i] = check_pixel(d[i], x0 + i, y, n, n_frames, disp, hw, h, w, cams,
                       offs, min_dsp, max_dsp, err_sq);
  if (kVec) {
    *reinterpret_cast<float4*>(out + at) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (x0 + i < w) out[at + i] = o[i];
  }
}

}  // namespace

// offsets: n_off host ints, 1 <= n_off <= kMaxOffsets, |offset| <= kMaxHalo
extern "C" int mvs_consistency(const float* disp, const float* K,
                               const float* R, const float* t, float* out,
                               int n_frames, int h, int w, const int* offsets,
                               int n_off, float min_dsp, float max_dsp,
                               float err_sq, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets) return (int)cudaErrorInvalidValue;
  Offsets offs;
  offs.n = n_off;
  offs.halo = 0;
  for (int k = 0; k < kMaxOffsets; ++k) {
    offs.v[k] = k < n_off ? offsets[k] : 0;
    const int a = offs.v[k] < 0 ? -offs.v[k] : offs.v[k];
    if (a > kMaxHalo) return (int)cudaErrorInvalidValue;
    if (a > offs.halo) offs.halo = a;
  }
  if (n_frames == 0 || h == 0 || w == 0) return 0;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kThreadsX * kPix - 1) / (kThreadsX * kPix),
                  (h + kThreadsY - 1) / kThreadsY, n_frames);
  const bool vec =
      w % kPix == 0 && ((uintptr_t)disp | (uintptr_t)out) % 16 == 0;
  if (vec)
    consistency_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        disp, K, R, t, out, n_frames, h, w, offs, min_dsp, max_dsp, err_sq);
  else
    consistency_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        disp, K, R, t, out, n_frames, h, w, offs, min_dsp, max_dsp, err_sq);
  return (int)cudaGetLastError();
}

extern "C" const char* mvs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
