// K1: cross-view depth-consistency filter, one thread per pixel.
//
// Replaces: multiviewstitch_tpu/ops/pallas_gather.py:pallas_gather_banded
// (the integer 2D gather behind ops/consistency.py:_gather_px_frames) as
// used by check_consistency. The TPU kernel DMAs an 8-row band's source
// window into VMEM and marks targets outside it invalid; here each thread
// reads its neighbour pixel directly, so every target is served ("ok" is
// always true) and the whole filter — valid test, unproject, project into
// the -1/+1 frames, round, gather, round trip, pixel-error test — runs in
// registers with one disparity write.
//
// Bound on the H100: bytes moved, not FLOPs (~60 flops per neighbour per
// pixel against 4 B read + 4 B gathered + 4 B written). Design: the
// per-pixel intermediates ([N,H,W,3] points, projected coordinates, masks)
// that the plain version writes to device memory never leave registers, so
// the traffic is one read of the disparity, two gathers from the
// neighbour frames (mostly L2 hits: neighbour targets are near the pixel's
// own position) and one write. Cameras are read from device memory.
//
// Numerics: built with -fmad=false so each multiply and add rounds like the
// separate PyTorch ops of check_consistency_reference; floor(x+0.5) ties
// then fall the same way.

#include "common.cuh"

namespace {

__global__ void consistency_kernel(const float* __restrict__ disp,
                                   const float* __restrict__ K,
                                   const float* __restrict__ R,
                                   const float* __restrict__ t,
                                   float* __restrict__ out, int n_frames,
                                   int h, int w, float min_dsp, float max_dsp,
                                   float err_sq) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long hw = (long long)h * w;
  if (idx >= hw * n_frames) return;
  int n = (int)(idx / hw);
  int pix = (int)(idx - (long long)n * hw);
  int y = pix / w;
  int x = pix - y * w;

  float d = disp[idx];
  bool keep = (d >= min_dsp) && (d <= max_dsp);
  if (keep) {
    mvs::Cam cam = mvs::load_cam(K, R, t, n);
    float fu = (float)x, fv = (float)y;
    float depth = 1.0f / d;
    float p[3];
    mvs::unproject(cam, fu, fv, depth, p);
    for (int off = -1; off <= 1 && keep; off += 2) {
      int m = n + off;
      if (m < 0 || m >= n_frames) continue;  // missing neighbour: no vote
      mvs::Cam nc = mvs::load_cam(K, R, t, m);
      float un, vn, zn;
      mvs::project(nc, p, &un, &vn, &zn);
      float ru = mvs::round_px(un), rv = mvs::round_px(vn);
      bool inb1 = (ru >= 0.f) && (ru <= (float)(w - 1)) && (rv >= 0.f) &&
                  (rv <= (float)(h - 1)) && (zn > 0.f);
      float uc = mvs::clampf(ru, 0.f, (float)(w - 1));
      float vc = mvs::clampf(rv, 0.f, (float)(h - 1));
      float dn = disp[(long long)m * hw + (int)vc * w + (int)uc];
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
  }
  out[idx] = keep ? d : 0.0f;
}

}  // namespace

extern "C" int mvs_consistency(const float* disp, const float* K,
                               const float* R, const float* t, float* out,
                               int n_frames, int h, int w, float min_dsp,
                               float max_dsp, float err_sq, void* stream) {
  long long total = (long long)n_frames * h * w;
  if (total == 0) return 0;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  consistency_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      disp, K, R, t, out, n_frames, h, w, min_dsp, max_dsp, err_sq);
  return (int)cudaGetLastError();
}

extern "C" const char* mvs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
