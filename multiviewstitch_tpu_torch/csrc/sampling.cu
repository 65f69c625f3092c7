// K2: multi-frame disparity-agreement votes of the oriented point sampler,
// one thread per strided sample.
//
// Replaces: multiviewstitch_tpu/ops/pallas_gather.py:pallas_gather_banded
// (the integer 2D gather behind ops/consistency.py:_gather_px_frames) as
// used by ops/point_sampling.py:sample_oriented_points. The TPU kernel
// gathers one neighbour frame per call through DMA'd row windows and marks
// out-of-window targets invalid; here each thread walks all 2*nbr_num
// neighbour frames of its sample — project, round, in-bounds test, direct
// gather, disparity agreement — and writes only the confidence.
//
// Bound on the H100: bytes moved, not FLOPs (~25 flops per neighbour per
// sample against a 12 B point read and a 4 B gather). Design: the plain
// version materialises [N,Hs,Ws] projected coordinates, masks and vote
// tensors per neighbour in device memory; here they live in registers, so
// the traffic is one read of the sample points, one gather per neighbour
// (near the sample's own position, so mostly L2 hits) and one write.
//
// Numerics: built with -fmad=false so each multiply and add rounds like the
// separate PyTorch ops of sampling_votes_reference.

#include "common.cuh"

namespace {

__global__ void sampling_vote_kernel(const float* __restrict__ pts,
                                     const float* __restrict__ disp,
                                     const float* __restrict__ K,
                                     const float* __restrict__ R,
                                     const float* __restrict__ t,
                                     float* __restrict__ conf, int n_frames,
                                     int hs, int ws, int h, int w,
                                     int nbr_num, int nbr_step, float min_dsp,
                                     float max_dsp, float dsp_err) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long per = (long long)hs * ws;
  if (idx >= per * n_frames) return;
  int n = (int)(idx / per);
  float p[3] = {pts[3 * idx], pts[3 * idx + 1], pts[3 * idx + 2]};
  long long hw = (long long)h * w;

  float votes = 0.f, exists_total = 0.f;
  for (int k = 1; k <= nbr_num; ++k) {
    for (int sgn = -1; sgn <= 1; sgn += 2) {
      int m = n + sgn * k * nbr_step;
      if (m < 0 || m >= n_frames) continue;  // no such frame: no vote
      mvs::Cam nc = mvs::load_cam(K, R, t, m);
      float un, vn, zn;
      mvs::project(nc, p, &un, &vn, &zn);
      float ru = mvs::round_px(un), rv = mvs::round_px(vn);
      bool inb = (ru >= 0.f) && (ru <= (float)(w - 1)) && (rv >= 0.f) &&
                 (rv <= (float)(h - 1)) && (zn > 0.f);
      float uc = mvs::clampf(ru, 0.f, (float)(w - 1));
      float vc = mvs::clampf(rv, 0.f, (float)(h - 1));
      float dn = disp[(long long)m * hw + (int)vc * w + (int)uc];
      float d_proj = zn > 1e-12f ? 1.0f / fmaxf(zn, 1e-12f) : 0.0f;
      bool agree = inb && (fabsf(dn - d_proj) <= dsp_err) &&
                   (dn >= min_dsp) && (dn <= max_dsp);
      votes += agree ? 1.0f : 0.0f;
      exists_total += 1.0f;
    }
  }
  conf[idx] = exists_total > 0.f ? votes / fmaxf(exists_total, 1.0f) : 1.0f;
}

}  // namespace

extern "C" int mvs_sampling_votes(const float* pts, const float* disp,
                                  const float* K, const float* R,
                                  const float* t, float* conf, int n_frames,
                                  int hs, int ws, int h, int w, int nbr_num,
                                  int nbr_step, float min_dsp, float max_dsp,
                                  float dsp_err, void* stream) {
  long long total = (long long)n_frames * hs * ws;
  if (total == 0) return 0;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sampling_vote_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, disp, K, R, t, conf, n_frames, hs, ws, h, w, nbr_num, nbr_step,
      min_dsp, max_dsp, dsp_err);
  return (int)cudaGetLastError();
}
