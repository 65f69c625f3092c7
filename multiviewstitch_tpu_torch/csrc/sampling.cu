// K2: the whole oriented point sampler, one thread per strided sample.
//
// Replaces: multiviewstitch_tpu/ops/pallas_gather.py:pallas_gather_banded
// (the integer 2D gather behind ops/consistency.py:_gather_px_frames) as
// used by ops/point_sampling.py:sample_oriented_points, together with the
// XLA program around it. The TPU kernel gathers one neighbour frame per
// call through DMA'd row windows; here one kernel computes everything the
// sampler returns for each sample (x, y) = (sx * r, sy * r) of frame n:
//   - the point: the unprojection of the pixel;
//   - the normal: cross(dv, du) of the central-difference tangents of the
//     +-1-pixel neighbours (zero where a neighbour is invalid; neighbours
//     wrap around the borders like the plain version's roll), kept if its
//     length is > 1e-12, normalised and flipped toward the camera centre;
//   - the confidence: the share of the existing frames n +- k * step
//     (k = 1..nbr_num) whose disparity at the reprojected pixel agrees
//     within dsp_err;
//   - the keep mask: valid & has normal & conf >= conf_min.
// No [N,H,W,3] array exists: the outputs are points and normals [N,S,3],
// conf [N,S] and valid [N,S].
//
// Bound on the H100: bytes. The function reads the disparity once (4 B a
// pixel) and writes 29 B a sample (221 MB, 66 us at 3.35 TB/s for 64 VGA
// frames at stride 2); its float32 work is ~25 flops a needed pixel
// (unprojection), ~30 a sample (normal) and ~32 a sample and neighbour
// (projection and vote). Design: a (32 x 8)-thread block covers 32 x 8
// samples of one frame (frame = blockIdx.z). It stages the pixels its
// samples and their +-1 neighbours touch — the sample rows whole, the rows
// above and below at the sample columns — through loads that are
// coalesced along rows, unprojects each pixel once into shared memory
// (x, y, z, valid), and each sample reads its five points from there. The
// cameras of frames n and n +- k * step (at most 2 * nbr_num + 1) are
// staged once per block in shared memory. The vote gathers go through the
// read-only path (__ldg); their targets lie near the sample's own position
// in frames near n, so they hit L2. Each warp holds one sample row: it
// writes its 32 points and normals (384 B each) through shared memory as
// whole lines, conf and valid directly.
//
// Numerics: built with -fmad=false, in the operand order of common.cuh,
// with IEEE divisions and sqrt: the points, the confidences and the keep
// mask round like the separate PyTorch ops of the plain version. The
// normals use the plain formulas; PyTorch's own cross, norm and sum
// kernels may contract or reorder, so they match to a tolerance.

#include "common.cuh"

namespace {

constexpr int kSX = 32;  // samples a block: one warp per sample row
constexpr int kSY = 8;
constexpr int kThreads = kSX * kSY;
constexpr int kOutFloats = 6 * kSX;  // a warp's points, then its normals

// p in [-1, size * k) -> p mod size (more than one turn only for images
// smaller than a tile)
__device__ __forceinline__ int wrap(int p, int size) {
  if (p < 0) p += size;
  while (p >= size) p -= size;
  return p;
}

// The staged pixels of a tile at stride r, with S = min(r, 3) a template
// argument (no runtime integer division): staged index k along an axis
// maps to pixel (base + k / S) * r + k % S - 1, so sample i's pixel + d
// (d = -1, 0, 1) sits at k = i * S + 1 + d. Of the [ly][lx] staged grid
// only the samples' own rows (whole) and the rows above and below them
// (the samples' columns only) are needed; their kSY * lx + n_off * kSX
// entries are enumerated without gaps.
__host__ __device__ constexpr int staged_len(int samples, int S) {
  return (samples - 1) * S + 3;
}

template <int S>
struct Tile {
  static constexpr int lx = staged_len(kSX, S);
  static constexpr int ly = staged_len(kSY, S);
  static constexpr int n_off = S == 1 ? 2 : S == 2 ? kSY + 1 : 2 * kSY;
  static constexpr int count = kSY * lx + n_off * kSX;
  // staged row of the o-th off row: the rows j*S and j*S+2 that are not a
  // sample row j*S+1
  __device__ static int off_row(int o) {
    return S == 1   ? (o ? kSY + 1 : 0)
           : S == 2 ? 2 * o
                    : (o / 2) * 3 + (o % 2) * 2;
  }
  // staged cell (ky, kx) and wrapped pixel (py, px) of entry e < count of
  // the tile whose first sample is (sy0, sx0)
  __device__ static void pixel(int e, int sy0, int sx0, int r, int h, int w,
                               int* ky, int* kx, int* py, int* px) {
    if (e < kSY * lx) {
      *ky = e / lx * S + 1;
      *kx = e % lx;
    } else {
      *ky = off_row((e - kSY * lx) / kSX);
      *kx = (e - kSY * lx) % kSX * S + 1;
    }
    *py = wrap((sy0 + *ky / S) * r + *ky % S - 1, h);
    *px = wrap((sx0 + *kx / S) * r + *kx % S - 1, w);
  }
};

template <int S>
__global__ void __launch_bounds__(kThreads)
    oriented_points_kernel(const float* __restrict__ disp,
                           const float* __restrict__ K,
                           const float* __restrict__ R,
                           const float* __restrict__ t,
                           const float* __restrict__ centers,
                           float* __restrict__ points,
                           float* __restrict__ normals,
                           float* __restrict__ conf,
                           unsigned char* __restrict__ valid, int n_frames,
                           int h, int w, int r, int hs, int ws, int nbr_num,
                           int nbr_step, float min_dsp, float max_dsp,
                           float dsp_err, float conf_min) {
  using T = Tile<S>;
  extern __shared__ float4 smem[];
  float4* staged = smem;                                 // [ly][lx]
  float* obuf = reinterpret_cast<float*>(staged + T::lx * T::ly);
  mvs::Cam* cams = reinterpret_cast<mvs::Cam*>(obuf + kSY * kOutFloats);

  const int n = blockIdx.z;
  const int sx0 = blockIdx.x * kSX, sy0 = blockIdx.y * kSY;
  const int tid = threadIdx.y * kSX + threadIdx.x;
  const size_t hw = (size_t)h * w;

  // cameras: slot 0 is frame n, slot 2k-1 frame n - k*step, slot 2k frame
  // n + k*step; slots of frames that do not exist stay unset and unread
  const int n_slots = 2 * nbr_num + 1;
  for (int i = tid; i < n_slots * mvs::kCamFields; i += kThreads) {
    const int slot = i / mvs::kCamFields;
    const int k = (slot + 1) / 2;
    const int m = slot % 2 ? n - k * nbr_step : n + k * nbr_step;
    if (m >= 0 && m < n_frames)
      reinterpret_cast<float*>(cams)[i] =
          mvs::cam_field(K, R, t, m, i % mvs::kCamFields);
  }
  __syncthreads();

  // stage and unproject the pixels the block's samples touch: consecutive
  // threads take consecutive pixels of a row
  const float* frame = disp + (size_t)n * hw;
  for (int e = tid; e < T::count; e += kThreads) {
    int ky, kx, py, px;
    T::pixel(e, sy0, sx0, r, h, w, &ky, &kx, &py, &px);
    const float d = __ldg(frame + (size_t)py * w + px);
    const bool ok = (d >= min_dsp) && (d <= max_dsp);
    float p[3];
    mvs::unproject(cams[0], (float)px, (float)py, 1.0f / (ok ? d : 1.0f), p);
    staged[ky * T::lx + kx] = make_float4(p[0], p[1], p[2], ok ? 1.0f : 0.0f);
  }
  __syncthreads();

  const int i = threadIdx.x, j = threadIdx.y;
  const int sx = sx0 + i, sy = sy0 + j;
  const int row = (j * S + 1) * T::lx, col = i * S + 1;
  const float4 c = staged[row + col];
  const float4 xm = staged[row + col - 1], xp = staged[row + col + 1];
  const float4 ym = staged[row - T::lx + col], yp = staged[row + T::lx + col];

  // normal: cross(dv, du) of the central differences, zero where either
  // neighbour is invalid
  float du[3] = {0.f, 0.f, 0.f}, dv[3] = {0.f, 0.f, 0.f};
  if (xp.w != 0.f && xm.w != 0.f)
    du[0] = xp.x - xm.x, du[1] = xp.y - xm.y, du[2] = xp.z - xm.z;
  if (yp.w != 0.f && ym.w != 0.f)
    dv[0] = yp.x - ym.x, dv[1] = yp.y - ym.y, dv[2] = yp.z - ym.z;
  float nr[3] = {dv[1] * du[2] - dv[2] * du[1], dv[2] * du[0] - dv[0] * du[2],
                 dv[0] * du[1] - dv[1] * du[0]};
  const float len = sqrtf(nr[0] * nr[0] + nr[1] * nr[1] + nr[2] * nr[2]);
  const bool has_n = len > 1e-12f;
  const float lc = fmaxf(len, 1e-12f);
  nr[0] = nr[0] / lc, nr[1] = nr[1] / lc, nr[2] = nr[2] / lc;
  const float* C = centers + 3 * n;
  const float facing = nr[0] * (__ldg(C) - c.x) +
                       nr[1] * (__ldg(C + 1) - c.y) +
                       nr[2] * (__ldg(C + 2) - c.z);
  if (facing < 0.f) nr[0] = -nr[0], nr[1] = -nr[1], nr[2] = -nr[2];

  // confidence: disparity agreement in the existing neighbour frames
  // (samples past the last row or column only fill the tile)
  const float p[3] = {c.x, c.y, c.z};
  float votes = 0.f, exists_total = 0.f;
  const int n_votes = sx < ws && sy < hs ? nbr_num : 0;
  for (int k = 1; k <= n_votes; ++k) {
    for (int sgn = -1; sgn <= 1; sgn += 2) {
      const int m = n + sgn * k * nbr_step;
      if (m < 0 || m >= n_frames) continue;  // no such frame: no vote
      const mvs::Cam& nc = cams[sgn < 0 ? 2 * k - 1 : 2 * k];
      float un, vn, zn, inv_z;
      mvs::project(nc, p, &un, &vn, &zn, &inv_z);
      const float ru = mvs::round_px(un), rv = mvs::round_px(vn);
      const bool inb = (ru >= 0.f) && (ru <= (float)(w - 1)) && (rv >= 0.f) &&
                       (rv <= (float)(h - 1)) && (zn > 0.f);
      const float uc = mvs::clampf(ru, 0.f, (float)(w - 1));
      const float vc = mvs::clampf(rv, 0.f, (float)(h - 1));
      const float dn = __ldg(disp + (size_t)m * hw + (int)vc * w + (int)uc);
      // the plain version's 1 / max(zn, 1e-12): where zn > 1e-12 that is
      // the 1 / zn the projection took
      const float d_proj = zn > 1e-12f ? inv_z : 0.0f;
      const bool agree = inb && (fabsf(dn - d_proj) <= dsp_err) &&
                         (dn >= min_dsp) && (dn <= max_dsp);
      votes += agree ? 1.0f : 0.0f;
      exists_total += 1.0f;
    }
  }
  const float cf =
      exists_total > 0.f ? votes / fmaxf(exists_total, 1.0f) : 1.0f;
  const bool keep = c.w != 0.f && has_n && cf >= conf_min;

  // write: the warp's points and normals as whole lines through shared
  // memory; the row is warp-uniform, samples past ws are dropped
  float* ob = obuf + j * kOutFloats;
  ob[3 * i] = c.x, ob[3 * i + 1] = c.y, ob[3 * i + 2] = c.z;
  ob[3 * kSX + 3 * i] = nr[0], ob[3 * kSX + 3 * i + 1] = nr[1];
  ob[3 * kSX + 3 * i + 2] = nr[2];
  __syncwarp();
  if (sy >= hs) return;
  const int cnt = min(kSX, ws - sx0);
  const size_t base = ((size_t)n * hs + sy) * ws + sx0;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int e = i + kSX * q;
    if (e < 3 * cnt) {
      points[3 * base + e] = ob[e];
      normals[3 * base + e] = ob[3 * kSX + e];
    }
  }
  if (sx < ws) {
    conf[base + i] = cf;
    valid[base + i] = keep ? 1 : 0;
  }
}

}  // namespace

extern "C" int mvs_oriented_points(
    const float* disp, const float* K, const float* R, const float* t,
    const float* centers, float* points, float* normals, float* conf,
    unsigned char* valid, int n_frames, int h, int w, int r, int nbr_num,
    int nbr_step, float min_dsp, float max_dsp, float dsp_err,
    float conf_min, void* stream) {
  if (n_frames == 0 || h == 0 || w == 0) return 0;
  const int hs = (h + r - 1) / r, ws = (w + r - 1) / r;
  const int S = r < 3 ? r : 3;
  const size_t smem = sizeof(float4) * staged_len(kSX, S) * staged_len(kSY, S) +
                      sizeof(float) * kSY * kOutFloats +
                      sizeof(mvs::Cam) * (2 * nbr_num + 1);
  auto kernel = S == 1   ? oriented_points_kernel<1>
                : S == 2 ? oriented_points_kernel<2>
                         : oriented_points_kernel<3>;
  if (smem > 48 * 1024) {  // above the default: opt in (at most 227 KB)
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((ws + kSX - 1) / kSX, (hs + kSY - 1) / kSY, n_frames);
  kernel<<<grid, dim3(kSX, kSY), smem, (cudaStream_t)stream>>>(
      disp, K, R, t, centers, points, normals, conf, valid, n_frames, h, w, r,
      hs, ws, nbr_num, nbr_step, min_dsp, max_dsp, dsp_err, conf_min);
  return (int)cudaGetLastError();
}
