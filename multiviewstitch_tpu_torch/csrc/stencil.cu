// K4: the periodic stencils of the Poisson field (ops/poisson.py) on
// float32 cubes [G,G,G] (z, y, x; x contiguous), wrapping on every axis.
//
// Replaces: no TPU kernel. The JAX package's ops/poisson.py is plain jnp
// (rolls and einsums that XLA fuses on the TPU). The port's plain PyTorch
// version runs one elementwise pass over the field per operation: ~35
// passes a damped-Jacobi sweep at 1024^3, where one field is 4.29 GB.
// Entry points, each the twin of a plain function that stays beside it:
//   sweep, jacobi   one sweep x' = x + ((b - (L - screen) x) * omega) / diag
//                   (_smooth_jacobi), out of place;
//   sweep, matvec   (L - screen) x (_matvec, for _cg);
//   sweep, restrict 4 * restrict2(b - (L - screen) x) straight into the
//                   (G/2)^3 field (_restrict2(_residual(...)).mul_(4) in
//                   _vcycle): the fine residual never exists in memory;
//   prolong         x += e[z/2, y/2, x/2] (_prolong_add);
//   coarsest        every sweep of a grid of at most 16^3 cells in one
//                   launch of one block (_smooth_jacobi there);
//   blur            one 3-tap periodic pass along one axis (_box_blur_).
//
// Bound on the H100: bytes. A sweep reads x and b and writes x' (12 B a
// cell: 12.9 GB, 3.85 ms at 3.35 TB/s at 1024^3); its 13 flops a cell take
// 0.2 ms at 67 TFLOP/s. The restriction reads 8 B a cell and writes 0.5,
// the prolongation and a blur pass read and write 8.
// Design of the sweep: a (32 x 16)-thread block owns a (128 x 16)-cell
// (x, y) tile and marches along z through a chunk of 64 planes. Each
// thread holds 4 consecutive x cells (one 16-byte load, neighbouring
// threads on neighbouring addresses) and their z-1, z, z+1 values in
// registers; the current plane's tile with its one-cell halo sits in
// shared memory (two buffers, one barrier a plane), so x is read once from
// device memory (plus the halo columns and rows, mostly from L2). The
// next plane's loads are issued before the barrier. The restriction mode
// keeps the even plane's residual in registers, averages it with the odd
// plane's, and finishes the y and x pairs through shared memory. The blur
// marches the same way along z or y; along x it reads its row's two
// neighbours through L1. A grid whose side is not a multiple of 4, or a
// pointer not 16-byte aligned, takes the one-cell-a-thread instantiation.
// Offsets are 64-bit (G^3 = 2^30 at 1024^3).
//
// Numerics: built with -fmad=false, in the order of the plain version's
// PyTorch ops, each rounding as they do: the laplacian as x * -6, then
// + x[z-1], + x[z+1], + x[y-1], + x[y+1], + x[x-1], + x[x+1]; add_'s
// alpha as PyTorch's CUDA add computes self + alpha * other, contracted
// into one fused multiply-add (__fmaf_rn); a division by a Python scalar as
// PyTorch's CUDA div_ runs it, a product with the float reciprocal the
// wrapper passes; restriction pairs as (a + b) * 0.5 along z, then y, then
// x, then * 4. The outputs are bit-identical to the plain version's on the
// card.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;        // threads along x in a sweep block
constexpr int kTY = 16;        // rows of a sweep block
constexpr int kPad = 4;        // shared columns left of a tile row
constexpr int kChunk = 64;     // planes a block marches (even)
constexpr int kRowsX = 8;      // rows of a blur or prolongation block
constexpr int kCoarseThreads = 1024;
constexpr int kCoarseCells = 4096;  // 16^3

enum Mode { kJacobi = 0, kMatvec = 1, kRestrict = 2 };

// PyTorch's scalars as its CUDA kernels use them, in float
struct Coef {
  float neg_screen;  // add_(x, alpha=-screen)
  float omega;       // mul_(omega)
  float inv_diag;    // div_(-6 - screen): 1 / float(-6 - screen)
};

// p in [-G, 2G) -> p mod G
__device__ __forceinline__ int wrap(int p, int G) {
  return p < 0 ? p + G : (p >= G ? p - G : p);
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldg(p + j);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

template <int V>
__device__ __forceinline__ void copy(float (&d)[V], const float (&s)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) d[j] = s[j];
}

// (L - screen) x at one cell from its value and six neighbours
__device__ __forceinline__ float screened_laplacian(
    float c, float zm, float zp, float ym, float yp, float xm, float xp,
    const Coef& k) {
  float lap = c * -6.0f;
  lap = lap + zm;
  lap = lap + zp;
  lap = lap + ym;
  lap = lap + yp;
  lap = lap + xm;
  lap = lap + xp;
  return __fmaf_rn(k.neg_screen, c, lap);
}

// One Jacobi sweep, the matvec or the restricted residual (MODE) over a
// (kTX * V) x kTY tile, marching z through [z0, z0 + kChunk).
template <int V, int MODE>
__global__ void __launch_bounds__(kTX * kTY) stencil_sweep(
    const float* __restrict__ x, const float* __restrict__ b,
    float* __restrict__ out, int G, Coef k) {
  constexpr int TXC = kTX * V;          // tile width in cells
  constexpr int SW = TXC + 2 * kPad;    // shared row stride
  constexpr bool kRes = MODE == kRestrict;
  __shared__ __align__(16) float plane[2][kTY + 2][SW];
  __shared__ __align__(16) float zpair[kRes ? kTY : 1][kRes ? TXC : 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tile_x = blockIdx.x * TXC, tile_y = blockIdx.y * kTY;
  const int rows = min(kTY, G - tile_y);   // of the tile inside the grid
  const int cols = min(TXC, G - tile_x);
  const int cx = tx * V;                   // the thread's first column
  const bool live = ty < rows && cx < cols;
  const bool up = live && ty == 0;         // loads the row above the tile
  const bool down = live && ty == rows - 1;  // ... and the row below
  const bool left = live && tx == 0;       // loads the column left of it
  const bool right = live && cx + V == cols;  // ... and right of it
  const int y = tile_y + ty;
  const size_t P = (size_t)G * G;
  const size_t own = (size_t)y * G + tile_x + cx;
  const size_t above = (size_t)wrap(tile_y - 1, G) * G + tile_x + cx;
  const size_t below = (size_t)wrap(y + 1, G) * G + tile_x + cx;
  const size_t lcol = (size_t)y * G + wrap(tile_x - 1, G);
  const size_t rcol = (size_t)y * G + wrap(tile_x + cols, G);
  const int z0 = blockIdx.z * kChunk;
  const int z1 = min(z0 + kChunk, G);

  float zm[V], cc[V], zp[V], hu[V], hd[V], hl = 0.f, hr = 0.f;
  if (live) {
    load<V>(x + (size_t)wrap(z0 - 1, G) * P + own, zm);
    load<V>(x + (size_t)z0 * P + own, cc);
    load<V>(x + (size_t)wrap(z0 + 1, G) * P + own, zp);
  }
  {
    const float* pz = x + (size_t)z0 * P;
    if (up) load<V>(pz + above, hu);
    if (down) load<V>(pz + below, hd);
    if (left) hl = __ldg(pz + lcol);
    if (right) hr = __ldg(pz + rcol);
  }
  float rz[V];  // kRestrict: the even plane's residual
  for (int z = z0; z < z1; ++z) {
    float(*s)[SW] = plane[z & 1];
    if (live) store<V>(&s[ty + 1][kPad + cx], cc);
    if (up) store<V>(&s[0][kPad + cx], hu);
    if (down) store<V>(&s[rows + 1][kPad + cx], hd);
    if (left) s[ty + 1][kPad - 1] = hl;
    if (right) s[ty + 1][kPad + cols] = hr;
    float bv[V], zn[V];
    if (live && MODE != kMatvec) load<V>(b + (size_t)z * P + own, bv);
    if (z + 1 < z1) {  // the next plane's loads, ahead of the barrier
      const float* pn = x + (size_t)(z + 1) * P;
      if (live) load<V>(x + (size_t)wrap(z + 2, G) * P + own, zn);
      if (up) load<V>(pn + above, hu);
      if (down) load<V>(pn + below, hd);
      if (left) hl = __ldg(pn + lcol);
      if (right) hr = __ldg(pn + rcol);
    }
    __syncthreads();
    float o[V];
    if (live) {
      const float* srow = &s[ty + 1][kPad + cx];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xm = j == 0 ? srow[-1] : cc[j - 1];
        const float xp = j == V - 1 ? srow[V] : cc[j + 1];
        const float m = screened_laplacian(cc[j], zm[j], zp[j],
                                           s[ty][kPad + cx + j],
                                           s[ty + 2][kPad + cx + j], xm, xp,
                                           k);
        if constexpr (MODE == kMatvec) {
          o[j] = m;
        } else {
          float r = bv[j] - m;
          if constexpr (MODE == kJacobi) {
            r = r * k.omega;
            r = r * k.inv_diag;
            o[j] = cc[j] + r;
          } else {
            o[j] = r;
          }
        }
      }
    }
    if constexpr (!kRes) {
      if (live) store<V>(out + (size_t)z * P + own, o);
    } else if (((z - z0) & 1) == 0) {
      copy<V>(rz, o);
    } else {  // z pairs, then y pairs and x pairs through shared memory
      if (live) {
#pragma unroll
        for (int j = 0; j < V; ++j) zpair[ty][cx + j] = (rz[j] + o[j]) * 0.5f;
      }
      __syncthreads();
      const int gc = G >> 1, hc = cols >> 1, hr2 = rows >> 1;
      const size_t cplane = (size_t)(z >> 1) * gc * gc;
      for (int q = ty * kTX + tx; q < (kTY / 2) * (TXC / 2);
           q += kTX * kTY) {
        const int qy = q / (TXC / 2), qx = q - qy * (TXC / 2);
        if (qy < hr2 && qx < hc) {
          const float a = (zpair[2 * qy][2 * qx] +
                           zpair[2 * qy + 1][2 * qx]) * 0.5f;
          const float c = (zpair[2 * qy][2 * qx + 1] +
                           zpair[2 * qy + 1][2 * qx + 1]) * 0.5f;
          out[cplane + (size_t)((tile_y >> 1) + qy) * gc + (tile_x >> 1) +
              qx] = ((a + c) * 0.5f) * 4.0f;
        }
      }
    }
    copy<V>(zm, cc);
    copy<V>(cc, zp);
    copy<V>(zp, zn);
  }
}

// Every sweep of a grid of at most kCoarseCells cells in one block: x in
// shared memory, b and the new values in registers, two barriers a sweep.
__global__ void __launch_bounds__(kCoarseThreads) stencil_coarsest(
    float* __restrict__ x, const float* __restrict__ b, int G, int iters,
    Coef k) {
  constexpr int K = kCoarseCells / kCoarseThreads;
  __shared__ float s[kCoarseCells];
  const int n = G * G * G, gg = G * G;
  float bv[K], nv[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int i = threadIdx.x + q * kCoarseThreads;
    if (i < n) {
      s[i] = x[i];
      bv[q] = b[i];
    }
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = threadIdx.x + q * kCoarseThreads;
      if (i < n) {
        const int z = i / gg, yx = i - z * gg, y = yx / G, xx = yx - y * G;
        const int zo = z * gg, yo = y * G;
        const float c = s[i];
        const float m = screened_laplacian(
            c, s[wrap(z - 1, G) * gg + yx], s[wrap(z + 1, G) * gg + yx],
            s[zo + wrap(y - 1, G) * G + xx], s[zo + wrap(y + 1, G) * G + xx],
            s[zo + yo + wrap(xx - 1, G)], s[zo + yo + wrap(xx + 1, G)], k);
        float r = bv[q] - m;
        r = r * k.omega;
        r = r * k.inv_diag;
        nv[q] = c + r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = threadIdx.x + q * kCoarseThreads;
      if (i < n) s[i] = nv[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int i = threadIdx.x + q * kCoarseThreads;
    if (i < n) x[i] = s[i];
  }
}

// x += e[z/2, y/2, x/2] over a (kTX * V) x kRowsX tile of plane z (G even)
template <int V>
__global__ void stencil_prolong(float* __restrict__ x,
                                const float* __restrict__ e, int G) {
  const int xa = (blockIdx.x * kTX + threadIdx.x) * V;
  const int y = blockIdx.y * kRowsX + threadIdx.y;
  const int z = blockIdx.z;
  if (xa >= G || y >= G) return;
  const int gc = G >> 1;
  float* p = x + ((size_t)z * G + y) * G + xa;
  const float* q = e + ((size_t)(z >> 1) * gc + (y >> 1)) * gc + (xa >> 1);
  if constexpr (V == 4) {
    float4 v = *reinterpret_cast<const float4*>(p);
    const float2 c = __ldg(reinterpret_cast<const float2*>(q));
    v.x = v.x + c.x;
    v.y = v.y + c.x;
    v.z = v.z + c.y;
    v.w = v.w + c.y;
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = p[0] + __ldg(q);
  }
}

// out = ((a + a[x-1]) + a[x+1]) * inv3 along x
template <int V>
__global__ void stencil_blur_x(const float* __restrict__ a,
                               float* __restrict__ out, int G, float inv3) {
  const int xa = (blockIdx.x * kTX + threadIdx.x) * V;
  const int y = blockIdx.y * kRowsX + threadIdx.y;
  const int z = blockIdx.z;
  if (xa >= G || y >= G) return;
  const size_t r = ((size_t)z * G + y) * G;
  float v[V], o[V];
  load<V>(a + r + xa, v);
  const float l = __ldg(a + r + wrap(xa - 1, G));
  const float h = __ldg(a + r + wrap(xa + V, G));
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float am = j == 0 ? l : v[j - 1];
    const float ap = j == V - 1 ? h : v[j + 1];
    o[j] = ((v[j] + am) + ap) * inv3;
  }
  store<V>(out + r + xa, o);
}

// out = ((a + a[m-1]) + a[m+1]) * inv3 along the axis of stride ``stride``
// (z: G^2, y: G), marching it through [m0, m0 + kChunk); w indexes the
// other non-x axis, at stride ``wstride``.
template <int V>
__global__ void stencil_blur_march(const float* __restrict__ a,
                                   float* __restrict__ out, int G,
                                   size_t stride, size_t wstride,
                                   float inv3) {
  const int xa = (blockIdx.x * kTX + threadIdx.x) * V;
  const int w = blockIdx.y * kRowsX + threadIdx.y;
  if (xa >= G || w >= G) return;
  const int m0 = blockIdx.z * kChunk, m1 = min(m0 + kChunk, G);
  const float* base = a + (size_t)w * wstride + xa;
  float* obase = out + (size_t)w * wstride + xa;
  float pv[V], cv[V], nv[V], o[V];
  load<V>(base + (size_t)wrap(m0 - 1, G) * stride, pv);
  load<V>(base + (size_t)m0 * stride, cv);
  for (int m = m0; m < m1; ++m) {
    load<V>(base + (size_t)wrap(m + 1, G) * stride, nv);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = ((cv[j] + pv[j]) + nv[j]) * inv3;
    store<V>(obase + (size_t)m * stride, o);
    copy<V>(pv, cv);
    copy<V>(cv, nv);
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int V>
void launch_sweep(const float* x, const float* b, float* out, int G,
                  int mode, Coef k, cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((G + kTX * V - 1) / (kTX * V), (G + kTY - 1) / kTY,
                  (G + kChunk - 1) / kChunk);
  if (mode == kJacobi)
    stencil_sweep<V, kJacobi><<<grid, block, 0, stream>>>(x, b, out, G, k);
  else if (mode == kMatvec)
    stencil_sweep<V, kMatvec><<<grid, block, 0, stream>>>(x, b, out, G, k);
  else
    stencil_sweep<V, kRestrict><<<grid, block, 0, stream>>>(x, b, out, G, k);
}

template <int V>
dim3 row_grid(int G) {
  return dim3((G + kTX * V - 1) / (kTX * V), (G + kRowsX - 1) / kRowsX, G);
}

}  // namespace

// mode 0: out = one Jacobi sweep of x; 1: out = (L - screen) x (b unused,
// may be null); 2: out [G/2]^3 = 4 * restrict2(b - (L - screen) x), G even
extern "C" int mvs_stencil_sweep(const float* x, const float* b, float* out,
                                 int G, int mode, float neg_screen,
                                 float omega, float inv_diag, void* stream) {
  if (G < 1 || G > 65535 || mode < kJacobi || mode > kRestrict ||
      (mode == kRestrict && G % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const Coef k{neg_screen, omega, inv_diag};
  const bool vec = G % 4 == 0 && aligned(x) && aligned(out) &&
                   (b == nullptr || aligned(b));
  if (vec)
    launch_sweep<4>(x, b, out, G, mode, k, (cudaStream_t)stream);
  else
    launch_sweep<1>(x, b, out, G, mode, k, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// iters Jacobi sweeps of x in place, G^3 <= 4096 cells
extern "C" int mvs_stencil_coarsest(float* x, const float* b, int G,
                                    int iters, float neg_screen, float omega,
                                    float inv_diag, void* stream) {
  if (G < 1 || G * G * G > kCoarseCells || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Coef k{neg_screen, omega, inv_diag};
  stencil_coarsest<<<1, kCoarseThreads, 0, (cudaStream_t)stream>>>(
      x, b, G, iters, k);
  return (int)cudaGetLastError();
}

// x [G]^3 += e [G/2]^3 broadcast over 2x2x2 blocks, G even
extern "C" int mvs_stencil_prolong(float* x, const float* e, int G,
                                   void* stream) {
  if (G < 2 || G > 65535 || G % 2 != 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kRowsX);
  if (G % 4 == 0 && aligned(x) && aligned(e))
    stencil_prolong<4><<<row_grid<4>(G), block, 0, (cudaStream_t)stream>>>(
        x, e, G);
  else
    stencil_prolong<1><<<row_grid<1>(G), block, 0, (cudaStream_t)stream>>>(
        x, e, G);
  return (int)cudaGetLastError();
}

// out = one 3-tap periodic box pass of a along axis (0 z, 1 y, 2 x)
extern "C" int mvs_stencil_blur(const float* a, float* out, int G, int axis,
                                float inv3, void* stream) {
  if (G < 1 || G > 65535 || axis < 0 || axis > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kTX, kRowsX);
  const bool vec = G % 4 == 0 && aligned(a) && aligned(out);
  if (axis == 2) {
    if (vec)
      stencil_blur_x<4><<<row_grid<4>(G), block, 0, st>>>(a, out, G, inv3);
    else
      stencil_blur_x<1><<<row_grid<1>(G), block, 0, st>>>(a, out, G, inv3);
    return (int)cudaGetLastError();
  }
  const size_t g = (size_t)G;
  const size_t stride = axis == 0 ? g * g : g;
  const size_t wstride = axis == 0 ? g : g * g;
  const int chunks = (G + kChunk - 1) / kChunk;
  if (vec)
    stencil_blur_march<4>
        <<<dim3((G + kTX * 4 - 1) / (kTX * 4), (G + kRowsX - 1) / kRowsX,
                chunks),
           block, 0, st>>>(a, out, G, stride, wstride, inv3);
  else
    stencil_blur_march<1>
        <<<dim3((G + kTX - 1) / kTX, (G + kRowsX - 1) / kRowsX, chunks),
           block, 0, st>>>(a, out, G, stride, wstride, inv3);
  return (int)cudaGetLastError();
}
