// K3: z-max (largest 1/z wins) triangle rasterizer, binned into 16x16
// screen tiles, each tile's z-buffer held in shared memory.
//
// Replaces: multiviewstitch_tpu/ops/pallas_raster.py:raster_faces and
// :raster_strips, and with them the XLA tile passes, the compacted
// scatter-max ladder and the full-frame pass of
// multiviewstitch_tpu/ops/rasterizer.py:render_disparity. The TPU kernels
// keep the z-buffer in VMEM and only take faces whose bbox is under a size
// class; everything else fell to the XLA ladder, whose capacities made
// giant close-up faces a special case ("overflow"). Here every face of any
// size renders exactly, and overflow does not exist.
//
// What bounded the previous design (one warp per (frame, face) walking the
// face's clipped bbox with a global atomicMax per pixel): parallelism on
// giant faces -- two full-frame faces were two warps on two of 132 SMs,
// 9,600 serial iterations each -- and idle lanes on tiny ones, where a
// 1-3 px face kept at most 9 of its warp's 32 lanes busy.
//
// This design: two memsets, four kernels and one host read per call.
//   1. setup, one thread per (frame, face): range-check the vertex ids into
//      an error word, compute the area and the image-clipped bbox, write a
//      48-byte face record, and count the face once in each 16x16 tile its
//      bbox touches. A block expands its faces' (face, tile) pairs over all
//      of its threads (a full-frame face costs its block 1,200 / 256 steps,
//      not 1,200 serial ones), and the lanes of a warp that hit one tile
//      share one atomic.
//   2. scan, one block: exclusive prefix sum of the per-(frame, tile)
//      counts -> bin offsets, and the work list: one item per 256 records
//      of each non-empty bin.
//   3. scatter: the same pair expansion writes each face id into its
//      tiles' bins (counting sort; the order inside a bin is not
//      deterministic, and max is order-free, so the image is).
//   4. fine, persistent 256-thread blocks taking items from a work
//      counter: an item's records are copied into shared memory (16-byte
//      cp.async), every (record, pixel) pair of the records' bboxes inside
//      the tile is listed by a prefix sum and spread evenly over the
//      threads, and each evaluation z-maxes into the tile's shared
//      z-buffer. The tile is stored once if its bin is one item, else
//      merged by atomicMax into the zeroed output.
// The bins are allocated before anything runs, for 2 pairs a face and 2
// faces a tile; kernels 3-4 write nothing if the pair total does not fit,
// and the caller, which reads the total and the error word once after the
// last kernel, then runs the call again with room for every pair.
// What bounds it: the fine pass's per-pixel evaluations (every bbox pixel
// of every face, ~130 instructions each with the bookkeeping) on the
// sphere meshes; the latency of the chain of small kernels on meshes with
// few pairs; and the bin volume (one entry per (face, touched tile): a
// full-frame face writes 1,200 at VGA).
//
// Tiles are 16x16 rather than 32x8: a square tile is touched by fewer
// small-face bboxes (fewer pairs and fewer wasted per-pixel tests), and the
// store is still whole 32-byte sectors (two 64-byte rows per warp).
//
// Numerics: the area, bbox, edge functions, winding test and disparity
// interpolation use the operand order of rasterizer.raster_reference, only
// the pixels of each face's clipped bbox are evaluated (as the plain
// version only visits those), and the build uses -fmad=false, so the image
// is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 16;                  // tile edge, pixels
constexpr int kTilePx = kTile * kTile;
constexpr int kBinThreads = 256;           // faces per setup/scatter block
constexpr int kScanThreads = 1024;
constexpr int kScanBins = 8;               // consecutive bins a scan thread
constexpr int kFineThreads = 256;
constexpr int kChunk = kFineThreads;       // face records per work item
constexpr int kRec = 12;                   // floats per face record
static_assert(kTilePx == kFineThreads, "one tile pixel per fine thread");

// meta, u64, followed directly by the per-bin counts: the (face, tile)
// pair total, the error word, the number of work items, the fine pass's
// work counter
enum Meta { kTotal, kError, kItems, kNext, kMeta = 8 };

// Face record [kRec] f32, 48 bytes (three 16-byte pieces):
//   0..8  u0 v0 z0 u1 v1 z1 u2 v2 z2 (z is 1/z, as in uvz)
//   9     signed area
//   10    bits: ix0 | ix1 << 16, the clipped bbox's columns
//   11    bits: iy0 | iy1 << 16, its rows
// A culled face has ix0 > ix1.
constexpr unsigned kCulled = 1u;

struct TileSpan {
  int tx0, ty0, ntx, count;
};

__device__ __forceinline__ TileSpan tile_span(unsigned bx, unsigned by) {
  TileSpan s{0, 0, 1, 0};
  int ix0 = bx & 0xffff, ix1 = bx >> 16;
  int iy0 = by & 0xffff, iy1 = by >> 16;
  if (ix0 > ix1) return s;
  s.tx0 = ix0 / kTile;
  s.ty0 = iy0 / kTile;
  s.ntx = ix1 / kTile - s.tx0 + 1;
  s.count = s.ntx * (iy1 / kTile - s.ty0 + 1);
  return s;
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. s_warp holds 32 ints.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    s_warp[lane] = s;
  }
  __syncthreads();
  int excl = x - v + (warp ? s_warp[warp - 1] : 0);
  *total = s_warp[nw - 1];
  return excl;
}

// Setup (kScatter false) and scatter (kScatter true), one thread per
// (frame n = blockIdx.y, face f). Each block lists its faces' (face, tile)
// pairs, prefix-summed in s_off; warp w takes pairs 32 w + lane, + 256,
// ..., each pair's face found by binary search.
template <bool kScatter>
__global__ void __launch_bounds__(kBinThreads)
    bin_kernel(const float* __restrict__ uvz, const int* __restrict__ faces,
               const uint8_t* __restrict__ face_ok, float* __restrict__ rec,
               int* __restrict__ counts, const int* __restrict__ start,
               int* __restrict__ bins, int capacity,
               unsigned long long* __restrict__ meta, int n_verts,
               int n_faces, int h, int w, int tiles_x, int n_tiles) {
  __shared__ int s_off[kBinThreads + 1];
  __shared__ TileSpan s_span[kBinThreads];
  __shared__ int s_warp[32];
  // The scatter runs only if the bins hold every pair (the total is final
  // once the setup kernel has ended).
  if (kScatter && meta[kTotal] > (unsigned long long)capacity) return;
  int f = blockIdx.x * kBinThreads + threadIdx.x;
  int n = blockIdx.y;
  unsigned bx = kCulled, by = 0;
  if (f < n_faces) {
    float4* r = reinterpret_cast<float4*>(
        rec + ((size_t)n * n_faces + f) * kRec);
    if (kScatter) {
      float4 q = r[2];
      bx = __float_as_uint(q.z);
      by = __float_as_uint(q.w);
    } else {
      int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
      bool bad = i0 < 0 || i0 >= n_verts || i1 < 0 || i1 >= n_verts ||
                 i2 < 0 || i2 >= n_verts;
      if (bad) atomicOr(&meta[kError], 1ull);
      float area = 0.f, z2 = 0.f;
      if (!bad && face_ok[(size_t)n * n_faces + f]) {
        const float* V = uvz + (size_t)n * n_verts * 3;
        float u0 = V[3 * i0], v0 = V[3 * i0 + 1], z0 = V[3 * i0 + 2];
        float u1 = V[3 * i1], v1 = V[3 * i1 + 1], z1 = V[3 * i1 + 2];
        float u2 = V[3 * i2], v2 = V[3 * i2 + 1];
        z2 = V[3 * i2 + 2];
        area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0);
        float x0 = fmaxf(floorf(fminf(u0, fminf(u1, u2))), 0.f);
        float x1 = fminf(ceilf(fmaxf(u0, fmaxf(u1, u2))), (float)(w - 1));
        float y0 = fmaxf(floorf(fminf(v0, fminf(v1, v2))), 0.f);
        float y1 = fminf(ceilf(fmaxf(v0, fmaxf(v1, v2))), (float)(h - 1));
        // |area| > 1e-12 (false for NaN) and an on-screen clipped bbox
        if (fabsf(area) > 1e-12f && x0 <= x1 && y0 <= y1) {
          bx = (unsigned)x0 | ((unsigned)x1 << 16);
          by = (unsigned)y0 | ((unsigned)y1 << 16);
          r[0] = make_float4(u0, v0, z0, u1);
          r[1] = make_float4(v1, z1, u2, v2);
        }
      }
      r[2] = make_float4(z2, area, __uint_as_float(bx), __uint_as_float(by));
    }
  }
  TileSpan span = tile_span(bx, by);
  int total;
  int off = block_exclusive_scan(span.count, s_warp, &total);
  s_off[threadIdx.x] = off;
  s_span[threadIdx.x] = span;
  if (threadIdx.x == 0) s_off[kBinThreads] = total;
  __syncthreads();
  if (!kScatter && threadIdx.x == 0 && total > 0)
    atomicAdd(&meta[kTotal], (unsigned long long)total);

  int* cnt = counts + (size_t)n * n_tiles;
  const int* st = kScatter ? start + (size_t)n * n_tiles : nullptr;
  int lane = threadIdx.x & 31;
  // whole warps iterate, so the lanes of one tile can share one atomic
  for (int p0 = threadIdx.x - lane; p0 < total; p0 += kBinThreads) {
    int p = p0 + lane;
    bool valid = p < total;
    unsigned act = __ballot_sync(0xffffffffu, valid);
    if (!valid) continue;
    int lo = 0, hi = kBinThreads - 1;  // first j with s_off[j + 1] > p
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (s_off[mid + 1] <= p) lo = mid + 1;
      else hi = mid;
    }
    TileSpan s = s_span[lo];
    int k = p - s_off[lo];
    int tile = (s.ty0 + k / s.ntx) * tiles_x + s.tx0 + k % s.ntx;
    unsigned peers = __match_any_sync(act, tile);
    int leader = __ffs(peers) - 1;
    if (kScatter) {
      int base = 0;
      if (lane == leader) base = atomicAdd(&cnt[tile], __popc(peers));
      base = __shfl_sync(peers, base, leader);
      int rank = __popc(peers & ((1u << lane) - 1));
      bins[st[tile] + base + rank] = blockIdx.x * kBinThreads + lo;
    } else if (lane == leader) {
      atomicAdd(&cnt[tile], __popc(peers));
    }
  }
}

// One block: start[i] = sum of counts[0..i), then counts[i] = 0 (the
// scatter counts again from zero, so counts end as they began), and the
// work items (bin, chunk), one per kChunk records of each non-empty bin,
// at most item_cap of them; their number into meta. Rounds of kScanThreads
// * kScanBins bins, staged through shared memory so that the loads and
// stores are coalesced and each thread scans kScanBins consecutive bins.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ counts, int* __restrict__ start,
                int2* __restrict__ items, int item_cap,
                unsigned long long* __restrict__ meta, int n_bins) {
  __shared__ int s_c[kScanBins * kScanThreads];
  __shared__ int s_warp[32];
  int tid = threadIdx.x;
  int carry = 0, carry_items = 0;
  for (int base = 0; base < n_bins; base += kScanBins * kScanThreads) {
    for (int k = tid; k < kScanBins * kScanThreads; k += kScanThreads) {
      s_c[k] = base + k < n_bins ? counts[base + k] : 0;
      if (base + k < n_bins) counts[base + k] = 0;
    }
    __syncthreads();
    int c[kScanBins], sum = 0, n_items = 0;
    for (int k = 0; k < kScanBins; ++k) {
      c[k] = s_c[kScanBins * tid + k];
      sum += c[k];
      n_items += (c[k] + kChunk - 1) / kChunk;
    }
    int total, total_items;
    int run = carry + block_exclusive_scan(sum, s_warp, &total);
    __syncthreads();
    int at = carry_items + block_exclusive_scan(n_items, s_warp,
                                                &total_items);
    int i0 = base + kScanBins * tid;
    for (int k = 0; k < kScanBins; ++k) {
      s_c[kScanBins * tid + k] = run;
      run += c[k];
      for (int chunk = 0; chunk * kChunk < c[k]; ++chunk, ++at)
        if (at < item_cap) items[at] = make_int2(i0 + k, chunk);
    }
    __syncthreads();
    for (int k = tid; k < kScanBins * kScanThreads && base + k < n_bins;
         k += kScanThreads)
      start[base + k] = s_c[k];
    carry += total;
    carry_items += total_items;
    __syncthreads();  // s_c and s_warp are reused by the next round
  }
  if (tid == 0) meta[kItems] = (unsigned long long)carry_items;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Face {
  float u0, v0, z0, u1, v1, z1, u2, v2, z2, area;
};

__device__ __forceinline__ Face load_face(const float* r) {
  float4 q0 = *reinterpret_cast<const float4*>(r);
  float4 q1 = *reinterpret_cast<const float4*>(r + 4);
  float2 q2 = *reinterpret_cast<const float2*>(r + 8);
  return Face{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y};
}

// Disparity of face a at pixel (fx, fy) if the pixel is inside the face
// and the disparity is > 0, else 0 (raster_reference's expressions).
__device__ __forceinline__ float eval_pixel(const Face& a, float fx,
                                            float fy) {
  float e0 = (a.u1 - a.u0) * (fy - a.v0) - (a.v1 - a.v0) * (fx - a.u0);
  float e1 = (a.u2 - a.u1) * (fy - a.v1) - (a.v2 - a.v1) * (fx - a.u1);
  float e2 = (a.u0 - a.u2) * (fy - a.v2) - (a.v0 - a.v2) * (fx - a.u2);
  bool inside = a.area >= 0.f ? (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f)
                              : (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f);
  if (!inside) return 0.f;
  float w0 = e1 / a.area;
  float w1 = e2 / a.area;
  float w2 = e0 / a.area;
  float disp = w0 * a.z0 + w1 * a.z1 + w2 * a.z2;
  return disp > 0.f ? disp : 0.f;
}

// Copy record `id` of R into a shared slot: three 16-byte cp.async copies.
__device__ __forceinline__ void stage_record(float* slot, const float* R,
                                             int id) {
  const float* src = R + (size_t)id * kRec;
  for (int part = 0; part < 3; ++part)
    cp_async16(slot + 4 * part, src + 4 * part);
}

// Persistent blocks; each takes work items from the counter in meta (the
// next one is fetched while the current one runs). An item is up to kChunk
// records of one bin, thread j copying record j into shared memory. The
// block lists every (record, pixel) pair of the records' bboxes inside the
// tile (a prefix sum of their pixel counts) and gives each warp an equal
// run of pairs: a 1-px face costs one evaluation, a giant face 256, and no
// lane idles on a short face while another walks a long one. Each
// evaluation z-maxes into the tile's shared z-buffer s_z (atomicMax on the
// bits of disp > 0: int order is float order there).
__global__ void __launch_bounds__(kFineThreads)
    fine_kernel(const float* __restrict__ rec, const int* __restrict__ counts,
                const int* __restrict__ start, const int2* __restrict__ items,
                const int* __restrict__ bins, int capacity,
                unsigned long long* __restrict__ meta,
                float* __restrict__ zbuf, int n_faces, int h, int w,
                int tiles_x, int n_tiles) {
  constexpr int kWarps = kFineThreads / 32;
  __shared__ __align__(16) float s_rec[kChunk * kRec];
  __shared__ int s_z[kTilePx];
  __shared__ int s_rect[kChunk];     // x0 | y0 << 8 | bw << 16 in the tile
  __shared__ int s_magic[kChunk];    // ceil(2^16 / bw): k / bw by a multiply
  __shared__ int s_off[kChunk + 1];  // pixel-pair prefix
  __shared__ int s_warp[32];
  __shared__ int s_item;
  if (meta[kTotal] > (unsigned long long)capacity) return;  // bins unfilled
  int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  int n_items = (int)meta[kItems];
  if (tid == 0) s_item = (int)atomicAdd(&meta[kNext], 1ull);
  __syncthreads();
  int item = s_item;
  while (item < n_items) {
    __syncthreads();  // every thread has read s_item
    int next = 0;
    if (tid == 0) next = (int)atomicAdd(&meta[kNext], 1ull);
    int2 it = items[item];
    int b = it.x, c0 = it.y * kChunk;
    int n = b / n_tiles, t = b - n * n_tiles;
    int tx0 = (t % tiles_x) * kTile, ty0 = (t / tiles_x) * kTile;
    int cnt = counts[b];
    int m = min(cnt - c0, kChunk);
    if (tid < m)
      stage_record(s_rec + tid * kRec, rec + (size_t)n * n_faces * kRec,
                   bins[start[b] + c0 + tid]);
    cp_async_commit();
    s_z[tid] = 0;
    cp_async_wait<0>();
    __syncthreads();
    int n_px = 0;
    if (tid < m) {
      const float* r = s_rec + tid * kRec;
      unsigned bx = __float_as_uint(r[10]), by = __float_as_uint(r[11]);
      int x0 = max((int)(bx & 0xffff), tx0);
      int x1 = min((int)(bx >> 16), tx0 + kTile - 1);
      int y0 = max((int)(by & 0xffff), ty0);
      int y1 = min((int)(by >> 16), ty0 + kTile - 1);
      int bw = x1 - x0 + 1;
      n_px = bw * (y1 - y0 + 1);
      s_rect[tid] = (x0 - tx0) | (y0 - ty0) << 8 | bw << 16;
      s_magic[tid] = (65536 + bw - 1) / bw;
    }
    int n_pairs;
    int off = block_exclusive_scan(n_px, s_warp, &n_pairs);
    s_off[tid] = off;
    if (tid == 0) s_off[kChunk] = n_pairs;
    __syncthreads();
    int seg = (n_pairs + kWarps - 1) / kWarps;
    int p0 = warp * seg, p1 = min(p0 + seg, n_pairs);
    if (p0 < p1) {
      int j = 0, hi = m - 1;  // the record j with s_off[j] <= p0 < s_off[j+1]
      while (j < hi) {
        int mid = (j + hi) >> 1;
        if (s_off[mid + 1] <= p0) j = mid + 1;
        else hi = mid;
      }
      for (int base = p0; base < p1; base += 32) {
        int p = base + lane;
        int jj = j;
        if (p < p1) {
          while (s_off[jj + 1] <= p) ++jj;  // a few records on
          int k = p - s_off[jj];
          int rect = s_rect[jj];
          int bw = rect >> 16;
          int dy = (k * s_magic[jj]) >> 16;  // k / bw, exact for k < 256
          int lx = (rect & 0xff) + k - dy * bw, ly = ((rect >> 8) & 0xff) + dy;
          float d = eval_pixel(load_face(s_rec + jj * kRec), (float)(tx0 + lx),
                               (float)(ty0 + ly));
          if (d > 0.f) atomicMax(&s_z[ly * kTile + lx], __float_as_int(d));
        }
        j = __shfl_sync(0xffffffffu, jj, 31);
      }
    }
    __syncthreads();
    int px = tx0 + (tid & (kTile - 1)), py = ty0 + tid / kTile;
    if (px < w && py < h) {
      float* out = zbuf + ((size_t)n * h + py) * w + px;
      if (cnt <= kChunk) *out = __int_as_float(s_z[tid]);  // the only item
      else if (s_z[tid] != 0) atomicMax(reinterpret_cast<int*>(out), s_z[tid]);
    }
    if (tid == 0) s_item = next;
    __syncthreads();
    item = s_item;
  }
}

// Blocks of fine_kernel resident on the current device (one wave), cached
// per device id.
int fine_blocks() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = dev < kMaxDevices ? cached[dev].load() : 0;
  if (blocks == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fine_kernel,
                                                  kFineThreads, 0);
    blocks = sms * max(per_sm, 1);
    if (dev < kMaxDevices) cached[dev].store(blocks);
  }
  return blocks;
}

}  // namespace

// One call: zero meta [kMeta] u64 and the counts [n_bins] that follow it
// (n_bins = n_frames * 16x16 tiles) and zbuf [n_frames, h, w], then the
// four kernels. rec [n_frames, n_faces, 12] f32, start [n_bins] and items
// [item_cap] int2 are scratch (item_cap >= n_bins + capacity / 256 holds
// every item when the pairs fit). meta[kTotal] gets the (face, tile) pair
// total and meta[kError] the error word (1: a vertex id out of range).
// The bins [capacity] and zbuf are filled only if the total fits the
// capacity; otherwise the caller, having read the total, calls again with
// that capacity.
extern "C" int mvs_raster(const float* uvz, const int* faces,
                          const uint8_t* face_ok, float* rec,
                          unsigned long long* meta, int* start, int2* items,
                          int item_cap, int* bins, int capacity, float* zbuf,
                          int n_frames, int n_verts, int n_faces, int h,
                          int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int tiles_x = (w + kTile - 1) / kTile;
  int n_tiles = tiles_x * ((h + kTile - 1) / kTile);
  int n_bins = n_frames * n_tiles;
  int* counts = reinterpret_cast<int*>(meta + kMeta);
  cudaMemsetAsync(meta, 0, kMeta * sizeof(*meta) + n_bins * sizeof(int), st);
  cudaMemsetAsync(zbuf, 0, (size_t)n_frames * h * w * sizeof(float), st);
  dim3 grid((n_faces + kBinThreads - 1) / kBinThreads, n_frames);
  if (n_faces > 0)
    bin_kernel<false><<<grid, kBinThreads, 0, st>>>(
        uvz, faces, face_ok, rec, counts, nullptr, nullptr, 0, meta, n_verts,
        n_faces, h, w, tiles_x, n_tiles);
  scan_kernel<<<1, kScanThreads, 0, st>>>(counts, start, items, item_cap,
                                          meta, n_bins);
  if (n_faces > 0)
    bin_kernel<true><<<grid, kBinThreads, 0, st>>>(
        nullptr, nullptr, nullptr, rec, counts, start, bins, capacity, meta,
        0, n_faces, h, w, tiles_x, n_tiles);
  fine_kernel<<<fine_blocks(), kFineThreads, 0, st>>>(
      rec, counts, start, items, bins, capacity, meta, zbuf, n_faces, h, w,
      tiles_x, n_tiles);
  return (int)cudaGetLastError();
}
