// mvs_io: native data-loading runtime of multiviewstitch_tpu_torch (the
// port's own copy of native/mvs_io.cpp; host IO, not a device kernel).
//
// The reference's runtime is single-threaded C++ file IO threaded through
// the pipeline (LoadDepth/SaveDepth Common/Utils.h:166-186, the .npts
// reader Processor.cpp:952-964, the OBJ reader PlyObj.cpp:29-75). This
// library is a small C ABI (ctypes-friendly) of multi-threaded batch
// loaders that fill host buffers ready for torch.as_tensor, so input IO
// overlaps and never serializes the device.
//
//   - mvs_load_raw_batch: N raw float32 disparity files -> one [N,H,W]
//     contiguous buffer, loaded by a thread pool
//   - mvs_parse_npts: fast text parse of "x y z nx ny nz" lines
//   - mvs_parse_obj_counts / mvs_parse_obj: two-phase OBJ parse
//     (v / vn / f with a//b and a/b/c forms)
//   - mvs_write_raw: write a float32 raster
//
// Built at first use by io/native_loader.py (g++ -O3 -march=native -shared
// -fPIC -pthread) into the git-ignored _build/ directory.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Load `n` raw float32 files of `count` elements each into out[n*count].
// paths: array of n C strings. Returns 0 on success, else 1-based index of
// the first failing file.
int mvs_load_raw_batch(const char** paths, int n, int64_t count,
                       float* out, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  int nt = num_threads > 0 ? num_threads : 4;
  if (nt > n) nt = n > 0 ? n : 1;
  std::vector<std::thread> workers;
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n || err.load() != 0) return;
        FILE* f = fopen(paths[i], "rb");
        if (!f) { err.store(i + 1); return; }
        size_t got = fread(out + (int64_t)i * count, sizeof(float),
                           (size_t)count, f);
        fclose(f);
        if (got != (size_t)count) { err.store(i + 1); return; }
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

int mvs_write_raw(const char* path, const float* data, int64_t count) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  size_t put = fwrite(data, sizeof(float), (size_t)count, f);
  fclose(f);
  return put == (size_t)count ? 0 : 1;
}

// Fast forward-only float parser (handles +-, decimals, exponents).
static inline const char* parse_float(const char* p, const char* end,
                                      float* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  if (p >= end) return nullptr;
  char* q = nullptr;
  float v = strtof(p, &q);
  if (q == p) return nullptr;
  *out = v;
  return q;
}

static char* read_file(const char* path, int64_t* size_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(sz + 1);
  if (!buf) { fclose(f); return nullptr; }
  size_t got = fread(buf, 1, sz, f);
  fclose(f);
  if (got != (size_t)sz) { free(buf); return nullptr; }
  buf[sz] = 0;
  *size_out = sz;
  return buf;
}

// Parse an .npts file (6 floats per line). Returns number of points, or -1
// on error. Writes at most max_points*6 floats into out (pts interleaved
// with normals, reference layout Processor.cpp:952-964).
int64_t mvs_parse_npts(const char* path, float* out, int64_t max_points) {
  int64_t sz = 0;
  char* buf = read_file(path, &sz);
  if (!buf) return -1;
  const char* p = buf;
  const char* end = buf + sz;
  int64_t n = 0;
  while (n < max_points) {
    float vals[6];
    const char* q = p;
    bool ok = true;
    for (int k = 0; k < 6; ++k) {
      q = parse_float(q, end, &vals[k]);
      if (!q) { ok = false; break; }
    }
    if (!ok) break;
    memcpy(out + n * 6, vals, sizeof(vals));
    n++;
    p = q;
  }
  free(buf);
  return n;
}

// Phase 1: count v / vn / f records so the caller can size buffers.
int mvs_parse_obj_counts(const char* path, int64_t* nv, int64_t* nn,
                         int64_t* nf) {
  int64_t sz = 0;
  char* buf = read_file(path, &sz);
  if (!buf) return 1;
  int64_t v = 0, n = 0, f = 0;
  const char* p = buf;
  const char* end = buf + sz;
  while (p < end) {
    if (p[0] == 'v' && p[1] == ' ') v++;
    else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') n++;
    else if (p[0] == 'f' && p[1] == ' ') f++;
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  free(buf);
  *nv = v; *nn = n; *nf = f;
  return 0;
}

// Phase 2: fill verts[nv*3], normals[nn*3], faces[nf*3] (0-based; first
// index of each face token, the reference's a//b form, PlyObj.cpp:29-75).
int mvs_parse_obj(const char* path, float* verts, float* normals,
                  int32_t* faces, int64_t nv_cap, int64_t nn_cap,
                  int64_t nf_cap) {
  int64_t sz = 0;
  char* buf = read_file(path, &sz);
  if (!buf) return 1;
  int64_t v = 0, n = 0, f = 0;
  char* p = buf;
  char* end = buf + sz;
  while (p < end) {
    if (p[0] == 'v' && p[1] == ' ' && v < nv_cap) {
      char* q = p + 2;
      for (int k = 0; k < 3; ++k) verts[v * 3 + k] = strtof(q, &q);
      v++;
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ' && n < nn_cap) {
      char* q = p + 3;
      for (int k = 0; k < 3; ++k) normals[n * 3 + k] = strtof(q, &q);
      n++;
    } else if (p[0] == 'f' && p[1] == ' ' && f < nf_cap) {
      char* q = p + 2;
      for (int k = 0; k < 3; ++k) {
        long idx = strtol(q, &q, 10);
        faces[f * 3 + k] = (int32_t)(idx > 0 ? idx - 1 : v + idx);
        // skip /t or //n attachments
        while (q < end && *q != ' ' && *q != '\n' && *q != '\r') ++q;
      }
      f++;
    }
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  free(buf);
  return 0;
}

}  // extern "C"
