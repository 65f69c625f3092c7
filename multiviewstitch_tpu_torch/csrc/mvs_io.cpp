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
//   - mvs_write_obj / mvs_write_npts: the OBJ and NPTS text of
//     io/meshio.py's writers, byte for byte. The rows are cut into chunks
//     of kChunkRows; min(8, cores, chunks) threads format the chunks into
//     buffers of their own, which are then written in order. A float of a
//     v / vn / colour field is Python's repr of the value widened to
//     double (what f"{x}" prints for a numpy float32 or float64): the
//     shortest digits that round-trip, positional for 1e-4 <= |x| < 1e16
//     with ".0" where no '.' is printed, else d[.ddd]e+-XX; nan, inf,
//     -inf as Python prints them. An integer (a face index + 1 in its
//     own type, an integer colour) is plain decimal. An NPTS value is
//     "%.8g" of the float32 value widened to double (np.savetxt's text).
//     They need floating-point std::to_chars (libstdc++ of GCC >= 11);
//     without it they return ENOSYS and mvs_writers_available() is 0, so
//     io/native_loader.py writes with Python and the rest still builds.
//
// Built at first use by io/native_loader.py (g++ -O3 -march=native -shared
// -fPIC -pthread) into the git-ignored _build/ directory.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <system_error>
#include <thread>
#include <vector>
#if __has_include(<charconv>)
#include <charconv>
#endif

#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
#define MVS_WRITERS 1
#else
#define MVS_WRITERS 0
#endif

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

#if MVS_WRITERS
namespace {

constexpr int64_t kChunkRows = 1 << 15;  // rows a thread formats at a time
constexpr int kMaxThreads = 8;           // as mvs_load_raw_batch's callers
constexpr int kNum = 32;                 // room for one formatted number

// dtype codes of the arrays handed to mvs_write_obj
enum Code { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3 };

inline char* put_str(char* p, const char* s, size_t n) {
  memcpy(p, s, n);
  return p + n;
}

// Python's repr(float(x)): shortest round-trip digits, positional for
// 1e-4 <= |x| < 1e16 (with ".0" where no '.' is printed), else scientific.
inline char* put_repr(char* p, double x) {
  if (std::isnan(x)) return put_str(p, "nan", 3);
  if (std::isinf(x)) return x < 0 ? put_str(p, "-inf", 4)
                                  : put_str(p, "inf", 3);
  double a = std::fabs(x);
  if (a != 0.0 && (a < 1e-4 || a >= 1e16))
    return std::to_chars(p, p + kNum, x, std::chars_format::scientific).ptr;
  char* e = std::to_chars(p, p + kNum, x, std::chars_format::fixed).ptr;
  if (!std::memchr(p, '.', e - p)) e = put_str(e, ".0", 2);
  return e;
}

// "%.8g" as Python's % formatting prints it (nan without a sign).
inline char* put_g8(char* p, double x) {
  if (std::isnan(x)) return put_str(p, "nan", 3);
  if (std::isinf(x)) return x < 0 ? put_str(p, "-inf", 4)
                                  : put_str(p, "inf", 3);
  return std::to_chars(p, p + kNum, x, std::chars_format::general, 8).ptr;
}

inline char* put_int(char* p, int64_t v) {
  return std::to_chars(p, p + kNum, v).ptr;
}

// Element i of an array of dtype `code`: a float field, or an integer one
// (printed in decimal).
inline char* put_field(char* p, const void* a, int code, int64_t i) {
  switch (code) {
    case kF32: return put_repr(p, (double)static_cast<const float*>(a)[i]);
    case kF64: return put_repr(p, static_cast<const double*>(a)[i]);
    case kI32: return put_int(p, static_cast<const int32_t*>(a)[i]);
    default: return put_int(p, static_cast<const int64_t*>(a)[i]);
  }
}

// A face index + 1, wrapping in its own type as numpy's `faces + 1` does.
inline int64_t index_plus_one(const void* f, int code, int64_t i) {
  if (code == kI32)
    return (int32_t)((uint32_t) static_cast<const int32_t*>(f)[i] + 1u);
  return (int64_t)((uint64_t) static_cast<const int64_t*>(f)[i] + 1u);
}

inline char* put_row3(char* p, const void* a, int code, int64_t row) {
  for (int k = 0; k < 3; ++k) {
    if (k) *p++ = ' ';
    p = put_field(p, a, code, row * 3 + k);
  }
  return p;
}

struct Chunk { int part; int64_t begin, end; };

void add_chunks(std::vector<Chunk>& chunks, int part, int64_t rows) {
  for (int64_t b = 0; b < rows; b += kChunkRows)
    chunks.push_back({part, b, std::min(rows, b + kChunkRows)});
}

int os_error() { return errno ? errno : EIO; }

// Formats `chunks` on min(8, cores, chunks) threads, each chunk into its
// own buffer (`format(chunk, out)` returns the end of what it wrote, at
// most row_max bytes a row), then writes the buffers to `path` in order.
// Returns 0 or an errno value.
template <class Format>
int write_chunks(const char* path, const std::vector<Chunk>& chunks,
                 size_t row_max, const Format& format) {
  FILE* f = fopen(path, "wb");
  if (!f) return os_error();
  std::vector<std::string> out(chunks.size());
  std::atomic<size_t> next(0);
  std::atomic<bool> no_memory(false);
  auto work = [&]() {
    try {
      std::unique_ptr<char[]> buf(new char[kChunkRows * row_max]);
      for (size_t i; (i = next.fetch_add(1)) < chunks.size();)
        out[i].assign(buf.get(), format(chunks[i], buf.get()) - buf.get());
    } catch (const std::bad_alloc&) {
      no_memory = true;
    }
  };
  int nt = std::min<int64_t>({kMaxThreads,
                              std::max(1u, std::thread::hardware_concurrency()),
                              (int64_t)chunks.size()});
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < nt; ++t) pool.emplace_back(work);
  } catch (const std::system_error&) {
    // fewer threads: the calling thread and those started share the rows
  }
  work();
  for (auto& t : pool) t.join();
  int err = no_memory ? ENOMEM : 0;
  for (const auto& s : out) {
    if (err) break;
    if (fwrite(s.data(), 1, s.size(), f) != s.size()) err = os_error();
  }
  if (fclose(f) != 0 && !err) err = os_error();
  return err;
}

}  // namespace
#endif

extern "C" {

int mvs_writers_available() { return MVS_WRITERS; }

// The OBJ of io/meshio.write_obj. verts [n_verts,3]; normals [n_verts,3]
// or NULL (then `vn` and `v` lines interleave and faces read a//a);
// colors [n_verts,3] or NULL (r g b on each `v` line; ignored with
// normals); faces [n_faces,3] 0-based or NULL. Each array is C-contiguous
// of its dtype code (verts, normals: float32 0 / float64 1; colors: any
// code; faces: int32 2 / int64 3). Returns 0 or an errno value.
int mvs_write_obj(const char* path, const void* verts, const void* normals,
                  const void* colors, const void* faces, int64_t n_verts,
                  int64_t n_faces, int verts_code, int normals_code,
                  int colors_code, int faces_code) {
#if MVS_WRITERS
  std::vector<Chunk> chunks;
  add_chunks(chunks, 0, n_verts);
  if (faces) add_chunks(chunks, 1, n_faces);
  if (normals) colors = nullptr;
  auto format = [&](const Chunk& c, char* p) {
    if (c.part == 0) {
      for (int64_t i = c.begin; i < c.end; ++i) {
        if (normals) {
          p = put_row3(put_str(p, "vn ", 3), normals, normals_code, i);
          *p++ = '\n';
        }
        p = put_row3(put_str(p, "v ", 2), verts, verts_code, i);
        if (colors) p = put_row3(put_str(p, " ", 1), colors, colors_code, i);
        *p++ = '\n';
      }
    } else {
      for (int64_t i = c.begin; i < c.end; ++i) {
        p = put_str(p, "f", 1);
        for (int k = 0; k < 3; ++k) {
          int64_t a = index_plus_one(faces, faces_code, i * 3 + k);
          p = put_int(put_str(p, " ", 1), a);
          if (normals) p = put_int(put_str(p, "//", 2), a);
        }
        *p++ = '\n';
      }
    }
    return p;
  };
  // two lines of 3 (or one of 6) numbers; a face: 3 x (2 integers + "//")
  return write_chunks(path, chunks, 8 * (kNum + 1), format);
#else
  return ENOSYS;
#endif
}

// The NPTS of io/meshio.write_npts: n rows "x y z nx ny nz", each value
// "%.8g" of the float32 widened to double. Returns 0 or an errno value.
int mvs_write_npts(const char* path, const float* points,
                   const float* normals, int64_t n) {
#if MVS_WRITERS
  std::vector<Chunk> chunks;
  add_chunks(chunks, 0, n);
  auto format = [&](const Chunk& c, char* p) {
    for (int64_t i = c.begin; i < c.end; ++i) {
      for (int k = 0; k < 6; ++k) {
        const float* a = k < 3 ? points : normals;
        p = put_g8(p, (double)a[i * 3 + k % 3]);
        *p++ = k < 5 ? ' ' : '\n';
      }
    }
    return p;
  };
  return write_chunks(path, chunks, 6 * (kNum + 1), format);
#else
  return ENOSYS;
#endif
}

}  // extern "C"
