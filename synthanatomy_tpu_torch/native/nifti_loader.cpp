// Native NIfTI volume loader — the C++ data-path component.
//
// The reference's data loading rides nibabel + DataLoader worker
// processes (reference src/utils/vqvae.py:206-210, 391-467); the hot
// host-side cost for 160×224×160 volumes is gzip inflation, dtype
// conversion, axis reordering (F-order file → C-order canonical-RAS
// array) and intensity normalization.  This library fuses those into
// two passes per volume:
//
//   whole-file read → gzip inflate (libdeflate single-shot when
//   available, zlib streaming otherwise) → NIfTI-1 header parse →
//   one fused gather pass: dtype → float32 with scl_slope/inter,
//   blocked F→C transpose with optional closest-canonical
//   permutation/flips (nibabel io_orientation math), min/max tracking
//   → optional [0, 1] scale pass, writing straight into the
//   caller-provided (numpy) buffer plus the 4×4 sform/qform affine.
//
// Exposed as a plain C ABI consumed via ctypes
// (synthanatomy_tpu_torch/native/__init__.py) — no pybind11 needed.
//
// Build: g++ -O3 -shared -fPIC nifti_loader.cpp -lz [-ldeflate
//        -DHAVE_LIBDEFLATE]
//
// Error codes: 0 ok; -1 open; -2 header; -3 dtype; -4 capacity;
// -5 payload truncated.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <zlib.h>
#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

struct NiftiHeader {
  int32_t sizeof_hdr;
  int64_t shape[3];
  int16_t datatype;
  float pixdim[8];
  float vox_offset;
  float scl_slope, scl_inter;
  int16_t qform_code, sform_code;
  float quatern[3], qoffset[3];
  float srow[3][4];
  bool swap;  // byte-swapped file
};

template <typename T>
T bswap(T v) {
  union {
    T val;
    unsigned char b[sizeof(T)];
  } s, d;
  s.val = v;
  for (size_t i = 0; i < sizeof(T); ++i) d.b[i] = s.b[sizeof(T) - 1 - i];
  return d.val;
}

template <typename T>
T rd(const unsigned char* p, bool swap) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return swap ? bswap(v) : v;
}

int parse_header(const unsigned char* h, NiftiHeader* out) {
  int32_t sz;
  std::memcpy(&sz, h, 4);
  bool swap = false;
  if (sz != 348) {
    sz = bswap(sz);
    if (sz != 348) return -2;
    swap = true;
  }
  if (!((h[344] == 'n' && (h[345] == '+' || h[345] == 'i')))) return -2;
  out->swap = swap;
  int16_t ndim = rd<int16_t>(h + 40, swap);
  if (ndim < 3) {
    // accept 2D by promoting a singleton dim
    out->shape[2] = 1;
  }
  for (int i = 0; i < 3; ++i)
    out->shape[i] = rd<int16_t>(h + 42 + 2 * i, swap);
  out->datatype = rd<int16_t>(h + 70, swap);
  for (int i = 0; i < 8; ++i)
    out->pixdim[i] = rd<float>(h + 76 + 4 * i, swap);
  out->vox_offset = rd<float>(h + 108, swap);
  out->scl_slope = rd<float>(h + 112, swap);
  out->scl_inter = rd<float>(h + 116, swap);
  out->qform_code = rd<int16_t>(h + 252, swap);
  out->sform_code = rd<int16_t>(h + 254, swap);
  for (int i = 0; i < 3; ++i) out->quatern[i] = rd<float>(h + 256 + 4 * i, swap);
  for (int i = 0; i < 3; ++i) out->qoffset[i] = rd<float>(h + 268 + 4 * i, swap);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c)
      out->srow[r][c] = rd<float>(h + 280 + 16 * r + 4 * c, swap);
  return 0;
}

template <typename T>
void convert(const unsigned char* src, float* dst, int64_t n, bool swap,
             float slope, float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  if (slope == 0.0f) slope = 1.0f;
  for (int64_t i = 0; i < n; ++i) {
    T v = s[i];
    if (swap && sizeof(T) > 1) v = bswap(v);
    dst[i] = static_cast<float>(v) * slope + inter;
  }
}

void affine_from_header(const NiftiHeader& h, float* affine16) {
  float A[4][4] = {{0}};
  if (h.sform_code > 0) {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c) A[r][c] = h.srow[r][c];
  } else if (h.qform_code > 0) {
    float b = h.quatern[0], c = h.quatern[1], d = h.quatern[2];
    float a2 = 1.0f - (b * b + c * c + d * d);
    float a = a2 > 0 ? std::sqrt(a2) : 0.0f;
    float R[3][3] = {
        {a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)},
        {2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)},
        {2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c}};
    float qfac = h.pixdim[0] < 0 ? -1.0f : 1.0f;
    float Z[3] = {h.pixdim[1], h.pixdim[2], h.pixdim[3] * qfac};
    for (int r = 0; r < 3; ++r) {
      for (int cc = 0; cc < 3; ++cc) A[r][cc] = R[r][cc] * Z[cc];
      A[r][3] = h.qoffset[r];
    }
  } else {
    A[0][0] = h.pixdim[1];
    A[1][1] = h.pixdim[2];
    A[2][2] = h.pixdim[3];
  }
  A[3][3] = 1.0f;
  std::memcpy(affine16, A, 16 * sizeof(float));
}

// ---------------------------------------------------------------------------
// v2 helpers: whole-file read + fast inflate + fused gather/convert
// ---------------------------------------------------------------------------

// Read the entire file into `buf`.  Returns 0 or an error code.
int read_file(const char* path, std::vector<unsigned char>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_SET);
  buf->resize(sz);
  size_t got = sz ? std::fread(buf->data(), 1, sz, f) : 0;
  std::fclose(f);
  return got == (size_t)sz ? 0 : -5;
}

// Inflate a whole gzip file body into `out` (resized to the
// uncompressed size).  Prefers libdeflate's single-shot decompressor
// (2-3x zlib), sized from the gzip ISIZE trailer; falls back to zlib
// streaming for multi-member files or when libdeflate is absent.
int inflate_whole(const std::vector<unsigned char>& in,
                  std::vector<unsigned char>* out) {
  if (in.size() < 18) return -5;
#ifdef HAVE_LIBDEFLATE
  {
    // ISIZE: uncompressed length mod 2^32 — exact for our volumes
    uint32_t isize;
    std::memcpy(&isize, in.data() + in.size() - 4, 4);
    if (isize > 0 && isize < (1u << 31)) {
      out->resize(isize);
      libdeflate_decompressor* d = libdeflate_alloc_decompressor();
      if (d) {
        size_t actual = 0;
        libdeflate_result rc = libdeflate_gzip_decompress(
            d, in.data(), in.size(), out->data(), out->size(), &actual);
        libdeflate_free_decompressor(d);
        if (rc == LIBDEFLATE_SUCCESS && actual == isize) return 0;
      }
    }
  }
#endif
  // zlib streaming fallback (handles multi-member / bad-ISIZE streams)
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return -5;
  out->clear();
  out->resize(std::max<size_t>(in.size() * 4, 1 << 20));
  zs.next_in = const_cast<unsigned char*>(in.data());
  zs.avail_in = in.size();
  size_t total = 0;
  for (;;) {
    if (total == out->size()) out->resize(out->size() * 2);
    zs.next_out = out->data() + total;
    zs.avail_out = out->size() - total;
    int rc = inflate(&zs, Z_NO_FLUSH);
    total = out->size() - zs.avail_out;
    if (rc == Z_STREAM_END) {
      if (zs.avail_in == 0) break;
      if (inflateReset2(&zs, 15 + 16) != Z_OK) break;  // next member
    } else if (rc != Z_OK) {
      inflateEnd(&zs);
      return -5;
    }
  }
  inflateEnd(&zs);
  out->resize(total);
  return 0;
}

// nibabel io_orientation equivalent (matches the greedy
// dominant-direction assignment in data/nifti.py::_io_orientation,
// including np.argmax first-of-equals tie-breaking).  ornt[j] =
// (output axis, flip) for input axis j.
void io_orientation(const float affine16[16], int ornt_axis[3],
                    int ornt_flip[3]) {
  double Rn[3][3];
  for (int c = 0; c < 3; ++c) {
    double zoom = 0;
    for (int r = 0; r < 3; ++r) {
      double v = affine16[4 * r + c];
      zoom += v * v;
    }
    zoom = std::sqrt(zoom);
    if (zoom == 0) zoom = 1;
    for (int r = 0; r < 3; ++r) Rn[r][c] = affine16[4 * r + c] / zoom;
  }
  double A[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) A[r][c] = std::fabs(Rn[r][c]);
  for (int it = 0; it < 3; ++it) {
    int bi = 0, bj = 0;
    double best = -2;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        if (A[r][c] > best) {
          best = A[r][c];
          bi = r;
          bj = c;
        }
    ornt_axis[bj] = bi;
    ornt_flip[bj] = Rn[bi][bj] >= 0 ? 1 : -1;
    for (int c = 0; c < 3; ++c) A[bi][c] = -1;
    for (int r = 0; r < 3; ++r) A[r][bj] = -1;
  }
}

// Fused dtype→f32 (+scl) + gather into C-order output with arbitrary
// per-input-axis output steps (handles F→C transpose, canonical
// permutation and flips in one pass), tracking min/max.  Blocked so
// both the strided reads and the strided writes stay in cache:
// input x (contiguous reads) × the input axis mapping to the output's
// innermost dim (contiguous writes).
template <typename T>
void gather_convert(const unsigned char* src, float* dst,
                    const int64_t shp[3], const int64_t ostep[3],
                    int64_t obase, bool swap, float slope, float inter,
                    float* minv, float* maxv) {
  const T* s = reinterpret_cast<const T*>(src);
  if (slope == 0.0f) slope = 1.0f;
  const int64_t X = shp[0], Y = shp[1], Z = shp[2];
  float lo = 3.4e38f, hi = -3.4e38f;
  auto cvt = [&](T v) {
    if (swap && sizeof(T) > 1) v = bswap(v);
    float f = static_cast<float>(v) * slope + inter;
    if (f < lo) lo = f;
    if (f > hi) hi = f;
    return f;
  };
  // input axis whose output step is ±1 (the output-innermost axis)
  int wi = 0;
  for (int a = 0; a < 3; ++a)
    if (ostep[a] == 1 || ostep[a] == -1) wi = a;

  if (wi == 0) {
    // x is output-innermost: contiguous reads AND (±1-strided) writes
    for (int64_t z = 0; z < Z; ++z)
      for (int64_t y = 0; y < Y; ++y) {
        const T* row = s + X * (y + Y * z);
        float* o = dst + obase + ostep[1] * y + ostep[2] * z;
        const int64_t st = ostep[0];
        for (int64_t x = 0; x < X; ++x) o[st * x] = cvt(row[x]);
      }
    *minv = lo;
    *maxv = hi;
    return;
  }
  // tile x (contiguous reads) × wi (contiguous writes); oi = the third
  const int oi = (wi == 1) ? 2 : 1;
  const int64_t B = 64;
  const int64_t istride[3] = {1, X, X * Y};
  const int64_t dims[3] = {X, Y, Z};
  for (int64_t u = 0; u < dims[oi]; ++u)
    for (int64_t x0 = 0; x0 < X; x0 += B)
      for (int64_t w0 = 0; w0 < dims[wi]; w0 += B) {
        const int64_t x1 = std::min(x0 + B, X);
        const int64_t w1 = std::min(w0 + B, dims[wi]);
        for (int64_t x = x0; x < x1; ++x) {
          const T* in = s + x + istride[oi] * u + istride[wi] * w0;
          float* o = dst + obase + ostep[0] * x + ostep[oi] * u +
                     ostep[wi] * w0;
          const int64_t ist = istride[wi], ost = ostep[wi];
          for (int64_t w = 0; w < w1 - w0; ++w)
            o[ost * w] = cvt(in[ist * w]);
        }
      }
  *minv = lo;
  *maxv = hi;
}

}  // namespace

extern "C" {

// Read only the dims (for buffer allocation).
int sat_nifti_shape(const char* path, int64_t* shape3) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[352];
  int got = gzread(f, hdr, 352);
  gzclose(f);
  if (got < 348) return -2;
  NiftiHeader h;
  int rc = parse_header(hdr, &h);
  if (rc) return rc;
  for (int i = 0; i < 3; ++i) shape3[i] = h.shape[i];
  return 0;
}

// Full decode into `out` (capacity floats, C-order from F-order file —
// i.e. out is indexed out[x + nx*(y + ny*z)], matching numpy
// reshape(shape, order='F')).  affine16 gets the row-major 4×4 affine.
int sat_load_nifti(const char* path, float* out, int64_t capacity,
                   int64_t* shape3, float* affine16, int normalize) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[352];
  if (gzread(f, hdr, 352) < 348) {
    gzclose(f);
    return -2;
  }
  NiftiHeader h;
  int rc = parse_header(hdr, &h);
  if (rc) {
    gzclose(f);
    return rc;
  }
  int64_t n = h.shape[0] * h.shape[1] * h.shape[2];
  if (n <= 0 || n > capacity) {
    gzclose(f);
    return -4;
  }

  int itemsize;
  switch (h.datatype) {
    case 2: itemsize = 1; break;    // uint8
    case 256: itemsize = 1; break;  // int8
    case 4: itemsize = 2; break;    // int16
    case 512: itemsize = 2; break;  // uint16
    case 8: itemsize = 4; break;    // int32
    case 768: itemsize = 4; break;  // uint32
    case 16: itemsize = 4; break;   // float32
    case 64: itemsize = 8; break;   // float64
    default: gzclose(f); return -3;
  }

  // skip to vox_offset
  int64_t off = static_cast<int64_t>(h.vox_offset);
  if (off > 352) {
    std::vector<unsigned char> skip(off - 352);
    if (gzread(f, skip.data(), skip.size()) != (int)skip.size()) {
      gzclose(f);
      return -5;
    }
  }

  std::vector<unsigned char> raw(n * itemsize);
  int64_t want = n * itemsize, got_total = 0;
  while (got_total < want) {
    int chunk = (int)std::min<int64_t>(want - got_total, 1 << 28);
    int got = gzread(f, raw.data() + got_total, chunk);
    if (got <= 0) break;
    got_total += got;
  }
  gzclose(f);
  if (got_total != want) return -5;

  float slope = h.scl_slope, inter = h.scl_inter;
  bool scale = !(slope == 0.0f || slope == 1.0f) || inter != 0.0f;
  float s = scale ? slope : 1.0f, in = scale ? inter : 0.0f;
  switch (h.datatype) {
    case 2: convert<uint8_t>(raw.data(), out, n, h.swap, s, in); break;
    case 256: convert<int8_t>(raw.data(), out, n, h.swap, s, in); break;
    case 4: convert<int16_t>(raw.data(), out, n, h.swap, s, in); break;
    case 512: convert<uint16_t>(raw.data(), out, n, h.swap, s, in); break;
    case 8: convert<int32_t>(raw.data(), out, n, h.swap, s, in); break;
    case 768: convert<uint32_t>(raw.data(), out, n, h.swap, s, in); break;
    case 16: convert<float>(raw.data(), out, n, h.swap, s, in); break;
    case 64: convert<double>(raw.data(), out, n, h.swap, s, in); break;
  }

  if (normalize) {
    float lo = out[0], hi = out[0];
    for (int64_t i = 1; i < n; ++i) {
      float v = out[i];
      if (v < lo) lo = v;
      if (v > hi) hi = v;
    }
    float range = hi - lo;
    if (range < 1e-12f) {
      for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
    } else {
      float inv = 1.0f / range;
      for (int64_t i = 0; i < n; ++i) out[i] = (out[i] - lo) * inv;
    }
  }

  for (int i = 0; i < 3; ++i) shape3[i] = h.shape[i];
  affine_from_header(h, affine16);
  return 0;
}

// v2: whole-file fast path.  Decodes into `out` in C ORDER (unlike v1's
// F-order contract), optionally reoriented to closest-canonical RAS
// (canonical=1), optionally min-max normalized.  shape3 receives the
// OUTPUT (post-permutation) shape; ornt6 receives the io_orientation
// (output_axis, flip) pairs per input axis so the caller can rebuild
// the canonical affine; affine16 receives the RAW header affine.
int sat_load_nifti_v2(const char* path, float* out, int64_t capacity,
                      int64_t* shape3, float* affine16, int normalize,
                      int canonical, int32_t* ornt6) {
  std::vector<unsigned char> file;
  int rc = read_file(path, &file);
  if (rc) return rc;

  std::vector<unsigned char> inflated;
  const std::vector<unsigned char>* data = &file;
  if (file.size() >= 2 && file[0] == 0x1f && file[1] == 0x8b) {
    rc = inflate_whole(file, &inflated);
    if (rc) return rc;
    data = &inflated;
  }
  if (data->size() < 348) return -2;

  NiftiHeader h;
  rc = parse_header(data->data(), &h);
  if (rc) return rc;
  int64_t n = h.shape[0] * h.shape[1] * h.shape[2];
  if (n <= 0 || n > capacity) return -4;

  int itemsize;
  switch (h.datatype) {
    case 2: case 256: itemsize = 1; break;
    case 4: case 512: itemsize = 2; break;
    case 8: case 768: case 16: itemsize = 4; break;
    case 64: itemsize = 8; break;
    default: return -3;
  }
  int64_t off = static_cast<int64_t>(h.vox_offset);
  if (off < 348 || off + n * itemsize > (int64_t)data->size()) return -5;
  const unsigned char* raw = data->data() + off;

  affine_from_header(h, affine16);

  // orientation: identity unless canonical requested
  int oaxis[3] = {0, 1, 2}, oflip[3] = {1, 1, 1};
  if (canonical) io_orientation(affine16, oaxis, oflip);
  for (int a = 0; a < 3; ++a) {
    ornt6[2 * a] = oaxis[a];
    ornt6[2 * a + 1] = oflip[a];
  }
  int64_t odims[3];
  for (int a = 0; a < 3; ++a) odims[oaxis[a]] = h.shape[a];
  int64_t ostrides[3];  // C-order strides of the output array
  ostrides[2] = 1;
  ostrides[1] = odims[2];
  ostrides[0] = odims[2] * odims[1];
  int64_t ostep[3], obase = 0;
  for (int a = 0; a < 3; ++a) {
    int64_t st = ostrides[oaxis[a]];
    if (oflip[a] < 0) {
      obase += (h.shape[a] - 1) * st;
      ostep[a] = -st;
    } else {
      ostep[a] = st;
    }
  }
  for (int a = 0; a < 3; ++a) shape3[a] = odims[a];

  float slope = h.scl_slope, inter = h.scl_inter;
  bool scale = !(slope == 0.0f || slope == 1.0f) || inter != 0.0f;
  float s = scale ? slope : 1.0f, in = scale ? inter : 0.0f;
  float lo = 0, hi = 0;
  switch (h.datatype) {
    case 2: gather_convert<uint8_t>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 256: gather_convert<int8_t>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 4: gather_convert<int16_t>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 512: gather_convert<uint16_t>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 8: gather_convert<int32_t>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 768: gather_convert<uint32_t>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 16: gather_convert<float>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
    case 64: gather_convert<double>(raw, out, h.shape, ostep, obase, h.swap, s, in, &lo, &hi); break;
  }

  if (normalize) {
    float range = hi - lo;
    if (range < 1e-12f) {
      for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
    } else {
      float inv = 1.0f / range;
      for (int64_t i = 0; i < n; ++i) out[i] = (out[i] - lo) * inv;
    }
  }
  return 0;
}

}  // extern "C"
