// ife_native — host-side native runtime components.
//
// TPU-native framework analog of the reference's compiled libraries
// (libIO/libHR2Reader/libString, reference src/IO/CMakeLists.txt:1-8):
// the device compute path is JAX/XLA/Pallas; this library provides the
// host-side hot paths around it:
//   * HR2 binary volume codec (zlib streaming, reference
//     src/IO/HR2Reader.cxx:11-222 format)
//   * multithreaded dense-histogram binning (the MakeBag host loop,
//     reference tools/MakeBag.cxx:448-457 / DenseHistogram.h:47-53)
//   * multithreaded masked gather (ROI voxel extraction)
//
// C ABI for ctypes. Build: make -C native   ->  native/libife_native.so
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------------

void ife_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// HR2 codec
// ---------------------------------------------------------------------------

typedef struct {
  int64_t size[3];
  double origin[3];
  double spacing[3];
  int32_t is_float;  // 1 = float32 payload, 0 = int8 payload widened to float
} IfeHr2Info;

namespace {

const char* kTags[] = {"PixelType", "Compression", "Dimension",
                       "Size",      "Origin",      "Spacing",
                       "ImageData"};

bool read_exact(FILE* f, void* buf, size_t n) {
  return std::fread(buf, 1, n, f) == n;
}

// length-prefixed ASCII tag (reference HR2Reader.cxx:196-209)
bool read_tag(FILE* f, std::string* tag) {
  unsigned char len;
  if (!read_exact(f, &len, 1)) return false;
  std::vector<char> buf(len);
  if (!read_exact(f, buf.data(), len)) return false;
  tag->assign(buf.data(), len);
  for (const char* t : kTags)
    if (*tag == t) return true;
  return false;
}

// <=4 little-endian bytes, zero byte terminates early (HR2Reader.cxx:211-222)
bool read_field_length(FILE* f, uint32_t* out) {
  uint32_t v = 0;
  int i = 0;
  for (; i < 4; ++i) {
    unsigned char b;
    if (!read_exact(f, &b, 1)) return false;
    if (b == 0) break;
    v |= static_cast<uint32_t>(b) << (8 * i);
  }
  *out = v;
  return true;
}

}  // namespace

// Returns 0 on success. *data is malloc'd float32, x fastest (caller frees
// with ife_free). err gets a message on failure.
int ife_hr2_read(const char* path, IfeHr2Info* info, float** data,
                 char* err, int err_len) {
#define FAIL(msg)                         \
  do {                                    \
    std::snprintf(err, err_len, "%s", msg); \
    if (f) std::fclose(f);                \
    return 1;                             \
  } while (0)

  FILE* f = std::fopen(path, "rb");
  if (!f) FAIL("cannot open file");
  char magic[3];
  if (!read_exact(f, magic, 3)) FAIL("short file");
  // accepts "HR?" with ? != '3' — reference quirk (HR2Reader.cxx:97-102)
  if (!(magic[0] == 'H' && magic[1] == 'R' && magic[2] != '3'))
    FAIL("not an HR2 file");

  std::string pixel_type = "float", compression;
  info->size[0] = info->size[1] = info->size[2] = 0;
  for (int d = 0; d < 3; ++d) {
    info->origin[d] = 0.0;
    info->spacing[d] = 1.0;
  }
  uint64_t payload_len = 0;
  while (true) {
    std::string tag;
    if (!read_tag(f, &tag)) FAIL("bad header tag");
    uint32_t len;
    if (!read_field_length(f, &len)) FAIL("bad field length");
    if (tag == "ImageData") {
      payload_len = len;
      break;
    }
    std::vector<char> buf(len);
    if (!read_exact(f, buf.data(), len)) FAIL("short header field");
    std::string val(buf.data(), len);
    if (tag == "PixelType") pixel_type = val;
    else if (tag == "Compression") compression = val;
    else if (tag == "Dimension") {
      if (std::atoi(val.c_str()) != 3) FAIL("only 3D supported");
    } else if (tag == "Size" || tag == "Origin" || tag == "Spacing") {
      double v[3] = {0, 0, 0};
      if (std::sscanf(val.c_str(), "%lf %lf %lf", &v[0], &v[1], &v[2]) != 3)
        FAIL("bad triple field");
      for (int d = 0; d < 3; ++d) {
        if (tag == "Size") info->size[d] = static_cast<int64_t>(v[d]);
        else if (tag == "Origin") info->origin[d] = v[d];
        else info->spacing[d] = v[d];
      }
    }
  }
  if (compression != "ZLib") FAIL("only ZLib compression supported");
  const bool is_float = pixel_type == "float";
  if (!is_float && pixel_type != "char") FAIL("pixel type must be float|char");
  info->is_float = is_float ? 1 : 0;

  const uint64_t n =
      static_cast<uint64_t>(info->size[0]) * info->size[1] * info->size[2];
  if (n == 0) FAIL("zero-sized volume");
  const uint64_t raw_len = n * (is_float ? 4 : 1);
  std::vector<unsigned char> raw(raw_len);

  // streaming inflate, 64 KiB chunks (reference Util/InflateStream.h:12-72)
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) FAIL("inflateInit failed");
  std::vector<unsigned char> chunk(1 << 16);
  uint64_t produced = 0, consumed = 0;
  int zret = Z_OK;
  while (zret != Z_STREAM_END && consumed < payload_len) {
    const size_t want =
        std::min<uint64_t>(chunk.size(), payload_len - consumed);
    const size_t got = std::fread(chunk.data(), 1, want, f);
    if (got == 0) break;
    consumed += got;
    zs.next_in = chunk.data();
    zs.avail_in = static_cast<uInt>(got);
    while (zs.avail_in > 0 && zret != Z_STREAM_END) {
      zs.next_out = raw.data() + produced;
      zs.avail_out = static_cast<uInt>(
          std::min<uint64_t>(raw_len - produced, 1u << 30));
      if (zs.avail_out == 0) { zret = Z_STREAM_END; break; }
      zret = inflate(&zs, Z_NO_FLUSH);
      if (zret != Z_OK && zret != Z_STREAM_END) {
        inflateEnd(&zs);
        FAIL("inflate error");
      }
      produced = zs.next_out - raw.data();
    }
  }
  inflateEnd(&zs);
  if (produced < raw_len) FAIL("truncated voxel payload");
  std::fclose(f);
  f = nullptr;

  float* out = static_cast<float*>(std::malloc(n * sizeof(float)));
  if (!out) { std::snprintf(err, err_len, "oom"); return 1; }
  if (is_float) {
    std::memcpy(out, raw.data(), n * sizeof(float));
  } else {
    const int8_t* s = reinterpret_cast<const int8_t*>(raw.data());
    for (uint64_t i = 0; i < n; ++i) out[i] = static_cast<float>(s[i]);
  }
  *data = out;
  return 0;
#undef FAIL
}

namespace {

void put_field_length(std::string* out, uint32_t v) {
  // inverse of read_field_length: LE bytes up to last nonzero, then a zero
  // terminator if fewer than 4 bytes were written
  int nbytes = 0;
  for (int i = 0; i < 4; ++i)
    if ((v >> (8 * i)) & 0xFF) nbytes = i + 1;
  for (int i = 0; i < nbytes; ++i)
    out->push_back(static_cast<char>((v >> (8 * i)) & 0xFF));
  if (nbytes < 4) out->push_back('\0');
}

void put_field(std::string* out, const char* tag, const std::string& val) {
  out->push_back(static_cast<char>(std::strlen(tag)));
  out->append(tag);
  put_field_length(out, static_cast<uint32_t>(val.size()));
  out->append(val);
}

}  // namespace

// data: float32 x-fastest. pixel "float" or "char". Returns 0 on success.
int ife_hr2_write(const char* path, const IfeHr2Info* info, const float* data,
                  char* err, int err_len) {
  const uint64_t n =
      static_cast<uint64_t>(info->size[0]) * info->size[1] * info->size[2];
  const bool is_float = info->is_float != 0;
  std::vector<unsigned char> raw(n * (is_float ? 4 : 1));
  if (is_float) {
    std::memcpy(raw.data(), data, n * sizeof(float));
  } else {
    int8_t* d = reinterpret_cast<int8_t*>(raw.data());
    for (uint64_t i = 0; i < n; ++i) d[i] = static_cast<int8_t>(data[i]);
  }
  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<unsigned char> comp(bound);
  if (compress2(comp.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), 6) != Z_OK) {
    std::snprintf(err, err_len, "compress failed");
    return 1;
  }

  char buf[256];
  std::string hdr;
  put_field(&hdr, "PixelType", is_float ? "float" : "char");
  put_field(&hdr, "Compression", "ZLib");
  put_field(&hdr, "Dimension", "3");
  std::snprintf(buf, sizeof(buf), "%lld %lld %lld",
                static_cast<long long>(info->size[0]),
                static_cast<long long>(info->size[1]),
                static_cast<long long>(info->size[2]));
  put_field(&hdr, "Size", buf);
  std::snprintf(buf, sizeof(buf), "%.17g %.17g %.17g", info->origin[0],
                info->origin[1], info->origin[2]);
  put_field(&hdr, "Origin", buf);
  std::snprintf(buf, sizeof(buf), "%.17g %.17g %.17g", info->spacing[0],
                info->spacing[1], info->spacing[2]);
  put_field(&hdr, "Spacing", buf);
  hdr.push_back(static_cast<char>(std::strlen("ImageData")));
  hdr.append("ImageData");
  put_field_length(&hdr, static_cast<uint32_t>(bound));

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    std::snprintf(err, err_len, "cannot open output");
    return 1;
  }
  bool ok = std::fwrite("HR2", 1, 3, f) == 3 &&
            std::fwrite(hdr.data(), 1, hdr.size(), f) == hdr.size() &&
            std::fwrite(comp.data(), 1, bound, f) == bound;
  std::fclose(f);
  if (!ok) {
    std::snprintf(err, err_len, "short write");
    return 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// multithreaded histogram binning
// ---------------------------------------------------------------------------

// bin(x) = index of first edge >= x (searchsorted left) over n_edges+1 bins
// (reference DenseHistogram.h:22-53). mask: optional (nullptr = all), count
// only where mask != 0. counts must hold n_edges+1 zeros-initialized? No —
// this function zeroes it.
void ife_histogram(const float* values, int64_t n, const double* edges,
                   int32_t n_edges, const uint8_t* mask, uint64_t* counts) {
  const int32_t n_bins = n_edges + 1;
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n < (1 << 16)) n_threads = 1;
  std::vector<std::vector<uint64_t>> partial(
      n_threads, std::vector<uint64_t>(n_bins, 0));
  std::vector<std::thread> threads;
  const int64_t step = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t lo = t * step;
      const int64_t hi = std::min<int64_t>(n, lo + step);
      std::vector<uint64_t>& mine = partial[t];
      for (int64_t i = lo; i < hi; ++i) {
        if (mask && !mask[i]) continue;
        const double v = values[i];
        const double* e =
            std::lower_bound(edges, edges + n_edges, v);
        mine[static_cast<int32_t>(e - edges)]++;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int32_t b = 0; b < n_bins; ++b) {
    uint64_t acc = 0;
    for (int t = 0; t < n_threads; ++t) acc += partial[t][b];
    counts[b] = acc;
  }
}

// Many histograms over strided channels: values is (n, n_hist) row-major;
// histogram h uses edges[h*n_edges .. ] and fills counts[h*(n_edges+1) ..].
// The MakeBag inner loop (8 features x n voxels) in one pass.
void ife_histogram_channels(const float* values, int64_t n, int32_t n_hist,
                            const double* edges, int32_t n_edges,
                            const uint8_t* mask, uint64_t* counts) {
  const int32_t n_bins = n_edges + 1;
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n < (1 << 14)) n_threads = 1;
  std::vector<std::vector<uint64_t>> partial(
      n_threads, std::vector<uint64_t>(static_cast<size_t>(n_hist) * n_bins, 0));
  std::vector<std::thread> threads;
  const int64_t step = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t lo = t * step;
      const int64_t hi = std::min<int64_t>(n, lo + step);
      std::vector<uint64_t>& mine = partial[t];
      for (int64_t i = lo; i < hi; ++i) {
        if (mask && !mask[i]) continue;
        const float* row = values + i * n_hist;
        for (int32_t h = 0; h < n_hist; ++h) {
          const double* e0 = edges + static_cast<size_t>(h) * n_edges;
          const double* e = std::lower_bound(e0, e0 + n_edges,
                                             static_cast<double>(row[h]));
          mine[static_cast<size_t>(h) * n_bins + (e - e0)]++;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  const size_t total = static_cast<size_t>(n_hist) * n_bins;
  for (size_t b = 0; b < total; ++b) {
    uint64_t acc = 0;
    for (int t = 0; t < n_threads; ++t) acc += partial[t][b];
    counts[b] = acc;
  }
}

// ---------------------------------------------------------------------------
// JPEG Lossless (process 14) decoder — ITU-T T.81 Annex H
// ---------------------------------------------------------------------------
// Native fast path for ife_tpu/io/jpegll.py (the DICOM transfer syntax
// 1.2.840.10008.1.2.4.70): the pure-Python decoder costs ~1-2 s per CT
// slice; this one decodes the same streams in milliseconds. Semantics
// mirror the Python reference exactly (single-component SOF3, any
// selection value 1-7, Huffman magnitude categories + EXTEND, modulo-2^16
// arithmetic, byte-stuffed entropy segment, point transform).

namespace jll {

struct BitReader {
  const uint8_t* buf;
  size_t nbits;
  size_t pos = 0;
  int bit() {
    if (pos >= nbits) return 1;  // T.81 decoders pad with 1-bits
    int b = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  uint32_t bits(int k) {
    uint32_t v = 0;
    while (k--) v = (v << 1) | bit();
    return v;
  }
};

struct Huff {
  uint32_t first_code[17];
  uint32_t count[17];
  uint32_t offset[17];
  std::vector<uint8_t> vals;
  void build(const uint8_t* bits, const uint8_t* huffval, int nv) {
    vals.assign(huffval, huffval + nv);
    uint32_t code = 0;
    uint32_t k = 0;
    for (int L = 1; L <= 16; ++L) {
      first_code[L] = code;
      offset[L] = k;
      count[L] = bits[L - 1];
      code += count[L];
      k += count[L];
      code <<= 1;
    }
  }
  int decode(BitReader& br) const {
    uint32_t code = 0;
    for (int L = 1; L <= 16; ++L) {
      code = (code << 1) | br.bit();
      if (count[L] && code >= first_code[L] &&
          code < first_code[L] + count[L])
        return vals[offset[L] + (code - first_code[L])];
    }
    return -1;
  }
};

}  // namespace jll

// Decode a single-component SOF3 stream into out (rows*cols uint16, raw
// stored values). rows/cols must match the SOF3 frame header (the DICOM
// caller knows them from tags). Returns 0 on success, <0 on error.
int ife_jll_decode(const uint8_t* d, int64_t len, uint16_t* out,
                   int32_t rows, int32_t cols) {
  auto u16at = [&](int64_t p) -> int { return (d[p] << 8) | d[p + 1]; };
  if (len < 4 || u16at(0) != 0xFFD8) return -1;
  int64_t pos = 2;
  jll::Huff tables[4];
  bool have[4] = {false, false, false, false};
  int precision = 0, frows = 0, fcols = 0;
  while (pos + 4 <= len) {
    int marker = u16at(pos);
    pos += 2;
    if (marker == 0xFFD9) break;
    if (marker < 0xFFC0 || marker > 0xFFFE) return -2;
    int seglen = u16at(pos);
    if (pos + seglen > len) return -2;
    const uint8_t* seg = d + pos + 2;
    int segn = seglen - 2;
    if (marker == 0xFFC3) {
      if (segn < 6) return -2;
      precision = seg[0];
      frows = (seg[1] << 8) | seg[2];
      fcols = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) return -3;  // multi-component unsupported
    } else if (marker == 0xFFC4) {
      int p = 0;
      while (p + 17 <= segn) {
        int th = seg[p] & 0x0F;
        int nv = 0;
        for (int i = 0; i < 16; ++i) nv += seg[p + 1 + i];
        if (p + 17 + nv > segn) return -2;
        if (th < 4) {
          tables[th].build(seg + p + 1, seg + p + 17, nv);
          have[th] = true;
        }
        p += 17 + nv;
      }
    } else if (marker == 0xFFDA) {
      if (segn < 6) return -2;
      int ns = seg[0];
      if (ns != 1) return -3;
      int td = seg[2] >> 4;
      int pred = seg[1 + 2 * ns];
      int pt = seg[3 + 2 * ns] & 0x0F;
      if (td > 3 || !have[td]) return -4;
      if (frows != rows || fcols != cols) return -7;
      if (precision < 2 || precision > 16) return -2;
      pos += seglen;
      // un-stuff the entropy segment (FF 00 -> FF; FF xx ends it)
      std::vector<uint8_t> ent;
      ent.reserve(static_cast<size_t>(len - pos));
      for (int64_t i = pos; i < len; ++i) {
        uint8_t b = d[i];
        if (b == 0xFF) {
          if (i + 1 < len && d[i + 1] == 0x00) {
            ent.push_back(0xFF);
            ++i;
          } else {
            break;
          }
        } else {
          ent.push_back(b);
        }
      }
      jll::BitReader br{ent.data(), ent.size() * 8};
      const jll::Huff& H = tables[td];
      const int32_t def = 1 << (precision - pt - 1);
      for (int32_t r = 0; r < rows; ++r) {
        uint16_t* row = out + static_cast<int64_t>(r) * cols;
        const uint16_t* up =
            r ? out + static_cast<int64_t>(r - 1) * cols : nullptr;
        for (int32_t c = 0; c < cols; ++c) {
          int s = H.decode(br);
          if (s < 0) return -8;
          int32_t diff;
          if (s == 16) {
            diff = 32768;
          } else if (s == 0) {
            diff = 0;
          } else {
            uint32_t v = br.bits(s);
            diff = (v < (1u << (s - 1)))
                       ? static_cast<int32_t>(v) - (1 << s) + 1
                       : static_cast<int32_t>(v);
          }
          int32_t px;
          if (r == 0 && c == 0) {
            px = def;
          } else if (r == 0) {
            px = row[c - 1];
          } else if (c == 0) {
            px = up[0];
          } else {
            const int32_t ra = row[c - 1], rb = up[c], rc_ = up[c - 1];
            switch (pred) {
              case 1: px = ra; break;
              case 2: px = rb; break;
              case 3: px = rc_; break;
              case 4: px = ra + rb - rc_; break;
              case 5: px = ra + ((rb - rc_) >> 1); break;
              case 6: px = rb + ((ra - rc_) >> 1); break;
              case 7: px = (ra + rb) >> 1; break;
              default: return -9;
            }
          }
          row[c] = static_cast<uint16_t>((px + diff) & 0xFFFF);
        }
      }
      if (pt) {
        const int64_t npix = static_cast<int64_t>(rows) * cols;
        for (int64_t i = 0; i < npix; ++i)
          out[i] = static_cast<uint16_t>(out[i] << pt);
      }
      return 0;
    } else if (marker >= 0xFFC0 && marker <= 0xFFCF && marker != 0xFFC4 &&
               marker != 0xFFC8) {
      return -5;  // a non-lossless SOF
    }
    pos += seglen;
  }
  return -6;  // no scan found
}

// ---------------------------------------------------------------------------
// JPEG-LS (T.87 LOCO-I) decoder
// ---------------------------------------------------------------------------
// Native fast path for ife_tpu/io/jpegls.py (DICOM transfer syntaxes
// 1.2.840.10008.1.2.4.80/.81): the pure-Python per-pixel decoder costs
// ~0.5-2 s per CT slice; this mirrors it statement for statement
// (context modeling, Golomb limits, run mode, RI mapping, LSE
// zero-means-default) so the two stay byte-identical.

namespace jls {

struct BitReader {
  const uint8_t* d;
  int64_t len;
  int64_t pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool prev_ff = false;
  int bit() {
    if (nbits == 0) {
      if (pos >= len) return 0;  // tolerate ragged zero padding
      uint8_t b = d[pos++];
      if (prev_ff) {
        acc = b & 0x7F;
        nbits = 7;
      } else {
        acc = b;
        nbits = 8;
      }
      prev_ff = (b == 0xFF);
    }
    --nbits;
    return (acc >> nbits) & 1;
  }
  uint32_t bits(int k) {
    uint32_t v = 0;
    while (k--) v = (v << 1) | bit();
    return v;
  }
};

static const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  2,  2,  3,  3, 3, 3,
                          4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Params {
  int maxval, near, range, qbpp, limit, t1, t2, t3, reset;
  int64_t A[367], B[365], N[367], Nn[2];
  int C[365];
  int runindex = 0;
  void init(int precision, int near_, int maxval_, int t1_, int t2_,
            int t3_, int reset_) {
    near = near_;
    maxval = maxval_ > 0 ? maxval_ : (1 << precision) - 1;
    range = (maxval + 2 * near) / (2 * near + 1) + 1;
    qbpp = 1;
    while ((1 << qbpp) < range) ++qbpp;
    int bpp = 2;
    while ((1 << bpp) <= maxval) ++bpp;
    if (bpp < 2) bpp = 2;
    limit = 2 * (bpp + (bpp > 8 ? bpp : 8));
    // defaults (C.2.4.1.1.1); a ZERO preset selects the default field
    auto clampf = [&](long long i, int j) {
      return (i > maxval || i < j) ? j : static_cast<int>(i);
    };
    int d1, d2, d3;
    if (maxval >= 128) {
      int f = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
      d1 = clampf(1LL * f + 2 + 3 * near, near + 1);
      d2 = clampf(4LL * f + 3 + 5 * near, d1);
      d3 = clampf(17LL * f + 4 + 7 * near, d2);
    } else {
      int f = 256 / (maxval + 1);
      int b1 = 3 / f + 3 * near;
      int b2 = 7 / f + 5 * near;
      int b3 = 21 / f + 7 * near;
      d1 = clampf(b1 > 2 ? b1 : 2, near + 1);
      d2 = clampf(b2 > 3 ? b2 : 3, d1);
      d3 = clampf(b3 > 4 ? b3 : 4, d2);
    }
    t1 = t1_ ? t1_ : d1;
    t2 = t2_ ? t2_ : d2;
    t3 = t3_ ? t3_ : d3;
    reset = reset_ ? reset_ : 64;
    int64_t a0 = (range + 32) / 64;
    if (a0 < 2) a0 = 2;
    for (int i = 0; i < 367; ++i) {
      A[i] = a0;
      N[i] = 1;
    }
    for (int i = 0; i < 365; ++i) {
      B[i] = 0;
      C[i] = 0;
    }
    Nn[0] = Nn[1] = 0;
  }
  int quant(int dv) const {
    if (dv <= -t3) return -4;
    if (dv <= -t2) return -3;
    if (dv <= -t1) return -2;
    if (dv < -near) return -1;
    if (dv <= near) return 0;
    if (dv < t1) return 1;
    if (dv < t2) return 2;
    if (dv < t3) return 3;
    return 4;
  }
};

static inline int golomb_decode(BitReader& br, int k, int glimit,
                                int qbpp, bool* err) {
  int z = 0;
  while (br.bit() == 0) {
    if (++z > glimit) {
      *err = true;
      return 0;
    }
  }
  if (z < glimit - qbpp - 1)
    return (z << k) | (k ? static_cast<int>(br.bits(k)) : 0);
  return static_cast<int>(br.bits(qbpp)) + 1;
}

static inline int mod_range(int e, int range) {
  if (e < 0) e += range;
  if (e >= (range + 1) / 2) e -= range;
  return e;
}

static inline int reconstruct(const Params& p, int px, int sign, int e) {
  int rx = px + sign * e * (2 * p.near + 1);
  if (rx < -p.near)
    rx += p.range * (2 * p.near + 1);
  else if (rx > p.maxval + p.near)
    rx -= p.range * (2 * p.near + 1);
  if (rx < 0) rx = 0;
  if (rx > p.maxval) rx = p.maxval;
  return rx;
}

}  // namespace jls

// Decode a single-component ILV=0 JPEG-LS stream into out (rows*cols
// uint16). Returns 0 on success, <0 on error (mirrors the Python
// decoder's ValueErrors).
int ife_jls_decode(const uint8_t* d, int64_t len, uint16_t* out,
                   int32_t rows, int32_t cols) {
  auto u16at = [&](int64_t p) -> int { return (d[p] << 8) | d[p + 1]; };
  if (len < 4 || u16at(0) != 0xFFD8) return -1;
  int64_t pos = 2;
  int precision = 0, frows = 0, fcols = 0;
  int lse_maxval = 0, lse_t1 = 0, lse_t2 = 0, lse_t3 = 0, lse_reset = 0;
  while (pos + 4 <= len) {
    int marker = u16at(pos);
    pos += 2;
    if (marker == 0xFFD9) break;
    if (marker < 0xFFC0 || marker > 0xFFFE) return -2;
    int seglen = u16at(pos);
    if (pos + seglen > len) return -2;
    const uint8_t* seg = d + pos + 2;
    int segn = seglen - 2;
    if (marker == 0xFFF7) {  // SOF55
      if (segn < 6) return -2;
      precision = seg[0];
      frows = (seg[1] << 8) | seg[2];
      fcols = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) return -3;
    } else if (marker == 0xFFF8) {  // LSE
      if (segn >= 11 && seg[0] == 1) {
        lse_maxval = (seg[1] << 8) | seg[2];
        lse_t1 = (seg[3] << 8) | seg[4];
        lse_t2 = (seg[5] << 8) | seg[6];
        lse_t3 = (seg[7] << 8) | seg[8];
        lse_reset = (seg[9] << 8) | seg[10];
      }
    } else if (marker == 0xFFDA) {  // SOS
      if (segn < 6) return -2;
      if (seg[0] != 1) return -3;
      int near = seg[1 + 2];
      int ilv = seg[2 + 2];
      if (ilv != 0) return -3;
      if (!precision || frows != rows || fcols != cols) return -7;
      jls::Params p;  // ~12 KB of context state: fine on the stack
      p.init(precision, near, lse_maxval, lse_t1, lse_t2, lse_t3,
             lse_reset);
      p.runindex = 0;
      jls::BitReader br{d + pos + seglen, len - pos - seglen};
      bool err = false;
      for (int32_t i = 0; i < rows; ++i) {
        uint16_t* row = out + static_cast<int64_t>(i) * cols;
        const uint16_t* up =
            i ? out + static_cast<int64_t>(i - 1) * cols : nullptr;
        const uint16_t* up2 =
            i >= 2 ? out + static_cast<int64_t>(i - 2) * cols : nullptr;
        int32_t j = 0;
        while (j < cols) {
          // causal template with the A.2.1 edge rules
          int a, b, c_, dd;
          if (i == 0) {
            b = c_ = dd = 0;
            a = j ? row[j - 1] : 0;
          } else {
            b = up[j];
            dd = (j + 1 < cols) ? up[j + 1] : b;
            if (j == 0) {
              a = b;
              c_ = up2 ? up2[0] : 0;
            } else {
              a = row[j - 1];
              c_ = up[j - 1];
            }
          }
          int q1 = p.quant(dd - b), q2 = p.quant(b - c_),
              q3 = p.quant(c_ - a);
          if (q1 == 0 && q2 == 0 && q3 == 0) {
            // ---- run mode (A.7) ----
            bool end_of_line = false;
            while (br.bit() == 1) {
              int n = 1 << jls::J[p.runindex];
              int take = n < cols - j ? n : cols - j;
              for (int t = 0; t < take; ++t) row[j + t] = (uint16_t)a;
              j += take;
              if (take < n || j >= cols) {
                end_of_line = true;
                if (p.runindex < 31 && take == n) ++p.runindex;
                break;
              }
              if (p.runindex < 31) ++p.runindex;
            }
            if (end_of_line) continue;
            int r = jls::J[p.runindex]
                        ? static_cast<int>(br.bits(jls::J[p.runindex]))
                        : 0;
            if (r > cols - j) return -8;
            for (int t = 0; t < r; ++t) row[j + t] = (uint16_t)a;
            j += r;
            if (j >= cols) return -8;
            // ---- run-interruption sample (A.7.2) ----
            int bri = i ? up[j] : 0;
            int ritype = (std::abs(a - bri) <= p.near) ? 1 : 0;
            int px = ritype ? a : bri;
            int sign = (ritype == 0 && a > bri) ? -1 : 1;
            int q = 365 + ritype;
            int64_t temp = ritype ? p.A[366] + (p.N[366] >> 1) : p.A[365];
            int k = 0;
            while ((p.N[q] << k) < temp) ++k;
            int glimit = p.limit - jls::J[p.runindex] - 1;
            int em = jls::golomb_decode(br, k, glimit, p.qbpp, &err);
            if (err) return -8;
            int s = em + ritype;  // 2|e| - map
            int errval;
            if (k == 0 && 2 * p.Nn[q - 365] < p.N[q])
              errval = (s % 2) ? (s + 1) / 2 : -(s / 2);
            else
              errval = (s % 2 == 0) ? s / 2 : -((s + 1) / 2);
            row[j] = (uint16_t)jls::reconstruct(p, px, sign, errval);
            if (errval < 0) ++p.Nn[q - 365];
            p.A[q] += (em + 1 - ritype) >> 1;
            if (p.N[q] == p.reset) {
              p.A[q] >>= 1;
              p.N[q] >>= 1;
              p.Nn[q - 365] >>= 1;
            }
            ++p.N[q];
            if (p.runindex > 0) --p.runindex;
            ++j;
            continue;
          }
          // ---- regular mode (A.4-A.6) ----
          int sign =
              (q1 < 0 || (q1 == 0 && (q2 < 0 || (q2 == 0 && q3 < 0))))
                  ? -1
                  : 1;
          int q = std::abs(81 * q1 + 9 * q2 + q3);
          int px;
          if (c_ >= (a > b ? a : b))
            px = a < b ? a : b;
          else if (c_ <= (a < b ? a : b))
            px = a > b ? a : b;
          else
            px = a + b - c_;
          px += sign * p.C[q];
          if (px < 0) px = 0;
          if (px > p.maxval) px = p.maxval;
          int k = 0;
          while ((p.N[q] << k) < p.A[q]) ++k;
          int merr = jls::golomb_decode(br, k, p.limit, p.qbpp, &err);
          if (err) return -8;
          int errval;
          if (p.near == 0 && k == 0 && 2 * p.B[q] <= -p.N[q])
            errval = (merr % 2) ? (merr - 1) / 2 : -(merr / 2) - 1;
          else
            errval = (merr % 2 == 0) ? merr / 2 : -((merr + 1) / 2);
          errval = jls::mod_range(errval, p.range);
          row[j] = (uint16_t)jls::reconstruct(p, px, sign, errval);
          // A/B/N update + bias (A.6)
          p.B[q] += static_cast<int64_t>(errval) * (2 * p.near + 1);
          p.A[q] += std::abs(errval);
          if (p.N[q] == p.reset) {
            p.A[q] >>= 1;
            p.B[q] = p.B[q] >= 0 ? (p.B[q] >> 1) : -((1 - p.B[q]) >> 1);
            p.N[q] >>= 1;
          }
          ++p.N[q];
          if (p.B[q] <= -p.N[q]) {
            if (p.C[q] > -128) --p.C[q];
            p.B[q] += p.N[q];
            if (p.B[q] <= -p.N[q]) p.B[q] = -p.N[q] + 1;
          } else if (p.B[q] > 0) {
            if (p.C[q] < 127) ++p.C[q];
            p.B[q] -= p.N[q];
            if (p.B[q] > 0) p.B[q] = 0;
          }
          ++j;
        }
      }
      return 0;
    } else if (marker >= 0xFFC0 && marker <= 0xFFCF && marker != 0xFFC4 &&
               marker != 0xFFC8) {
      return -5;
    }
    pos += seglen;
  }
  return -6;  // no scan found
}

}  // extern "C"
