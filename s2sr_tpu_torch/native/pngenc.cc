// Native PNG tile encoder, the port's copy of s2sr_tpu/native/pngenc.cc.
//
// The tile pyramid emits thousands of 256x256 RGBA tiles per job; this
// encodes them in C++, called from Python through ctypes
// (s2sr_tpu_torch/tiles/png.py), releasing the GIL while it runs.
//
// C ABI (the JAX package's):
//   int s2sr_png_encode(const uint8_t* data, int height, int width,
//                       int channels, int level,
//                       uint8_t* out, size_t out_cap, size_t* out_len);
// returns 0 on success, nonzero on error (2 bad channel count, 3 out of
// memory, 4 encoder error, 5 output over out_cap). Every row takes the
// Sub filter, compressed at `level`.
//
// Built against libpng (+ zlib) by default. With S2SR_PNG_ZLIB_ONLY it
// writes the same IHDR/IDAT/IEND chunks with zlib alone (compress2 at
// `level`, one IDAT), for a machine without libpng's headers:
//   const char* s2sr_png_backend(void);   // "libpng" or "zlib"

#include <cstdint>
#include <cstring>
#include <vector>

#ifndef S2SR_PNG_ZLIB_ONLY
#include <png.h>

namespace {

struct MemSink {
  uint8_t* buf;
  size_t cap;
  size_t len;
  bool overflow;
};

void write_cb(png_structp png, png_bytep data, png_size_t length) {
  MemSink* sink = static_cast<MemSink*>(png_get_io_ptr(png));
  if (sink->len + length > sink->cap) {
    sink->overflow = true;
    return;
  }
  std::memcpy(sink->buf + sink->len, data, length);
  sink->len += length;
}

void flush_cb(png_structp) {}

}  // namespace

extern "C" const char* s2sr_png_backend(void) { return "libpng"; }

extern "C" int s2sr_png_encode(const uint8_t* data, int height, int width,
                               int channels, int level, uint8_t* out,
                               size_t out_cap, size_t* out_len) {
  int color_type;
  switch (channels) {
    case 1: color_type = PNG_COLOR_TYPE_GRAY; break;
    case 2: color_type = PNG_COLOR_TYPE_GRAY_ALPHA; break;
    case 3: color_type = PNG_COLOR_TYPE_RGB; break;
    case 4: color_type = PNG_COLOR_TYPE_RGBA; break;
    default: return 2;
  }

  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING,
                                            nullptr, nullptr, nullptr);
  if (!png) return 3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return 3;
  }
  MemSink sink{out, out_cap, 0, false};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return 4;
  }
  png_set_write_fn(png, &sink, write_cb, flush_cb);
  png_set_compression_level(png, level);
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, color_type,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  std::vector<png_bytep> rows(height);
  const size_t stride = static_cast<size_t>(width) * channels;
  for (int y = 0; y < height; ++y) {
    rows[y] = const_cast<png_bytep>(data + y * stride);
  }
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  if (sink.overflow) return 5;
  *out_len = sink.len;
  return 0;
}

#else  // S2SR_PNG_ZLIB_ONLY

#include <zlib.h>

namespace {

void put32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

// A chunk whose payload is already at p + 8: length, tag, CRC.
size_t seal_chunk(uint8_t* p, const char* tag, size_t n) {
  put32(p, static_cast<uint32_t>(n));
  std::memcpy(p + 4, tag, 4);
  put32(p + 8 + n, static_cast<uint32_t>(
      crc32(0, p + 4, static_cast<unsigned>(n + 4))));
  return n + 12;
}

}  // namespace

extern "C" const char* s2sr_png_backend(void) { return "zlib"; }

extern "C" int s2sr_png_encode(const uint8_t* data, int height, int width,
                               int channels, int level, uint8_t* out,
                               size_t out_cap, size_t* out_len) {
  static const uint8_t kColorType[5] = {0, 0, 4, 2, 6};
  if (channels < 1 || channels > 4) return 2;
  const size_t stride = static_cast<size_t>(width) * channels;
  std::vector<uint8_t> raw;
  try {
    raw.resize(static_cast<size_t>(height) * (stride + 1));
  } catch (...) {
    return 3;
  }
  for (int y = 0; y < height; ++y) {  // filter 1 (Sub) on every row
    const uint8_t* src = data + y * stride;
    uint8_t* dst = raw.data() + y * (stride + 1);
    dst[0] = 1;
    for (size_t i = 0; i < stride; ++i) {
      dst[1 + i] = static_cast<uint8_t>(
          src[i] - (i >= static_cast<size_t>(channels) ? src[i - channels] : 0));
    }
  }
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  const size_t head = 8 + 25;  // signature, IHDR
  if (out_cap < head + 12 + 12) return 5;
  std::memcpy(out, kSig, 8);
  uint8_t* ihdr = out + 8;
  put32(ihdr + 8, static_cast<uint32_t>(width));
  put32(ihdr + 12, static_cast<uint32_t>(height));
  ihdr[16] = 8;
  ihdr[17] = kColorType[channels];
  ihdr[18] = ihdr[19] = ihdr[20] = 0;
  seal_chunk(ihdr, "IHDR", 13);
  uLong zlen = out_cap - head - 12 - 12;
  if (compress2(out + head + 8, &zlen, raw.data(), raw.size(), level) != Z_OK)
    return 5;
  size_t len = head + seal_chunk(out + head, "IDAT", zlen);
  len += seal_chunk(out + len, "IEND", 0);
  *out_len = len;
  return 0;
}

#endif  // S2SR_PNG_ZLIB_ONLY
