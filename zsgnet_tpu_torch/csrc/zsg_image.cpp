// zsg_image — the host image pipeline of zsgnet_tpu_torch.
//
// The input path's host stage (decode → resize → normalize) as native
// code, so a loader thread pays no per-pixel Python:
//
//   * PNG decode (8-bit gray / RGB / RGBA / palette, non-interlaced) on
//     zlib inflate — no image library dependency;
//   * Pillow-algorithm bilinear resampling (separable triangle filter
//     with support scaled by the downscale factor, matching
//     PIL.Image.resize(..., BILINEAR) to ≤2/255 per channel) so native
//     and PIL paths are interchangeable mid-dataset;
//   * ImageNet mean/std normalization to float32 NHWC.
//
// Exposed as a C ABI consumed via ctypes (zsgnet_tpu_torch/data/native.py,
// which builds it with g++ at first use). JPEG and exotic PNGs fall back
// to PIL. The decode, resample and normalize code is the same as the JAX
// package's csrc/zsg_image.cpp, so both libraries give the same bytes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

#include <zlib.h>

// JPEG decode rides the system libjpeg when present (ZSG_USE_JPEG set by
// native.py iff jpeglib.h exists); PIL uses the same library, so the
// two paths produce identical RGB bytes. Absent the header, JPEG files
// simply fall back to PIL (return code -2).
#ifdef ZSG_USE_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif

namespace {

constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Unfilter one scanline in place. prev may be null for the first row.
void unfilter(uint8_t filter, uint8_t* row, const uint8_t* prev, size_t len,
              int bpp) {
  switch (filter) {
    case 0:
      break;
    case 1:  // Sub
      for (size_t i = bpp; i < len; ++i) row[i] += row[i - bpp];
      break;
    case 2:  // Up
      if (prev)
        for (size_t i = 0; i < len; ++i) row[i] += prev[i];
      break;
    case 3:  // Average
      for (size_t i = 0; i < len; ++i) {
        int a = (i >= size_t(bpp)) ? row[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        row[i] += uint8_t((a + b) >> 1);
      }
      break;
    case 4:  // Paeth
      for (size_t i = 0; i < len; ++i) {
        int a = (i >= size_t(bpp)) ? row[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        int c = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
        row[i] += uint8_t(paeth(a, b, c));
      }
      break;
    default:
      break;
  }
}

struct Coeff {
  int xmin;
  int n;
  std::vector<double> w;
};

// Pillow's precompute_coeffs for the triangle (bilinear) filter.
std::vector<Coeff> bilinear_coeffs(int in_size, int out_size) {
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // triangle support = 1
  std::vector<Coeff> out(out_size);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = int(std::max(0.0, std::floor(center - support)));
    int xmax = int(std::min(double(in_size), std::ceil(center + support)));
    Coeff c;
    c.xmin = xmin;
    c.n = xmax - xmin;
    c.w.resize(c.n);
    double total = 0.0;
    for (int x = 0; x < c.n; ++x) {
      double t = (x + xmin - center + 0.5) / filterscale;
      double v = (t < 0) ? -t : t;
      double weight = v < 1.0 ? 1.0 - v : 0.0;
      c.w[x] = weight;
      total += weight;
    }
    if (total > 0)
      for (auto& w : c.w) w /= total;
    out[xx] = std::move(c);
  }
  return out;
}

}  // namespace

extern "C" {

// Decode an 8-bit non-interlaced PNG to interleaved RGB (alpha dropped,
// gray broadcast, palette expanded). *out_rgb is malloc'd; caller frees
// with zsg_free. Returns 0 on success, negative error codes otherwise.
int zsg_png_decode(const uint8_t* data, size_t n, uint8_t** out_rgb,
                   int* out_h, int* out_w) {
  if (n < 8 || std::memcmp(data, kPngSig, 8) != 0) return -1;  // not a PNG
  size_t off = 8;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  while (off + 8 <= n) {
    uint32_t len = be32(data + off);
    const uint8_t* type = data + off + 4;
    const uint8_t* body = data + off + 8;
    if (off + 12 + len > n) return -2;  // truncated
    if (!std::memcmp(type, "IHDR", 4)) {
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!std::memcmp(type, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (!width || !height || bit_depth != 8 || interlace != 0) return -3;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // RGB
    case 3: channels = 1; break;  // palette index
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // RGBA
    default: return -3;
  }
  if (color_type == 3 && palette.empty()) return -3;

  size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw(height * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return -4;  // inflate failure

  uint8_t* rgb = static_cast<uint8_t*>(
      std::malloc(size_t(width) * height * 3));
  if (!rgb) return -5;
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < height; ++y) {
    uint8_t* row = raw.data() + y * (stride + 1);
    uint8_t filter = row[0];
    uint8_t* px = row + 1;
    unfilter(filter, px, prev, stride, channels);
    prev = px;
    uint8_t* dst = rgb + size_t(y) * width * 3;
    for (uint32_t x = 0; x < width; ++x) {
      const uint8_t* s = px + size_t(x) * channels;
      switch (color_type) {
        case 0: dst[0] = dst[1] = dst[2] = s[0]; break;
        case 2: dst[0] = s[0]; dst[1] = s[1]; dst[2] = s[2]; break;
        case 3: {
          size_t pi = size_t(s[0]) * 3;
          if (pi + 2 >= palette.size()) { std::free(rgb); return -3; }
          dst[0] = palette[pi]; dst[1] = palette[pi + 1]; dst[2] = palette[pi + 2];
          break;
        }
        case 4: dst[0] = dst[1] = dst[2] = s[0]; break;
        case 6: dst[0] = s[0]; dst[1] = s[1]; dst[2] = s[2]; break;
      }
      dst += 3;
    }
  }
  *out_rgb = rgb;
  *out_h = int(height);
  *out_w = int(width);
  return 0;
}

// Pillow-style bilinear resize of interleaved RGB + per-channel
// normalization: out[y,x,c] = (resized/255 - mean[c]) / std[c], float32
// HWC. Two separable passes in double precision.
int zsg_resize_normalize_rgb(const uint8_t* rgb, int h, int w, int out_h,
                             int out_w, const float* mean, const float* stdv,
                             float* out) {
  if (h <= 0 || w <= 0 || out_h <= 0 || out_w <= 0) return -1;
  auto xc = bilinear_coeffs(w, out_w);
  auto yc = bilinear_coeffs(h, out_h);

  // Horizontal pass: (h, w, 3) u8 → (h, out_w, 3) double.
  std::vector<double> tmp(size_t(h) * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb + size_t(y) * w * 3;
    double* dst = tmp.data() + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const Coeff& c = xc[x];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < c.n; ++k) {
        const uint8_t* s = src + size_t(c.xmin + k) * 3;
        double wgt = c.w[k];
        acc[0] += wgt * s[0];
        acc[1] += wgt * s[1];
        acc[2] += wgt * s[2];
      }
      dst[x * 3 + 0] = acc[0];
      dst[x * 3 + 1] = acc[1];
      dst[x * 3 + 2] = acc[2];
    }
  }
  // Vertical pass + normalize: → (out_h, out_w, 3) float32.
  double inv255 = 1.0 / 255.0;
  for (int y = 0; y < out_h; ++y) {
    const Coeff& c = yc[y];
    float* dst = out + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < c.n; ++k) {
        const double* s = tmp.data() + (size_t(c.xmin + k) * out_w + x) * 3;
        double wgt = c.w[k];
        acc[0] += wgt * s[0];
        acc[1] += wgt * s[1];
        acc[2] += wgt * s[2];
      }
      for (int ch = 0; ch < 3; ++ch)
        dst[x * 3 + ch] =
            float((acc[ch] * inv255 - mean[ch]) / stdv[ch]);
    }
  }
  return 0;
}

// Pillow-style bilinear resize to uint8 (Pillow's rounding: +0.5
// truncate, clamped). Used by the normalize-on-device input path: the
// host ships uint8 (4x less transfer); the model normalizes it on the
// device.
int zsg_resize_u8(const uint8_t* rgb, int h, int w, int out_h, int out_w,
                  uint8_t* out) {
  if (h <= 0 || w <= 0 || out_h <= 0 || out_w <= 0) return -1;
  auto xc = bilinear_coeffs(w, out_w);
  auto yc = bilinear_coeffs(h, out_h);
  std::vector<double> tmp(size_t(h) * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb + size_t(y) * w * 3;
    double* dst = tmp.data() + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const Coeff& c = xc[x];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < c.n; ++k) {
        const uint8_t* s = src + size_t(c.xmin + k) * 3;
        double wgt = c.w[k];
        acc[0] += wgt * s[0];
        acc[1] += wgt * s[1];
        acc[2] += wgt * s[2];
      }
      dst[x * 3 + 0] = acc[0];
      dst[x * 3 + 1] = acc[1];
      dst[x * 3 + 2] = acc[2];
    }
  }
  for (int y = 0; y < out_h; ++y) {
    const Coeff& c = yc[y];
    uint8_t* dst = out + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < c.n; ++k) {
        const double* s = tmp.data() + (size_t(c.xmin + k) * out_w + x) * 3;
        double wgt = c.w[k];
        acc[0] += wgt * s[0];
        acc[1] += wgt * s[1];
        acc[2] += wgt * s[2];
      }
      for (int ch = 0; ch < 3; ++ch) {
        double v = acc[ch] + 0.5;
        dst[x * 3 + ch] =
            uint8_t(v < 0 ? 0 : (v > 255 ? 255 : int(v)));
      }
    }
  }
  return 0;
}

#ifdef ZSG_USE_JPEG
namespace {
struct ZsgJpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};
void zsg_jpeg_error_exit(j_common_ptr cinfo) {
  ZsgJpegErr* err = reinterpret_cast<ZsgJpegErr*>(cinfo->err);
  longjmp(err->jump, 1);  // corrupt stream → error return, not exit()
}
}  // namespace
#endif

// JPEG bytes → malloc'd RGB8 buffer. Returns 0 ok, -1 corrupt/unsupported,
// -2 compiled without libjpeg. Baseline+progressive, gray and YCbCr
// (anything libjpeg can emit as 1- or 3-component output); CMYK → -1
// (PIL fallback).
int zsg_jpeg_decode(const uint8_t* data, size_t n, uint8_t** out_rgb,
                    int* out_h, int* out_w) {
#ifndef ZSG_USE_JPEG
  (void)data; (void)n; (void)out_rgb; (void)out_h; (void)out_w;
  return -2;
#else
  jpeg_decompress_struct cinfo;
  ZsgJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = zsg_jpeg_error_exit;
  // volatile: modified after setjmp and read in the longjmp handler —
  // without it the value is indeterminate there (C11 7.13.2.1) and the
  // decode buffer leaks when libjpeg errors mid-scanline.
  uint8_t* volatile rgb = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(rgb);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(n));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg upsamples gray→RGB for us
  jpeg_start_decompress(&cinfo);
  const int w = int(cinfo.output_width), h = int(cinfo.output_height);
  if (cinfo.output_components != 3 || w <= 0 || h <= 0) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  rgb = static_cast<uint8_t*>(std::malloc(size_t(h) * w * 3));
  if (!rgb) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_rgb = rgb;
  *out_h = h;
  *out_w = w;
  return 0;
#endif
}

int zsg_has_jpeg(void) {
#ifdef ZSG_USE_JPEG
  return 1;
#else
  return 0;
#endif
}

// Format-sniffing decode: PNG signature or JPEG SOI → the right decoder.
static int zsg_image_decode(const uint8_t* data, size_t n, uint8_t** out_rgb,
                            int* out_h, int* out_w) {
  if (n >= 8 && std::memcmp(data, kPngSig, 8) == 0)
    return zsg_png_decode(data, n, out_rgb, out_h, out_w);
  if (n >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return zsg_jpeg_decode(data, n, out_rgb, out_h, out_w);
  return -1;
}

// One-shot: PNG/JPEG bytes → resized uint8 (out_h, out_w, 3) + original
// size. Sniffs the container from the magic bytes.
int zsg_image_load_u8(const uint8_t* data, size_t n, int out_h, int out_w,
                      uint8_t* out, int* orig_h, int* orig_w) {
  uint8_t* rgb = nullptr;
  int h = 0, w = 0;
  int rc = zsg_image_decode(data, n, &rgb, &h, &w);
  if (rc != 0) return rc;
  rc = zsg_resize_u8(rgb, h, w, out_h, out_w, out);
  std::free(rgb);
  if (rc != 0) return rc;
  *orig_h = h;
  *orig_w = w;
  return 0;
}

// One-shot: PNG/JPEG bytes → normalized float32 (out_h, out_w, 3) +
// original size. Sniffs the container from the magic bytes.
int zsg_image_load(const uint8_t* data, size_t n, int out_h, int out_w,
                   const float* mean, const float* stdv, float* out,
                   int* orig_h, int* orig_w) {
  uint8_t* rgb = nullptr;
  int h = 0, w = 0;
  int rc = zsg_image_decode(data, n, &rgb, &h, &w);
  if (rc != 0) return rc;
  rc = zsg_resize_normalize_rgb(rgb, h, w, out_h, out_w, mean, stdv, out);
  std::free(rgb);
  if (rc != 0) return rc;
  *orig_h = h;
  *orig_w = w;
  return 0;
}

// One-shot: PNG bytes → resized uint8 (out_h, out_w, 3) + original size.
int zsg_png_load_u8(const uint8_t* data, size_t n, int out_h, int out_w,
                    uint8_t* out, int* orig_h, int* orig_w) {
  uint8_t* rgb = nullptr;
  int h = 0, w = 0;
  int rc = zsg_png_decode(data, n, &rgb, &h, &w);
  if (rc != 0) return rc;
  rc = zsg_resize_u8(rgb, h, w, out_h, out_w, out);
  std::free(rgb);
  if (rc != 0) return rc;
  *orig_h = h;
  *orig_w = w;
  return 0;
}

// One-shot: PNG bytes → normalized float32 (out_h, out_w, 3) + original
// size. `out` must hold out_h*out_w*3 floats.
int zsg_png_load(const uint8_t* data, size_t n, int out_h, int out_w,
                 const float* mean, const float* stdv, float* out,
                 int* orig_h, int* orig_w) {
  uint8_t* rgb = nullptr;
  int h = 0, w = 0;
  int rc = zsg_png_decode(data, n, &rgb, &h, &w);
  if (rc != 0) return rc;
  rc = zsg_resize_normalize_rgb(rgb, h, w, out_h, out_w, mean, stdv, out);
  std::free(rgb);
  if (rc != 0) return rc;
  *orig_h = h;
  *orig_w = w;
  return 0;
}

void zsg_free(void* p) { std::free(p); }

}  // extern "C"
