// Native clip-decode library of unigeo_tpu_torch (built on first use, see __init__.py).
//
// Replaces the reference's per-frame PIL decode loop (the host-side hot loop,
// SURVEY.md §3.2: per-frame PNG/webp/jpg decode inside Dataset.__getitem__)
// with one C call per clip: every frame of a clip is decoded by a thread pool
// directly into the caller's preallocated numpy buffer in the layout the
// pipeline wants ([N,3,H,W] float32 0..255 for RGB, [N,H,W] float32 meters
// for depth), so no intermediate PIL objects, no per-frame Python dispatch,
// and no HWC->CHW numpy passes.
//
// Codecs: libpng (8-bit color via the simplified API; 16-bit grayscale depth
// via the full API with raw values — no gamma/linear-light transforms),
// libjpeg, libwebp.  Format is sniffed from magic bytes, not the extension.
//
// C ABI only (consumed via ctypes).  All functions return 0 on success or a
// negative UG_ERR_* code; batch calls return the first error encountered.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <png.h>
#include <csetjmp>
extern "C" {
#include <jpeglib.h>
}
#include <webp/decode.h>

namespace {

enum UgErr {
  UG_OK = 0,
  UG_ERR_OPEN = -1,      // cannot open file
  UG_ERR_FORMAT = -2,    // unknown magic / unsupported encoding
  UG_ERR_DECODE = -3,    // codec failure
  UG_ERR_SHAPE = -4,     // decoded dims != expected dims
  UG_ERR_DEPTHFMT = -5,  // depth file is not 8/16-bit grayscale
};

struct Blob {
  std::vector<uint8_t> data;
};

int read_file(const char* path, Blob* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return UG_ERR_OPEN;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    fclose(f);
    return UG_ERR_OPEN;
  }
  out->data.resize(static_cast<size_t>(size));
  size_t got = fread(out->data.data(), 1, out->data.size(), f);
  fclose(f);
  return got == out->data.size() ? UG_OK : UG_ERR_OPEN;
}

enum Format { FMT_PNG, FMT_JPEG, FMT_WEBP, FMT_UNKNOWN };

Format sniff(const uint8_t* p, size_t n) {
  if (n >= 8 && p[0] == 0x89 && p[1] == 'P' && p[2] == 'N' && p[3] == 'G')
    return FMT_PNG;
  if (n >= 3 && p[0] == 0xFF && p[1] == 0xD8 && p[2] == 0xFF) return FMT_JPEG;
  if (n >= 12 && !memcmp(p, "RIFF", 4) && !memcmp(p + 8, "WEBP", 4))
    return FMT_WEBP;
  return FMT_UNKNOWN;
}

// ---------------------------------------------------------------------------
// RGB8 decode (any supported codec) into a caller-sized HWC buffer.
// ---------------------------------------------------------------------------

int decode_png_rgb8(const Blob& blob, uint8_t* out, int h, int w) {
  png_image img;
  memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, blob.data.data(),
                                        blob.data.size()))
    return UG_ERR_DECODE;
  if (static_cast<int>(img.height) != h || static_cast<int>(img.width) != w) {
    png_image_free(&img);
    return UG_ERR_SHAPE;
  }
  img.format = PNG_FORMAT_RGB;  // palette/gray/alpha all normalized to RGB
  if (!png_image_finish_read(&img, nullptr, out, /*row_stride=*/w * 3,
                             nullptr)) {
    png_image_free(&img);
    return UG_ERR_DECODE;
  }
  return UG_OK;
}

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int decode_jpeg_rgb8(const Blob& blob, uint8_t* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return UG_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob.data.data()),
               blob.data.size());
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return UG_ERR_SHAPE;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return UG_OK;
}

int decode_webp_rgb8(const Blob& blob, uint8_t* out, int h, int w) {
  int ww = 0, hh = 0;
  if (!WebPGetInfo(blob.data.data(), blob.data.size(), &ww, &hh))
    return UG_ERR_DECODE;
  if (hh != h || ww != w) return UG_ERR_SHAPE;
  size_t out_size = static_cast<size_t>(h) * w * 3;
  if (!WebPDecodeRGBInto(blob.data.data(), blob.data.size(), out, out_size,
                         w * 3))
    return UG_ERR_DECODE;
  return UG_OK;
}

int decode_rgb8(const char* path, uint8_t* out, int h, int w) {
  Blob blob;
  int rc = read_file(path, &blob);
  if (rc != UG_OK) return rc;
  switch (sniff(blob.data.data(), blob.data.size())) {
    case FMT_PNG:
      return decode_png_rgb8(blob, out, h, w);
    case FMT_JPEG:
      return decode_jpeg_rgb8(blob, out, h, w);
    case FMT_WEBP:
      return decode_webp_rgb8(blob, out, h, w);
    default:
      return UG_ERR_FORMAT;
  }
}

// ---------------------------------------------------------------------------
// Depth decode: 16-bit (or 8-bit) grayscale PNG, RAW sample values — the full
// libpng API, because the simplified API applies linear-light scaling to
// 16-bit reads, which would corrupt millimeter depth codes.
// ---------------------------------------------------------------------------

struct PngMemReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngMemReader* r = static_cast<PngMemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->size) png_error(png, "read past end");
  memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

int decode_png_gray_raw(const Blob& blob, uint16_t* out, int h, int w,
                        int* bit_depth_out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return UG_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return UG_ERR_DECODE;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return UG_ERR_DECODE;
  }
  PngMemReader reader{blob.data.data(), blob.data.size(), 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  int color_type = png_get_color_type(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int hh = png_get_image_height(png, info);
  int ww = png_get_image_width(png, info);
  if (hh != h || ww != w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return UG_ERR_SHAPE;
  }
  if (color_type != PNG_COLOR_TYPE_GRAY || (bit_depth != 8 && bit_depth != 16)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return UG_ERR_DEPTHFMT;
  }
  if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian; x86 is not
  png_read_update_info(png, info);

  // png_read_image handles Adam7 interlacing internally (a manual
  // png_read_row loop over h rows would silently return pass-1 garbage
  // for interlaced files)
  const size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> pixels(rowbytes * static_cast<size_t>(h));
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = pixels.data() + rowbytes * y;
  png_read_image(png, rows.data());
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rows[y];
    if (bit_depth == 16) {
      memcpy(out + static_cast<size_t>(y) * w, src,
             static_cast<size_t>(w) * 2);
    } else {
      for (int x = 0; x < w; ++x)
        out[static_cast<size_t>(y) * w + x] = src[x];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  *bit_depth_out = bit_depth;
  return UG_OK;
}

// ---------------------------------------------------------------------------
// Thread pool: one atomic work index over the clip's frames.
// ---------------------------------------------------------------------------

template <typename Fn>
int parallel_frames(int n, int nthreads, Fn fn) {
  if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads <= 0) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0);
  std::atomic<int> err(UG_OK);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != UG_OK) break;
      int rc = fn(i);
      if (rc != UG_OK) {
        int expected = UG_OK;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

}  // namespace

// ---------------------------------------------------------------------------
// Public C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Probe dims/kind without decoding pixels.  kind: 0=png8, 1=jpeg, 2=webp,
// 3=png16-gray.  Returns UG_ERR_* on failure.  Header-only: reads a small
// bounded prefix of the file (growing only if a JPEG buries its SOF behind
// large APPn segments), never the whole blob — this runs once per clip
// decode to size the output buffer.
int ug_image_info(const char* path, int32_t* h, int32_t* w, int32_t* kind) {
  FILE* f = fopen(path, "rb");
  if (!f) return UG_ERR_OPEN;
  std::vector<uint8_t> buf;
  size_t want = 4096;
  auto fill = [&](size_t target) {
    size_t had = buf.size();
    if (target <= had) return;
    buf.resize(target);
    size_t got = fread(buf.data() + had, 1, target - had, f);
    buf.resize(had + got);
  };
  fill(want);
  if (buf.size() < 12) {
    fclose(f);
    return UG_ERR_FORMAT;
  }
  int rc = UG_ERR_FORMAT;
  switch (sniff(buf.data(), buf.size())) {
    case FMT_PNG: {
      // IHDR is always the first chunk: width/height big-endian at 16/20,
      // bit depth at 24, color type at 25 (PNG spec §11.2.2)
      if (buf.size() >= 26 && !memcmp(buf.data() + 12, "IHDR", 4)) {
        auto be32 = [&](size_t o) {
          return (uint32_t(buf[o]) << 24) | (uint32_t(buf[o + 1]) << 16) |
                 (uint32_t(buf[o + 2]) << 8) | uint32_t(buf[o + 3]);
        };
        *w = static_cast<int32_t>(be32(16));
        *h = static_cast<int32_t>(be32(20));
        *kind = (buf[24] == 16) ? 3 : 0;
        rc = UG_OK;
      } else {
        rc = UG_ERR_DECODE;
      }
      break;
    }
    case FMT_JPEG: {
      // scan marker segments for SOFn (dims live in its payload); APPn/COM
      // segments are skipped via their length fields
      rc = UG_ERR_DECODE;
      size_t pos = 2;
      for (;;) {
        fill(pos + 10);
        if (pos + 4 > buf.size()) break;            // truncated
        if (buf[pos] != 0xFF) break;                 // marker desync
        uint8_t m = buf[pos + 1];
        if (m == 0xFF) {  // fill bytes
          ++pos;
          continue;
        }
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD9)) {  // standalone markers
          pos += 2;
          continue;
        }
        size_t seg = (size_t(buf[pos + 2]) << 8) | buf[pos + 3];
        bool is_sof = (m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                      m != 0xCC;
        if (is_sof) {
          fill(pos + 9);
          if (pos + 9 <= buf.size()) {
            *h = (int32_t(buf[pos + 5]) << 8) | buf[pos + 6];
            *w = (int32_t(buf[pos + 7]) << 8) | buf[pos + 8];
            *kind = 1;
            rc = UG_OK;
          }
          break;
        }
        if (m == 0xDA) break;  // start of scan without SOF: malformed
        pos += 2 + seg;
      }
      break;
    }
    case FMT_WEBP: {
      // all WebP variants (VP8/VP8L/VP8X) carry dims in the first 30 bytes
      fill(64);
      int ww = 0, hh = 0;
      if (WebPGetInfo(buf.data(), buf.size(), &ww, &hh)) {
        *h = hh;
        *w = ww;
        *kind = 2;
        rc = UG_OK;
      } else {
        rc = UG_ERR_DECODE;
      }
      break;
    }
    default:
      rc = UG_ERR_FORMAT;
  }
  fclose(f);
  return rc;
}

// Decode one RGB image to interleaved u8 HWC (caller allocates h*w*3).
int ug_decode_rgb8(const char* path, uint8_t* out, int32_t h, int32_t w) {
  return decode_rgb8(path, out, h, w);
}

// Decode one 8/16-bit grayscale PNG to u16 raw codes (caller allocates h*w).
int ug_decode_gray16(const char* path, uint16_t* out, int32_t h, int32_t w) {
  Blob blob;
  int rc = read_file(path, &blob);
  if (rc != UG_OK) return rc;
  if (sniff(blob.data.data(), blob.data.size()) != FMT_PNG)
    return UG_ERR_FORMAT;
  int bits = 0;
  return decode_png_gray_raw(blob, out, h, w, &bits);
}

// Decode a clip of n same-sized RGB frames into [n,3,h,w] float32 0..255
// (planar CHW per frame — the unified sample contract's image layout),
// decoding frames in parallel.
int ug_decode_clip_rgb_f32(const char** paths, int32_t n, int32_t h, int32_t w,
                           float* out, int32_t nthreads) {
  const size_t plane = static_cast<size_t>(h) * w;
  return parallel_frames(n, nthreads, [&](int i) -> int {
    std::vector<uint8_t> hwc(plane * 3);
    int rc = decode_rgb8(paths[i], hwc.data(), h, w);
    if (rc != UG_OK) return rc;
    float* dst = out + static_cast<size_t>(i) * plane * 3;
    // HWC u8 -> CHW f32
    for (size_t p = 0; p < plane; ++p) {
      dst[p] = hwc[p * 3];
      dst[plane + p] = hwc[p * 3 + 1];
      dst[2 * plane + p] = hwc[p * 3 + 2];
    }
    return UG_OK;
  });
}

// Decode a clip of n grayscale PNG depth frames into [n,h,w] float32, with
// raw codes divided by `scale` (e.g. 1000 for mm, 5000 for TUM).
int ug_decode_clip_depth_f32(const char** paths, int32_t n, int32_t h,
                             int32_t w, float scale, float* out,
                             int32_t nthreads) {
  const size_t plane = static_cast<size_t>(h) * w;
  return parallel_frames(n, nthreads, [&](int i) -> int {
    std::vector<uint16_t> raw(plane);
    Blob blob;
    int rc = read_file(paths[i], &blob);
    if (rc != UG_OK) return rc;
    if (sniff(blob.data.data(), blob.data.size()) != FMT_PNG)
      return UG_ERR_FORMAT;
    int bits = 0;
    rc = decode_png_gray_raw(blob, raw.data(), h, w, &bits);
    if (rc != UG_OK) return rc;
    float* dst = out + static_cast<size_t>(i) * plane;
    // IEEE divide, not multiply-by-reciprocal: must match numpy's
    // ``array / scale`` bit-for-bit (the reciprocal differs in the last
    // ulp for ~30% of codes)
    for (size_t p = 0; p < plane; ++p) dst[p] = raw[p] / scale;
    return UG_OK;
  });
}

// Decode a clip of n RGB-coded normal maps into [n,3,h,w] float32 in [-1,1]
// with the reference's zero-pixel invalid masking (all u8 channels == 0 →
// the output vector is zeroed; reference scannetpp.py:115-122).
int ug_decode_clip_normal_f32(const char** paths, int32_t n, int32_t h,
                              int32_t w, float* out, int32_t nthreads) {
  const size_t plane = static_cast<size_t>(h) * w;
  return parallel_frames(n, nthreads, [&](int i) -> int {
    std::vector<uint8_t> hwc(plane * 3);
    int rc = decode_rgb8(paths[i], hwc.data(), h, w);
    if (rc != UG_OK) return rc;
    float* dst = out + static_cast<size_t>(i) * plane * 3;
    // exact operation order of the python path (raw/255*2-1, float32 at
    // every step) so the arrays match bit-for-bit
    auto conv = [](uint8_t v) { return v / 255.0f * 2.0f - 1.0f; };
    for (size_t p = 0; p < plane; ++p) {
      uint8_t r = hwc[p * 3], g = hwc[p * 3 + 1], b = hwc[p * 3 + 2];
      if (r == 0 && g == 0 && b == 0) {
        dst[p] = dst[plane + p] = dst[2 * plane + p] = 0.0f;
      } else {
        dst[p] = conv(r);
        dst[plane + p] = conv(g);
        dst[2 * plane + p] = conv(b);
      }
    }
    return UG_OK;
  });
}

}  // extern "C"
