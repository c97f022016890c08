// Native image decode and resize for the port's data layer
// (adaptersis_tpu_torch/data/native.py builds it with g++ at first use:
// -O3 -fPIC -std=c++17 -shared, -lpng -ljpeg -lpthread).
//
// The reference reads its datasets with PIL in DataLoader worker processes:
// decode, `.convert("RGB")`, then `resize(..., BILINEAR)` for frames and
// `resize(..., NEAREST)` for masks. This is the same thing bit for bit:
// libpng/libjpeg decode, Pillow's fixed-point triangle-filter resampling
// (a filter whose support scales with the downscale ratio, not the 2-tap
// GPU bilinear) and its nearest rule, plus a pthread batch filler, behind a
// C ABI read through ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

// ---------- PNG ----------
// want_gray: the caller is loading a LABEL MASK and PIL-parity means the RAW
// stored values (palette indices stay indices, like `Image.open` with no
// convert — tools/dataset.py:144 opens masks raw). Anything whose raw values
// can't be represented losslessly in uint8 (16-bit gray, true-RGB) is REFUSED
// so the Python caller falls back to PIL instead of silently training on
// transformed label ids.
bool decode_png(FILE* f, Image* out, bool want_gray) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return false; }
  if (setjmp(png_jmpbuf(png))) { png_destroy_read_struct(&png, &info, nullptr); return false; }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);
  if (want_gray) {
    bool ok = (color_type == PNG_COLOR_TYPE_PALETTE && bit_depth <= 8) ||
              (color_type == PNG_COLOR_TYPE_GRAY && bit_depth <= 8);
    if (!ok) { png_destroy_read_struct(&png, &info, nullptr); return false; }
    if (bit_depth < 8) png_set_packing(png);  // raw indices/levels, one byte each
  } else {
    if (bit_depth == 16) png_set_strip_16(png);
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  out->w = (int)w; out->h = (int)h; out->c = channels;
  out->data.resize((size_t)w * h * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++) rows[y] = out->data.data() + (size_t)y * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------- JPEG ----------
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};
void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out, bool want_gray) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return false; }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (want_gray) {
    // masks: only a natively-grayscale JPEG matches PIL's raw read; color→gray
    // conversion would alter label values → refuse, caller falls back
    if (cinfo.jpeg_color_space != JCS_GRAYSCALE) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = cinfo.output_components;
  out->data.resize((size_t)out->w * out->h * out->c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + (size_t)cinfo.output_scanline * out->w * out->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_file(const char* path, Image* out, bool want_gray) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) { fclose(f); return false; }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0x89 && magic[1] == 'P') ok = decode_png(f, out, want_gray);
  else if (magic[0] == 0xFF && magic[1] == 0xD8) ok = decode_jpeg(f, out, want_gray);
  fclose(f);
  return ok;
}

// ---------- PIL-exact triangle-filter resize (separable, fixed point) ----------
// Bit-exact reproduction of Pillow's ImagingResample 8bpc pipeline
// (src/libImaging/Resample.c): per-output-pixel bounds use the same +0.5
// truncation, coefficients are rounded to int32 with PRECISION_BITS = 22, and
// the horizontal pass quantizes to uint8 before the vertical pass — the
// intermediate rounding IS PIL's observable numerics.
constexpr int kPrecisionBits = 32 - 8 - 2;

struct FilterTable {
  int ksize = 0;
  std::vector<int> bounds;      // per output pixel: (xmin, n)
  std::vector<int32_t> kk;      // per output pixel: ksize fixed-point weights
};

FilterTable build_triangle(int in_size, int out_size) {
  FilterTable t;
  double scale = (double)in_size / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle support = 1
  double ss = 1.0 / filterscale;
  t.ksize = (int)std::ceil(support) * 2 + 1;
  t.bounds.resize((size_t)out_size * 2);
  std::vector<double> k(t.ksize);
  t.kk.assign((size_t)out_size * t.ksize, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int n = xmax - xmin;
    double ww = 0.0;
    for (int x = 0; x < n; x++) {
      double arg = (x + xmin - center + 0.5) * ss;
      double w = arg < 0 ? 1.0 + arg : 1.0 - arg;   // triangle
      if (w < 0) w = 0;
      k[x] = w * ss;
      ww += k[x];
    }
    for (int x = 0; x < n; x++) {
      if (ww != 0.0) k[x] /= ww;
      // Pillow normalize_coeffs_8bpc rounding
      t.kk[(size_t)xx * t.ksize + x] = (int32_t)(
          k[x] < 0 ? -0.5 + k[x] * (1 << kPrecisionBits)
                   : 0.5 + k[x] * (1 << kPrecisionBits));
    }
    t.bounds[xx * 2] = xmin;
    t.bounds[xx * 2 + 1] = n;
  }
  return t;
}

inline uint8_t clip8(int64_t in) {
  int64_t v = in >> kPrecisionBits;
  return (uint8_t)std::clamp<int64_t>(v, 0, 255);
}

void resize_bilinear_pil(const Image& src, int out_h, int out_w, uint8_t* dst) {
  FilterTable th = build_triangle(src.w, out_w);
  FilterTable tv = build_triangle(src.h, out_h);
  int c = src.c;
  // horizontal pass into a uint8 temp (src.h x out_w) — PIL quantizes here
  std::vector<uint8_t> tmp((size_t)src.h * out_w * c);
  for (int y = 0; y < src.h; y++) {
    const uint8_t* row = src.data.data() + (size_t)y * src.w * c;
    for (int x = 0; x < out_w; x++) {
      const int32_t* k = &th.kk[(size_t)x * th.ksize];
      int x0 = th.bounds[x * 2], n = th.bounds[x * 2 + 1];
      for (int ch = 0; ch < c; ch++) {
        int64_t acc = (int64_t)1 << (kPrecisionBits - 1);
        for (int i = 0; i < n; i++)
          acc += (int64_t)row[(size_t)(x0 + i) * c + ch] * k[i];
        tmp[((size_t)y * out_w + x) * c + ch] = clip8(acc);
      }
    }
  }
  // vertical pass
  for (int y = 0; y < out_h; y++) {
    const int32_t* k = &tv.kk[(size_t)y * tv.ksize];
    int y0 = tv.bounds[y * 2], n = tv.bounds[y * 2 + 1];
    for (int x = 0; x < out_w; x++) {
      for (int ch = 0; ch < c; ch++) {
        int64_t acc = (int64_t)1 << (kPrecisionBits - 1);
        for (int i = 0; i < n; i++)
          acc += (int64_t)tmp[((size_t)(y0 + i) * out_w + x) * c + ch] * k[i];
        dst[((size_t)y * out_w + x) * c + ch] = clip8(acc);
      }
    }
  }
}

void resize_nearest_pil(const Image& src, int out_h, int out_w, uint8_t* dst) {
  // Pillow's NEAREST (ImagingScaleAffine): the source coordinate of output
  // pixel x is (int) of a/2 + x·a accumulated in double, one addition of
  // a = in/out per pixel. The closed form (x + 0.5)·in/out differs from it
  // where that product is an integer and the running sum falls below it
  // (e.g. column 26 of 960 → 53).
  int c = src.c;
  double ax = (double)src.w / out_w, ay = (double)src.h / out_h;
  std::vector<int> xin(out_w);
  double xo = ax * 0.5;
  for (int x = 0; x < out_w; x++, xo += ax) xin[x] = std::min((int)xo, src.w - 1);
  double yo = ay * 0.5;
  for (int y = 0; y < out_h; y++, yo += ay) {
    int sy = std::min((int)yo, src.h - 1);
    for (int x = 0; x < out_w; x++) {
      memcpy(dst + ((size_t)y * out_w + x) * c,
             src.data.data() + ((size_t)sy * src.w + xin[x]) * c, c);
    }
  }
}

void to_rgb(Image* img) {
  if (img->c == 3) return;
  Image out;
  out.w = img->w; out.h = img->h; out.c = 3;
  out.data.resize((size_t)out.w * out.h * 3);
  for (size_t i = 0; i < (size_t)img->w * img->h; i++) {
    uint8_t g = img->data[i * img->c];
    out.data[i * 3] = out.data[i * 3 + 1] = out.data[i * 3 + 2] = g;
  }
  *img = std::move(out);
}

}  // namespace

extern "C" {

// Decode an image file to RGB (channels=3) or gray (channels=1), resized to
// (out_h, out_w) with resample 0=nearest, 1=PIL-bilinear. Returns 0 on success.
int asn_decode_resize(const char* path, int out_h, int out_w, int channels,
                      int resample, uint8_t* out) {
  Image img;
  if (!decode_file(path, &img, channels == 1)) return 1;
  if (channels == 3) to_rgb(&img);
  else if (img.c != 1) return 1;  // masks must arrive single-channel raw
  if (out_h == img.h && out_w == img.w) {
    memcpy(out, img.data.data(), img.data.size());
    return 0;
  }
  if (resample == 1) resize_bilinear_pil(img, out_h, out_w, out);
  else resize_nearest_pil(img, out_h, out_w, out);
  return 0;
}

// Fill a contiguous (n, out_h, out_w, channels) batch from n files with a thread
// pool (the native replacement for torch DataLoader workers). Returns the number
// of failed decodes.
int asn_batch_load(const char** paths, int n, int out_h, int out_w, int channels,
                   int resample, uint8_t* out_batch, int n_threads) {
  std::atomic<int> next(0), failures(0);
  size_t stride = (size_t)out_h * out_w * channels;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (asn_decode_resize(paths[i], out_h, out_w, channels, resample,
                            out_batch + (size_t)i * stride) != 0)
        failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; i++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

int asn_version() { return 1; }
}
