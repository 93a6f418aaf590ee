// mstgan_native — native runtime components for the style-transfer
// framework.
//
// The reference project's "runtime" is per-image Python/PIL work inside its
// batch loop (batch_process_images.py:186-238 and the dataset transform,
// pretrain.py:32-37). This library is the native equivalent: the full
// host side of the batch pipeline as native code —
//
//   input:  JPEG/PNG decode -> Lanczos-3 resize -> centered canvas paste,
//           filling uint8 batches for the device without per-image Python.
//           JPEGs use libjpeg-turbo DCT-domain scaled decode (scale_num/8
//           chosen so the IDCT emits the smallest image >= the target), so
//           most of the inverse-DCT + color-convert work never happens —
//           the dominant decode cost on this single-core deployment host.
//   output: aspect-crop (batch_process_images.py:412-438 semantics) ->
//           Lanczos resize back to source size when <= 1MP -> JPEG/PNG
//           encode + save, again batched behind one C call.
//
// Plus the felzenszwalb segmentation inner loop (union-find over sorted
// edges), the host-side hot spot of the local-style pipeline.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 mstgan_native.cpp
//        -o libmstgan_native.so -ljpeg -lpng -lpthread

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct Image {
  int w = 0, h = 0;          // decoded (possibly DCT-scaled) dimensions
  int full_w = 0, full_h = 0;  // source dimensions from the header
  std::vector<uint8_t> rgb;  // h*w*3
  bool ok = false;
};

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_err_silent(j_common_ptr, int) {}

// target_w/target_h: the post-resize dims this image is headed for (0 = no
// scaling hint, full decode). The decoder picks the smallest DCT scale
// (num/8, num in 1..8) whose output still covers the target, so the
// Lanczos pass downstream sees the fewest possible pixels. This is exactly
// PIL's Image.draft() strategy; the subsequent Lanczos resample supplies
// the anti-aliasing the 8x8-block DCT scaling lacks.
Image decode_jpeg_mem(const uint8_t* buf, size_t len, int target_w,
                      int target_h) {
  Image out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_err_silent;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  out.full_w = cinfo.image_width;
  out.full_h = cinfo.image_height;
  if (target_w > 0 && target_h > 0) {
    int num = 8;
    for (int s = 1; s < 8; ++s) {
      long sw = (long(cinfo.image_width) * s + 7) / 8;
      long sh = (long(cinfo.image_height) * s + 7) / 8;
      if (sw >= target_w && sh >= target_h) {
        num = s;
        break;
      }
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  out.w = cinfo.output_width;
  out.h = cinfo.output_height;
  out.rgb.resize(size_t(out.w) * out.h * 3);
  // hand libjpeg as many row pointers as it will fill per call
  std::vector<JSAMPROW> rows(cinfo.rec_outbuf_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    int base = cinfo.output_scanline;
    int avail = std::min<int>(rows.size(), cinfo.output_height - base);
    for (int r = 0; r < avail; ++r)
      rows[r] = out.rgb.data() + size_t(base + r) * out.w * 3;
    jpeg_read_scanlines(&cinfo, rows.data(), avail);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}

Image decode_png(FILE* f) {
  Image out;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return out;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return out;
  }
  // constructed BEFORE setjmp: longjmp past a vector's initialization is
  // UB and leaks its buffer; constructed-then-jumped-over objects in scope
  // are destroyed on the normal return below.
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return out;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  // force 8-bit RGB
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (png_get_bit_depth(png, info) == 16) png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out.w = png_get_image_width(png, info);
  out.h = png_get_image_height(png, info);
  out.full_w = out.w;
  out.full_h = out.h;
  out.rgb.resize(size_t(out.w) * out.h * 3);
  rows.resize(out.h);
  for (int y = 0; y < out.h; ++y)
    rows[y] = out.rgb.data() + size_t(y) * out.w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  out.ok = true;
  return out;
}

// canvas > 0 enables the scaled-decode hint for JPEGs: the aspect-fit
// target dims are computed from the header before any pixels are decoded.
Image decode_file(const char* path, int canvas) {
  Image out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    // slurp whole file -> jpeg_mem_src (no stdio callback per MCU row)
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    rewind(f);
    std::vector<uint8_t> buf(std::max(sz, 0L));
    if (sz > 0 && fread(buf.data(), 1, sz, f) != size_t(sz)) {
      fclose(f);
      return out;
    }
    fclose(f);
    int tw = 0, th = 0;
    if (canvas > 0 && sz > 4) {
      // peek dims cheaply with a header-only pass to compute the target
      jpeg_decompress_struct ci;
      JpegErr je;
      ci.err = jpeg_std_error(&je.pub);
      je.pub.error_exit = jpeg_err_exit;
      je.pub.emit_message = jpeg_err_silent;
      if (!setjmp(je.jump)) {
        jpeg_create_decompress(&ci);
        jpeg_mem_src(&ci, buf.data(), static_cast<unsigned long>(sz));
        jpeg_read_header(&ci, TRUE);
        int w = ci.image_width, h = ci.image_height;
        if (w > h) {
          tw = canvas;
          th = std::max(1, int(h * (double(canvas) / w)));
        } else {
          th = canvas;
          tw = std::max(1, int(w * (double(canvas) / h)));
        }
      }
      jpeg_destroy_decompress(&ci);
    }
    return decode_jpeg_mem(buf.data(), sz, tw, th);
  }
  if (n >= 8 && !png_sig_cmp(magic, 0, 8)) {
    out = decode_png(f);
  }
  fclose(f);
  return out;
}

// ---------------------------------------------------------------------------
// Lanczos-3 resize (PIL-compatible: support scales with downscale factor)
// ---------------------------------------------------------------------------

inline double lanczos3(double x) {
  if (x == 0.0) return 1.0;
  x = std::abs(x);
  if (x >= 3.0) return 0.0;
  double px = M_PI * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

// Precomputed 1-D resampling taps for one axis (PIL ImagingResampleHorizontal
// equivalent). Weights normalized in double, stored as float — the per-pixel
// accumulation runs in float (PIL itself uses int16 fixed point; float is
// strictly more precise than that while vectorizing on this host).
struct Taps {
  int ksize;
  std::vector<int> bounds;     // 2 per output px: start, count
  std::vector<float> weights;  // ksize per output px
};

Taps compute_taps(int in_size, int out_size) {
  Taps t;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 3.0 * filterscale;
  t.ksize = int(std::ceil(support)) * 2 + 1;
  t.bounds.resize(size_t(out_size) * 2);
  t.weights.assign(size_t(out_size) * t.ksize, 0.0f);
  std::vector<double> wbuf(t.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5)) - xmin;
    for (int x = 0; x < xmax; ++x) {
      double v = lanczos3((x + xmin - center + 0.5) / filterscale);
      wbuf[x] = v;
      ww += v;
    }
    float* w = &t.weights[size_t(xx) * t.ksize];
    for (int x = 0; x < xmax; ++x)
      w[x] = float(ww != 0.0 ? wbuf[x] / ww : wbuf[x]);
    t.bounds[size_t(xx) * 2] = xmin;
    t.bounds[size_t(xx) * 2 + 1] = xmax;
  }
  return t;
}

inline uint8_t clip8(float v) {
  return uint8_t(std::min(255.0f, std::max(0.0f, v + 0.5f)));
}

// Resize RGB uint8 (h,w) -> (nh,nw)
std::vector<uint8_t> lanczos_resize(const uint8_t* src, int h, int w,
                                    int nh, int nw) {
  Taps tx = compute_taps(w, nw);
  Taps ty = compute_taps(h, nh);
  // horizontal pass into float buffer (h, nw, 3)
  std::vector<float> tmp(size_t(h) * nw * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + size_t(y) * w * 3;
    float* orow = tmp.data() + size_t(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      int xmin = tx.bounds[size_t(x) * 2];
      int cnt = tx.bounds[size_t(x) * 2 + 1];
      const float* wts = &tx.weights[size_t(x) * tx.ksize];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const uint8_t* p = row + size_t(xmin) * 3;
      for (int k = 0; k < cnt; ++k, p += 3) {
        float wk = wts[k];
        acc0 += p[0] * wk;
        acc1 += p[1] * wk;
        acc2 += p[2] * wk;
      }
      orow[x * 3] = acc0;
      orow[x * 3 + 1] = acc1;
      orow[x * 3 + 2] = acc2;
    }
  }
  // vertical pass: accumulate whole output rows (contiguous, vectorizable)
  std::vector<uint8_t> out(size_t(nh) * nw * 3);
  std::vector<float> accrow(size_t(nw) * 3);
  for (int y = 0; y < nh; ++y) {
    int ymin = ty.bounds[size_t(y) * 2];
    int cnt = ty.bounds[size_t(y) * 2 + 1];
    const float* wts = &ty.weights[size_t(y) * ty.ksize];
    std::fill(accrow.begin(), accrow.end(), 0.0f);
    for (int k = 0; k < cnt; ++k) {
      const float* irow = tmp.data() + size_t(ymin + k) * nw * 3;
      float wk = wts[k];
      float* acc = accrow.data();
      for (int i = 0; i < nw * 3; ++i) acc[i] += irow[i] * wk;
    }
    uint8_t* orow = out.data() + size_t(y) * nw * 3;
    for (int i = 0; i < nw * 3; ++i) orow[i] = clip8(accrow[i]);
  }
  return out;
}

// ---------------------------------------------------------------------------
// encoding (the save path)
// ---------------------------------------------------------------------------

bool encode_jpeg(const char* path, const uint8_t* rgb, int w, int h,
                 int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        rgb + size_t(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return true;
}

bool encode_png(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                            nullptr, nullptr);
  if (!png) {
    fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(f);
    return false;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  // lossless regardless of level; level 1 is ~5x faster than the zlib
  // default on the throughput path
  png_set_compression_level(png, 1);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  rows.resize(h);
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<uint8_t*>(rgb + size_t(y) * w * 3);
  png_write_image(png, rows.data());
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return true;
}

bool has_suffix_ci(const char* path, const char* suf) {
  size_t lp = std::strlen(path), ls = std::strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; ++i)
    if (std::tolower(path[lp - ls + i]) != suf[i]) return false;
  return true;
}

}  // namespace

extern "C" {

// Decode one image; returns 1 on success. Caller provides the canvas buffer
// (canvas*canvas*3). orig_wh receives the source dimensions.
int mstgan_decode_canvas(const char* path, int canvas, uint8_t fill,
                         uint8_t* out, int* orig_wh) {
  Image img = decode_file(path, canvas);
  if (!img.ok) return 0;
  orig_wh[0] = img.full_w;
  orig_wh[1] = img.full_h;
  // aspect-fit target from the SOURCE dims (batch_process_images.py:187-199)
  int nw, nh;
  if (img.full_w > img.full_h) {
    nw = canvas;
    nh = int(img.full_h * (double(canvas) / img.full_w));
  } else {
    nh = canvas;
    nw = int(img.full_w * (double(canvas) / img.full_h));
  }
  nw = std::max(nw, 1);
  nh = std::max(nh, 1);
  const uint8_t* src = img.rgb.data();
  std::vector<uint8_t> resized;
  if (img.w != nw || img.h != nh) {
    resized = lanczos_resize(src, img.h, img.w, nh, nw);
    src = resized.data();
  }
  std::memset(out, fill, size_t(canvas) * canvas * 3);
  int ox = (canvas - nw) / 2, oy = (canvas - nh) / 2;
  for (int y = 0; y < nh; ++y)
    std::memcpy(out + (size_t(oy + y) * canvas + ox) * 3,
                src + size_t(y) * nw * 3, size_t(nw) * 3);
  return 1;
}

// Threaded batch decode: paths is n pointers; out is (n, canvas, canvas, 3);
// orig_whs is (n, 2); ok flags (n). Returns count of successes.
int mstgan_decode_canvas_batch(const char** paths, int n, int canvas,
                               uint8_t fill, uint8_t* out, int* orig_whs,
                               uint8_t* ok, int num_threads) {
  std::atomic<int> next(0), good(0);
  int nt = std::max(1, std::min(num_threads, n));
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int r = mstgan_decode_canvas(paths[i], canvas, fill,
                                   out + size_t(i) * canvas * canvas * 3,
                                   orig_whs + size_t(i) * 2);
      ok[i] = uint8_t(r);
      if (r) good.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

// Save one stylized canvas: aspect-crop back to the source aspect ratio,
// resize to the original size when <= 1MP, encode by extension (.jpg/.jpeg/
// .png). Exact semantics of ops/image.py restore_aspect + the PIL save in
// pipelines/batch.py (batch_process_images.py:412-438). Returns 1 on
// success, 0 on failure (unknown extension, unwritable path, ...).
int mstgan_save_canvas(const uint8_t* canvas_img, int canvas, int orig_w,
                       int orig_h, const char* path, int quality) {
  if (!(has_suffix_ci(path, ".jpg") || has_suffix_ci(path, ".jpeg") ||
        has_suffix_ci(path, ".png")))
    return 0;  // caller falls back to PIL for exotic formats
  // crop bounds — ops/image.py aspect_crop_bounds
  int l = 0, t = 0, cw = canvas, ch = canvas;
  if (orig_w != orig_h) {
    double ar = double(orig_w) / orig_h;
    if (ar > 1.0) {
      cw = canvas;
      ch = int(canvas / ar);
    } else {
      cw = int(canvas * ar);
      ch = canvas;
    }
    l = (canvas - cw) / 2;
    t = (canvas - ch) / 2;
  }
  std::vector<uint8_t> crop;
  const uint8_t* img = canvas_img;
  int iw = canvas, ih = canvas;
  if (cw != canvas || ch != canvas) {
    crop.resize(size_t(ch) * cw * 3);
    for (int y = 0; y < ch; ++y)
      std::memcpy(crop.data() + size_t(y) * cw * 3,
                  canvas_img + (size_t(t + y) * canvas + l) * 3,
                  size_t(cw) * 3);
    img = crop.data();
    iw = cw;
    ih = ch;
  }
  std::vector<uint8_t> resized;
  if (int64_t(orig_w) * orig_h <= 1024 * 1024 &&
      (orig_w != iw || orig_h != ih)) {
    resized = lanczos_resize(img, ih, iw, orig_h, orig_w);
    img = resized.data();
    iw = orig_w;
    ih = orig_h;
  }
  if (has_suffix_ci(path, ".png")) return encode_png(path, img, iw, ih);
  return encode_jpeg(path, img, iw, ih, quality);
}

// Threaded batch save: batch is (n, canvas, canvas, 3); orig_whs (n, 2);
// ok flags (n). Returns count of successes.
int mstgan_save_canvas_batch(const uint8_t* batch, int n, int canvas,
                             const int* orig_whs, const char** paths,
                             int quality, uint8_t* ok, int num_threads) {
  std::atomic<int> next(0), good(0);
  int nt = std::max(1, std::min(num_threads, n));
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int r = mstgan_save_canvas(batch + size_t(i) * canvas * canvas * 3,
                                 canvas, orig_whs[size_t(i) * 2],
                                 orig_whs[size_t(i) * 2 + 1], paths[i],
                                 quality);
      ok[i] = uint8_t(r);
      if (r) good.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

// Plain resize for the save path (restore to original size).
int mstgan_resize(const uint8_t* src, int h, int w, uint8_t* dst, int nh,
                  int nw) {
  auto out = lanczos_resize(src, h, w, nh, nw);
  std::memcpy(dst, out.data(), out.size());
  return 1;
}

// ---------------------------------------------------------------------------
// felzenszwalb segmentation (the union-find hot loop)
// ---------------------------------------------------------------------------

namespace {
struct DSU {
  std::vector<int> parent, rank_;
  std::vector<int64_t> size;
  explicit DSU(int n) : parent(n), rank_(n, 0), size(n, 1) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int find(int x) {
    int root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int nx = parent[x];
      parent[x] = root;
      x = nx;
    }
    return root;
  }
  int unite(int a, int b) {
    int ra = find(a), rb = find(b);
    if (ra == rb) return ra;
    if (rank_[ra] < rank_[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
    if (rank_[ra] == rank_[rb]) rank_[ra]++;
    return ra;
  }
};
}  // namespace

// img: (h, w, 3) float32 ALREADY smoothed and scaled to [0,1] by the caller
// (the Python wrapper does the gaussian pre-smoothing on device).
// labels_out: (h, w) int32. Returns number of segments.
int mstgan_felzenszwalb(const float* img, int h, int w, float scale,
                        int min_size, int32_t* labels_out) {
  const int n = h * w;
  struct Edge {
    float wgt;
    int a, b;
  };
  std::vector<Edge> edges;
  edges.reserve(size_t(n) * 4);
  auto diff = [&](int ia, int ib) {
    const float* pa = img + size_t(ia) * 3;
    const float* pb = img + size_t(ib) * 3;
    float d0 = pa[0] - pb[0], d1 = pa[1] - pb[1], d2 = pa[2] - pb[2];
    return std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
  };
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int i = y * w + x;
      if (x + 1 < w) edges.push_back({diff(i, i + 1), i, i + 1});
      if (y + 1 < h) edges.push_back({diff(i, i + w), i, i + w});
      if (x + 1 < w && y + 1 < h)
        edges.push_back({diff(i, i + w + 1), i, i + w + 1});
      if (x > 0 && y + 1 < h)
        edges.push_back({diff(i, i + w - 1), i, i + w - 1});
    }
  }
  std::stable_sort(edges.begin(), edges.end(),
                   [](const Edge& a, const Edge& b) { return a.wgt < b.wgt; });
  DSU dsu(n);
  std::vector<float> threshold(n, scale);
  for (const Edge& e : edges) {
    int ra = dsu.find(e.a), rb = dsu.find(e.b);
    if (ra == rb) continue;
    if (e.wgt <= threshold[ra] && e.wgt <= threshold[rb]) {
      int r = dsu.unite(ra, rb);
      threshold[r] = e.wgt + scale / dsu.size[r];
    }
  }
  for (const Edge& e : edges) {
    int ra = dsu.find(e.a), rb = dsu.find(e.b);
    if (ra != rb && (dsu.size[ra] < min_size || dsu.size[rb] < min_size))
      dsu.unite(ra, rb);
  }
  // relabel 0..k-1
  std::vector<int32_t> remap(n, -1);
  int32_t k = 0;
  for (int i = 0; i < n; ++i) {
    int r = dsu.find(i);
    if (remap[r] < 0) remap[r] = k++;
    labels_out[i] = remap[r];
  }
  return k;
}

}  // extern "C"
