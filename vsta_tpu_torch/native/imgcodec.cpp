// Native host-side image codec for the data pipeline.
//
// The reference's image path is PIL + torchvision running on the
// DataLoader workers (reference: project/data/wildtrack_loader.py:368-373,
// project/data/transforms.py:4-18) - i.e. its hot decode/resize work is
// done by native libjpeg/libpng/PIL-C under the hood. This is the
// framework's own native equivalent: decode (libjpeg/libpng) + a
// PIL-compatible separable triangle-filter resize + fused ImageNet
// normalization, exposed through a C ABI consumed via ctypes
// (vsta_tpu_torch/native/__init__.py, which builds it into build/native/).
//
// Build: g++ -O3 -shared -fPIC imgcodec.cpp -o libimgcodec.so -ljpeg -lpng -lz
//
// Error codes: 0 ok; -1 io; -2 unknown format; -3 decode failure;
// -4 bad args.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int h = 0;
  int w = 0;
  std::vector<unsigned char> rgb;  // h*w*3
};

bool read_file(const char* path, std::vector<unsigned char>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const unsigned char* buf, size_t n, Image& img,
                 int target_h = 0, int target_w = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: decode at the smallest 1/den >= target size
  // (libjpeg supports den in {1, 2, 4, 8}); the triangle resize then
  // finishes the job. ~den^2 less IDCT work for big downscales.
  if (target_h > 0 && target_w > 0) {
    int den = 1;
    while (den < 8 &&
           static_cast<int>(cinfo.image_height) / (den * 2) >= target_h &&
           static_cast<int>(cinfo.image_width) / (den * 2) >= target_w) {
      den *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned int>(den);
  }
  jpeg_start_decompress(&cinfo);
  img.w = static_cast<int>(cinfo.output_width);
  img.h = static_cast<int>(cinfo.output_height);
  img.rgb.resize(static_cast<size_t>(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = img.rgb.data() +
                         static_cast<size_t>(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(const unsigned char* buf, size_t n, Image& img) {
  png_image pimg;
  std::memset(&pimg, 0, sizeof(pimg));
  pimg.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pimg, buf, n)) return false;
  pimg.format = PNG_FORMAT_RGB;
  img.w = static_cast<int>(pimg.width);
  img.h = static_cast<int>(pimg.height);
  img.rgb.resize(PNG_IMAGE_SIZE(pimg));
  if (!png_image_finish_read(&pimg, nullptr, img.rgb.data(), 0, nullptr)) {
    png_image_free(&pimg);
    return false;
  }
  return true;
}

int decode_any(const char* path, Image& img, int target_h = 0,
               int target_w = 0) {
  std::vector<unsigned char> buf;
  if (!read_file(path, buf)) return -1;
  if (buf.size() >= 8 && buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' &&
      buf[3] == 'G') {
    return decode_png(buf.data(), buf.size(), img) ? 0 : -3;
  }
  if (buf.size() >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
    return decode_jpeg(buf.data(), buf.size(), img, target_h, target_w) ? 0
                                                                        : -3;
  }
  return -2;
}

// PIL-style resize weights: separable triangle filter with support
// scaled by the downsampling ratio (Pillow's "BILINEAR" resample).
struct WeightTable {
  std::vector<int> starts;    // per output index
  std::vector<int> sizes;     // taps per output index
  std::vector<float> weights; // concatenated, normalized
  int max_taps = 0;
};

WeightTable build_weights(int in_size, int out_size) {
  WeightTable t;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // triangle filter radius 1
  t.starts.resize(out_size);
  t.sizes.resize(out_size);
  std::vector<float> tmp;
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    tmp.clear();
    double total = 0.0;
    for (int j = xmin; j < xmax; ++j) {
      double x = (j - center + 0.5) / filterscale;
      double w = x < 0 ? 1.0 + x : 1.0 - x;  // triangle
      if (w < 0) w = 0;
      tmp.push_back(static_cast<float>(w));
      total += w;
    }
    if (total <= 0) {  // degenerate: nearest
      tmp.assign(1, 1.0f);
      xmin = std::min(std::max(static_cast<int>(center), 0), in_size - 1);
      xmax = xmin + 1;
      total = 1.0;
    }
    t.starts[i] = xmin;
    t.sizes[i] = xmax - xmin;
    if (t.sizes[i] > t.max_taps) t.max_taps = t.sizes[i];
    for (float w : tmp) t.weights.push_back(static_cast<float>(w / total));
  }
  return t;
}

// Resize RGB u8 -> float32 RGB [out_h, out_w, 3] in [0, 255].
void resize_triangle(const Image& img, int out_h, int out_w,
                     std::vector<float>& out) {
  WeightTable wx = build_weights(img.w, out_w);
  WeightTable wy = build_weights(img.h, out_h);

  // horizontal pass: [h, out_w, 3]
  std::vector<float> mid(static_cast<size_t>(img.h) * out_w * 3);
  for (int y = 0; y < img.h; ++y) {
    const unsigned char* row = img.rgb.data() + static_cast<size_t>(y) * img.w * 3;
    float* mrow = mid.data() + static_cast<size_t>(y) * out_w * 3;
    size_t woff = 0;
    for (int x = 0; x < out_w; ++x) {
      int s = wx.starts[x], n = wx.sizes[x];
      const float* w = wx.weights.data() + woff;
      float r = 0, g = 0, b = 0;
      for (int j = 0; j < n; ++j) {
        const unsigned char* p = row + static_cast<size_t>(s + j) * 3;
        r += w[j] * p[0];
        g += w[j] * p[1];
        b += w[j] * p[2];
      }
      mrow[x * 3 + 0] = r;
      mrow[x * 3 + 1] = g;
      mrow[x * 3 + 2] = b;
      woff += n;
    }
  }

  // vertical pass: [out_h, out_w, 3]
  out.resize(static_cast<size_t>(out_h) * out_w * 3);
  size_t woff = 0;
  for (int y = 0; y < out_h; ++y) {
    int s = wy.starts[y], n = wy.sizes[y];
    const float* w = wy.weights.data() + woff;
    float* orow = out.data() + static_cast<size_t>(y) * out_w * 3;
    std::memset(orow, 0, sizeof(float) * out_w * 3);
    for (int j = 0; j < n; ++j) {
      const float* mrow = mid.data() + static_cast<size_t>(s + j) * out_w * 3;
      float wj = w[j];
      for (int k = 0; k < out_w * 3; ++k) orow[k] += wj * mrow[k];
    }
    woff += n;
  }
}

}  // namespace

extern "C" {

// Decode + resize; write uint8 RGB HWC [out_h, out_w, 3].
int vsta_decode_resize_u8(const char* path, int out_h, int out_w,
                          unsigned char* out) {
  if (!path || !out || out_h <= 0 || out_w <= 0) return -4;
  Image img;
  int rc = decode_any(path, img, out_h, out_w);
  if (rc != 0) return rc;
  std::vector<float> f;
  resize_triangle(img, out_h, out_w, f);
  size_t n = static_cast<size_t>(out_h) * out_w * 3;
  for (size_t i = 0; i < n; ++i) {
    float v = f[i] + 0.5f;  // round like Pillow's clip8
    if (v < 0) v = 0;
    if (v > 255) v = 255;
    out[i] = static_cast<unsigned char>(v);
  }
  return 0;
}

// Decode + resize + fused normalize: out[c] = (x/255 - mean[c]) / std[c];
// float32 RGB HWC.
int vsta_decode_resize_norm(const char* path, int out_h, int out_w,
                            const float* mean, const float* std_,
                            float* out) {
  if (!path || !out || !mean || !std_ || out_h <= 0 || out_w <= 0) return -4;
  Image img;
  int rc = decode_any(path, img, out_h, out_w);
  if (rc != 0) return rc;
  std::vector<float> f;
  resize_triangle(img, out_h, out_w, f);
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
  size_t npx = static_cast<size_t>(out_h) * out_w;
  for (size_t i = 0; i < npx; ++i) {
    for (int c = 0; c < 3; ++c) {
      // Match the uint8 path exactly: quantize to u8 first (the
      // reference's PIL pipeline also materializes uint8 pixels).
      float v = f[i * 3 + c] + 0.5f;
      if (v < 0) v = 0;
      if (v > 255) v = 255;
      float u = static_cast<float>(static_cast<unsigned char>(v));
      out[i * 3 + c] = (u * inv255 - mean[c]) * inv_std[c];
    }
  }
  return 0;
}

// Probe dimensions without full decode (decodes header only for JPEG;
// PNG simplified API reads the header).
int vsta_image_size(const char* path, int* h, int* w) {
  if (!path || !h || !w) return -4;
  Image img;
  int rc = decode_any(path, img);  // simple + correct; not a hot path
  if (rc != 0) return rc;
  *h = img.h;
  *w = img.w;
  return 0;
}

}  // extern "C"
