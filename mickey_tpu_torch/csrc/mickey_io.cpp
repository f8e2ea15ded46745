// Native batched JPEG ingest of the PyTorch port (``data/native.py``).
//
// Batched JPEG decode + bilinear resize + [0,1] float32 normalization into a
// single caller-allocated NHWC buffer, on a std::thread worker pool: the
// decode, the resize arithmetic and the zero fill of an undecodable image
// are ``mickey_tpu``'s C++ ingest's, line for line, so both give the same
// bits. The interface is plain C, loaded with ctypes (which releases the
// interpreter lock for the call), so the build needs neither Python's nor
// numpy's headers:
//
//   int mk_decode_resize_batch(const unsigned char* const* data,
//                              const size_t* sizes, int n, int width,
//                              int height, int num_threads, float* out);
//
// ``out`` holds n * height * width * 3 floats; the return value is the
// number of images that failed to decode (their pixels are zero).
//
// Bilinear resize uses half-pixel centers (src = (dst + 0.5) * scale - 0.5),
// matching cv2.INTER_LINEAR semantics.

// jpeglib.h needs size_t and FILE declared first
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG into an RGB byte buffer. Returns false on failure.
bool decode_jpeg(const unsigned char* data, size_t size, std::vector<unsigned char>& rgb,
                 int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize (half-pixel centers) + /255 normalize into float32 NHWC.
// Separable two-pass: horizontal weights precomputed per column, a rolling
// two-row cache of horizontally-resized rows for the vertical blend.
struct ResizePlan {
  std::vector<int> x0, x1;
  std::vector<float> wx;
  int sw = -1, dw = -1;
  void prepare(int sw_, int dw_) {
    if (sw == sw_ && dw == dw_) return;
    sw = sw_;
    dw = dw_;
    x0.resize(dw);
    x1.resize(dw);
    wx.resize(dw);
    const float sx = static_cast<float>(sw) / dw;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int i0 = static_cast<int>(std::floor(fx));
      wx[x] = fx - i0;
      int i1 = i0 + 1;
      x0[x] = i0 < 0 ? 0 : (i0 >= sw ? sw - 1 : i0);
      x1[x] = i1 < 0 ? 0 : (i1 >= sw ? sw - 1 : i1);
    }
  }
};

void hresize_row(const unsigned char* src_row, const ResizePlan& p, float* out) {
  for (int x = 0; x < p.dw; ++x) {
    const unsigned char* a = src_row + p.x0[x] * 3;
    const unsigned char* b = src_row + p.x1[x] * 3;
    const float w = p.wx[x];
    out[x * 3 + 0] = a[0] + w * (b[0] - a[0]);
    out[x * 3 + 1] = a[1] + w * (b[1] - a[1]);
    out[x * 3 + 2] = a[2] + w * (b[2] - a[2]);
  }
}

void resize_normalize(const unsigned char* src, int sw, int sh, float* dst, int dw, int dh,
                      ResizePlan& plan, std::vector<float>& rows) {
  plan.prepare(sw, dw);
  rows.resize(2 * static_cast<size_t>(dw) * 3);
  float* row_buf[2] = {rows.data(), rows.data() + static_cast<size_t>(dw) * 3};
  int cached[2] = {-1, -1};

  const float sy = static_cast<float>(sh) / dh;
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 >= sh ? sh - 1 : y1);

    float* r0;
    float* r1;
    // rolling cache: reuse horizontally-resized rows across dst rows
    if (cached[0] == y0) {
      r0 = row_buf[0];
    } else if (cached[1] == y0) {
      r0 = row_buf[1];
    } else {
      int slot = (cached[0] == y1) ? 1 : 0;
      hresize_row(src + static_cast<size_t>(y0) * sw * 3, plan, row_buf[slot]);
      cached[slot] = y0;
      r0 = row_buf[slot];
    }
    if (cached[0] == y1) {
      r1 = row_buf[0];
    } else if (cached[1] == y1) {
      r1 = row_buf[1];
    } else {
      int slot = (r0 == row_buf[0]) ? 1 : 0;
      hresize_row(src + static_cast<size_t>(y1) * sw * 3, plan, row_buf[slot]);
      cached[slot] = y1;
      r1 = row_buf[slot];
    }

    float* out = dst + static_cast<size_t>(y) * dw * 3;
    const int n = dw * 3;
    for (int i = 0; i < n; ++i) {
      out[i] = (r0[i] + wy * (r1[i] - r0[i])) * inv255;
    }
  }
}

struct Job {
  const unsigned char* data;
  size_t size;
  float* out;  // (dh, dw, 3)
};

}  // namespace

extern "C" int mk_decode_resize_batch(const unsigned char* const* data, const size_t* sizes, int n,
                                      int width, int height, int num_threads, float* out) {
  const size_t per_image = static_cast<size_t>(height) * width * 3;
  std::vector<Job> jobs(n);
  for (int i = 0; i < n; ++i) {
    jobs[i] = {data[i], sizes[i], out + i * per_image};
  }

  std::atomic<long> next(0);
  std::atomic<long> failures(0);
  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    ResizePlan plan;
    std::vector<float> rows;
    while (true) {
      long i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      if (!decode_jpeg(jobs[i].data, jobs[i].size, rgb, w, h)) {
        failures.fetch_add(1);
        std::memset(jobs[i].out, 0, per_image * sizeof(float));
        continue;
      }
      resize_normalize(rgb.data(), w, h, jobs[i].out, width, height, plan, rows);
    }
  };

  int threads = std::max(1, std::min<int>(num_threads, n));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return static_cast<int>(failures.load());
}
