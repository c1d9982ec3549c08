// Native JPEG decode pool for the frame-folder ingest path (a copy of
// video_graph_ssl_tpu/data/native/jpeg_pool.cpp; built at first use by
// jpeg_pool.py into video_graph_ssl_tpu_torch/_build/).
//
// Counterpart of the reference's torch DataLoader worker processes +
// cv2.imread (lib/data/build.py:40-54, datasets/utils.py): decoding JPEG
// frames is the host-side bottleneck when feeding a TPU chip >1250 clips/s.
// This pool decodes on C++ threads with the GIL released end-to-end and —
// unlike cv2.imread + resize — uses libjpeg's DCT-domain prescaling
// (scale_num/scale_denom in {1/8 .. 1/1}) so a 1080p frame headed for a
// 171x128 canvas is IDCT'd at 1/4 or 1/8 size instead of full resolution.
//
// C ABI (driven from Python via ctypes, no pybind11 in this image):
//   jp_pool_create(n_threads)            -> opaque handle
//   jp_pool_destroy(handle)
//   jp_decode_batch(handle, paths, n, out_h, out_w, out)   -> n_failed
//     paths: array of n NUL-terminated file paths
//     out:   n * out_h * out_w * 3 uint8 buffer (RGB, bilinear-resized)
//
// Build: g++ -O3 -shared -fPIC jpeg_pool.cpp -o jpeg_pool.so -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file to RGB and bilinear-resize into out (out_h*out_w*3).
// Returns true on success.
bool decode_one(const char* path, int out_h, int out_w, uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  std::vector<uint8_t> decoded;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain prescale: pick the smallest scale >= target in both dims.
  // libjpeg supports scale_num in 1..16 over denom 8 (we use 1,2,4,8).
  for (int denom = 8; denom >= 1; denom /= 2) {
    if ((int)cinfo.image_width / denom >= out_w &&
        (int)cinfo.image_height / denom >= out_h) {
      cinfo.scale_num = 1;
      cinfo.scale_denom = denom;
      break;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
  }

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;  // 3 after JCS_RGB
  decoded.resize((size_t)w * h * ch);
  JSAMPROW row;
  while ((int)cinfo.output_scanline < h) {
    row = decoded.data() + (size_t)cinfo.output_scanline * w * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  // Bilinear resize (align_corners=False convention, matches cv2
  // INTER_LINEAR) from (h, w) to (out_h, out_w).
  const float sy = (float)h / out_h;
  const float sx = (float)w / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = (int)fy;
    if (fy < 0) { fy = 0; y0 = 0; }
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = (int)fx;
      if (fx < 0) { fx = 0; x0 = 0; }
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      const uint8_t* p00 = &decoded[((size_t)y0 * w + x0) * ch];
      const uint8_t* p01 = &decoded[((size_t)y0 * w + x1) * ch];
      const uint8_t* p10 = &decoded[((size_t)y1 * w + x0) * ch];
      const uint8_t* p11 = &decoded[((size_t)y1 * w + x1) * ch];
      uint8_t* dst = out + ((size_t)oy * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float v0 = p00[c] + (p01[c] - p00[c]) * wx;
        float v1 = p10[c] + (p11[c] - p10[c]) * wx;
        dst[c] = (uint8_t)(v0 + (v1 - v0) * wy + 0.5f);
      }
    }
  }
  return true;
}

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { Loop(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

void* jp_pool_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Pool(n_threads);
}

void jp_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Decode n files into out (n, out_h, out_w, 3) uint8.  Blocks until the
// whole batch is done; returns the number of failed decodes (their output
// slots are zero-filled).
int jp_decode_batch(void* pool, const char** paths, int n, int out_h,
                    int out_w, uint8_t* out) {
  Pool* p = static_cast<Pool*>(pool);
  std::atomic<int> failed(0);
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  const size_t frame = (size_t)out_h * out_w * 3;
  for (int i = 0; i < n; ++i) {
    p->Submit([&, i] {
      uint8_t* dst = out + (size_t)i * frame;
      if (!decode_one(paths[i], out_h, out_w, dst)) {
        memset(dst, 0, frame);
        failed.fetch_add(1);
      }
      if (done.fetch_add(1) + 1 == n) {
        std::unique_lock<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return failed.load();
}

}  // extern "C"
