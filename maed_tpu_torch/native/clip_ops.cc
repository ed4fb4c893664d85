// Host-side clip assembly for maed_tpu_torch's data path: JPEG decode, the
// affine crop (bilinear, constant border) and either the [0,255] ->
// ImageNet-normalized float32 store or a rounded uint8 crop (the device
// normalizes uint8 clips), multi-threaded over frames.
//
// A copy of maed_tpu/native/clip_ops.cc (the fused equivalent of the
// original MAED's cv2.warpAffine + ToTensor + Normalize chain) whose crop
// arithmetic is unchanged, with three differences: the decoder is required
// (libjpeg, or nvJPEG from the CUDA toolkit with host output where libjpeg
// is absent; build.sh picks one and fails when it finds neither); one more
// entry point, jpeg_decode_rgb, decodes a single image for the paths that
// augment before they crop; and jpeg_encode_rgb writes one (libjpeg's
// compressor, or nvJPEG's encoder), for the tools that write JPEG frames.
// Exposed to Python through ctypes (maed_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

#if defined(HAVE_LIBJPEG)
#include <cstdio>
#include <jpeglib.h>
#elif defined(HAVE_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <mutex>
#else
#error "build with -DHAVE_LIBJPEG or -DHAVE_NVJPEG: the data path needs a JPEG decoder"
#endif

namespace {

// mean/std in [0,1] space; folded into the 1/255 scale below.
constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

// Output policies: float32 stores the ImageNet-normalized value; uint8
// stores the rounded bilinear sample (cv2.warpAffine-on-uint8 semantics to
// within 1 LSB of cv2's fixed-point rounding).
inline void store_px(float* dst, float v, float scale, float bias) {
  *dst = v * scale + bias;
}
inline void store_px(uint8_t* dst, float v, float, float) {
  const float c = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
  *dst = static_cast<uint8_t>(std::lrintf(c));
}

template <typename OutT>
struct FrameTask {
  const uint8_t* src;   // H_in x W_in x 3, RGB
  int src_h, src_w;
  const double* inv;    // 2x3 inverse affine (output px -> input px)
  OutT* dst;            // out_h x out_w x 3
};

template <typename OutT>
inline void process_frame(const FrameTask<OutT>& t, int out_h, int out_w) {
  const float scale[3] = {1.0f / (255.0f * kStd[0]), 1.0f / (255.0f * kStd[1]),
                          1.0f / (255.0f * kStd[2])};
  const float bias[3] = {-kMean[0] / kStd[0], -kMean[1] / kStd[1],
                         -kMean[2] / kStd[2]};
  const double a = t.inv[0], b = t.inv[1], c = t.inv[2];
  const double d = t.inv[3], e = t.inv[4], f = t.inv[5];

  const size_t stride = static_cast<size_t>(t.src_w) * 3;

  for (int y = 0; y < out_h; ++y) {
    OutT* row = t.dst + static_cast<size_t>(y) * out_w * 3;
    // input coordinates move linearly along the row: precompute start + step
    const double row_sx = b * y + c;
    const double row_sy = e * y + f;

    // interior span: output x where all 4 bilinear taps are in-bounds for
    // BOTH coordinates. Solve the linear constraints 0 <= x0, x0+1 < W,
    // 0 <= y0, y0+1 < H conservatively.
    int lo = 0, hi = out_w;  // [lo, hi) handled by the fast path
    auto clamp_span = [&](double step, double start, double min_v, double max_v) {
      // need min_v <= start + step*x <= max_v for x in [lo, hi)
      if (std::fabs(step) < 1e-12) {
        if (start < min_v || start > max_v) { lo = 0; hi = 0; }
        return;
      }
      double x1 = (min_v - start) / step;
      double x2 = (max_v - start) / step;
      if (x1 > x2) std::swap(x1, x2);
      lo = std::max(lo, static_cast<int>(std::ceil(x1)));
      hi = std::min(hi, static_cast<int>(std::floor(x2)) + 1);
    };
    clamp_span(a, row_sx, 0.0, static_cast<double>(t.src_w) - 2.0);
    clamp_span(d, row_sy, 0.0, static_cast<double>(t.src_h) - 2.0);
    if (lo > hi) { lo = hi = 0; }

    auto slow_pixel = [&](int x) {
      const double sx = row_sx + a * x;
      const double sy = row_sy + d * x;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const float fx = static_cast<float>(sx - x0);
      const float fy = static_cast<float>(sy - y0);
      const bool in00 = (x0 >= 0) & (x0 < t.src_w) & (y0 >= 0) & (y0 < t.src_h);
      const bool in10 = (x0 + 1 >= 0) & (x0 + 1 < t.src_w) & (y0 >= 0) & (y0 < t.src_h);
      const bool in01 = (x0 >= 0) & (x0 < t.src_w) & (y0 + 1 >= 0) & (y0 + 1 < t.src_h);
      const bool in11 = (x0 + 1 >= 0) & (x0 + 1 < t.src_w) & (y0 + 1 >= 0) & (y0 + 1 < t.src_h);
      const float w00 = (1 - fx) * (1 - fy);
      const float w10 = fx * (1 - fy);
      const float w01 = (1 - fx) * fy;
      const float w11 = fx * fy;
      const uint8_t* p00 = in00 ? t.src + (static_cast<size_t>(y0) * t.src_w + x0) * 3 : nullptr;
      const uint8_t* p10 = in10 ? t.src + (static_cast<size_t>(y0) * t.src_w + x0 + 1) * 3 : nullptr;
      const uint8_t* p01 = in01 ? t.src + (static_cast<size_t>(y0 + 1) * t.src_w + x0) * 3 : nullptr;
      const uint8_t* p11 = in11 ? t.src + (static_cast<size_t>(y0 + 1) * t.src_w + x0 + 1) * 3 : nullptr;
      for (int ch = 0; ch < 3; ++ch) {
        float v = 0.f;
        if (p00) v += w00 * p00[ch];
        if (p10) v += w10 * p10[ch];
        if (p01) v += w01 * p01[ch];
        if (p11) v += w11 * p11[ch];
        store_px(row + x * 3 + ch, v, scale[ch], bias[ch]);
      }
    };

    for (int x = 0; x < lo; ++x) slow_pixel(x);
    // branch-free interior
    for (int x = lo; x < hi; ++x) {
      const double sx = row_sx + a * x;
      const double sy = row_sy + d * x;
      const int x0 = static_cast<int>(sx);
      const int y0 = static_cast<int>(sy);
      const float fx = static_cast<float>(sx - x0);
      const float fy = static_cast<float>(sy - y0);
      const float w00 = (1 - fx) * (1 - fy);
      const float w10 = fx * (1 - fy);
      const float w01 = (1 - fx) * fy;
      const float w11 = fx * fy;
      const uint8_t* p00 = t.src + static_cast<size_t>(y0) * stride + x0 * 3;
      const uint8_t* p01 = p00 + stride;
      for (int ch = 0; ch < 3; ++ch) {
        const float v = w00 * p00[ch] + w10 * p00[3 + ch] +
                        w01 * p01[ch] + w11 * p01[3 + ch];
        store_px(row + x * 3 + ch, v, scale[ch], bias[ch]);
      }
    }
    for (int x = hi; x < out_w; ++x) slow_pixel(x);
  }
}

// Shared frame-parallel driver for the decoded-frames entry points.
template <typename OutT>
void run_crop(const uint8_t** frames, const int* src_hw, int T,
              const double* inv_trans, int out_h, int out_w, OutT* out,
              int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > T) n_threads = T;

  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < T) {
      FrameTask<OutT> task;
      task.src = frames[i];
      task.src_h = src_hw[i * 2];
      task.src_w = src_hw[i * 2 + 1];
      task.inv = inv_trans + i * 6;
      task.dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
      process_frame(task, out_h, out_w);
    }
  };

  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Largest dimension we will allocate for (a dataset frame is <= 4K video;
// the JPEG format header allows up to 65500 x 65500 x 3 ~= 12.8 GB, so a
// corrupt or hostile header is rejected before any allocation, or the
// std::bad_alloc would escape a worker thread and terminate the process).
constexpr int kMaxJpegDim = 8192;

#if defined(HAVE_LIBJPEG)

constexpr const char* kDecoderName = "libjpeg";

struct JpegErr {
  jpeg_error_mgr pub;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(e->jb, 1);
}

// The image's size from its header; false on a corrupt or oversized header.
bool jpeg_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return *w > 0 && *h > 0 && *w <= kMaxJpegDim && *h <= kMaxJpegDim;
}

// Decode a JPEG byte buffer to RGB; returns false on corrupt, oversized, or
// allocation-failing input (any failure converts into the caller's
// failed-frame path instead of an exception crossing the thread boundary).
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>& out,
                 int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  if (*w <= 0 || *h <= 0 || *w > kMaxJpegDim || *h > kMaxJpegDim) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  try {
    out.resize(static_cast<size_t>(*w) * *h * 3);
  } catch (const std::bad_alloc&) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() +
                   static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decoder_device_live() { return false; }

// Encode h x w interleaved RGB as a baseline JPEG with libjpeg's defaults
// (4:2:0 chroma, the ISLOW DCT, the standard Huffman tables), which is what
// cv2.imwrite writes at the same quality. False on any failure.
bool encode_jpeg(const uint8_t* rgb, int h, int w, int quality, std::vector<uint8_t>& out) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* mem = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &size);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + static_cast<size_t>(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  out.assign(mem, mem + size);
  jpeg_destroy_compress(&cinfo);
  std::free(mem);
  return true;
}

#else  // HAVE_NVJPEG

constexpr const char* kDecoderName = "nvjpeg";

// One nvJPEG handle a process (thread-safe by its documentation) and a pool
// of decode states, each with its own stream and device buffer, taken by one
// decode at a time: the frame-parallel drivers below decode from several
// threads at once. The handle is made at the first decode, which makes the
// process's CUDA context.
struct NvState {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t cap = 0;
};

std::mutex g_nv_mutex;
nvjpegHandle_t g_nv_handle = nullptr;
std::vector<NvState*> g_nv_free;
std::atomic<bool> g_nv_live(false);

nvjpegHandle_t nv_handle_locked() {
  if (g_nv_handle == nullptr) {
    if (nvjpegCreateSimple(&g_nv_handle) != NVJPEG_STATUS_SUCCESS) {
      g_nv_handle = nullptr;
      return nullptr;
    }
    g_nv_live.store(true);
  }
  return g_nv_handle;
}

nvjpegHandle_t nv_handle() {
  std::lock_guard<std::mutex> lock(g_nv_mutex);
  return nv_handle_locked();
}

NvState* nv_acquire() {
  std::lock_guard<std::mutex> lock(g_nv_mutex);
  nvjpegHandle_t handle = nv_handle_locked();
  if (handle == nullptr) return nullptr;
  if (!g_nv_free.empty()) {
    NvState* s = g_nv_free.back();
    g_nv_free.pop_back();
    return s;
  }
  auto* s = new (std::nothrow) NvState;
  if (s == nullptr) return nullptr;
  if (nvjpegJpegStateCreate(handle, &s->state) != NVJPEG_STATUS_SUCCESS) {
    delete s;
    return nullptr;
  }
  if (cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking) != cudaSuccess) {
    nvjpegJpegStateDestroy(s->state);
    delete s;
    return nullptr;
  }
  return s;
}

void nv_release(NvState* s) {
  std::lock_guard<std::mutex> lock(g_nv_mutex);
  g_nv_free.push_back(s);
}

struct NvInfo {
  int components = 0;
  nvjpegChromaSubsampling_t subsampling = NVJPEG_CSS_UNKNOWN;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
};

bool nv_info(const uint8_t* buf, size_t len, NvInfo* info) {
  nvjpegHandle_t handle = nv_handle();
  return handle != nullptr &&
         nvjpegGetImageInfo(handle, buf, len, &info->components, &info->subsampling,
                            info->widths, info->heights) == NVJPEG_STATUS_SUCCESS;
}

// The image's size from its header; false on a corrupt or oversized header.
bool jpeg_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  NvInfo info;
  if (!nv_info(buf, len, &info)) return false;
  *w = info.widths[0];
  *h = info.heights[0];
  return *w > 0 && *h > 0 && *w <= kMaxJpegDim && *h <= kMaxJpegDim;
}

// libjpeg's "fancy" upsampling of one chroma plane (cw x ch) to full
// resolution (w x h) by factors fx, fy in {1, 2} (jdsample.c: h2v2, h2v1
// and h1v2_fancy_upsample, with the image's edge rows and columns
// replicated), so that the RGB is what libjpeg, and so cv2, makes of the
// same coefficients.
void fancy_upsample(const uint8_t* in, int cw, int ch, int fx, int fy, int w, int h,
                    uint8_t* out) {
  std::vector<int> col(static_cast<size_t>(cw));
  std::vector<uint8_t> row(static_cast<size_t>(2 * cw));
  for (int y = 0; y < h; ++y) {
    const int r = y / fy;
    const uint8_t* near = in + static_cast<size_t>(r) * cw;
    if (fy == 2) {  // 3/4 of the nearer row and 1/4 of the further one
      const int other = (y % 2 == 0) ? std::max(r - 1, 0) : std::min(r + 1, ch - 1);
      const uint8_t* far = in + static_cast<size_t>(other) * cw;
      for (int x = 0; x < cw; ++x) col[x] = near[x] * 3 + far[x];
    }
    uint8_t* dst = out + static_cast<size_t>(y) * w;
    if (fx == 1 && fy == 1) {
      std::memcpy(dst, near, static_cast<size_t>(w));
    } else if (fx == 1) {  // h1v2: (3 near + far + bias) / 4, bias 1 above, 2 below
      const int bias = (y % 2 == 0) ? 1 : 2;
      for (int x = 0; x < w; ++x) dst[x] = static_cast<uint8_t>((col[x] + bias) >> 2);
    } else if (fy == 1) {  // h2v1
      if (cw == 1) {
        for (int x = 0; x < w; ++x) dst[x] = near[0];
        continue;
      }
      row[0] = near[0];
      row[1] = static_cast<uint8_t>((near[0] * 3 + near[1] + 2) >> 2);
      for (int x = 1; x < cw - 1; ++x) {
        const int v = near[x] * 3;
        row[2 * x] = static_cast<uint8_t>((v + near[x - 1] + 1) >> 2);
        row[2 * x + 1] = static_cast<uint8_t>((v + near[x + 1] + 2) >> 2);
      }
      row[2 * cw - 2] = static_cast<uint8_t>((near[cw - 1] * 3 + near[cw - 2] + 1) >> 2);
      row[2 * cw - 1] = near[cw - 1];
      std::memcpy(dst, row.data(), static_cast<size_t>(w));
    } else {  // h2v2: 9/16, 3/16, 3/16, 1/16 of the four nearest
      if (cw == 1) {
        for (int x = 0; x < w; ++x) dst[x] = static_cast<uint8_t>((col[0] * 4 + 8) >> 4);
        continue;
      }
      row[0] = static_cast<uint8_t>((col[0] * 4 + 8) >> 4);
      row[1] = static_cast<uint8_t>((col[0] * 3 + col[1] + 7) >> 4);
      for (int x = 1; x < cw - 1; ++x) {
        row[2 * x] = static_cast<uint8_t>((col[x] * 3 + col[x - 1] + 8) >> 4);
        row[2 * x + 1] = static_cast<uint8_t>((col[x] * 3 + col[x + 1] + 7) >> 4);
      }
      row[2 * cw - 2] = static_cast<uint8_t>((col[cw - 1] * 3 + col[cw - 2] + 8) >> 4);
      row[2 * cw - 1] = static_cast<uint8_t>((col[cw - 1] * 4 + 7) >> 4);
      std::memcpy(dst, row.data(), static_cast<size_t>(w));
    }
  }
}

// libjpeg's YCbCr -> RGB (jdcolor.c: 16-bit fixed point tables, results
// clamped to [0, 255]).
void ycc_to_rgb(const uint8_t* yp, const uint8_t* cb, const uint8_t* cr, size_t n,
                uint8_t* rgb) {
  constexpr int kBits = 16;
  constexpr int64_t kHalf = int64_t{1} << (kBits - 1);
  auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kBits) + 0.5); };
  static const struct Tables {
    int r_cr[256], b_cb[256];
    int64_t g_cr[256], g_cb[256];
  } t = [&] {
    Tables v;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      v.r_cr[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      v.b_cb[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      v.g_cr[i] = -fix(0.71414) * x;
      v.g_cb[i] = -fix(0.34414) * x + kHalf;
    }
    return v;
  }();
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (size_t i = 0; i < n; ++i) {
    const int y = yp[i];
    rgb[3 * i] = clamp(y + t.r_cr[cr[i]]);
    rgb[3 * i + 1] = clamp(y + static_cast<int>((t.g_cb[cb[i]] + t.g_cr[cr[i]]) >> kBits));
    rgb[3 * i + 2] = clamp(y + t.b_cb[cb[i]]);
  }
}

// Decode on the card to planar Y, Cb, Cr at their own resolutions, copy the
// planes to the host, then upsample the chroma and convert to RGB as libjpeg
// does: nvJPEG's own RGB output upsamples the chroma otherwise, which puts
// its pixels several LSB (up to 21 on the fixture frames) from cv2's. False
// on any failure, and for chroma subsamplings other than 4:4:4, 4:2:2,
// 4:2:0, 4:4:0 and gray.
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>& out,
                 int* h, int* w) {
  NvInfo info;
  if (!nv_info(buf, len, &info)) return false;
  *w = info.widths[0];
  *h = info.heights[0];
  if (*w <= 0 || *h <= 0 || *w > kMaxJpegDim || *h > kMaxJpegDim) return false;
  int fx = 1, fy = 1;
  const bool gray = info.subsampling == NVJPEG_CSS_GRAY;
  switch (info.subsampling) {
    case NVJPEG_CSS_444: case NVJPEG_CSS_GRAY: break;
    case NVJPEG_CSS_422: fx = 2; break;
    case NVJPEG_CSS_420: fx = fy = 2; break;
    case NVJPEG_CSS_440: fy = 2; break;
    default: return false;
  }
  const int planes = gray ? 1 : 3;
  size_t offsets[3] = {0, 0, 0}, total = 0;
  for (int c = 0; c < planes; ++c) {
    offsets[c] = total;
    total += static_cast<size_t>(info.widths[c]) * info.heights[c];
  }
  std::vector<uint8_t> host;
  try {
    out.resize(static_cast<size_t>(*w) * *h * 3);
    host.resize(total + (gray ? 0 : 2 * static_cast<size_t>(*w) * *h));
  } catch (const std::bad_alloc&) {
    return false;
  }
  NvState* s = nv_acquire();
  if (s == nullptr) return false;
  bool ok = true;
  if (s->cap < total) {
    if (s->dev != nullptr) cudaFree(s->dev);
    s->dev = nullptr;
    s->cap = 0;
    ok = cudaMalloc(reinterpret_cast<void**>(&s->dev), total) == cudaSuccess;
    if (ok) s->cap = total;
  }
  if (ok) {
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    for (int c = 0; c < planes; ++c) {
      img.channel[c] = s->dev + offsets[c];
      img.pitch[c] = static_cast<size_t>(info.widths[c]);
    }
    ok = nvjpegDecode(nv_handle(), s->state, buf, len,
                      gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img,
                      s->stream) == NVJPEG_STATUS_SUCCESS &&
         cudaMemcpyAsync(host.data(), s->dev, total, cudaMemcpyDeviceToHost,
                         s->stream) == cudaSuccess &&
         cudaStreamSynchronize(s->stream) == cudaSuccess;
  }
  nv_release(s);
  if (!ok) return false;
  const size_t n = static_cast<size_t>(*w) * *h;
  const uint8_t* y = host.data();
  if (gray) {
    for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return true;
  }
  // the Y plane is w wide when nvJPEG pads nothing; the chroma planes are
  // ceil(w / fx) x ceil(h / fy), libjpeg's downsampled sizes
  if (info.widths[0] != *w || info.widths[1] != (*w + fx - 1) / fx ||
      info.heights[1] != (*h + fy - 1) / fy || info.widths[2] != info.widths[1] ||
      info.heights[2] != info.heights[1]) {
    return false;
  }
  uint8_t* cb = host.data() + total;
  uint8_t* cr = cb + n;
  fancy_upsample(host.data() + offsets[1], info.widths[1], info.heights[1], fx, fy, *w, *h, cb);
  fancy_upsample(host.data() + offsets[2], info.widths[2], info.heights[2], fx, fy, *w, *h, cr);
  ycc_to_rgb(y, cb, cr, n, out.data());
  return true;
}

// Whether this process made a CUDA context for the decoder: a process that
// did must not fork.
bool decoder_device_live() { return g_nv_live.load(); }

// Encode h x w interleaved RGB as a baseline JPEG on the card with nvJPEG's
// encoder: 4:2:0 chroma (cv2.imwrite's default), the standard Huffman
// tables, the quality's scaled standard quantization tables. False on any
// failure.
bool encode_jpeg(const uint8_t* rgb, int h, int w, int quality, std::vector<uint8_t>& out) {
  nvjpegHandle_t handle = nv_handle();
  if (handle == nullptr) return false;
  const size_t bytes = static_cast<size_t>(h) * w * 3;
  cudaStream_t stream = nullptr;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  uint8_t* dev = nullptr;
  bool ok =
      cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) == cudaSuccess &&
      nvjpegEncoderStateCreate(handle, &state, stream) == NVJPEG_STATUS_SUCCESS &&
      nvjpegEncoderParamsCreate(handle, &params, stream) == NVJPEG_STATUS_SUCCESS &&
      nvjpegEncoderParamsSetQuality(params, quality, stream) == NVJPEG_STATUS_SUCCESS &&
      nvjpegEncoderParamsSetSamplingFactors(params, NVJPEG_CSS_420, stream) ==
          NVJPEG_STATUS_SUCCESS &&
      nvjpegEncoderParamsSetOptimizedHuffman(params, 0, stream) == NVJPEG_STATUS_SUCCESS &&
      cudaMalloc(reinterpret_cast<void**>(&dev), bytes) == cudaSuccess &&
      cudaMemcpyAsync(dev, rgb, bytes, cudaMemcpyHostToDevice, stream) == cudaSuccess;
  if (ok) {
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = dev;
    img.pitch[0] = static_cast<size_t>(w) * 3;
    size_t length = 0;
    ok = nvjpegEncodeImage(handle, state, params, &img, NVJPEG_INPUT_RGBI, w, h, stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncodeRetrieveBitstream(handle, state, nullptr, &length, stream) ==
             NVJPEG_STATUS_SUCCESS &&
         cudaStreamSynchronize(stream) == cudaSuccess;
    if (ok) {
      out.resize(length);
      ok = nvjpegEncodeRetrieveBitstream(handle, state, out.data(), &length, stream) ==
               NVJPEG_STATUS_SUCCESS &&
           cudaStreamSynchronize(stream) == cudaSuccess;
      out.resize(length);
    }
  }
  if (dev != nullptr) cudaFree(dev);
  if (params != nullptr) nvjpegEncoderParamsDestroy(params);
  if (state != nullptr) nvjpegEncoderStateDestroy(state);
  if (stream != nullptr) cudaStreamDestroy(stream);
  return ok;
}

#endif  // HAVE_LIBJPEG / HAVE_NVJPEG

// Threaded JPEG-decode + crop driver shared by the f32/u8 entry points.
template <typename OutT>
int run_decode_crop(const uint8_t** jpegs, const int64_t* jpeg_lens, int T,
                    const double* inv_trans, int out_h, int out_w, OutT* out,
                    int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > T) n_threads = T;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    std::vector<uint8_t> pixels;  // reused per thread
    int i;
    while ((i = next.fetch_add(1)) < T) {
      int h = 0, w = 0;
      if (!decode_jpeg(jpegs[i], static_cast<size_t>(jpeg_lens[i]), pixels,
                       &h, &w)) {
        failed.store(1);
        continue;
      }
      FrameTask<OutT> task;
      task.src = pixels.data();
      task.src_h = h;
      task.src_w = w;
      task.inv = inv_trans + i * 6;
      task.dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
      process_frame(task, out_h, out_w);
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load() ? -2 : 0;
}

}  // namespace

extern "C" {

// frames: T pointers to H_in x W_in x 3 uint8 RGB buffers (per-frame sizes in
// src_hw, shape (T, 2) as h, w). inv_trans: (T, 6) row-major 2x3 inverse
// affines mapping OUTPUT pixel (x, y) to INPUT coordinates. out: float32
// buffer (T, out_h, out_w, 3). n_threads <= 0 selects hardware concurrency.
void clip_crop_normalize(const uint8_t** frames, const int* src_hw, int T,
                         const double* inv_trans, int out_h, int out_w,
                         float* out, int n_threads) {
  run_crop(frames, src_hw, T, inv_trans, out_h, out_w, out, n_threads);
}

// Same crop, uint8 output, NO normalize (the model normalizes on the device;
// DATASET.DEVICE_PREPROC). Rounding matches cv2.warpAffine-on-uint8 to
// within 1 LSB.
void clip_crop_u8(const uint8_t** frames, const int* src_hw, int T,
                  const double* inv_trans, int out_h, int out_w,
                  uint8_t* out, int n_threads) {
  run_crop(frames, src_hw, T, inv_trans, out_h, out_w, out, n_threads);
}

// The decoder this build links: "libjpeg" or "nvjpeg".
const char* jpeg_decoder_name() { return kDecoderName; }

// 1 once the decoder made a CUDA context in this process (nvJPEG only).
int jpeg_decoder_device_live() { return decoder_device_live() ? 1 : 0; }

// Decode one JPEG to interleaved RGB. Writes the image's size to *h and *w;
// when out is null or cap (bytes) is smaller than h * w * 3 it decodes
// nothing and returns -3, so a caller may ask for the size first. Returns 0
// on success, -2 on a corrupt or oversized image.
int jpeg_decode_rgb(const uint8_t* jpeg, int64_t len, uint8_t* out,
                    int64_t cap, int* h, int* w) {
  if (!jpeg_dims(jpeg, static_cast<size_t>(len), h, w)) return -2;
  const int64_t need = static_cast<int64_t>(*h) * *w * 3;
  if (out == nullptr || cap < need) return -3;
  std::vector<uint8_t> pixels;
  int dh = 0, dw = 0;
  if (!decode_jpeg(jpeg, static_cast<size_t>(len), pixels, &dh, &dw) ||
      dh != *h || dw != *w) {
    return -2;
  }
  std::memcpy(out, pixels.data(), static_cast<size_t>(need));
  return 0;
}

// Encode h x w x 3 interleaved RGB as a baseline JPEG at `quality` (1 to
// 100) with 4:2:0 chroma into out (cap bytes). Writes the encoded size to
// *len. Returns 0 on success, -2 when the encoder fails or the size is out of
// range, -3 when cap is too small (nothing written; *len says what is needed).
int jpeg_encode_rgb(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, int64_t cap,
                    int64_t* len) {
  if (h < 1 || w < 1 || h > kMaxJpegDim || w > kMaxJpegDim || quality < 1 || quality > 100)
    return -2;
  std::vector<uint8_t> jpeg;
  if (!encode_jpeg(rgb, h, w, quality, jpeg) || jpeg.empty()) return -2;
  *len = static_cast<int64_t>(jpeg.size());
  if (out == nullptr || cap < *len) return -3;
  std::memcpy(out, jpeg.data(), jpeg.size());
  return 0;
}

// Threaded JPEG-decode + fused crop/normalize: the full host input pipeline
// for a clip in one native call (the reference's cv2.imread + warpAffine +
// ToTensor + Normalize chain). jpegs: T pointers to encoded buffers with
// byte lengths jpeg_lens. Returns 0 on success, -2 if any frame failed to
// decode.
int clip_decode_crop_normalize(const uint8_t** jpegs, const int64_t* jpeg_lens,
                               int T, const double* inv_trans, int out_h,
                               int out_w, float* out, int n_threads) {
  return run_decode_crop(jpegs, jpeg_lens, T, inv_trans, out_h, out_w, out,
                         n_threads);
}

// Threaded JPEG-decode + crop to a uint8 buffer (device-normalize mode).
int clip_decode_crop_u8(const uint8_t** jpegs, const int64_t* jpeg_lens,
                        int T, const double* inv_trans, int out_h,
                        int out_w, uint8_t* out, int n_threads) {
  return run_decode_crop(jpegs, jpeg_lens, T, inv_trans, out_h, out_w, out,
                         n_threads);
}

}  // extern "C"
