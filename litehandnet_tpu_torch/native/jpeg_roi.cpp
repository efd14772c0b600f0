// Native host-side JPEG ROI decoder for the litehandnet_tpu_torch data loader
// (a copy of litehandnet_tpu/native/jpeg_roi.cpp; the decode is the same).
//
// Replaces the hot part of the reference's data path — full-image decode in
// forked DataLoader workers (reference datasets/data_pipeline/loading.py:6-89
// via mmcv/cv2) — with a C++ fast path for the host:
//
//   * libjpeg-turbo partial decode: jpeg_crop_scanline + jpeg_skip_scanlines
//     decode ONLY the bbox ROI window instead of the full frame, so cost
//     scales with the crop, not the source image.
//   * DCT-domain scaled decode (scale_num/8): when the ROI must be downscaled
//     to fit the canvas anyway, decoding at 1/2..7/8 scale skips most of the
//     IDCT + color-convert work before the fine bilinear resize.
//   * a pthread worker pool decodes a whole batch per call — one GIL release
//     per batch instead of per image, and true parallelism on many-core
//     hosts (Python threads + cv2 parallelize too, but pay per-call overhead).
//
// Geometry contract matches data/image_io.py::_load_image exactly: source-image
// coords map to canvas coords as (p - offset) * scale, with offset/scale
// computed by the same formulas (ROI clip, f = min(H0/h, W0/w),
// nw = max(int(w*f), 1)). Pixel content is tolerance-equal (resampling path
// differs when DCT scaling engages); coordinate math is bit-identical.
//
// Build: g++ -O3 -march=native -fPIC -shared -std=c++17 jpeg_roi.cpp
//        -o _jpeg_roi.so -ljpeg -lpthread (native/__init__.py does it)

#include <cstddef>  // jpeglib.h uses size_t/FILE without including them
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

// Bilinear uint8 resize, half-pixel-center convention (cv2/PIL-compatible:
// src = (dst + 0.5) * (in/out) - 0.5). RGB interleaved. Separable: a
// vertical blend over contiguous rows (autovectorizes under -O3
// -march=native), then a horizontal gather pass with precomputed tables.
void resize_bilinear_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst,
                         int dh, int dw) {
  const float fx = static_cast<float>(sw) / dw;
  const float fy = static_cast<float>(sh) / dh;
  std::vector<int> xas(dw), xbs(dw);
  std::vector<float> wxs(dw);
  for (int x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * fx - 0.5f;
    sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
    int x0 = static_cast<int>(sx);
    xas[x] = x0 * 3;
    xbs[x] = std::min(x0 + 1, sw - 1) * 3;
    wxs[x] = sx - x0;
  }
  std::vector<float> vtmp(static_cast<size_t>(sw) * 3);
  const int row_n = sw * 3;
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * fy - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    int y0 = static_cast<int>(sy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = sy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * row_n;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * row_n;
    float* v = vtmp.data();
    for (int i = 0; i < row_n; ++i)  // contiguous: vectorized
      v[i] = r0[i] + (r1[i] - r0[i]) * wy;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int a = xas[x], b = xbs[x];
      const float wx = wxs[x];
      out[x * 3 + 0] =
          static_cast<uint8_t>(v[a + 0] + (v[b + 0] - v[a + 0]) * wx + 0.5f);
      out[x * 3 + 1] =
          static_cast<uint8_t>(v[a + 1] + (v[b + 1] - v[a + 1]) * wx + 0.5f);
      out[x * 3 + 2] =
          static_cast<uint8_t>(v[a + 2] + (v[b + 2] - v[a + 2]) * wx + 0.5f);
    }
  }
}

struct Job {
  const char* path;
  uint8_t* canvas;     // [H0, W0, 3], caller-zeroed
  float cx, cy, half;  // ROI window in source coords; half < 0 => no ROI
  float* geom;         // out [4]: off_x, off_y, scale_x, scale_y
  int* status;         // out: 0 ok, nonzero = fall back to Python
};

// Decode one JPEG into the canvas following _load_image semantics.
int decode_one(const Job& job, int H0, int W0) {
  job.geom[0] = 0.0f;
  job.geom[1] = 0.0f;
  job.geom[2] = 1.0f;
  job.geom[3] = 1.0f;

  FILE* fp = std::fopen(job.path, "rb");
  if (!fp) return 1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  // declared before setjmp: error_exit longjmps over this scope, which
  // would skip the destructors (UB + leak) of anything constructed after
  std::vector<uint8_t> roi_buf;
  std::vector<uint8_t> spill;  // direct-mode rows wider than the canvas

  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 2;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);

  const int w = static_cast<int>(cinfo.image_width);
  const int h = static_cast<int>(cinfo.image_height);
  if (w <= 0 || h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 3;
  }

  // --- geometry (must mirror _load_image bit-for-bit) ---
  int x0 = 0, y0 = 0, x1 = w, y1 = h;
  if ((h > H0 || w > W0) && job.half >= 0.0f) {
    int rx0 = std::max(static_cast<int>(std::floor(job.cx - job.half)), 0);
    int ry0 = std::max(static_cast<int>(std::floor(job.cy - job.half)), 0);
    int rx1 = std::min(static_cast<int>(std::ceil(job.cx + job.half)), w);
    int ry1 = std::min(static_cast<int>(std::ceil(job.cy + job.half)), h);
    if (rx1 > rx0 && ry1 > ry0) {
      x0 = rx0; y0 = ry0; x1 = rx1; y1 = ry1;
      job.geom[0] = static_cast<float>(x0);
      job.geom[1] = static_cast<float>(y0);
    }
  }
  const int rw = x1 - x0, rh = y1 - y0;
  int out_w = rw, out_h = rh;  // final dims pasted into the canvas
  bool need_resize = false;
  if (rh > H0 || rw > W0) {
    // match Python: f = min(H0/h, W0/w); n = max(int(dim * f), 1)
    double f = std::min(static_cast<double>(H0) / rh,
                        static_cast<double>(W0) / rw);
    out_w = std::max(static_cast<int>(rw * f), 1);
    out_h = std::max(static_cast<int>(rh * f), 1);
    job.geom[2] = static_cast<float>(out_w) / rw;
    job.geom[3] = static_cast<float>(out_h) / rh;
    need_resize = true;
  }

  // --- choose DCT decode scale: smallest SIMD scale s/8 >= fine-scale.
  // Only 8/8, 4/8, 2/8, 1/8 hit libjpeg-turbo's SIMD IDCT kernels; the
  // intermediate ratios fall back to scalar IDCT and decode SLOWER than
  // full size (measured: 7/8 at 0.54x the 8/8 rate on this host).
  int scale_num = 8;
  if (need_resize) {
    double fine = std::max(static_cast<double>(out_w) / rw,
                           static_cast<double>(out_h) / rh);
    for (int s : {1, 2, 4}) {
      if (fine <= s / 8.0 + 1e-9) {
        scale_num = s;
        break;
      }
    }
  }
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;

  jpeg_calc_output_dimensions(&cinfo);
  const double sx = static_cast<double>(cinfo.output_width) / w;
  const double sy = static_cast<double>(cinfo.output_height) / h;

  if (cinfo.progressive_mode) {
    // jpeg_crop_scanline/skip_scanlines don't support progressive JPEGs;
    // rare in these datasets -> let Python decode it
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 7;
  }

  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {  // CMYK etc. -> Python fallback
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 4;
  }

  // ROI in the scaled output coordinate space (cover the full-res window)
  int sx0 = std::max(static_cast<int>(std::floor(x0 * sx)), 0);
  int sy0 = std::max(static_cast<int>(std::floor(y0 * sy)), 0);
  int sx1 = std::min(static_cast<int>(std::ceil(x1 * sx)),
                     static_cast<int>(cinfo.output_width));
  int sy1 = std::min(static_cast<int>(std::ceil(y1 * sy)),
                     static_cast<int>(cinfo.output_height));

  // libjpeg-turbo: restrict columns (iMCU-aligned; may widen the window)
  JDIMENSION crop_x = static_cast<JDIMENSION>(sx0);
  JDIMENSION crop_w = static_cast<JDIMENSION>(sx1 - sx0);
  jpeg_crop_scanline(&cinfo, &crop_x, &crop_w);
  const int srw = static_cast<int>(crop_w);
  const int srh = sy1 - sy0;

  const bool direct =
      !need_resize && scale_num == 8 && srh <= H0 && srw >= rw;
  uint8_t* dest = nullptr;
  int dest_stride = 0;
  if (direct) {
    // full-scale ROI that fits the canvas: decode straight into it, then
    // shift left in-place if iMCU alignment added left margin
    dest = job.canvas;
    dest_stride = W0 * 3;
  } else {
    roi_buf.resize(static_cast<size_t>(srh) * srw * 3);
    dest = roi_buf.data();
    dest_stride = srw * 3;
  }

  if (sy0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(sy0));
  const int lpad = static_cast<int>(crop_x) - (direct ? x0 : sx0);
  int row = 0;
  while (row < srh &&
         cinfo.output_scanline < static_cast<JDIMENSION>(sy1)) {
    uint8_t* rowptr;
    if (direct && srw > W0) {
      if (spill.empty()) spill.resize(static_cast<size_t>(srw) * 3);
      rowptr = spill.data();
    } else {
      rowptr = dest + static_cast<size_t>(row) * dest_stride;
    }
    JSAMPROW rows[1] = {rowptr};
    JDIMENSION got = jpeg_read_scanlines(&cinfo, rows, 1);
    if (got == 0) break;
    if (direct && srw > W0) {
      // spill rows are aligned + clipped to the ROI here; no post-fixup
      const int shift = std::max(-lpad, 0);
      std::memcpy(dest + static_cast<size_t>(row) * dest_stride,
                  rowptr + shift * 3,
                  static_cast<size_t>(std::min({srw - shift, rw, W0})) * 3);
    }
    ++row;
  }
  if (cinfo.output_scanline < cinfo.output_height)
    jpeg_skip_scanlines(
        &cinfo, static_cast<JDIMENSION>(cinfo.output_height -
                                        cinfo.output_scanline));
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  if (row < srh) return 5;

  if (direct) {
    // drop the iMCU left margin (crop_x <= x0 requested) and zero everything
    // beyond the true ROI width rw, matching Python's canvas[:h, :w] = roi.
    // Spill rows (srw > W0) were already shifted + clipped during the
    // scanline copy above — shifting them again would displace the image
    // by the alignment offset (srw is constant per image, so either every
    // row spilled or none did).
    const int keep = std::min(rw, W0);
    if (lpad < 0 && srw <= W0) {
      const int shift = -lpad;
      for (int yy = 0; yy < row; ++yy) {
        uint8_t* r = job.canvas + static_cast<size_t>(yy) * W0 * 3;
        std::memmove(r, r + shift * 3, static_cast<size_t>(keep) * 3);
        std::memset(r + keep * 3, 0, static_cast<size_t>(W0 - keep) * 3);
      }
    } else if (keep < W0) {
      for (int yy = 0; yy < row; ++yy) {
        uint8_t* r = job.canvas + static_cast<size_t>(yy) * W0 * 3;
        std::memset(r + keep * 3, 0, static_cast<size_t>(W0 - keep) * 3);
      }
    }
    return 0;
  }

  // buffered path: trim the iMCU left margin, then resize into the canvas
  const int trim = std::max(sx0 - static_cast<int>(crop_x), 0) * 3;
  const int eff_w = std::min(srw - trim / 3, sx1 - sx0);
  if (eff_w <= 0) return 6;
  if (need_resize) {
    std::vector<uint8_t> tight;
    const uint8_t* src = roi_buf.data() + trim;
    int stride_px = srw;
    if (trim > 0 || eff_w != srw) {
      tight.resize(static_cast<size_t>(srh) * eff_w * 3);
      for (int yy = 0; yy < srh; ++yy)
        std::memcpy(tight.data() + static_cast<size_t>(yy) * eff_w * 3,
                    roi_buf.data() + static_cast<size_t>(yy) * srw * 3 + trim,
                    static_cast<size_t>(eff_w) * 3);
      src = tight.data();
      stride_px = eff_w;
      (void)stride_px;
    }
    std::vector<uint8_t> resized(static_cast<size_t>(out_h) * out_w * 3);
    resize_bilinear_rgb(src, srh, eff_w, resized.data(), out_h, out_w);
    for (int yy = 0; yy < out_h; ++yy)
      std::memcpy(job.canvas + static_cast<size_t>(yy) * W0 * 3,
                  resized.data() + static_cast<size_t>(yy) * out_w * 3,
                  static_cast<size_t>(out_w) * 3);
  } else {
    const int copy_w = std::min(eff_w, W0);
    const int copy_h = std::min(srh, H0);
    for (int yy = 0; yy < copy_h; ++yy)
      std::memcpy(job.canvas + static_cast<size_t>(yy) * W0 * 3,
                  roi_buf.data() + static_cast<size_t>(yy) * srw * 3 + trim,
                  static_cast<size_t>(copy_w) * 3);
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode a batch of JPEGs into caller-zeroed canvases [n, H0, W0, 3].
// centers: [n, 2] ROI centers (source coords); halves: [n] half-window
// (negative = whole image). geoms out: [n, 4] = off_x, off_y, sx, sy.
// statuses out: [n] 0 = ok, nonzero = caller should fall back for that image.
void lhn_decode_roi_batch(int n, const char** paths, uint8_t* canvases,
                          int H0, int W0, const float* centers,
                          const float* halves, float* geoms, int* statuses,
                          int n_threads) {
  if (n <= 0) return;
  std::atomic<int> next(0);
  const size_t canvas_sz = static_cast<size_t>(H0) * W0 * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Job job;
      job.path = paths[i];
      job.canvas = canvases + canvas_sz * i;
      job.cx = centers[2 * i];
      job.cy = centers[2 * i + 1];
      job.half = halves[i];
      job.geom = geoms + 4 * i;
      statuses[i] = decode_one(job, H0, W0);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  if (nt == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

int lhn_abi_version() { return 1; }

}  // extern "C"
