// Host-side image preparation for the folder datasets, built with the host
// C++ compiler (no CUDA) and bound with ctypes by islam_tpu_torch/data/native.py.
//
// The port's copy of native/preproc.cpp (the fused crop, /255 and normalise
// of the JAX package's pipeline), with the three per-byte loops that the
// folder datasets add, so that no image library is needed:
//
//   png_unfilter       PNG's five row filters undone (None, Sub, Up,
//                      Average, Paeth); Average and Paeth depend on the left
//                      neighbour, a serial loop along each row.
//   resize_linear_u8   cv2.resize(INTER_LINEAR) of a uint8 image, bit for
//                      bit: 11-bit fixed-point taps, a horizontal pass into
//                      int32 and cv2's vertical rounding.
//   remap_linear_u8    cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of a
//                      uint8 image by float maps, bit for bit: a float32
//                      lerp along x, then y, rounded half to even.
//
// Each has a numpy version beside its binding, which the tests hold it to.
// Compile without floating-point contraction (-ffp-contract=off): the
// remap's lerps must round as cv2's do.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// Fused center-crop + normalize.
//
// src:  n images, uint8 HWC (BGR as cv2 loads them), size (sh, sw, 3)
// dst_raw:  n x (th, tw, 3) float32, value = pixel / 255
// dst_norm: n x (th, tw, 3) float32, value = (pixel/255 - mean[c]) / std[c]
//           (pass dst_norm = nullptr to skip)
// Crop is centered: x0 = (sw - tw) / 2, y0 = (sh - th) / 2.
void preproc_batch(const uint8_t* src, int n, int sh, int sw,
                   int th, int tw,
                   const float* mean, const float* stdv,
                   float* dst_raw, float* dst_norm,
                   int num_threads) {
  const int x0 = (sw - tw) / 2;
  const int y0 = (sh - th) / 2;
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {0, 0, 0};
  for (int c = 0; c < 3; c++) inv_std[c] = 1.0f / stdv[c];

  auto work = [&](int begin, int end) {
    for (int i = begin; i < end; i++) {
      const uint8_t* s = src + (size_t)i * sh * sw * 3;
      float* r = dst_raw + (size_t)i * th * tw * 3;
      float* m = dst_norm ? dst_norm + (size_t)i * th * tw * 3 : nullptr;
      for (int y = 0; y < th; y++) {
        const uint8_t* srow = s + ((size_t)(y0 + y) * sw + x0) * 3;
        float* rrow = r + (size_t)y * tw * 3;
        float* mrow = m ? m + (size_t)y * tw * 3 : nullptr;
        for (int x = 0; x < tw * 3; x += 3) {
          const float b = srow[x + 0] * inv255;
          const float g = srow[x + 1] * inv255;
          const float rr = srow[x + 2] * inv255;
          rrow[x + 0] = b;
          rrow[x + 1] = g;
          rrow[x + 2] = rr;
          if (mrow) {
            mrow[x + 0] = (b - mean[0]) * inv_std[0];
            mrow[x + 1] = (g - mean[1]) * inv_std[1];
            mrow[x + 2] = (rr - mean[2]) * inv_std[2];
          }
        }
      }
    }
  };

  int nt = std::max(1, std::min(num_threads, n));
  if (nt == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int b = t * per, e = std::min(n, b + per);
    if (b >= e) break;
    threads.emplace_back(work, b, e);
  }
  for (auto& th_ : threads) th_.join();
}

// PNG row un-filtering (PNG spec, section 9).
//
// src: height rows of (1 + row_bytes) bytes, each a filter type byte and
//      the filtered row, as zlib inflates the IDAT stream
// dst: height x row_bytes bytes, the image rows
// bpp: bytes per complete pixel (at least 1), the distance to "left"
// Returns 0, or 1 + the row index of an unknown filter type.
int png_unfilter(const uint8_t* src, uint8_t* dst, int height, int row_bytes,
                 int bpp) {
  for (int y = 0; y < height; y++) {
    const uint8_t* in = src + (size_t)y * (row_bytes + 1);
    const int filter = in[0];
    in += 1;
    uint8_t* out = dst + (size_t)y * row_bytes;
    const uint8_t* up = y ? out - row_bytes : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(out, in, row_bytes);
        break;
      case 1:
        for (int x = 0; x < row_bytes; x++)
          out[x] = in[x] + (x >= bpp ? out[x - bpp] : 0);
        break;
      case 2:
        for (int x = 0; x < row_bytes; x++)
          out[x] = in[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (int x = 0; x < row_bytes; x++) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = in[x] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (int x = 0; x < row_bytes; x++) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = in[x] + pred;
        }
        break;
      default:
        return 1 + y;
    }
  }
  return 0;
}

// The source index and 11-bit weights of one output coordinate, as cv2's
// resize computes them (float fx, floor, clamped at both edges).
static void linear_tap(int d, double scale, int size, bool clamp_edges,
                       int* s, int* w0, int* w1) {
  float f = (float)((d + 0.5) * scale - 0.5);
  int i = (int)std::floor(f);
  f -= (float)i;
  if (clamp_edges) {
    if (i < 0) { f = 0.f; i = 0; }
    if (i >= size - 1) { f = 0.f; i = size - 1; }
  }
  *s = i;
  *w0 = (int)std::nearbyint((1.f - f) * 2048.f);
  *w1 = (int)std::nearbyint(f * 2048.f);
}

// cv2.resize(src, (tw, th), interpolation=INTER_LINEAR) for uint8 HWC.
void resize_linear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                      int th, int tw, int cn) {
  const double sx_scale = (double)sw / tw, sy_scale = (double)sh / th;
  std::vector<int> xofs(tw), xa0(tw), xa1(tw);
  for (int x = 0; x < tw; x++)
    linear_tap(x, sx_scale, sw, true, &xofs[x], &xa0[x], &xa1[x]);
  // the horizontal passes of the two source rows; consecutive output rows
  // share source rows, so each pass is kept with its row index
  std::vector<int32_t> buf0((size_t)tw * cn), buf1((size_t)tw * cn);
  int32_t* S0 = buf0.data();
  int32_t* S1 = buf1.data();
  int have0 = -1, have1 = -1;
  auto hpass = [&](int sy, int32_t* out) {
    const uint8_t* s = src + (size_t)sy * sw * cn;
    for (int x = 0; x < tw; x++) {
      const uint8_t* p0 = s + (size_t)xofs[x] * cn;
      const uint8_t* p1 = s + (size_t)std::min(xofs[x] + 1, sw - 1) * cn;
      for (int c = 0; c < cn; c++)
        out[x * cn + c] = p0[c] * xa0[x] + p1[c] * xa1[x];
    }
  };
  for (int y = 0; y < th; y++) {
    int sy, b0, b1;
    linear_tap(y, sy_scale, sh, false, &sy, &b0, &b1);
    const int r0 = std::min(std::max(sy, 0), sh - 1);
    const int r1 = std::min(std::max(sy + 1, 0), sh - 1);
    if (r0 != have0) {
      if (r0 == have1) {
        std::swap(S0, S1);
        std::swap(have0, have1);
      } else {
        hpass(r0, S0);
        have0 = r0;
      }
    }
    if (r1 != have1) {
      hpass(r1, S1);
      have1 = r1;
    }
    uint8_t* d = dst + (size_t)y * tw * cn;
    for (int x = 0; x < tw * cn; x++) {
      // cv2's vertical step: 16-bit high products of (S >> 4) and the
      // weights, then (sum + 2) >> 2
      const int v = (((S0[x] >> 4) * b0) >> 16) + (((S1[x] >> 4) * b1) >> 16);
      d[x] = (uint8_t)std::min(std::max((v + 2) >> 2, 0), 255);
    }
  }
}

// cv2.remap(src, map_x, map_y, INTER_LINEAR) for uint8 HWC, constant 0
// border: taps outside the image read 0.
void remap_linear_u8(const uint8_t* src, int sh, int sw, int cn,
                     const float* map_x, const float* map_y, uint8_t* dst,
                     int th, int tw) {
  for (int y = 0; y < th; y++) {
    for (int x = 0; x < tw; x++) {
      const size_t o = (size_t)y * tw + x;
      const float mx = map_x[o], my = map_y[o];
      const float fx0 = std::floor(mx), fy0 = std::floor(my);
      const float fx = mx - fx0, fy = my - fy0;
      const int x0 = (int)fx0, y0 = (int)fy0;
      uint8_t* d = dst + o * cn;
      for (int c = 0; c < cn; c++) {
        float p[4];
        for (int k = 0; k < 4; k++) {
          const int xx = x0 + (k & 1), yy = y0 + (k >> 1);
          p[k] = (xx >= 0 && xx < sw && yy >= 0 && yy < sh)
                     ? (float)src[((size_t)yy * sw + xx) * cn + c] : 0.f;
        }
        const float a = p[0] + fx * (p[1] - p[0]);
        const float b = p[2] + fx * (p[3] - p[2]);
        const float v = std::nearbyint(a + fy * (b - a));
        d[c] = (uint8_t)std::min(std::max(v, 0.f), 255.f);
      }
    }
  }
}

}  // extern "C"
