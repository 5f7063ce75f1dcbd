// PWC-Net local correlation (cost volume), forward, one row shift per block,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel islam_tpu/ops/pallas/correlation_kernel.py::
// _corr_all_kernel (reached through _corr_fwd_all).  Same function as
// correlation.cu, with md = 4 (81 displacement channels):
//
//   out[b, (dy+4)*9 + (dx+4), y, x]
//       = (1/C) * sum_c f1[b, c, y, x] * pad4(f2)[b, c, y+dy, x+dx]
//
// f2 is zero-padded by 4 on both spatial axes, the sum accumulates in f32,
// and the output has the input dtype (f32 or bf16).  Inputs are contiguous
// (B, C, H, W).
//
// The names do not carry over: the TPU pair differ only in their grid (one
// dy per step, or all nine), and on this card the split that matters is the
// other one.  correlation.cu (which replaces _corr_dy_kernel) keeps all 81
// sums of a pixel in one thread, one block per 4x32 output tile.  This
// kernel gives each block one row shift dy of one image: the grid is
// (column tile, row tile, b * 9 + dy), each thread keeps the 9 dx sums of
// one pixel, and there are 9x as many blocks.  The small pyramid levels
// (7x10 .. 28x40 at B=8) launch 16-40 blocks of the 81-sum kernel on 132
// SMs; here they launch 144-720.  The cost is that f1 is read once per dy,
// nine times in all, mostly from L2: blocks of one image and neighbouring dy
// are adjacent in the grid.
//
// What bounds it.  The bytes the function must move are both inputs read
// once and the 81-channel output written once (about 127 MB for the five
// levels of one 448x640, B=8 VO forward, 38 us at 3.35 TB/s); the work, 81
// multiply-adds per element of f1, is far below the card's f32 rate.  The
// kernel is memory-bound.  Per chunk of CC channels, a block stages its f1
// tile and the RY rows of f2 shifted by dy (columns x0-4 .. x0+TX+3, zero
// outside the image) in shared memory, with neighbouring threads on
// neighbouring addresses, and writes its 9 output planes once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MD = 4;
constexpr int ND = 2 * MD + 1;   // 9 displacements per axis
constexpr int TX = 32;           // output columns per block (one warp)
constexpr int RY = 4;            // output rows per block
constexpr int CC = 32;           // channels staged per chunk
constexpr int SW = TX + 2 * MD;  // staged f2 row width

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(TX * RY)
corr_fwd_dy_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   T* __restrict__ out, int C, int H, int W, float inv_c) {
  __shared__ float s1[CC][RY][TX];
  __shared__ float s2[CC][RY][SW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * RY;
  const int b = blockIdx.z / ND;
  const int dy = blockIdx.z % ND;  // row shift dy - MD
  const size_t plane = static_cast<size_t>(H) * W;
  const T* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const T* f2b = f2 + static_cast<size_t>(b) * C * plane;

  float acc[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int i = tid; i < CC * RY * TX; i += TX * RY) {
      const int cx = i % TX;
      const int r = (i / TX) % RY;
      const int cc = i / (TX * RY);
      const int gx = x0 + cx, gy = y0 + r, gc = c0 + cc;
      float v = 0.f;
      if (gc < C && gy < H && gx < W)
        v = to_f32(f1b[gc * plane + static_cast<size_t>(gy) * W + gx]);
      s1[cc][r][cx] = v;
    }
    for (int i = tid; i < CC * RY * SW; i += TX * RY) {
      const int cx = i % SW;
      const int r = (i / SW) % RY;
      const int cc = i / (SW * RY);
      const int gx = x0 - MD + cx, gy = y0 + r + dy - MD, gc = c0 + cc;
      float v = 0.f;
      if (gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(f2b[gc * plane + static_cast<size_t>(gy) * W + gx]);
      s2[cc][r][cx] = v;
    }
    __syncthreads();

    const int cn = min(CC, C - c0);
    for (int cc = 0; cc < cn; ++cc) {
      const float a = s1[cc][ty][tx];
#pragma unroll
      for (int dx = 0; dx < ND; ++dx)
        acc[dx] = fmaf(a, s2[cc][ty][tx + dx], acc[dx]);
    }
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (y < H && x < W) {
    T* ob = out + (static_cast<size_t>(b) * ND * ND + dy * ND) * plane +
            static_cast<size_t>(y) * W + x;
#pragma unroll
    for (int dx = 0; dx < ND; ++dx) store(ob + dx * plane, acc[dx] * inv_c);
  }
}

template <typename T>
void launch(const void* f1, const void* f2, void* out, int B, int C, int H,
            int W, float inv_c, cudaStream_t stream) {
  const dim3 block(TX, RY);
  const dim3 grid((W + TX - 1) / TX, (H + RY - 1) / RY, B * ND);
  corr_fwd_dy_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), C, H, W, inv_c);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int islam_corr_fwd_dy(const void* f1, const void* f2, void* out,
                                 int B, int C, int H, int W, float inv_c,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * ND > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dtype == 0) {
    launch<float>(f1, f2, out, B, C, H, W, inv_c, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(f1, f2, out, B, C, H, W, inv_c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
