// PWC-Net local correlation (cost volume), forward, designed for Hopper
// (sm_90a).  The main path's kernel.
//
// Replaces the TPU kernel islam_tpu/ops/pallas/correlation_kernel.py::
// _corr_dy_kernel (reached through _corr_fwd / correlation_pallas).  Same
// function, with md = 4 (81 displacement channels):
//
//   out[b, (dy+4)*9 + (dx+4), y, x]
//       = (1/C) * sum_c f1[b, c, y, x] * pad4(f2)[b, c, y+dy, x+dx]
//
// f2 is zero-padded by 4 on both spatial axes, the sum accumulates in f32,
// and the output has the input dtype (f32 or bf16).  Inputs are contiguous
// (B, C, H, W), at any 2-byte-aligned offset (batch slices of a shared
// pyramid included).
//
// What bounds it.  Bytes: both inputs read once and the 81-channel output
// written once are about 127 MB for the five pyramid levels of one 448x640,
// B=8 VO forward (38 us at 3.35 TB/s); the 1.3 GFLOP of multiply-adds take
// about 20 us at the f32 FMA rate.
//
// What the design does.  correlation.cu (PR 1's port) gives each thread one
// pixel and 81 serial sums, loads one shared value per FMA, and launches
// 16-112 blocks on 132 SMs at the three coarse levels; nothing is in flight
// while a block computes.  Here:
//
// 1. A grid that fills the card.  A block owns one image (grid z), a strip
//    of ry rows by a tile of tw columns (grid x), and a group of ndy of the
//    nine row shifts dy (grid y).  Its threads split the group's dy, so f1
//    and the ry+ndy-1 shifted f2 rows are staged once per block and shared
//    by those dy.  At the fine levels the group is all nine dy and f1 is
//    read from device memory once; at the coarse levels the group is one or
//    three dy, and the re-reads of f1 come from L2 (each input of those
//    levels is at most 3.4 MB).  Where that leaves few threads a block (large
//    C, small planes), ns channel slices split each chunk's channels, and the
//    partial sums are reduced through shared memory in slice order, with no
//    atomics: the result is bitwise reproducible.  The launch plan (tile
//    sizes, grid, block, shared bytes) comes from _plan_sm90 in
//    ops/correlation.py, which picks tw from W so few lanes idle at W = 10,
//    20, 40; the C entry checks that the plan is consistent.
// 2. Register tiling.  A thread owns 4 neighbouring x of one row for its dy
//    and keeps their 9 dx sums (36 f32 accumulators) in registers.  Per
//    channel it loads its 4 f1 values and the 12 f2 values of its shifted
//    row (x-4 .. x+7) with four vector shared loads (16 bytes each in f32,
//    8 in bf16) and makes 36 FMAs from them: one load per 9 FMAs.
// 3. Asynchronous staging.  Channel chunks go global -> shared with
//    cp.async into a ring of three buffers, so the next two chunks are in
//    flight while one is summed (commit_group / wait_group 1, one barrier a
//    chunk).  The halo and everything outside the image are zero-filled by
//    the src-size-0 form of cp.async, not by branches around the sums.  The
//    copies are 16 bytes where the rows and the base are 16-byte aligned,
//    else 8 or 4 bytes (f32 at W = 10, bf16 at W = 10 and 20, odd
//    batch-slice offsets); bf16 rows that are not 4-byte aligned (odd W or
//    offset) are staged by plain 2-byte loads.  A thread keeps one spatial
//    slot of a staged tile and walks its channels, so a copy costs a few
//    instructions.  TMA is not used: its 16-byte stride rule cannot hold at
//    W = 10.
// 4. Each output written once, vectorised.  The sums are scaled by 1/C and
//    converted in registers and stored 4 x at a time (16 bytes in f32, 8 in
//    bf16) where W is a multiple of 4, else as scalar stores whose lanes
//    cover each sector together.  The kernel allocates nothing.
// 5. CUDA-core f32 FMAs, no tensor cores.  Every level is bounded by bytes,
//    not by the FMA rate; TF32, the only tensor-core type for f32 inputs,
//    keeps about 3 decimal digits and would break the 1e-5 x max|plain|
//    tolerance the main path is held to.  The bf16 instantiation takes the
//    same route (a bf16 tensor-core variant belongs with --bf16).
//
// Registers are capped at 72 (three blocks of 288 threads an SM), with no
// spills; that was the fastest of 1, 2 and 3 blocks an SM at 448x640.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MD = 4;
constexpr int ND = 2 * MD + 1;  // 9 displacements per axis
constexpr int XS = 4;           // output columns per thread
constexpr int NACC = ND * XS;   // accumulators per thread
constexpr int STAGES = 3;       // ring of channel-chunk buffers
constexpr int MAX_THREADS = 288;  // the plan's largest block: 9 x 4 x 8
constexpr int MIN_BLOCKS = 3;    // blocks an SM must hold: <= 72 registers
constexpr int MAX_SMEM = 232448;

struct Geometry {
  int C, H, W;
  float inv_c;
  int tw, ry, ndy, ns, cc;  // the launch plan's tile
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Elements of one ring buffer: the f1 tile (cc x ry x tw), padded to 16
// bytes, then the f2 rows (cc x (ry+ndy-1) x sw).  The left margin of a
// staged f2 row is 16 bytes, so 16-byte copies stay aligned.
template <typename T>
__host__ __device__ constexpr int margin() { return 16 / sizeof(T); }
__host__ __device__ inline int f1_elems(const Geometry& g) {
  return round_up(g.cc * g.ry * g.tw, 8);
}
template <typename T>
__host__ __device__ int stage_elems(const Geometry& g) {
  const int sw = g.tw + 2 * margin<T>();
  return round_up(f1_elems(g) + g.cc * (g.ry + g.ndy - 1) * sw, 8);
}
template <typename T>
int smem_bytes(const Geometry& g) {
  const int ring = STAGES * stage_elems<T>(g) * static_cast<int>(sizeof(T));
  const int red = g.ns > 1 ? g.ns * g.ndy * g.ry * (g.tw / XS) * NACC * 4 : 0;
  return ring > red ? ring : red;
}

// Elements of one copy of VEC bytes (2-byte copies are plain loads).
template <typename T, int VEC>
__host__ __device__ constexpr int granule() {
  return VEC >= static_cast<int>(sizeof(T)) ? VEC / sizeof(T) : 1;
}

// One copy of VEC bytes global -> shared, zero-filled when !ok.
template <typename T, int VEC>
__device__ __forceinline__ void copy(T* dst, const T* src, bool ok) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? __ldg(reinterpret_cast<const uint16_t*>(src)) : uint16_t(0);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? VEC : 0;
    if constexpr (VEC == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(n) : "memory");
    } else if constexpr (VEC == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(d), "l"(src), "r"(n) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(d), "l"(src), "r"(n) : "memory");
    }
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four neighbouring values from shared memory as f32, in one vector load.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float* v, float s) {
  *reinterpret_cast<float4*>(p) =
      make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(b)))
          << 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v,
                                       float s) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack2(v[0] * s, v[1] * s), pack2(v[2] * s, v[3] * s));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Issue the copies of one staged tile of cc channels x nb rows x nq
// granules of GE elements: granule (a, b, q) comes from channel c0+a, image
// row y_first+b, columns x_first+q*GE .., and goes to dst + (a*nb + b)*row_w
// + q*GE.  A thread keeps one spatial slot (b, q) and walks the channels, so
// the slot's bounds and offsets are computed once a chunk.  A granule lies
// wholly inside or outside the image (the plan's alignment rules), so one
// bound test zero-fills it, as do channels past cn.
template <typename T, int VEC>
__device__ __forceinline__ void stage_tile(
    T* dst, const T* src, const Geometry& g, int nb, int nq, int row_w,
    int x_first, int y_first, int c0, int cn) {
  constexpr int GE = granule<T, VEC>();
  const int nsp = nb * nq, n = blockDim.x;
  const int sstep = n >= nsp ? nsp : n;        // spatial slots a pass
  const int cstep = n >= nsp ? n / nsp : 1;    // channels a pass
  if (threadIdx.x >= sstep * cstep) return;
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const T* base = src + c0 * plane;
  for (int sp = threadIdx.x % sstep; sp < nsp; sp += sstep) {
    const int b = sp / nq, q = sp % nq;
    const int gy = y_first + b, gx = x_first + q * GE;
    const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
    const T* s = base + (in ? static_cast<size_t>(gy) * g.W + gx : 0);
    T* d = dst + b * row_w + q * GE;
    for (int a = threadIdx.x / sstep; a < g.cc; a += cstep) {
      const bool ok = in && a < cn;
      copy<T, VEC>(d + a * nb * row_w, ok ? s + a * plane : src, ok);
    }
  }
}

// Issue the copies of channels c0 .. c0+cc-1 into ring buffer st: the f1
// tile (rows y0 .., columns x0 ..) and the f2 rows y0+dy0-4 ..
// y0+ry+dy0+ndy-6, columns x0-L .. x0+tw+L-1.
template <typename T, int VEC>
__device__ __forceinline__ void stage_chunk(
    T* st, const T* f1b, const T* f2b, const Geometry& g, int x0, int y0,
    int ys0, int c0) {
  constexpr int GE = granule<T, VEC>();
  constexpr int L = margin<T>();
  const int sw = g.tw + 2 * L;
  const int cn = min(g.cc, g.C - c0);
  stage_tile<T, VEC>(st, f1b, g, g.ry, g.tw / GE, g.tw, x0, y0, c0, cn);
  stage_tile<T, VEC>(st + f1_elems(g), f2b, g, g.ry + g.ndy - 1, sw / GE,
                     sw, x0 - L, ys0, c0, cn);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
corr_sm90_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                 T* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  constexpr int L = margin<T>();

  // Thread -> (slice s, dy in group j, row r, column strip k), k fastest.
  const int nk = g.tw / XS;
  const int tps = g.ndy * g.ry * nk;  // threads per slice
  const int t = threadIdx.x % tps, s = threadIdx.x / tps;
  const int k = t % nk, r = (t / nk) % g.ry, j = t / (nk * g.ry);

  const int ncol = (g.W + g.tw - 1) / g.tw;
  const int x0 = (blockIdx.x % ncol) * g.tw;
  const int y0 = (blockIdx.x / ncol) * g.ry;
  const int dy0 = blockIdx.y * g.ndy;  // first row shift of the group, 0..8
  const int b = blockIdx.z;
  const size_t image = static_cast<size_t>(g.C) * g.H * g.W;
  const T* f1b = f1 + b * image;
  const T* f2b = f2 + b * image;
  const int ys0 = y0 + dy0 - MD;  // image row of staged f2 row 0

  const int sw = g.tw + 2 * L, sr = g.ry + g.ndy - 1;
  const int se = stage_elems<T>(g);
  const int s1_off = r * g.tw + XS * k;
  const int s2_off = f1_elems(g) + (r + j) * sw + (L - MD) + XS * k;
  const int s1_step = g.ry * g.tw, s2_step = sr * sw;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int nchunks = (g.C + g.cc - 1) / g.cc;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nchunks)
      stage_chunk<T, VEC>(ring + p * se, f1b, f2b, g, x0, y0, ys0, p * g.cc);
    commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    wait_pending<STAGES - 2>();  // this thread's copies of chunk ch landed
    __syncthreads();  // everyone's landed; everyone is done with chunk ch-1
    const int nxt = ch + STAGES - 1;
    if (nxt < nchunks)
      stage_chunk<T, VEC>(ring + (nxt % STAGES) * se, f1b, f2b, g, x0, y0,
                          ys0, nxt * g.cc);
    commit();

    const T* st = ring + (ch % STAGES) * se;
    const T* a_p = st + s1_off;
    const T* b_p = st + s2_off;
    const int cn = min(g.cc, g.C - ch * g.cc);
    for (int c = s; c < cn; c += g.ns) {
      float a[XS], v[XS + 2 * MD];
      load4(a_p + c * s1_step, a);
      load4(b_p + c * s2_step, v);
      load4(b_p + c * s2_step + 4, v + 4);
      load4(b_p + c * s2_step + 8, v + 8);
#pragma unroll
      for (int dx = 0; dx < ND; ++dx) {
#pragma unroll
        for (int i = 0; i < XS; ++i)
          acc[dx * XS + i] = fmaf(a[i], v[i + dx], acc[dx * XS + i]);
      }
    }
  }

  const size_t plane = static_cast<size_t>(g.H) * g.W;
  if (g.ns > 1) {
    // Every slice parks its sums in shared memory; then each thread adds up
    // a few outputs over the slices, in slice order, and stores them with x
    // fastest across the lanes.
    wait_pending<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    float4* mine = reinterpret_cast<float4*>(red + threadIdx.x * NACC);
#pragma unroll
    for (int i = 0; i < ND; ++i)
      mine[i] = make_float4(acc[i * XS], acc[i * XS + 1], acc[i * XS + 2],
                            acc[i * XS + 3]);
    __syncthreads();
    T* ob = out + (static_cast<size_t>(b) * ND * ND + dy0 * ND) * plane;
    for (int e = threadIdx.x; e < NACC * tps; e += blockDim.x) {
      const int xi = e % XS, kk = (e / XS) % nk, u = e / (XS * nk);
      const int rr = u % g.ry, jj = (u / g.ry) % g.ndy, dx = u / (g.ry * g.ndy);
      const int y = y0 + rr, x = x0 + XS * kk + xi;
      const float* p = red + ((jj * g.ry + rr) * nk + kk) * NACC + dx * XS + xi;
      float sum = 0.f;
      for (int q = 0; q < g.ns; ++q) sum += p[q * tps * NACC];
      if (y < g.H && x < g.W)
        store1(ob + (jj * ND + dx) * plane + static_cast<size_t>(y) * g.W + x,
               sum * g.inv_c);
    }
    return;
  }

  const int y = y0 + r, x = x0 + XS * k;
  if (y >= g.H || x >= g.W) return;
  T* ob = out + (static_cast<size_t>(b) * ND * ND + (dy0 + j) * ND) * plane +
          static_cast<size_t>(y) * g.W + x;
  if ((g.W & (XS - 1)) == 0) {
#pragma unroll
    for (int dx = 0; dx < ND; ++dx)
      store4(ob + dx * plane, acc + dx * XS, g.inv_c);
  } else {
#pragma unroll
    for (int dx = 0; dx < ND; ++dx) {
#pragma unroll
      for (int i = 0; i < XS; ++i)
        if (x + i < g.W) store1(ob + dx * plane + i, acc[dx * XS + i] * g.inv_c);
    }
  }
}

template <typename T, int VEC>
int launch(const void* f1, const void* f2, void* out, const Geometry& g,
           dim3 grid, int block, int smem, cudaStream_t stream) {
  auto kernel = corr_sm90_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(f1),
                                        static_cast<const T*>(f2),
                                        static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan's invariants, as _plan_sm90 builds them.
template <typename T>
bool plan_ok(const void* f1, const void* f2, const void* out, int B,
             const Geometry& g, int vec, dim3 grid, int block, int smem) {
  const int item = sizeof(T);
  const bool vec_ok = (vec == 16 || vec == 8 || vec == 4 ||
                       (vec == 2 && item == 2)) &&
                      aligned(f1, vec) && aligned(f2, vec) &&
                      (g.W * item) % vec == 0;
  const int col_unit = vec == 16 ? 16 / item : XS;
  return vec_ok && aligned(out, 16) && B >= 1 && B <= 65535 && g.C >= 1 &&
         g.H >= 1 && g.W >= 1 && g.tw >= XS && g.tw % col_unit == 0 &&
         g.ry >= 1 && (g.ndy == 1 || g.ndy == 3 || g.ndy == ND) &&
         g.ns >= 1 && g.cc >= g.ns && g.cc % g.ns == 0 &&
         block == g.ns * g.ndy * g.ry * (g.tw / XS) && block <= MAX_THREADS &&
         static_cast<int>(grid.x) ==
             ((g.W + g.tw - 1) / g.tw) * ((g.H + g.ry - 1) / g.ry) &&
         static_cast<int>(grid.y) == ND / g.ndy &&
         static_cast<int>(grid.z) == B && smem == smem_bytes<T>(g) &&
         smem <= MAX_SMEM;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: copy width in bytes (16, 4, or 2
// for bf16 rows that are not 4-byte aligned).  tw, ry, ndy, ns, cc, the
// grid, the block and the dynamic shared bytes are _plan_sm90's.  Returns
// cudaErrorInvalidValue for an inconsistent plan, else the cudaError_t of
// the launch (0 on success); the Python wrapper raises on anything but 0.
extern "C" int islam_corr_fwd_sm90(const void* f1, const void* f2, void* out,
                                   int B, int C, int H, int W, float inv_c,
                                   int dtype, int vec, int tw, int ry,
                                   int ndy, int ns, int cc, int grid_x,
                                   int grid_y, int grid_z, int block,
                                   int smem, void* stream) {
  const Geometry g{C, H, W, inv_c, tw, ry, ndy, ns, cc};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!plan_ok<float>(f1, f2, out, B, g, vec, grid, block, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec == 16) return launch<float, 16>(f1, f2, out, g, grid, block, smem, s);
    if (vec == 8) return launch<float, 8>(f1, f2, out, g, grid, block, smem, s);
    return launch<float, 4>(f1, f2, out, g, grid, block, smem, s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (!plan_ok<bf>(f1, f2, out, B, g, vec, grid, block, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec == 16) return launch<bf, 16>(f1, f2, out, g, grid, block, smem, s);
    if (vec == 8) return launch<bf, 8>(f1, f2, out, g, grid, block, smem, s);
    if (vec == 4) return launch<bf, 4>(f1, f2, out, g, grid, block, smem, s);
    return launch<bf, 2>(f1, f2, out, g, grid, block, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
