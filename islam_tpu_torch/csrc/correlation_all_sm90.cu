// PWC-Net local correlation (cost volume), forward, all 81 shifts per
// block, channel sums on the tensor cores; designed for Hopper (sm_90a).
//
// Replaces the TPU kernel islam_tpu/ops/pallas/correlation_kernel.py:57
// (_corr_all_kernel, reached through _corr_fwd_all).  Same function as the
// other three correlation kernels, with md = 4 (81 displacement channels):
//
//   out[b, (dy+4)*9 + (dx+4), y, x]
//       = (1/C) * sum_c f1[b, c, y, x] * pad4(f2)[b, c, y+dy, x+dx]
//
// f2 is zero-padded by 4 on both spatial axes, the sum accumulates in f32,
// and the output has the input dtype (f32 or bf16).  Inputs are contiguous
// (B, C, H, W), at any 2-byte-aligned offset.
//
// What bounds it.  Bytes: both inputs read once and the 81-channel output
// written once are about 127 MB (f32) for the five pyramid levels of one
// 448x640, B=8 VO forward, 38 us at 3.35 TB/s.  Even at the 2.67x excess of
// the banded products below, the multiply-adds take a fraction of that on
// the tensor cores.
//
// What the design does.
//
// 1. All 81 shifts per tile, so f1 is read once at every level (the TPU
//    kernel's own point).  A tile is one image, a strip of ry rows and 16
//    columns.  Per chunk of kc channels a block stages the tile's f1 (kc x
//    ry x 16) and the window of f2 that all nine row shifts need ((ry+8) x
//    24, plus one row where that makes the row count odd) in shared memory.
//    A warp owns one row r of the strip for all nine dy, so its f1 fragment
//    of a k-step is loaded once and used for the 9 dy.
// 2. Channel sums on the tensor cores, as banded products.  For output row
//    y and shift dy, a warp multiplies its 16 columns of f1 (M = x, K =
//    channels) by the 24 matching columns of f2's row y+dy (N = x', three
//    n8 fragments) and keeps, for each x, the 9 products with x' in
//    [x-4, x+4].  bf16: mma.sync.m16n8k16 with f32 accumulation (products
//    of bf16 are exact in f32), both operands by ldmatrix.trans, since NCHW
//    keeps x contiguous and the products need it as M and N.  f32: 3xTF32
//    on mma.sync.m16n8k8: each operand splits into hi = tf32(a) and lo =
//    tf32(a - hi) (cvt.rna), and the sum takes hi.lo + lo.hi + hi.hi; the
//    dropped lo.lo term is about 2^-22 of each product, inside the 1e-5 x
//    max|plain| tolerance.  The f32 operands come by plain shared loads:
//    ldmatrix moves 16-bit elements.  mma.sync and not wgmma: a wgmma tile
//    has 64 rows (x), which needs a band of 72 columns of f2 for 9 used a
//    row, 8x the needed work, where 16 x 24 is 2.67x.  Each warp keeps
//    9 x 3 x 4 f32 accumulators.
// 3. Asynchronous staging into a ring of two chunk buffers: the next chunk
//    is in flight while the tensor cores sum this one.  Where the base and
//    the row pitch are 16-byte multiples, one thread issues the TMA tile
//    loads of a chunk (cp.async.bulk.tensor.4d with an mbarrier); their
//    out-of-bounds zero fill is pad4, and the channels past C.  A TMA box
//    has to start on 16 bytes (one that started 8 bytes in faulted on the
//    H100, illegal instruction), and the f2 window starts 4 columns left of
//    its tile: 16 bytes in f32, 8 in bf16.  So bf16 tiles start at x = 16k
//    - 12, which puts the f2 window on 32 bytes; their f1 tile, 8 bytes in,
//    comes by 8-byte cp.async beside the TMA load.  Elsewhere (f32 at W =
//    10, bf16 at W = 10 and 20, pyramid slices at 2- and 4-byte offsets)
//    cp.async copies of 8 or 4 bytes with src-size-0 zero fill, and plain
//    2-byte loads for bf16 rows that are not 4-byte aligned.
// 4. Persistent blocks.  A block walks the tiles blockIdx.x, blockIdx.x +
//    gridDim.x, ..; its (tile, chunk) pairs are one stream through the
//    ring, so the next tile's first chunks are in flight while this tile is
//    summed and stored.  The grid is as many blocks as the card holds at
//    once.
// 5. The coarse levels are no longer a serial chain.  ns channel slices
//    split each chunk (16 channels a slice and chunk), so ns warps of the
//    same row sum at once, and a chunk of ns x 16 channels is one set of
//    copies: at (196,7,10) two chunks hold all channels, both issued before
//    the first sum.  The slices' partial tiles meet in shared memory and
//    are added in slice order, with no atomics: the output is bitwise
//    reproducible.  The launch plan (ry, ns, grid, block, shared
//    bytes) comes from _plan_all_sm90 in ops/correlation.py; the C entry
//    checks that it is consistent.
// 6. Each output plane is written once.  The band of the mma fragments
//    (which would scatter the stores) goes through shared memory as 81 x 16
//    values a warp (pitch BP, conflict-free), in a region of its own beside
//    the ring (or in the ring where each block has one tile); then the block's threads scale by 1/C, convert to the
//    output type and store with x fastest, 4 x a thread (16 bytes in f32, 8
//    in bf16) where W is a multiple of 4.
// 7. Shared-memory pitches: the f2 window is 24 columns (an odd multiple
//    of 8 elements) by an odd number of rows, so the 8 rows of an ldmatrix
//    (bf16) or the 4 k-rows of a fragment load (f32) fall in distinct banks.
//
// __launch_bounds__(256, 1) leaves the compiler up to 255 registers a
// thread; chip_smoke.py's build phase fails on any spill.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int MD = 4;
constexpr int ND = 2 * MD + 1;  // 9 displacements per axis
constexpr int NOUT = ND * ND;   // 81 output channels
constexpr int MT = 16;          // columns of a tile (mma M)
// Floats between two output channels of a band tile: lane (gid, tig)
// writes m = gid (+8), n = 8nf + 2tig (+1) to (dy*9 + n-m)*BP + m, whose
// bank is 8tig + 13gid (mod 32) at BP = 20, distinct for the 32 lanes
// (at 16 the four tig collide).  A multiple of 4, so float4 reads align.
constexpr int BP = 20;
constexpr int KS = 16;          // channels of one slice in one chunk
constexpr int STAGES = 2;       // ring of chunk buffers
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;
constexpr int TMA = 16;         // the VEC value that selects TMA staging

struct Geometry {
  int C, H, W;
  float inv_c;
  int ry, ns, kc;  // the launch plan's tile
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}
constexpr int SW = MT + 2 * MD;  // columns of the staged f2 window
__host__ __device__ inline int win_rows(const Geometry& g) {
  return (g.ry + 2 * MD) | 1;
}
// Bytes of one ring buffer: the f1 tile, then the f2 window, each rounded
// to 128 bytes (TMA destinations).
__host__ __device__ inline int f1_bytes(const Geometry& g, int item) {
  return round_up(g.kc * g.ry * MT * item, 128);
}
__host__ __device__ inline int f2_bytes(const Geometry& g, int item) {
  return round_up(g.kc * win_rows(g) * SW * item, 128);
}
// Columns left of 0 where the tiles start: bf16 tiles under TMA start at
// x = 16k - 12, so that their f2 windows (x - 4 ..) start on 32 bytes.
__host__ __device__ constexpr int col_shift(int vec, int item) {
  return vec == TMA && item == 2 ? 12 : 0;
}
__host__ __device__ inline int tile_count(const Geometry& g, int B, int sh) {
  return B * ((g.W + sh + MT - 1) / MT) * ((g.H + g.ry - 1) / g.ry);
}
// The ring (two buffers, or one where a block's stream is one chunk),
// then each warp's band tile of 81 x 16 f32 sums; where every block has one
// tile, the bands reuse the ring once the last chunk is summed.
inline int smem_bytes(const Geometry& g, int item, int tiles, int grid) {
  const int stream = (tiles + grid - 1) / grid * ((g.C + g.kc - 1) / g.kc);
  const int stages = stream < STAGES ? stream : STAGES;
  const int ring = stages * (f1_bytes(g, item) + f2_bytes(g, item));
  const int band = g.ns * g.ry * NOUT * BP * 4;
  if (tiles > grid) return ring + band;
  return ring > band ? ring : band;
}

// ---------------------------------------------------------------- staging

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One copy of VEC bytes global -> shared, zero-filled when !ok.
template <typename T, int VEC>
__device__ __forceinline__ void copy(T* dst, const T* src, bool ok) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? __ldg(reinterpret_cast<const uint16_t*>(src)) : uint16_t(0);
  } else {
    const int n = ok ? VEC : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(VEC), "r"(n)
                 : "memory");
  }
}

// cp.async staging of a tile of kc channels x nb rows x nq granules of GE
// elements: granule (a, j, q) comes from channel c0+a, image row y_first+j,
// columns x_first+q*GE .., and goes to dst + (a*nb + j)*row_w + q*GE.  A
// granule lies wholly inside or outside the image (the plan's alignment
// rules), so one bound test zero-fills it, as do channels past C.
template <typename T, int VEC>
__device__ __forceinline__ void stage_tile(
    T* dst, const T* src, const Geometry& g, int nb, int row_w,
    int x_first, int y_first, int c0) {
  constexpr int GE = VEC >= static_cast<int>(sizeof(T)) ? VEC / sizeof(T) : 1;
  const int nq = row_w / GE, nsp = nb * nq, n = blockDim.x;
  const int sstep = n >= nsp ? nsp : n;      // spatial slots a pass
  const int cstep = n >= nsp ? n / nsp : 1;  // channels a pass
  if (static_cast<int>(threadIdx.x) >= sstep * cstep) return;
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const int cn = min(g.kc, g.C - c0);
  const T* base = src + static_cast<size_t>(c0) * plane;
  for (int sp = threadIdx.x % sstep; sp < nsp; sp += sstep) {
    const int j = sp / nq, q = sp % nq;
    const int gy = y_first + j, gx = x_first + q * GE;
    const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
    const T* s = base + (in ? static_cast<size_t>(gy) * g.W + gx : 0);
    T* d = dst + j * row_w + q * GE;
    for (int a = threadIdx.x / sstep; a < g.kc; a += cstep) {
      const bool ok = in && a < cn;
      copy<T, VEC>(d + a * nb * row_w, ok ? s + a * plane : src, ok);
    }
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, int c, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(x), "r"(y), "r"(c), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Issue the loads of chunk ch (channels ch*kc ..) into ring buffer st:
// the f1 tile (rows y0 .., columns x0 ..) and the f2 window (rows y0-4 ..,
// columns x0-4 ..).
template <typename T, int VEC>
__device__ __forceinline__ void stage_chunk(
    unsigned char* st, const T* f1b, const T* f2b, const Geometry& g,
    const CUtensorMap* map1, const CUtensorMap* map2, uint64_t* bar,
    int b, int x0, int y0, int ch) {
  const int c0 = ch * g.kc;
  T* s1 = reinterpret_cast<T*>(st);
  T* s2 = reinterpret_cast<T*>(st + f1_bytes(g, sizeof(T)));
  if constexpr (VEC == TMA) {
    // bf16: the f1 tile starts 8 bytes into a 16-byte line, where a TMA
    // box faults, so it comes by 8-byte copies
    constexpr bool f1_tma = sizeof(T) == 4;
    if (threadIdx.x == 0) {
      const int bytes =
          g.kc * ((f1_tma ? g.ry * MT : 0) + win_rows(g) * SW) * sizeof(T);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
          :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
      if constexpr (f1_tma) tma_load(s1, map1, x0, y0, c0, b, bar);
      tma_load(s2, map2, x0 - MD, y0 - MD, c0, b, bar);
    }
    if constexpr (!f1_tma) stage_tile<T, 8>(s1, f1b, g, g.ry, MT, x0, y0, c0);
  } else {
    stage_tile<T, VEC>(s1, f1b, g, g.ry, MT, x0, y0, c0);
    stage_tile<T, VEC>(s2, f2b, g, win_rows(g), SW, x0 - MD, y0 - MD, c0);
  }
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi = tf32(v) (round to nearest, ties away), lo = tf32(v - hi)
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// One chunk's sums of a warp: row r, slice q (channels q*16 .. q*16+15 of
// the chunk), all 9 dy, into acc[dy][nf][4].
__device__ __forceinline__ void chunk_sums(
    float (&acc)[ND][3][4], const __nv_bfloat16* s1,
    const __nv_bfloat16* s2, const Geometry& g, int r, int q, int lane) {
  const int p1 = g.ry * MT, p2 = win_rows(g) * SW;
  // A (m = x, k = c) from f1 stored [c][row][x]: matrix j = lane/8 holds
  // m 8(j&1).., k 8(j>>1)..
  unsigned a[4];
  ldsm_x4_t(a, s1 + (q * KS + (lane & 7) + 8 * (lane >> 4)) * p1 +
                   r * MT + 8 * ((lane >> 3) & 1));
  // B (k = c, n = x') from f2 stored [c][row][x']: matrices (k 0-7, n 0-7),
  // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15); then n 16-23.
  const __nv_bfloat16* bp =
      s2 + (q * KS + (lane & 7) + 8 * ((lane >> 3) & 1)) * p2;
#pragma unroll
  for (int dy = 0; dy < ND; ++dy) {
    const __nv_bfloat16* row = bp + (r + dy) * SW;
    unsigned b[6];
    ldsm_x4_t(b, row + 8 * (lane >> 4));
    ldsm_x2_t(b + 4, row + 16);
    mma_bf16(acc[dy][0], a, b[0], b[1]);
    mma_bf16(acc[dy][1], a, b[2], b[3]);
    mma_bf16(acc[dy][2], a, b[4], b[5]);
  }
}

__device__ __forceinline__ void chunk_sums(
    float (&acc)[ND][3][4], const float* s1, const float* s2,
    const Geometry& g, int r, int q, int lane) {
  const int p1 = g.ry * MT, p2 = win_rows(g) * SW;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // two k8 steps
    const int k = q * KS + 8 * h + tig;
    // A: (m g, k tig), (m g+8, k tig), (m g, k tig+4), (m g+8, k tig+4)
    const float* ap = s1 + k * p1 + r * MT + gid;
    unsigned ahi[4], alo[4];
    split_tf32(ap[0], ahi[0], alo[0]);
    split_tf32(ap[8], ahi[1], alo[1]);
    split_tf32(ap[4 * p1], ahi[2], alo[2]);
    split_tf32(ap[4 * p1 + 8], ahi[3], alo[3]);
    // B: (k tig, n gid), (k tig+4, n gid)
    const float* bp = s2 + k * p2 + gid;
#pragma unroll
    for (int dy = 0; dy < ND; ++dy) {
#pragma unroll
      for (int nf = 0; nf < 3; ++nf) {
        const float* p = bp + (r + dy) * SW + 8 * nf;
        unsigned bhi[2], blo[2];
        split_tf32(p[0], bhi[0], blo[0]);
        split_tf32(p[4 * p2], bhi[1], blo[1]);
        mma_tf32(acc[dy][nf], ahi, blo[0], blo[1]);
        mma_tf32(acc[dy][nf], alo, bhi[0], bhi[1]);
        mma_tf32(acc[dy][nf], ahi, bhi[0], bhi[1]);
      }
    }
  }
}

// ------------------------------------------------------------------ stores

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(b)))
          << 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// ------------------------------------------------------------------ kernel

// A tile: image b, rows y0 .., columns x0 ..; tiles run image by image,
// rows, then columns, so the blocks in flight share images.
struct Tile {
  int b, x0, y0;
};
__device__ __forceinline__ Tile tile_at(const Geometry& g, int t, int sh) {
  const int ncol = (g.W + sh + MT - 1) / MT;
  const int per_image = ncol * ((g.H + g.ry - 1) / g.ry);
  const int rest = t % per_image;
  return {t / per_image, (rest % ncol) * MT - sh, (rest / ncol) * g.ry};
}

// Store one tile's sums.  Each warp writes its band (for each x, m, the 9
// products x' = x-4 .. x+4, n = m+dx; accumulator i of fragment nf holds m
// = gid + 8(i>>1), n = 8nf + 2tig + (i&1)) to its region; then the block
// adds the slices in order, scales, converts and stores, x fastest.
template <typename T>
__device__ __forceinline__ void store_tile(
    const float (&acc)[ND][3][4], float* band, T* __restrict__ out,
    const Geometry& g, const Tile& tile, int warp, int lane) {
  float* mine = band + warp * NOUT * BP;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int dy = 0; dy < ND; ++dy)
#pragma unroll
    for (int nf = 0; nf < 3; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = gid + 8 * (i >> 1), n = 8 * nf + 2 * tig + (i & 1);
        const int dx = n - m;
        if (dx >= 0 && dx < ND) mine[(dy * ND + dx) * BP + m] = acc[dy][nf][i];
      }
  __syncthreads();

  // (row, channel) lines of 16 x; a line's slices lie slice floats apart
  const int lines = g.ry * NOUT, slice = lines * BP;
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  T* ob = out + static_cast<size_t>(tile.b) * NOUT * plane;
  if ((g.W & 3) == 0) {
    for (int e = threadIdx.x; e < lines * (MT / 4); e += blockDim.x) {
      const int line = e >> 2, m = 4 * (e & 3);
      const int it = line / NOUT, o = line - it * NOUT;
      const int y = tile.y0 + it, x = tile.x0 + m;
      if (y >= g.H || x < 0 || x >= g.W) continue;
      const float* p = band + line * BP + m;
      float4 v = *reinterpret_cast<const float4*>(p);
      for (int k = 1; k < g.ns; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(p + k * slice);
        v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
      }
      v.x *= g.inv_c; v.y *= g.inv_c; v.z *= g.inv_c; v.w *= g.inv_c;
      store4(ob + o * plane + static_cast<size_t>(y) * g.W + x, v);
    }
  } else {
    for (int e = threadIdx.x; e < lines * MT; e += blockDim.x) {
      const int line = e >> 4, m = e & (MT - 1);
      const int it = line / NOUT, o = line - it * NOUT;
      const int y = tile.y0 + it, x = tile.x0 + m;
      if (y >= g.H || x < 0 || x >= g.W) continue;
      const float* p = band + line * BP + m;
      float v = p[0];
      for (int k = 1; k < g.ns; ++k) v += p[k * slice];
      store1(ob + o * plane + static_cast<size_t>(y) * g.W + x, v * g.inv_c);
    }
  }
}

// A persistent block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ..;
// its chunks (tile, channel chunk) form one stream through the ring, so the
// next tile's first chunks are in flight while this tile is summed and
// stored.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
corr_all_sm90_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                     T* __restrict__ out, const Geometry g, int tiles,
                     const __grid_constant__ CUtensorMap map1,
                     const __grid_constant__ CUtensorMap map2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[STAGES];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp % g.ry, q = warp / g.ry;  // row, channel slice
  constexpr int SH = col_shift(VEC, sizeof(T));

  const size_t image = static_cast<size_t>(g.C) * g.H * g.W;
  const int stage = f1_bytes(g, sizeof(T)) + f2_bytes(g, sizeof(T));
  const int nchunks = (g.C + g.kc - 1) / g.kc;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int stream = mine * nchunks;
  const int stages = stream < STAGES ? stream : STAGES;
  float* band = reinterpret_cast<float*>(
      smem + (tiles > static_cast<int>(gridDim.x) ? stages * stage : 0));

  // Issue stream position j: chunk j % nchunks of the block's tile j /
  // nchunks, into ring buffer j % STAGES.
  auto issue = [&](int j) {
    const Tile t = tile_at(g, blockIdx.x + (j / nchunks) * gridDim.x, SH);
    stage_chunk<T, VEC>(smem + (j % STAGES) * stage, f1 + t.b * image,
                        f2 + t.b * image, g, &map1, &map2,
                        &bars[j % STAGES], t.b, t.x0, t.y0, j % nchunks);
  };

  if constexpr (VEC == TMA) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&bars[i])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < STAGES; ++p) {
    if (p < stream) issue(p);
    commit();
  }

  float acc[ND][3][4];
  for (int j = 0; j < stream; ++j) {
    if (j % nchunks == 0) {
#pragma unroll
      for (int dy = 0; dy < ND; ++dy)
#pragma unroll
        for (int nf = 0; nf < 3; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[dy][nf][i] = 0.f;
    }
    const int st = j % STAGES;
    if constexpr (VEC == TMA) {
      if constexpr (sizeof(T) == 2) wait_pending<STAGES - 1>();  // f1
      wait_parity(&bars[st], (j / STAGES) & 1);
    } else {
      wait_pending<STAGES - 1>();  // this thread's copies of position j
    }
    __syncthreads();  // everyone's copies of position j have landed
    const unsigned char* sp = smem + st * stage;
    chunk_sums(acc, reinterpret_cast<const T*>(sp),
               reinterpret_cast<const T*>(sp + f1_bytes(g, sizeof(T))), g,
               r, q, lane);
    __syncthreads();  // everyone is done with buffer st
    if (j + STAGES < stream) {
      if constexpr (VEC == TMA)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + STAGES);
    }
    commit();
    if (j % nchunks == nchunks - 1)
      store_tile(acc, band, out, g,
                 tile_at(g, blockIdx.x + (j / nchunks) * gridDim.x, SH), warp,
                 lane);
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the process has loaded
// (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The (W, H, C, B) tensor map of x with box (bw, bh, bc, 1); zero fill out
// of bounds.
template <typename T>
bool make_map(CUtensorMap* map, const void* x, int B, const Geometry& g,
              int bw, int bh) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t item = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.W),
                              static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(g.C),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * item, dims[0] * dims[1] * item,
                                 dims[0] * dims[1] * dims[2] * item};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(g.kc), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(x), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int VEC>
int launch(const void* f1, const void* f2, void* out, int B,
           const Geometry& g, dim3 grid, int block, int smem,
           cudaStream_t stream) {
  CUtensorMap map1{}, map2{};
  if constexpr (VEC == TMA) {
    if ((sizeof(T) == 4 && !make_map<T>(&map1, f1, B, g, MT, g.ry)) ||
        !make_map<T>(&map2, f2, B, g, SW, win_rows(g)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = corr_all_sm90_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), g,
      tile_count(g, B, col_shift(VEC, sizeof(T))), map1, map2);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan's invariants, as _plan_all_sm90 builds them.
template <typename T>
bool plan_ok(const void* f1, const void* f2, const void* out, int B,
             const Geometry& g, int vec, dim3 grid, int block, int smem) {
  const int item = sizeof(T);
  const bool tma = vec == TMA && aligned(f1, 16) && aligned(f2, 16) &&
                   (g.W * item) % 16 == 0;
  // cp.async granules of at most 4 elements, so the f2 window, which
  // starts 4 columns left of a 16-column tile, starts on a granule
  const bool copies = (vec == 8 || vec == 4 || (vec == 2 && item == 2)) &&
                      vec / item <= 4 && aligned(f1, vec) &&
                      aligned(f2, vec) && (g.W * item) % vec == 0;
  const bool shape_ok = B >= 1 && g.C >= 1 && g.H >= 1 && g.W >= 1 &&
                        g.ry >= 1 && win_rows(g) <= 256 && g.ns >= 1 &&
                        g.kc == KS * g.ns &&
                        B <= (1 << 30) / (g.H * g.W);  // int tile indices
  if (!(tma || copies) || !aligned(out, 16) || !shape_ok) return false;
  const int tiles = tile_count(g, B, col_shift(vec, item));
  return block == 32 * g.ry * g.ns && block <= MAX_THREADS &&
         grid.x >= 1 && static_cast<int>(grid.x) <= tiles && grid.y == 1 &&
         grid.z == 1 &&
         smem == smem_bytes(g, item, tiles, static_cast<int>(grid.x)) &&
         smem <= MAX_SMEM;
}

template <typename T>
int dispatch(const void* f1, const void* f2, void* out, int B,
             const Geometry& g, int vec, dim3 grid, int block, int smem,
             cudaStream_t s) {
  if (!plan_ok<T>(f1, f2, out, B, g, vec, grid, block, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == TMA) return launch<T, TMA>(f1, f2, out, B, g, grid, block, smem, s);
  if constexpr (sizeof(T) == 2) {
    if (vec == 2) return launch<T, 2>(f1, f2, out, B, g, grid, block, smem, s);
  }
  if (vec == 8) return launch<T, 8>(f1, f2, out, B, g, grid, block, smem, s);
  return launch<T, 4>(f1, f2, out, B, g, grid, block, smem, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 16 stages by TMA (bf16: f2 by TMA,
// f1 by 8-byte copies, tiles from x = -12); 8, 4 or (bf16) 2 by copies of
// that many bytes.  ry, ns, kc, the grid
// (persistent blocks, at most one a tile), the block and the dynamic shared
// bytes are _plan_all_sm90's.  Returns
// cudaErrorInvalidValue for an inconsistent plan (or no tensor-map encoder),
// else the cudaError_t of the launch (0 on success); the Python wrapper
// raises on anything but 0.
extern "C" int islam_corr_fwd_all_sm90(
    const void* f1, const void* f2, void* out, int B, int C, int H, int W,
    float inv_c, int dtype, int vec, int ry, int ns, int kc,
    int grid_x, int grid_y, int grid_z, int block, int smem, void* stream) {
  const Geometry g{C, H, W, inv_c, ry, ns, kc};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(f1, f2, out, B, g, vec, grid, block, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(f1, f2, out, B, g, vec, grid, block, smem,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
