// Tensor-core core of cross-scale neighbourhood attention on Hopper, bf16:
// the forward K3 (na_fwd_wgmma_kernel) and its recompute-P backward K4
// (na_bwd_wgmma_kernel), both on wgmma with f32 accumulation and an f32
// softmax; and the attention of K2 (na2d_fused_q.cu), which runs K3's
// forward tile (fwd_tile, fwd_tile_chunked) with its pool-up and RoPE
// prologue building the query tile on chip (the `build_q` hook).
//
// A block is one warpgroup (128 threads) and owns one tile of M = 64 queries
// (tqh x tqw, a rectangle of the query grid) of one head and sample. The
// host (na2d_fused.py::_plan_tc) picks the tile shape whose box of LR cells
// is smallest: the urh x urw cells from (row_lo[tile row], col_lo[tile col])
// that hold every window cell of the tile's queries, padded with zero cells
// to NB, a multiple of 32 (at an integer ratio r with r^2 >= 64 every query of
// an 8 x 8 tile shares one window: 448^2 <- 28^2 has a 9 x 9 box, NB = 96; at
// the training shape's ratio 2, a 4 x 16 tile has a 10 x 12 box, NB = 128).
// A box above 192 cells (ratio 1 from k = 7, ratio 2 from k = 11) runs in
// chunks of 128 cells (the *_chunked kernels, at the end of this file; K4
// there is FlashAttention-2's backward, in a query-major and a key-major
// launch).
//
// The window of query (y, x) over the box is a mask with multiplicity:
// count_h[y][box row] * count_w[x][box col] (host-built per-axis tables, the
// times each box cell occurs in the query's window, read through the L1
// cache). At a ragged ratio a window can hold one LR cell twice, and the
// plain version counts it twice in the softmax; the kernel adds log(count)
// to the logit (0 for the common count of 1, -inf outside the window), which
// weights exp() by the count.
//
// Each operand is staged once, as it lies in device memory: a tile of rows
// (queries or box cells) of 64-channel blocks in wgmma's 128-byte swizzle
// (16-byte chunk j of row r at j ^ (r % 8), 8-row atoms 1024 bytes apart),
// by cp.async, every copy of a thread in flight at once and zero-filled past
// the grid's edge or the box. A product that contracts over the channels
// reads such a tile K-major; one that contracts over its rows reads it
// MN-major (wgmma's transposed B), so no tile is ever transposed.
//  K3:  S = Q . K_box^T              (SS: A = Q [64 x d], B = K_box [NB x d])
//       P = softmax(S + log count)   (f32 registers, rows reduced over a quad)
//       O = P . V_box                (RS: A = P as bf16 from registers, the
//                                     accumulator layout of S is wgmma's A
//                                     fragment layout; B = V_box MN-major)
//  K4:  S, P as in K3; dP = dO . V_box^T (SS); delta = rowsum(P * dP);
//       dS = P * (dP - delta); dQ = dS . K_box (RS, B = K_box MN-major);
//       dK_box = scale * dS^T . Q, dV_box = P^T . dO (SS: A = dS^T / P^T
//       [cells x 64] written to shared memory from registers by
//       stmatrix.trans, B = Q / dO MN-major), written as the tile's f32 box
//       partials, which the reduce pass sums per LR cell in tile order
//       (deterministic).
// The softmax scale is folded into the keys once they land, rounded as the
// plain version rounds bf16(k * scale). d and dv are multiples of 16 (the
// wrapper pads with zero channels); output products run in 32- then
// 16-channel chunks. P^T and dS^T share one shared tile, in turn, so that K4
// at the training shape (d 64, dv 192, NB 128) fits two blocks per SM.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
namespace natc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // one warpgroup
constexpr int M = 64;         // queries per tile

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Bytes of a K-major swizzled tile of `rows` rows (a multiple of 8) and
// `cols` bf16 columns: ceil(cols / 64) blocks of rows x 128 bytes.
__host__ __device__ constexpr int tile_bytes(int rows, int cols) {
  return cdiv(cols, 64) * rows * 128;
}

// Shared memory of one block; the wrapper plans with the same sums
// (na2d_fused.py::_tc_smem).
__host__ __device__ inline int smem_bytes(int d, int dv, int nb, bool backward) {
  const int qkv = 1024 + tile_bytes(M, d) + tile_bytes(nb, d) + tile_bytes(nb, dv);
  if (!backward) return qkv;
  return qkv + tile_bytes(M, dv) + tile_bytes(cdiv(nb, 64) * 64, M);
}

// Byte offset of element (r, c) in such a tile.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// Descriptor of the operand that starts at row r0 (a multiple of 8) and
// k-step ks (16 columns) of a tile at shared address `base`: K-major,
// 128-byte swizzle, 8-row atoms 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t op_desc(uint32_t base, int rows, int r0, int ks) {
  const uint32_t addr = base + (ks >> 2) * rows * 128 + r0 * 128 + (ks & 3) * 32;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Descriptor of a B operand read MN-major from such a tile: K = its rows
// [16 ks, 16 ks + 16), N = its columns from c0 (within one 64-column block).
// 128-byte swizzle; 8-row groups along K 1024 bytes apart (SBO), 64-column
// blocks along N rows * 128 bytes apart (LBO).
__device__ __forceinline__ uint64_t mn_desc(uint32_t base, int rows, int c0, int ks) {
  const uint32_t addr = base + (c0 >> 6) * rows * 128 + ks * 2048 + (c0 & 63) * 2;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((rows * 128) >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NATC_D8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) += a (64 x 16, bf16) * b (16 x N, bf16, shared memory).
// ss: a K-major from shared memory, b K-major; rs_t: a from registers, b
// MN-major; ss_t: a K-major from shared memory, b MN-major.
template <int N>
struct Wg;

template <>
struct Wg<32> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : NATC_D8(0), NATC_D8(8)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void rs_t(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : NATC_D8(0), NATC_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void ss_t(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : NATC_D8(0), NATC_D8(8)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wg<16> {
  __device__ __forceinline__ static void rs_t(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : NATC_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void ss_t(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : NATC_D8(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef NATC_D8

// The tile grid covers query rows [row0, row0 + Hq) of a taller grid (a
// band; K2's prologue reads its tables and pool rule at those global rows)
// and writes an output buffer of out_rows rows per sample whose row 0 is
// global query row out_row0. K3 and K4 (whose q holds only the band's rows)
// have row0 = out_row0 = 0, out_rows = Hq.
struct Geom {
  int Hq, Wq, hk, wk, n, d, dv, tqh, tqw, urh, urw, tiles_w;
  int row0, out_rows, out_row0;
};

// The box widths NB the single-pass kernels are built for (multiples of 32).
#define NATC_NB_CASES(X) X(32) X(64) X(96) X(128) X(160) X(192)

// The block's tile: sample, head, flat tile index, first query row and
// column, and the box's first LR row and column.
struct Tile {
  int b, h, tile, y0, x0, r0, c0;
};

__device__ __forceinline__ Tile tile_at(const Geom& g, const int* row_lo, const int* col_lo,
                                        int tile) {
  Tile t;
  t.tile = tile;
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  const int tr = t.tile / g.tiles_w;
  const int tc = t.tile - tr * g.tiles_w;
  t.y0 = tr * g.tqh;
  t.x0 = tc * g.tqw;
  t.r0 = row_lo[tr];
  t.c0 = col_lo[tc];
  return t;
}

// The tile of this block: tile blockIdx.x.
__device__ __forceinline__ Tile tile_of(const Geom& g, const int* row_lo, const int* col_lo) {
  return tile_at(g, row_lo, col_lo, blockIdx.x);
}

// Pixel index of query row r of the tile, or -1 past the grid's edge.
__device__ __forceinline__ long long query_pix(const Geom& g, const Tile& t, int r) {
  const int y = t.y0 + r / g.tqw;
  const int x = t.x0 + r % g.tqw;
  return (y < g.Hq && x < g.Wq) ? ((long long)t.b * g.Hq + y) * g.Wq + x : -1;
}

// Pixel index of query row r of the tile in the output buffer, or -1 past
// the grid's edge.
__device__ __forceinline__ long long out_pix(const Geom& g, const Tile& t, int r) {
  const int y = t.y0 + r / g.tqw;
  const int x = t.x0 + r % g.tqw;
  return (y < g.Hq && x < g.Wq)
             ? ((long long)t.b * g.out_rows + g.row0 + y - g.out_row0) * g.Wq + x
             : -1;
}

// Pixel index of box cell `cell` on the LR grid, or -1 for a padding cell.
__device__ __forceinline__ long long cell_pix(const Geom& g, const Tile& t, int cell) {
  if (cell >= g.urh * g.urw) return -1;
  const int i = cell / g.urw;
  return ((long long)t.b * g.hk + t.r0 + i) * g.wk + t.c0 + cell - i * g.urw;
}

// 8 bf16 times `scale`, each rounded back to bf16.
__device__ __forceinline__ uint4 scale8(uint4 raw, float scale) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[i] = pack2(f.x * scale, f.y * scale);
  }
  return out;
}

// Stage `rows` rows of `ch` channels of head h from src (B, ..., n, ch)
// into `tile` by cp.async, every copy of the thread in flight at once: row
// i is the pixel pix(i), zero-filled for -1. The thread's k-th chunk is
// element threadIdx.x + k * THREADS of rows x ch / 8.
template <typename Pix>
__device__ __forceinline__ void stage(int rows, int ch, const bf16* __restrict__ src, int n, int h,
                                      Pix pix, unsigned char* tile) {
  const int c8 = ch >> 3;
  const uint32_t base = smem_u32(tile);
  for (int e = threadIdx.x; e < rows * c8; e += THREADS) {
    const int r = e / c8;
    const int c = (e - r * c8) * 8;
    const long long p = pix(r);
    const bf16* from = p >= 0 ? src + (p * n + h) * ch + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(base + swz(rows, r, c)),
                 "l"(from), "r"(p >= 0 ? 16 : 0)
                 : "memory");
  }
}

// Once this thread's copies have landed: the chunks it staged into `tile`
// times `scale`, each rounded back to bf16.
__device__ __forceinline__ void scale_tile(int rows, int ch, unsigned char* tile, float scale) {
  const int c8 = ch >> 3;
  for (int e = threadIdx.x; e < rows * c8; e += THREADS) {
    const int r = e / c8;
    uint4* x = reinterpret_cast<uint4*>(tile + swz(rows, r, (e - r * c8) * 8));
    *x = scale8(*x, scale);
  }
}

// Wait for the thread's copies, scale the keys it staged, and make every
// thread's staging visible to every thread and to wgmma.
__device__ __forceinline__ void staged(int nb, int d, unsigned char* ks, float scale) {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  scale_tile(nb, d, ks, scale);
  fence_async_smem();
  __syncthreads();
}

// Accumulator element 4j + 2 * half + e of a 64 x N product sits at row
// 16 * warp + lane / 4 + 8 * half and column 8j + 2 * (lane % 4) + e.
__device__ __forceinline__ int acc_row(int half) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * half;
}
__device__ __forceinline__ int acc_col(int j) { return 8 * j + 2 * (threadIdx.x & 3); }

template <int NB>
__device__ __forceinline__ void zero_acc(float (&s)[NB / 32][16]) {
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) s[j][i] = 0.f;
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&s)[NB / 32][16]) {
#pragma unroll
  for (int j = 0; j < NB / 32; ++j) fence_regs(s[j]);
}

// s = A . B^T over `depth` channels: A the 64-row query tile at a_base, B
// the NB-row box tile at b_base, both K-major.
template <int NB>
__device__ __forceinline__ void box_logits(float (&s)[NB / 32][16], uint32_t a_base,
                                           uint32_t b_base, int depth) {
  zero_acc<NB>(s);
  fence_acc<NB>(s);
  wg_fence();
  for (int ks = 0; ks < depth / 16; ++ks) {
    const uint64_t da = op_desc(a_base, M, 0, ks);
#pragma unroll
    for (int j = 0; j < NB / 32; ++j) Wg<32>::ss(s[j], da, op_desc(b_base, NB, 32 * j, ks));
  }
  wg_commit();
  wg_wait0();
  fence_acc<NB>(s);
}

// A uniform tile (every query inside the grid, one window row on each
// axis: at a ratio of 8 or more most 8 x 8 tiles) has one window for all
// its queries: + log(count) of each box cell, one row of NB biases in
// shared memory (0 for the common count of 1, -inf outside the window or
// the box), read once per column instead of two count-table loads per
// logit. UniformCounts loads this thread's cells' counts (the tile's rows
// of the tables, read at its first query) early, so that the loads overlap
// other work; store() then writes their biases.
template <int NB>
struct UniformCounts {
  static constexpr int PER = cdiv(NB, THREADS);  // cells per thread
  uint32_t h[PER], w[PER];

  __device__ __forceinline__ void load(const Geom& g, const Tile& t,
                                       const uint8_t* __restrict__ cnt_h,
                                       const uint8_t* __restrict__ cnt_w) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int cell = threadIdx.x + i * THREADS;
      const int bi = cell / g.urw;
      const bool in = cell < g.urh * g.urw;
      h[i] = in ? __ldg(cnt_h + (size_t)t.y0 * g.urh + bi) : 0u;
      w[i] = in ? __ldg(cnt_w + (size_t)t.x0 * g.urw + cell - bi * g.urw) : 0u;
    }
  }

  __device__ __forceinline__ void store(float* bias) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int cell = threadIdx.x + i * THREADS;
      const uint32_t m = h[i] * w[i];
      if (cell < NB) bias[cell] = m == 0 ? -CUDART_INF_F : (m == 1 ? 0.f : __logf((float)m));
    }
  }
};

// A uniform tile's logits + its row of biases, in place; mx as window_mask.
template <int NB>
__device__ __forceinline__ void window_bias(float (&s)[NB / 32][16], const float* bias,
                                            float (&mx)[2]) {
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float add = bias[32 * j + acc_col(i >> 1) + (i & 1)];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float& x = s[j][4 * (i >> 1) + 2 * half + (i & 1)];
        x += add;
        mx[half] = fmaxf(mx[half], x);
      }
    }
}

// Logits of box cells [cell0, cell0 + NB) -> the window's multiplicity as
// + log(count) (-inf outside it), in place; mx gets the largest of the
// thread's own values of each row half. The counts are read from the host's
// tables cnt_h (Hq, urh), cnt_w (Wq, urw) through the L1 cache (in shared
// memory they would cost K4 its second block per SM at the training shape).
// Rows past the grid's edge have no window cell. WIDE: boxes of any size
// (cell * urw < 2^32), for the chunked K4's key-major boxes of queries.
template <int NB, bool WIDE = false>
__device__ __forceinline__ void window_mask(float (&s)[NB / 32][16], const Geom& g, const Tile& t,
                                            const uint8_t* __restrict__ cnt_h,
                                            const uint8_t* __restrict__ cnt_w, int cell0,
                                            float (&mx)[2]) {
  const int ncell = g.urh * g.urw;
  const uint8_t* hrow[2];
  const uint8_t* wrow[2];
  bool valid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = acc_row(half);
    const int y = t.y0 + r / g.tqw;
    const int x = t.x0 + r % g.tqw;
    valid[half] = y < g.Hq && x < g.Wq;
    hrow[half] = cnt_h + (size_t)min(y, g.Hq - 1) * g.urh;
    wrow[half] = cnt_w + (size_t)min(x, g.Wq - 1) * g.urw;
  }
  // cell / urw as a multiply and shift: exact while cell * urw < 2^16 (the
  // planner keeps the padded box's cells times urw below it); WIDE in 64 bits
  const uint32_t inv_urw = (65535u + g.urw) / g.urw;
  const unsigned long long inv_wide = ((1ull << 32) + g.urw - 1) / g.urw;
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cell = cell0 + 32 * j + acc_col(jj) + e;
        const int bi = WIDE ? (int)(((unsigned long long)cell * inv_wide) >> 32)
                            : (int)((cell * inv_urw) >> 16);
        const int bj = cell - bi * g.urw;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& x = s[j][4 * jj + 2 * half + e];
          const int m = valid[half] && cell < ncell ? __ldg(hrow[half] + bi) * __ldg(wrow[half] + bj)
                                                    : 0;
          x = m == 0 ? -CUDART_INF_F : (m == 1 ? x : x + __logf((float)m));
          mx[half] = fmaxf(mx[half], x);
        }
      }
}

// A row's value over the 4 threads of its quad.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Logits -> probabilities in place: window_mask over the whole box (a
// uniform tile: window_bias with its row of biases), then an f32 softmax
// over each query row, whose 4 owners are the threads of a quad. Rows past
// the grid's edge come out all zero.
template <int NB, bool UNIFORM = false>
__device__ __forceinline__ void window_softmax(float (&s)[NB / 32][16], const Geom& g,
                                               const Tile& t, const uint8_t* __restrict__ cnt_h,
                                               const uint8_t* __restrict__ cnt_w,
                                               const float* bias = nullptr) {
  float mx[2];
  if constexpr (UNIFORM)
    window_bias<NB>(s, bias, mx);
  else
    window_mask<NB>(s, g, t, cnt_h, cnt_w, 0, mx);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = quad_max(mx[half]);
    if (mx[half] == -CUDART_INF_F) mx[half] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1;
      s[j][i] = __expf(s[j][i] - mx[half]);
      sum[half] += s[j][i];
    }
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] = quad_sum(sum[half]);
    inv[half] = sum[half] > 0.f ? 1.f / sum[half] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) s[j][i] *= inv[(i >> 1) & 1];
}

// The 64 x NB accumulator as bf16 pairs: pk[j][i] holds elements 2i and
// 2i + 1 of chunk j (row half i % 2, column group i / 2).
template <int NB>
__device__ __forceinline__ void pack_pairs(const float (&s)[NB / 32][16],
                                           uint32_t (&pk)[NB / 32][8]) {
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) pk[j][i] = pack2(s[j][2 * i], s[j][2 * i + 1]);
}

// Those pairs as A fragments of k-steps over the accumulator's columns:
// k-step ks covers chunk ks / 2, column groups 2 (ks % 2) and 2 (ks % 2) + 1.
template <int NB>
__device__ __forceinline__ void to_frags(const uint32_t (&pk)[NB / 32][8],
                                         uint32_t (&a)[NB / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < NB / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[ks][i] = pk[ks >> 1][4 * (ks & 1) + i];
}

// acc = A (registers, 64 x NB) . B, B the [NB x channels] box tile at
// b_base read MN-major, channels [c0, c0 + N).
template <int NB, int N>
__device__ __forceinline__ void rs_chunk(float (&acc)[N / 2], const uint32_t (&a)[NB / 16][4],
                                         uint32_t b_base, int c0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < NB / 16; ++ks) Wg<N>::rs_t(acc, a[ks], mn_desc(b_base, NB, c0, ks));
  wg_commit();
  wg_wait0();
  fence_regs(acc);
}

// Store channels [c0, c0 + N) of the tile's valid query rows to dst (pixel,
// n, ch) as bf16. K3/K4: the grid's rows (query_pix), ch a multiple of 16.
// K2: the output buffer's rows (out_pix) and only the channels below ch (it
// pads dv in shared memory only), in pairs where ch is even, else one by one.
template <int N, bool K2 = false>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], bf16* __restrict__ dst,
                                           const Geom& g, const Tile& t, int ch, int c0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long p = K2 ? out_pix(g, t, acc_row(half)) : query_pix(g, t, acc_row(half));
    if (p < 0) continue;
    bf16* row = dst + (p * g.n + t.h) * ch + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = acc_col(j);
      const float a = acc[4 * j + 2 * half], b = acc[4 * j + 2 * half + 1];
      if (!K2 || (c0 + c + 2 <= ch && !(ch & 1))) {
        *reinterpret_cast<uint32_t*>(row + c) = pack2(a, b);
      } else {
        if (c0 + c < ch) row[c] = __float2bfloat16(a);
        if (c0 + c + 1 < ch) row[c + 1] = __float2bfloat16(b);
      }
    }
  }
}

// ------------------------------------------------------------ K3 forward
// The forward of one tile, its 64 x d query tile at qs (1024-aligned
// shared memory) and the K/V box after it: the box's copies start first,
// then build_q(qs) puts the queries there (K2: its pool-up and RoPE
// prologue, while the box's copies are in flight; K3 has issued the
// cp.async of q before and passes a build_q that does nothing), then the
// keys are scaled and every thread's staging becomes visible. The output
// (pixel, n, out_ch) gets the first out_ch of the g.dv channels
// (store_rows<N, K2>). bias (K2): a uniform tile's row of window biases
// (UniformCounts, stored by build_q), or null.
template <int NB, bool K2, typename BuildQ>
__device__ __forceinline__ void fwd_tile(BuildQ build_q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const uint8_t* __restrict__ cnt_h,
                                         const uint8_t* __restrict__ cnt_w, const Tile& t,
                                         bf16* __restrict__ out, int out_ch, float scale,
                                         const Geom& g, unsigned char* qs,
                                         const float* bias = nullptr) {
  unsigned char* ks = qs + tile_bytes(M, g.d);
  unsigned char* vs = ks + tile_bytes(NB, g.d);
  auto cpix = [&](int c) { return cell_pix(g, t, c); };
  stage(NB, g.d, k, g.n, t.h, cpix, ks);
  stage(NB, g.dv, v, g.n, t.h, cpix, vs);
  build_q(qs);
  staged(NB, g.d, ks, scale);

  float s[NB / 32][16];
  box_logits<NB>(s, smem_u32(qs), smem_u32(ks), g.d);
  if (K2 && bias != nullptr)
    window_softmax<NB, true>(s, g, t, cnt_h, cnt_w, bias);
  else
    window_softmax<NB>(s, g, t, cnt_h, cnt_w);
  uint32_t pp[NB / 32][8];
  pack_pairs<NB>(s, pp);
  uint32_t pa[NB / 16][4];
  to_frags<NB>(pp, pa);
  const uint32_t vs_u = smem_u32(vs);
  for (int c0 = 0; c0 < out_ch; c0 += 32) {
    if (g.dv - c0 >= 32) {
      float o[16];
      rs_chunk<NB, 32>(o, pa, vs_u, c0);
      store_rows<32, K2>(o, out, g, t, out_ch, c0);
    } else {
      float o[8];
      rs_chunk<NB, 16>(o, pa, vs_u, c0);
      store_rows<16, K2>(o, out, g, t, out_ch, c0);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
na_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ cnt_h,
                    const uint8_t* __restrict__ cnt_w, const int* __restrict__ row_lo,
                    const int* __restrict__ col_lo, bf16* __restrict__ out, float scale, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  unsigned char* qs = smem_raw + (((raw_u + 1023u) & ~1023u) - raw_u);
  const Tile t = tile_of(g, row_lo, col_lo);
  stage(M, g.d, q, g.n, t.h, [&](int r) { return query_pix(g, t, r); }, qs);
  fwd_tile<NB, false>([](unsigned char*) {}, k, v, cnt_h, cnt_w, t, out, g.dv, scale, g, qs);
}

// acc = A . B over the tile's 64 queries: A the [NBM x 64] tile at a_base
// (box cells [64 mc, 64 mc + 64)), B the [64 x channels] query tile at
// b_base read MN-major, channels [c0, c0 + N).
template <int N>
__device__ __forceinline__ void box_chunk(float (&acc)[N / 2], uint32_t a_base, int nbm, int mc,
                                          uint32_t b_base, int c0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < M / 16; ++ks)
    Wg<N>::ss_t(acc, op_desc(a_base, nbm, 64 * mc, ks), mn_desc(b_base, M, c0, ks));
  wg_commit();
  wg_wait0();
  fence_regs(acc);
}

// mul * acc into the box partials at channel offset `off`: row i of the
// accumulator is box cell 64 mc + i.
template <int N>
__device__ __forceinline__ void store_partial(const float (&acc)[N / 2], float* __restrict__ part,
                                              int ncell, int dc, int mc, int off, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int cell = 64 * mc + acc_row(half);
    if (cell >= ncell) continue;
    float* row = part + (size_t)cell * dc + off;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(row + acc_col(j)) =
          make_float2(mul * acc[4 * j + 2 * half], mul * acc[4 * j + 2 * half + 1]);
  }
}

// The [NBM x rows] product of box cells and a query tile of `rows`
// channels, chunk by chunk of channels: dst channels [off, off + rows) of
// the partials.
__device__ __forceinline__ void box_product(uint32_t a_base, int nbm, uint32_t b_base, int rows,
                                            float* part, int ncell, int dc, int off, float mul) {
  for (int mc = 0; mc < nbm / 64; ++mc)
    for (int c0 = 0; c0 < rows; c0 += 32) {
      if (rows - c0 >= 32) {
        float acc[16];
        box_chunk<32>(acc, a_base, nbm, mc, b_base, c0);
        store_partial<32>(acc, part, ncell, dc, mc, off + c0, mul);
      } else {
        float acc[8];
        box_chunk<16>(acc, a_base, nbm, mc, b_base, c0);
        store_partial<16>(acc, part, ncell, dc, mc, off + c0, mul);
      }
    }
}

// The 64 x NB accumulator's bf16 pairs, transposed, into the [NBM x 64]
// tile `dst` (row = box cell, column = query): stmatrix.trans stores four
// 8 x 8 blocks of a warp's 16 query rows at a time, each block's fragment
// as the 8 cells' rows of 8 queries (16 bytes each). Lane l gives the
// address of row l % 8 of block l / 8: blocks (column group, row half)
// (2q, 0), (2q, 1), (2q + 1, 0), (2q + 1, 1), the pairs pk[j][4q .. 4q + 3].
template <int NB>
__device__ __forceinline__ void put_transposed(const uint32_t (&pk)[NB / 32][8],
                                               unsigned char* dst, int nbm) {
  const int lane = threadIdx.x & 31;
  const int blk = lane >> 3;
  const int q0 = 16 * (threadIdx.x >> 5) + 8 * (blk & 1);  // the block's first query
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cell = 32 * j + 8 * (2 * q + (blk >> 1)) + (lane & 7);
      asm volatile(
          "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
              base + swz(nbm, cell, q0)),
          "r"(pk[j][4 * q]), "r"(pk[j][4 * q + 1]), "r"(pk[j][4 * q + 2]), "r"(pk[j][4 * q + 3])
          : "memory");
    }
}

// ---------------------------------------------------------- K4 backward
template <int NB>
__global__ void __launch_bounds__(THREADS)
na_bwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const uint8_t* __restrict__ cnt_h, const uint8_t* __restrict__ cnt_w,
                    const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                    bf16* __restrict__ dq, float* __restrict__ partial, float scale, Geom g) {
  constexpr int NBM = cdiv(NB, 64) * 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  unsigned char* qs = smem_raw + (((raw_u + 1023u) & ~1023u) - raw_u);  // [64 x d]
  unsigned char* ks = qs + tile_bytes(M, g.d);                           // [NB x d]
  unsigned char* gs = ks + tile_bytes(NB, g.d);                          // dO [64 x dv]
  unsigned char* vs = gs + tile_bytes(M, g.dv);                          // [NB x dv]
  unsigned char* pst = vs + tile_bytes(NB, g.dv);  // P^T, then dS^T [NBM x 64]
  const Tile t = tile_of(g, row_lo, col_lo);

  auto qpix = [&](int r) { return query_pix(g, t, r); };
  auto cpix = [&](int c) { return cell_pix(g, t, c); };
  stage(M, g.d, q, g.n, t.h, qpix, qs);
  stage(NB, g.d, k, g.n, t.h, cpix, ks);
  stage(M, g.dv, dout, g.n, t.h, qpix, gs);
  stage(NB, g.dv, v, g.n, t.h, cpix, vs);
  // the rows of P^T and dS^T past NB are never written below: zero them once
  for (int e = threadIdx.x; e < (NBM - NB) * 8; e += THREADS)
    *reinterpret_cast<uint4*>(pst + (NB + e / 8) * 128 + (e % 8) * 16) = make_uint4(0, 0, 0, 0);
  staged(NB, g.d, ks, scale);

  // P, recomputed in full: the tile's box holds every window cell of its
  // queries, so the softmax statistics need no second pass
  uint32_t pp[NB / 32][8];  // P in bf16, as dV's product reads it
  {
    float s[NB / 32][16];
    box_logits<NB>(s, smem_u32(qs), smem_u32(ks), g.d);
    window_softmax<NB>(s, g, t, cnt_h, cnt_w);
    pack_pairs<NB>(s, pp);
  }
  uint32_t dsp[NB / 32][8];  // dS in bf16
  {
    float dp[NB / 32][16];
    box_logits<NB>(dp, smem_u32(gs), smem_u32(vs), g.dv);
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB / 32; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pp[j][i]));
        delta[i & 1] += p.x * dp[j][2 * i] + p.y * dp[j][2 * i + 1];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 1);
      delta[half] += __shfl_xor_sync(0xffffffffu, delta[half], 2);
    }
#pragma unroll
    for (int j = 0; j < NB / 32; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pp[j][i]));
        dsp[j][i] = pack2(p.x * (dp[j][2 * i] - delta[i & 1]),
                          p.y * (dp[j][2 * i + 1] - delta[i & 1]));
      }
  }

  // dQ = dS . K_box (k pre-scaled)
  {
    uint32_t da[NB / 16][4];
    to_frags<NB>(dsp, da);
    const uint32_t ks_u = smem_u32(ks);
    for (int c0 = 0; c0 < g.d; c0 += 32) {
      if (g.d - c0 >= 32) {
        float o[16];
        rs_chunk<NB, 32>(o, da, ks_u, c0);
        store_rows<32>(o, dq, g, t, g.d, c0);
      } else {
        float o[8];
        rs_chunk<NB, 16>(o, da, ks_u, c0);
        store_rows<16>(o, dq, g, t, g.d, c0);
      }
    }
  }

  // the tile's box partials: dV = P^T . dO, then dK = scale * dS^T . Q in
  // the same shared tile
  const int ncell = g.urh * g.urw;
  const int dc = g.d + g.dv;
  float* part = partial + (((size_t)t.b * gridDim.x + t.tile) * g.n + t.h) * ncell * dc;
  put_transposed<NB>(pp, pst, NBM);
  fence_async_smem();
  __syncthreads();
  box_product(smem_u32(pst), NBM, smem_u32(gs), g.dv, part, ncell, dc, g.d, 1.f);
  __syncthreads();  // every warp's products have read P^T
  put_transposed<NB>(dsp, pst, NBM);
  fence_async_smem();
  __syncthreads();
  box_product(smem_u32(pst), NBM, smem_u32(qs), g.d, part, ncell, dc, 0, scale);
}

// ------------------------------------------- boxes above 192 cells, chunked
// A box of nbox cells (a multiple of NBC) runs in chunks of NBC cells, each
// staged in turn into one K (and V) tile. K3's softmax statistics come first,
// from a pass over the chunks' logits (a running row max and sum); then P is
// exact per chunk, as the single-pass kernels compute it, and K3 leaves each
// query's log-sum-exp for K4. K4 reads those statistics and walks its box
// once per launch (na_bwd_wgmma_chunked_kernel, below). Output, dq, dk and
// dv sum over the chunks in f32 in shared memory, each thread in its own
// slots (the accumulator elements it holds).

// Running row max m and sum l of exp(logit - m), updated with a chunk's
// masked logits s, whose largest per row half of this thread is cmx.
template <int NB>
__device__ __forceinline__ void online_stats(const float (&s)[NB / 32][16], const float (&cmx)[2],
                                             float (&m)[2], float (&l)[2]) {
  float mn[2], ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mn[half] = fmaxf(m[half], quad_max(cmx[half]));
    ms[half] = mn[half] == -CUDART_INF_F ? 0.f : mn[half];
  }
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) sum[(i >> 1) & 1] += __expf(s[j][i] - ms[(i >> 1) & 1]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = l[half] * __expf(m[half] - ms[half]) + quad_sum(sum[half]);
    m[half] = mn[half];
  }
}

// m, l -> the offset and the factor of exp() that give P.
__device__ __forceinline__ void finish_stats(float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (m[half] == -CUDART_INF_F) m[half] = 0.f;
    l[half] = l[half] > 0.f ? 1.f / l[half] : 0.f;
  }
}

// Logits of box cells [cell0, cell0 + NB) -> P with the whole box's
// statistics (finish_stats).
template <int NB>
__device__ __forceinline__ void window_probs(float (&s)[NB / 32][16], const Geom& g, const Tile& t,
                                             const uint8_t* __restrict__ cnt_h,
                                             const uint8_t* __restrict__ cnt_w, int cell0,
                                             const float (&m)[2], const float (&inv)[2]) {
  float cmx[2];
  window_mask<NB>(s, g, t, cnt_h, cnt_w, cell0, cmx);
#pragma unroll
  for (int j = 0; j < NB / 32; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1;
      s[j][i] = __expf(s[j][i] - m[half]) * inv[half];
    }
}

// Stage chunk [cell0, cell0 + NB) of the K box into ks (unscaled).
template <int NB>
__device__ __forceinline__ void stage_keys(const Geom& g, const Tile& t, const bf16* __restrict__ k,
                                           int cell0, unsigned char* ks) {
  stage(NB, g.d, k, g.n, t.h, [&](int c) { return cell_pix(g, t, cell0 + c); }, ks);
}

// The statistics of the tile's rows over all chunks, staging each chunk of
// keys into ks in turn (the first one's copies already in flight).
template <int NB>
__device__ __forceinline__ void chunk_stats(const Geom& g, const Tile& t, const bf16* __restrict__ k,
                                            const uint8_t* __restrict__ cnt_h,
                                            const uint8_t* __restrict__ cnt_w, int nbox,
                                            float scale, uint32_t qs_u, unsigned char* ks,
                                            float (&m)[2], float (&l)[2]) {
  m[0] = m[1] = -CUDART_INF_F;
  l[0] = l[1] = 0.f;
  for (int cell0 = 0; cell0 < nbox; cell0 += NB) {
    if (cell0 > 0) stage_keys<NB>(g, t, k, cell0, ks);
    staged(NB, g.d, ks, scale);
    float s[NB / 32][16], cmx[2];
    box_logits<NB>(s, qs_u, smem_u32(ks), g.d);
    window_mask<NB>(s, g, t, cnt_h, cnt_w, cell0, cmx);
    online_stats<NB>(s, cmx, m, l);
    __syncthreads();  // every warp's wgmmas have read the chunk before the next lands
  }
  finish_stats(m, l);
}

// Stage chunk [cell0, cell0 + NB) of the K box (scaled) and the V box.
template <int NB>
__device__ __forceinline__ void stage_chunk(const Geom& g, const Tile& t, const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, int cell0, float scale,
                                            unsigned char* ks, unsigned char* vs) {
  auto cpix = [&](int c) { return cell_pix(g, t, cell0 + c); };
  stage(NB, g.d, k, g.n, t.h, cpix, ks);
  stage(NB, g.dv, v, g.n, t.h, cpix, vs);
  staged(NB, g.d, ks, scale);
}

// Accumulator slots of channels [c0, c0 + N) in a thread's own shared f32
// sums (element i of the thread at acc[i * THREADS + thread]).
template <int N>
__device__ __forceinline__ void add_own(const float (&o)[N / 2], float* acc, int c0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[(c0 / 2 + i) * THREADS + threadIdx.x] += o[i];
}
template <int N>
__device__ __forceinline__ void load_own(float (&o)[N / 2], const float* acc, int c0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] = acc[(c0 / 2 + i) * THREADS + threadIdx.x];
}

// acc (own slots) += A (registers, 64 x NB) . B over `ch` channels, B the
// [NB x ch] tile at b_base read MN-major.
template <int NB>
__device__ __forceinline__ void rs_accumulate(float* acc, const uint32_t (&a)[NB / 16][4],
                                              uint32_t b_base, int ch) {
  for (int c0 = 0; c0 < ch; c0 += 32) {
    if (ch - c0 >= 32) {
      float o[16];
      rs_chunk<NB, 32>(o, a, b_base, c0);
      add_own<32>(o, acc, c0);
    } else {
      float o[8];
      rs_chunk<NB, 16>(o, a, b_base, c0);
      add_own<16>(o, acc, c0);
    }
  }
}

// The own slots of `width` channels (chunked as rs_accumulate chunks them),
// as bf16 rows of dst (pixel, n, ch): the first ch channels
// (store_rows<N, K2>).
template <bool K2 = false>
__device__ __forceinline__ void store_own(const float* acc, bf16* __restrict__ dst, const Geom& g,
                                          const Tile& t, int width, int ch) {
  for (int c0 = 0; c0 < ch; c0 += 32) {
    if (width - c0 >= 32) {
      float o[16];
      load_own<32>(o, acc, c0);
      store_rows<32, K2>(o, dst, g, t, ch, c0);
    } else {
      float o[8];
      load_own<16>(o, acc, c0);
      store_rows<16, K2>(o, dst, g, t, ch, c0);
    }
  }
}

constexpr int NBC = 128;  // box cells per chunk

// Whether the kernels take a box padded to nb cells, urw wide: one of
// NATC_NB_CASES, or (the chunked kernels) a multiple of NBC above them with
// nb * urw < 2^16 (the mask's division).
inline bool nb_supported(int nb, int urw) {
  bool ok = nb > 192 && nb % NBC == 0 && nb * urw < 65536;
#define X(N) ok = ok || nb == N;
  NATC_NB_CASES(X)
#undef X
  return ok;
}

// Shared memory of one block of the chunked K3 / K4. K3: the query tile, one
// chunk of the K/V box and the f32 sums of out. K4 (either launch): the
// block's 64 rows of two operands ([64 x d], [64 x dv]), one chunk of the
// other two ([NBC x d], [NBC x dv]), the f32 sums of dq or dk ([64 x d]) and
// of dv ([64 x dv]), and the lse and delta of NBC rows.
__host__ __device__ inline int smem_bytes_chunked(int d, int dv, bool backward) {
  const int qkv = 1024 + tile_bytes(M, d) + tile_bytes(NBC, d) + tile_bytes(NBC, dv);
  if (!backward) return qkv + M * dv * 4;
  return qkv + tile_bytes(M, dv) + M * (d + dv) * 4 + 2 * NBC * 4;
}

// The chunked forward of one tile (shared memory as fwd_tile, then the
// f32 sums of out): the first chunk's key copies start, build_q(qs) runs
// while they are in flight (as in fwd_tile), and the first chunk's staging
// makes both visible. lse (K3; K2 passes none): each query's f32 log-sum-exp
// of its window's logits, m + log(sum exp(s - m)), at (pixel, n).
template <int NB, bool K2, typename BuildQ>
__device__ __forceinline__ void fwd_tile_chunked(BuildQ build_q, const bf16* __restrict__ k,
                                                 const bf16* __restrict__ v,
                                                 const uint8_t* __restrict__ cnt_h,
                                                 const uint8_t* __restrict__ cnt_w,
                                                 const Tile& t, bf16* __restrict__ out,
                                                 int out_ch, int nbox, float scale,
                                                 const Geom& g, unsigned char* qs,
                                                 float* __restrict__ lse = nullptr) {
  unsigned char* ks = qs + tile_bytes(M, g.d);
  unsigned char* vs = ks + tile_bytes(NB, g.d);
  float* os = reinterpret_cast<float*>(vs + tile_bytes(NB, g.dv));  // 64 x dv
  stage_keys<NB>(g, t, k, 0, ks);
  build_q(qs);
  float m[2], inv[2];
  chunk_stats<NB>(g, t, k, cnt_h, cnt_w, nbox, scale, smem_u32(qs), ks, m, inv);
  if (lse != nullptr && (threadIdx.x & 3) == 0)  // a row's quad holds its statistics
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long p = query_pix(g, t, acc_row(half));
      if (p >= 0) lse[p * g.n + t.h] = m[half] - logf(inv[half]);
    }
  for (int i = 0; i < g.dv / 2; ++i) os[i * THREADS + threadIdx.x] = 0.f;
  for (int cell0 = 0; cell0 < nbox; cell0 += NB) {
    stage_chunk<NB>(g, t, k, v, cell0, scale, ks, vs);
    float s[NB / 32][16];
    box_logits<NB>(s, smem_u32(qs), smem_u32(ks), g.d);
    window_probs<NB>(s, g, t, cnt_h, cnt_w, cell0, m, inv);
    uint32_t pp[NB / 32][8];
    pack_pairs<NB>(s, pp);
    uint32_t pa[NB / 16][4];
    to_frags<NB>(pp, pa);
    rs_accumulate<NB>(os, pa, smem_u32(vs), g.dv);
    __syncthreads();
  }
  store_own<K2>(os, out, g, t, g.dv, out_ch);
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
na_fwd_wgmma_chunked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const uint8_t* __restrict__ cnt_h,
                            const uint8_t* __restrict__ cnt_w, const int* __restrict__ row_lo,
                            const int* __restrict__ col_lo, bf16* __restrict__ out,
                            float* __restrict__ lse, int nbox, float scale, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  unsigned char* qs = smem_raw + (((raw_u + 1023u) & ~1023u) - raw_u);
  const Tile t = tile_of(g, row_lo, col_lo);
  stage(M, g.d, q, g.n, t.h, [&](int r) { return query_pix(g, t, r); }, qs);
  fwd_tile_chunked<NB, false>([](unsigned char*) {}, k, v, cnt_h, cnt_w, t, out, g.dv, nbox,
                              scale, g, qs, lse);
}

// K4 on chunked boxes: FlashAttention-2's backward over the window, two
// launches of one kernel, each walking its box once with K3's per-query
// log-sum-exp (lse) and delta = rowsum(dO * O) of K3's output, so that P is
// exact per chunk with no statistics pass. A block owns its 64 rows of dq, or
// of dk and dv, and writes them once: no partials, no reduce pass, no
// atomics, the same sums in the same order on every run.
//  DQ   query-major, a block per 64-query tile (K3's geometry, tables and
//       boxes): S = Q K_c^T (+ log count), P = exp(S - lse), dP = dO V_c^T,
//       dS = P (dP - delta), dQ += dS K_c (keys pre-scaled: dQ is scale dS K).
//  DKV  key-major, a block per 64-key tile of the LR grid, on the transposed
//       geometry (kv_geometry in na2d_fused.cu): the tile's rows are its keys,
//       its box the queries whose windows hold any of them, its count tables
//       (key row, query-box row) and (key col, query-box col):
//       S^T = K Q_c^T (+ log count), P^T = exp(S^T - lse of each column),
//       dP^T = V dO_c^T, dS^T = P^T (dP^T - delta), dV += P^T dO_c,
//       dK += dS^T Q_c, dk = scale dK. P^T and dS^T are accumulators, so they
//       feed the RS wgmma from registers as K3 feeds P . V.
// The two launches read the same lse and delta, and each visits every
// (query, window cell) pair of the box once.
enum class Role : int { DQ = 0, DKV = 1 };

// lse and delta = sum_c dO * O (f32) of `rows` query rows, row r at pixel
// pix(r) (0 for -1): st[r] and st[NBC + r].
template <typename Pix>
__device__ __forceinline__ void row_stats(int rows, const Geom& g, int h, const float* __restrict__ lse,
                                          const bf16* __restrict__ out,
                                          const bf16* __restrict__ dout, Pix pix, float* st) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const long long p = pix(r);
    float l = 0.f, delta = 0.f;
    if (p >= 0) {
      l = lse[p * g.n + h];
      const uint4* o = reinterpret_cast<const uint4*>(out + (p * g.n + h) * g.dv);
      const uint4* gd = reinterpret_cast<const uint4*>(dout + (p * g.n + h) * g.dv);
      for (int c = 0; c < g.dv / 8; ++c) {
        const uint4 a = o[c], b = gd[c];
        const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(ha[i]), y = __bfloat1622float2(hb[i]);
          delta += x.x * y.x + x.y * y.y;
        }
      }
    }
    st[r] = l;
    st[NBC + r] = delta;
  }
}

// Rows a, a2 of the block (DQ: the tile's q, dO; DKV: its keys, scaled, and
// v) and chunks b, b2 of its box (DQ: keys, scaled, and v; DKV: q and dO).
// DQ writes dq (dst); DKV writes dk (dst) and dv (dst2). walk (DKV): the box
// cells to visit per tile row (the rows that hold a query of its keys, whole
// box rows from the first; at the grid's edges a tile's box holds more rows
// than most); DQ visits all nbox.
template <int NB, Role R>
__global__ void __launch_bounds__(THREADS)
na_bwd_wgmma_chunked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const bf16* __restrict__ out, const float* __restrict__ lse,
                            const uint8_t* __restrict__ cnt_h, const uint8_t* __restrict__ cnt_w,
                            const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                            const int* __restrict__ walk, bf16* __restrict__ dst,
                            bf16* __restrict__ dst2, int nbox, float scale, Geom g) {
  static_assert(NB == NBC, "the statistics hold one chunk of rows");
  constexpr bool DQ = R == Role::DQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  unsigned char* a = smem_raw + (((raw_u + 1023u) & ~1023u) - raw_u);  // [64 x d]
  unsigned char* a2 = a + tile_bytes(M, g.d);                           // [64 x dv]
  unsigned char* b = a2 + tile_bytes(M, g.dv);                          // chunk [NB x d]
  unsigned char* b2 = b + tile_bytes(NB, g.d);                          // chunk [NB x dv]
  float* acc = reinterpret_cast<float*>(b2 + tile_bytes(NB, g.dv));     // dq or dk, 64 x d
  float* acc2 = acc + M * g.d;                                          // dv, 64 x dv
  float* st = acc2 + M * g.dv;                                          // lse, delta
  const Tile t = tile_of(g, row_lo, col_lo);

  auto rpix = [&](int r) { return query_pix(g, t, r); };
  stage(M, g.d, DQ ? q : k, g.n, t.h, rpix, a);
  stage(M, g.dv, DQ ? dout : v, g.n, t.h, rpix, a2);
  if (DQ) row_stats(M, g, t.h, lse, out, dout, rpix, st);
  for (int i = 0; i < g.d / 2; ++i) acc[i * THREADS + threadIdx.x] = 0.f;
  if (!DQ)
    for (int i = 0; i < g.dv / 2; ++i) acc2[i * THREADS + threadIdx.x] = 0.f;

  const int ncells = DQ ? nbox : walk[t.tile / g.tiles_w];
  for (int cell0 = 0; cell0 < ncells; cell0 += NB) {
    auto cpix = [&](int c) { return cell_pix(g, t, cell0 + c); };
    stage(NB, g.d, DQ ? k : q, g.n, t.h, cpix, b);
    stage(NB, g.dv, DQ ? v : dout, g.n, t.h, cpix, b2);
    if (!DQ) row_stats(NB, g, t.h, lse, out, dout, cpix, st);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    if (DQ)
      scale_tile(NB, g.d, b, scale);
    else if (cell0 == 0)
      scale_tile(M, g.d, a, scale);
    fence_async_smem();
    __syncthreads();

    float s[NB / 32][16], dp[NB / 32][16], cmx[2];
    box_logits<NB>(s, smem_u32(a), smem_u32(b), g.d);
    window_mask<NB, true>(s, g, t, cnt_h, cnt_w, cell0, cmx);
    box_logits<NB>(dp, smem_u32(a2), smem_u32(b2), g.dv);
    float lr[2], dr[2];  // DQ: the thread's rows' lse and delta
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      lr[half] = st[acc_row(half)];
      dr[half] = st[NBC + acc_row(half)];
    }
#pragma unroll
    for (int j = 0; j < NB / 32; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int half = (i >> 1) & 1;
        const int col = 32 * j + acc_col(i >> 2) + (i & 1);  // DKV: the column's query
        const float p = __expf(s[j][i] - (DQ ? lr[half] : st[col]));
        s[j][i] = p;
        dp[j][i] = p * (dp[j][i] - (DQ ? dr[half] : st[NBC + col]));
      }
    uint32_t pp[NB / 32][8], dsp[NB / 32][8];
    pack_pairs<NB>(s, pp);
    pack_pairs<NB>(dp, dsp);
    uint32_t fr[NB / 16][4];
    if (!DQ) {  // dV += P^T . dO_c
      to_frags<NB>(pp, fr);
      rs_accumulate<NB>(acc2, fr, smem_u32(b2), g.dv);
    }
    to_frags<NB>(dsp, fr);  // dQ += dS . K_c, or dK += dS^T . Q_c
    rs_accumulate<NB>(acc, fr, smem_u32(b), g.d);
    __syncthreads();  // every warp is done with the chunk before the next lands
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // a tile whose box walks nothing
  if (DQ) {
    store_own(acc, dst, g, t, g.d, g.d);
  } else {
    for (int i = 0; i < g.d / 2; ++i) acc[i * THREADS + threadIdx.x] *= scale;
    store_own(acc, dst, g, t, g.d, g.d);
    store_own(acc2, dst2, g, t, g.dv, g.dv);
  }
}

}  // namespace natc
}  // namespace
