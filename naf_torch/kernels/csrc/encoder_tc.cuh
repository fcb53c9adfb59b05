// Tensor-core core of the bf16 encoder-layer kernels, K1 (encoder_fused.cu)
// and K6 (encoder_dual.cu), on Hopper: one GN -> SiLU -> conv_k layer,
//     y = conv_k(SiLU(x * scale + shift)) + bias,   k in {1, 3}, reflect padding,
// as an implicit GEMM on wgmma (M = 128 output pixels, N = 64 or 128 output
// channels, K = k*k*C), plus the tile's f32 [sum y, sum y^2] partials.
//
// A block owns an 8 x 16 output tile and N output channels; two warpgroups
// of 64 pixels each (a warp per tile row).
//  - Prologue, once per halo element: cp.async brings the raw
//    (8+k-1) x (16+k-1) halo tile of up to 128 input channels into shared
//    memory, one group per 64-channel block, source rows and columns
//    reflected by index math (reflect()); each thread then applies the
//    GroupNorm affine and SiLU in f32 to the chunks it copied and rounds them
//    to bf16 in place, as the JAX kernel rounds before its dot: the first
//    block before the block's stages, the second in slices while the first
//    block's wgmmas run. A pixel's channels are followed by 16 bytes of
//    padding, an odd count of 16-byte chunks per pixel, so the 8 rows of each
//    ldmatrix fall in 8 different bank groups.
//  - A from registers: each warp ldmatrix-es its 16 pixels x 16 channels at
//    the tap's shifted window. A window shifted by dx breaks the 8-row core
//    matrices that a shared-memory A descriptor needs.
//  - B from shared memory: the weights, packed on the host into stages of
//    64 input channels x N rows of 128 bytes with wgmma's 128-byte swizzle
//    (encoder_fused.py::pack_weights_tc), stream through a ring of STAGES
//    stages by bulk copies that complete on mbarriers, so later stages load
//    while this one's wgmmas run. A 3x3 layer's 288 KB of weights at
//    C = F = 128 would not fit in shared memory whole.
//  - Epilogue on the f32 accumulators: the bias; the tile's per-channel sums
//    over its valid pixels, reduced within each warp by shuffles and across
//    the 8 warps through shared memory in a fixed order (no atomics: the
//    result is deterministic); y rounded to bf16 and staged through shared
//    memory for 16-byte stores at a channel offset of a wider output.
#pragma once

#include <cstdint>

#include "encoder_common.cuh"

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;          // output tile rows: one warp each
constexpr int TW = 16;         // output tile columns: M = 128 pixels
constexpr int THREADS = 256;   // two warpgroups of 64 pixels
constexpr int KB = 64;         // input channels per weight stage: one 128-byte row
constexpr int CCH = 128;       // input channels per halo chunk
constexpr int STAGES = 3;      // weight stages in flight

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Weight stages of one k x k conv over C input channels. Stream order:
// 64-channel blocks, then taps (row-major).
__host__ __device__ constexpr int conv_steps(int kk, int C) { return kk * kk * ceil_div(C, KB); }

// Dynamic shared memory in bytes: the weight ring (1024-byte aligned for the
// swizzle atoms), the halo tile (which later stages the output tile), the
// per-warp channel sums, a chunk's scale and shift, and the bias.
struct SmemPlan {
  int ring, tile, red, total;
};

__host__ __device__ inline SmemPlan smem_plan(int kk_max, int C, int N) {
  SmemPlan p;
  p.ring = STAGES * N * 128;
  const int halo = (TH + kk_max - 1) * (TW + kk_max - 1) * ((C < CCH ? C : CCH) + 8);
  const int out = TH * TW * (N + 8);
  p.tile = (halo > out ? halo : out) * 2;
  p.red = 2 * (THREADS / 32) * N * 4;
  p.total = 1024 + p.ring + p.tile + p.red + (2 * CCH + N) * 4;
  return p;
}

struct Smem {
  uint32_t ring;      // shared address of stage 0
  bf16* tile;         // halo tile [pixel][C + 8], then the output tile [pixel][N + 8]
  uint32_t tile_u32;
  float* red;         // [warp][sum | sumsq][N]
  float* sc;          // [CCH] this chunk's scale
  float* sh;          // [CCH] this chunk's shift
  float* bias;        // [N]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ Smem carve(unsigned char* raw, const SmemPlan& p) {
  const uint32_t raw_u = smem_u32(raw);
  const uint32_t pad = ((raw_u + 1023u) & ~1023u) - raw_u;
  unsigned char* base = raw + pad;
  Smem s;
  s.ring = raw_u + pad;
  s.tile = reinterpret_cast<bf16*>(base + p.ring);
  s.tile_u32 = s.ring + p.ring;
  s.red = reinterpret_cast<float*>(base + p.ring + p.tile);
  s.sc = s.red + p.red / 4;
  s.sh = s.sc + CCH;
  s.bias = s.sh + CCH;
  return s;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B operand descriptor of one stage: K-major, 128-byte swizzle, rows of 128
// bytes, 8-row atoms 1024 bytes apart (SBO); LBO is unused in this mode.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define TC_D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) += a (64 x 16, bf16, registers) * b (16 x N, bf16, shared).
template <int N>
struct Mma;

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24), TC_D8(32), TC_D8(40), TC_D8(48), TC_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef TC_D8

// The weight stream of one block: stage g of it lands in ring slot
// g % STAGES and completes on that slot's mbarrier; thread 0 starts the copies.
template <int N>
struct Ring {
  static constexpr uint32_t BYTES = N * 128;
  uint32_t base;               // shared address of slot 0
  uint32_t bars;               // shared address of slot 0's mbarrier
  const unsigned char* src;    // this block's stream in global memory
  int total;                   // stages in the stream
  int next;                    // the stage the block consumes next

  __device__ __forceinline__ void fetch(int g) const {
    const int slot = g % STAGES;
    const uint32_t bar = bars + 8 * slot;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(BYTES)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            base + slot * BYTES),
        "l"(src + static_cast<size_t>(g) * BYTES), "r"(BYTES), "r"(bar)
        : "memory");
  }

  // Initialise the barriers and start the first stages; every thread waits.
  __device__ __forceinline__ void start() const {
    if (threadIdx.x == 0) {
      for (int slot = 0; slot < STAGES; ++slot)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bars + 8 * slot), "r"(1)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int g = 0; g < STAGES && g < total; ++g) fetch(g);
    }
    __syncthreads();
  }

  // Wait until stage `next` has landed; its shared address.
  __device__ __forceinline__ uint32_t wait() const {
    const int slot = next % STAGES;
    const uint32_t bar = bars + 8 * slot;
    const uint32_t parity = (next / STAGES) & 1;
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!done);
    return base + slot * BYTES;
  }

  // Once every warpgroup's wgmmas on stage g have completed: its slot takes
  // stage g + STAGES.
  __device__ __forceinline__ void refill(int g) const {
    __syncthreads();
    if (threadIdx.x == 0 && g + STAGES < total) fetch(g + STAGES);
  }
};

// One layer's operands for this block.
struct Layer {
  const bf16* x;       // the sample's input at its first input channel
  int xstride;         // channels per input pixel
  const float* sc;     // the sample's scale and shift at the first input channel
  const float* sh;
  int C;               // input channels
  bf16* y;             // the sample's output at this block's first output channel
  int out_total;       // channels per output pixel
  float* part;         // this tile's sum row at this block's first channel; sumsq follows
  int part_stride;     // channels per partials row
  int n_valid;         // output channels of this block: <= N, a multiple of 8
};

// SiLU(x * scale + shift) of 8 bf16 channels in f32, rounded to bf16.
__device__ __forceinline__ uint4 activate8(uint4 raw, const float* sc, const float* sh) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    const float z0 = v.x * sc[2 * i] + sh[2 * i];
    const float z1 = v.y * sc[2 * i + 1] + sh[2 * i + 1];
    o[i] = pack_bf16x2(__fdividef(z0, 1.f + __expf(-z0)), __fdividef(z1, 1.f + __expf(-z1)));
  }
  return out;
}

// acc (this thread's share of the 128 x N tile) = conv_KK(SiLU(...)) over
// the layer's C input channels, consuming conv_steps(KK, C) weight stages.
template <int KK, int N>
__device__ __forceinline__ void conv_tile(const Layer& L, const Smem& s, Ring<N>& ring, int H,
                                          int W, int oy, int ox, float (&acc)[N / 2]) {
  constexpr int P = KK / 2;
  constexpr int HW = TW + 2 * P;
  constexpr int NPIX = (TH + 2 * P) * HW;
  constexpr int NST = KK * KK;  // stages of a 64-channel block: one per tap
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cs = (L.C < CCH ? L.C : CCH) + 8;  // halo pixel stride in elements
  // ldmatrix rows: lanes 0-7 pixels 0-7 and lanes 8-15 pixels 8-15 of the
  // warp's tile row at channels 0-7; lanes 16-31 the same at channels 8-15
  const int px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = s.tile_u32 + ((warp * HW + px) * cs + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < L.C; c0 += CCH) {
    const int cc = L.C - c0 < CCH ? L.C - c0 : CCH;
    const int nblk = ceil_div(cc, KB);
    // The halo's 16-byte chunks of 64-channel block blk: element e is pixel
    // e / w8, channel group blk * 8 + e % w8; this thread's k-th is element
    // tid + k * THREADS.
    auto width8 = [&](int blk) { return (cc - blk * KB < KB ? cc - blk * KB : KB) / 8; };
    auto per_thread = [&](int blk) { return ceil_div(NPIX * width8(blk), THREADS); };
    auto for_chunks = [&](int blk, int k0, int k1, auto&& f) {
      const int w8 = width8(blk);
      for (int k = k0; k < k1; ++k) {
        const int e = tid + k * THREADS;
        if (e >= NPIX * w8) break;
        const int p = e / w8;
        f(p, blk * 8 + e - p * w8);
      }
    };
    auto load = [&](int p, int j) {
      const int hy = p / HW;
      const int hx = p - hy * HW;
      const int gy = reflect(oy + hy - P, H);
      const int gx = reflect(ox + hx - P, W);
      cp_async16(s.tile_u32 + (p * cs + 8 * j) * 2,
                 L.x + ((size_t)gy * W + gx) * L.xstride + c0 + 8 * j);
    };
    auto activate = [&](int p, int j) {
      uint4* v = reinterpret_cast<uint4*>(s.tile + p * cs + 8 * j);
      *v = activate8(*v, s.sc + 8 * j, s.sh + 8 * j);
    };
    __syncthreads();  // the tile and the chunk's scale / shift are free
    for (int i = tid; i < cc; i += THREADS) {
      s.sc[i] = L.sc[c0 + i];
      s.sh[i] = L.sh[c0 + i];
    }
    for (int blk = 0; blk < nblk; ++blk) {  // a cp.async group per block
      for_chunks(blk, 0, per_thread(blk), load);
      cp_async_commit();
    }
    if (nblk > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // scale / shift staged; each thread activates the chunks it copied
    for_chunks(0, 0, per_thread(0), activate);
    __syncthreads();  // block 0 of the tile is activated

    for (int blk = 0; blk < nblk; ++blk) {
      // Stage i is tap i of this block. One stage's wgmmas stay in flight
      // while the next block is activated in slices, the stage before is
      // refilled and the next stage's A fragments load (A alternates
      // between a0 and a1).
      const bool ahead = blk + 1 < nblk;
      const int kn = ahead ? per_thread(blk + 1) : 0;
      const int rest = (cc - blk * KB) / 16;
      auto load_a = [&](int i, uint32_t(&a)[4][4]) {
        const int dy = i / KK;
        const int dx = i - dy * KK;
        const uint32_t addr = a_lane + ((dy * HW + dx) * cs + blk * KB) * 2;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // past the chunk's channels: a zero fragment against zero weights
          const bool on = ks < rest;
          ldsm_x4(on ? addr + ks * 32 : addr, a[ks]);
#pragma unroll
          for (int r = 0; r < 4; ++r) a[ks][r] = on ? a[ks][r] : 0u;
        }
      };
      auto step = [&](int i, const uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
        const uint32_t stage = ring.wait();
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) Mma<N>::run(acc, cur[ks], b_desc(stage + ks * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (ahead) {  // the next block's channels: no fragment of this stage reads them
          if (i == 0) cp_async_wait<0>();
          for_chunks(blk + 1, i * kn / NST, (i + 1) * kn / NST, activate);
        }
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc);
        if (i > 0) ring.refill(ring.next - 1);  // stage i - 1 is complete in both warpgroups
        ++ring.next;
        if (i + 1 < NST) load_a(i + 1, nxt);
      };
      uint32_t a0[4][4], a1[4][4];
      load_a(0, a0);
#pragma unroll
      for (int i = 0; i < NST; i += 2) {
        step(i, a0, a1);
        if (i + 1 < NST) step(i + 1, a1, a0);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      ring.refill(ring.next - 1);  // also: the next block's activation is visible
    }
  }
}

// Bias, the tile's partial sums and the store of y. Accumulator element
// 4j + {0, 1} is pixel (warp, g) at channels 8j + 2t + {0, 1}; 4j + {2, 3}
// is pixel (warp, g + 8), where g = lane / 4 and t = lane % 4.
template <int N>
__device__ __forceinline__ void epilogue(const Layer& L, const Smem& s, const float (&acc)[N / 2],
                                         int H, int W, int oy, int ox) {
  constexpr int YS = N + 8;  // staged output pixel stride: an odd count of 16-byte chunks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool row_ok = oy + warp < H;
  const bool v0 = row_ok && ox + g < W;
  const bool v1 = row_ok && ox + g + 8 < W;
  bf16* ys = s.tile;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = s.bias[c];
    const float b1 = s.bias[c + 1];
    const float y00 = acc[4 * j] + b0;
    const float y01 = acc[4 * j + 1] + b1;
    const float y10 = acc[4 * j + 2] + b0;
    const float y11 = acc[4 * j + 3] + b1;
    float r[4] = {(v0 ? y00 : 0.f) + (v1 ? y10 : 0.f), (v0 ? y01 : 0.f) + (v1 ? y11 : 0.f),
                  (v0 ? y00 * y00 : 0.f) + (v1 ? y10 * y10 : 0.f),
                  (v0 ? y01 * y01 : 0.f) + (v1 ? y11 * y11 : 0.f)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) r[i] += __shfl_xor_sync(0xffffffffu, r[i], off);
    if (g == 0) {
      float* rw = s.red + warp * 2 * N;
      rw[c] = r[0];
      rw[c + 1] = r[1];
      rw[N + c] = r[2];
      rw[N + c + 1] = r[3];
    }
    *reinterpret_cast<uint32_t*>(ys + (warp * TW + g) * YS + c) = pack_bf16x2(y00, y01);
    *reinterpret_cast<uint32_t*>(ys + (warp * TW + g + 8) * YS + c) = pack_bf16x2(y10, y11);
  }
  __syncthreads();
  if (tid < L.n_valid) {
    float sum = 0.f, sq = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      sum += s.red[w * 2 * N + tid];
      sq += s.red[w * 2 * N + N + tid];
    }
    L.part[tid] = sum;
    L.part[L.part_stride + tid] = sq;
  }
  const int nch = L.n_valid / 8;
  for (int e = tid; e < TH * TW * nch; e += THREADS) {
    const int m = e / nch;
    const int j = e - m * nch;
    const int gy = oy + m / TW;
    const int gx = ox + m % TW;
    if (gy < H && gx < W)
      *reinterpret_cast<uint4*>(L.y + ((size_t)gy * W + gx) * L.out_total + 8 * j) =
          *reinterpret_cast<const uint4*>(ys + m * YS + 8 * j);
  }
}

// K1 in bf16: grid (tiles, F / N, B); wpk is pack_weights_tc's stream,
// (F / N, conv_steps(KK, C), N, 64) bf16.
template <int KK, int N>
__global__ void __launch_bounds__(THREADS, 2)
gn_silu_conv_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ shift, const bf16* __restrict__ wpk,
                          const float* __restrict__ bias, bf16* __restrict__ y,
                          float* __restrict__ part, int H, int W, int C, int F, int out_total,
                          int out_off, int tiles_w) {
  __shared__ __align__(8) uint64_t bars[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, smem_plan(KK, C, N));
  const int tile = blockIdx.x;
  const int fb = blockIdx.y * N;
  const int b = blockIdx.z;
  const int oy = tile / tiles_w * TH;
  const int ox = tile % tiles_w * TW;
  const int steps = conv_steps(KK, C);
  Ring<N> ring{s.ring, smem_u32(bars),
               reinterpret_cast<const unsigned char*>(wpk) +
                   static_cast<size_t>(blockIdx.y) * steps * Ring<N>::BYTES,
               steps, 0};
  ring.start();
  for (int i = threadIdx.x; i < N; i += THREADS) s.bias[i] = fb + i < F ? bias[fb + i] : 0.f;
  const Layer L{x + (size_t)b * H * W * C, C, scale + (size_t)b * C, shift + (size_t)b * C, C,
                y + (size_t)b * H * W * out_total + out_off + fb, out_total,
                part + ((size_t)b * gridDim.x + tile) * 2 * F + fb, F, F - fb < N ? F - fb : N};
  float acc[N / 2];
  conv_tile<KK, N>(L, s, ring, H, W, oy, ox, acc);
  epilogue<N>(L, s, acc, H, W, oy, ox);
}

// K6 in bf16: grid (tiles, ceil(C / N), B); the block runs the pixel
// half's 1x1 GEMM and then the semantic half's 3x3 GEMM, each with its own
// epilogue into its half of the packed output. wpk is the two halves'
// streams back to back per channel block.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
gn_silu_conv_dual_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                               const float* __restrict__ shift, const bf16* __restrict__ wpk,
                               const float* __restrict__ bias, bf16* __restrict__ y,
                               float* __restrict__ part, int H, int W, int C, int tiles_w) {
  __shared__ __align__(8) uint64_t bars[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, smem_plan(3, C, N));
  const int tile = blockIdx.x;
  const int fb = blockIdx.y * N;
  const int b = blockIdx.z;
  const int oy = tile / tiles_w * TH;
  const int ox = tile % tiles_w * TW;
  const int C2 = 2 * C;
  const int steps = conv_steps(1, C) + conv_steps(3, C);
  Ring<N> ring{s.ring, smem_u32(bars),
               reinterpret_cast<const unsigned char*>(wpk) +
                   static_cast<size_t>(blockIdx.y) * steps * Ring<N>::BYTES,
               steps, 0};
  ring.start();
  const size_t px0 = (size_t)b * H * W * C2;
  float* pt = part + ((size_t)b * gridDim.x + tile) * 2 * C2 + fb;
  float acc[N / 2];
  for (int half = 0; half < 2; ++half) {
    const int off = half * C;
    for (int i = threadIdx.x; i < N; i += THREADS)
      s.bias[i] = fb + i < C ? bias[off + fb + i] : 0.f;
    const Layer L{x + px0 + off, C2, scale + (size_t)b * C2 + off, shift + (size_t)b * C2 + off,
                  C, y + px0 + off + fb, C2, pt + off, C2, C - fb < N ? C - fb : N};
    if (half == 0)
      conv_tile<1, N>(L, s, ring, H, W, oy, ox, acc);
    else
      conv_tile<3, N>(L, s, ring, H, W, oy, ox, acc);
    epilogue<N>(L, s, acc, H, W, oy, ox);
  }
}

}  // namespace tc
}  // namespace
