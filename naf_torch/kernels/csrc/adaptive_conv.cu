// Spatially varying convolution (FeatUp's AdaptiveConv) on Hopper, kernel K5:
//
//     out[b, y, x, c] = sum_{i,j < K} ker[b, y, x, i, j] * src[b, y + i, x + j, c]
//
// src is the already padded source (B, H+K-1, W+K-1, C) in T (f32 or bf16),
// ker the per-pixel weights (B, H, W, K, K) in f32, out (B, H, W, C) in T.
// Weights and accumulation are f32, as in the TPU kernel.
//
// Replaces the TPU kernel naf_tpu/kernels/adaptive_conv_fused.py::
// adaptive_conv_fused (body `_kernel`). Its halo blocks (`pl.Element`), the
// right-padding of columns to multiples of 8, the 128-lane padding of K^2 and
// the C % 128 rule were for the TPU; this file takes any B, H, W and C and
// every odd K up to 15.
//
// There is no contraction dimension, so no tensor cores. The host plan
// (`_plan_k5` in adaptive_conv_fused.py) picks one of two routes, each built
// for what bounds it; the shared-memory sizes below are its formulas, and a
// launch whose plan disagrees with them is refused.
//
// narrow (C <= 8; JBU: C 3, K 11). The bytes are the weights: K^2 f32 per
// pixel against C source values. A block owns TWN consecutive pixels of one
// output row, one thread each. The row segment's weights are one contiguous
// range of `ker`: it is streamed into shared memory by 16-byte cp.async (the
// few elements before the first and after the last aligned piece by plain
// loads), together with the K x (TWN+K-1) source halo, all C channels as f32
// padded with zeros to 4 or 8 (f32 by 4-byte cp.async; bf16, converted, by
// plain loads; the source is small and stays in L2). Every lane then walks
// its pixel's K^2 taps: one weight (lanes K^2 floats apart, an odd stride:
// no bank conflict) and one or two float4 halo reads per tap. A block is
// short, and several blocks per SM keep the weights' copies in flight.
//
// wide (C > 8; FeatUp: C 384, K 7). At 448^2 the bytes (664 MB) and the
// operations (7.55 GFLOP) take about the same time, so the inner loop has to
// run near the FMA rate. A block owns a TH x 16 tile and one chunk of the
// channels (a grid axis, so the 56^2 and 112^2 stages fill the SMs), walked
// in stages of 32 channels:
//  - a thread owns a run of 4 consecutive pixels of a tile row and 8
//    channels of each stage (lane l of 4 in the run); per tap row it holds
//    the row's K weights of its 4 pixels in registers (K float4 loads from a
//    tap-major layout [K^2][TH*16 + 4]: one 16-byte load serves 32 FMAs),
//    then streams the 4+K-1 halo pixels of the row, each read once (8
//    channels, 16-byte loads) and used by every pixel of the run that needs
//    it: 32 accumulators;
//  - the tile's weights are staged once per block, by 4-byte cp.async into
//    the tap-major layout together with the first stage, and serve every
//    channel stage of the chunk;
//  - the stages' halos, (TH+K-1) x (16+K-1) pixels of 32 channels, arrive by
//    16-byte cp.async into a ring of two buffers (zero-filled past C and past
//    the edge): stage s+1's copies are issued right after the one barrier of
//    stage s and fly while stage s is computed. Channels that do not come in
//    16-byte pieces (f32 C % 4, bf16 C % 8, or a misaligned source) are
//    staged by plain loads instead;
//  - a halo pixel takes 144 bytes (f32, 32 channels + 4 of padding) or 80
//    (bf16): the two runs of a quarter-warp then read disjoint banks.
// Per warp and tap row that is 4(4+K-1) + K 16-byte wavefronts against 32K
// FFMA warp-instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 15;
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block may use

// wide route
constexpr int WTW = 16;  // tile columns
constexpr int WP = 4;    // consecutive pixels per thread
constexpr int WL = 4;    // lanes per run of pixels, 8 channels each
constexpr int WCS = 32;  // channels per pipeline stage
constexpr int WDEPTH = 2;

// elements per halo pixel of a stage: 32 channels and 16 bytes of padding
template <typename T> __host__ __device__ constexpr int halo_stride() {
  return WCS + 16 / (int)sizeof(T);
}

template <typename T> size_t wide_smem(int K, int TH) {
  return sizeof(float) * (size_t)K * K * (TH * WTW + 4) +
         (size_t)WDEPTH * (TH + K - 1) * (WTW + K - 1) * halo_stride<T>() * sizeof(T);
}

size_t narrow_smem(int K, int TWN, int NC4) {
  return sizeof(float) * ((size_t)TWN * K * K + 8) + 16 * (size_t)NC4 * K * (TWN + K - 1);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// 4-byte copy, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 8 channels lane l reads of a halo pixel's stage, as f32: for f32 the
// channels 4l..4l+3 and 16+4l..16+4l+3 (two 16-byte loads), for bf16
// 8l..8l+7 (one). chan0(l, g) is the first channel of h[4g..4g+3].
__device__ __forceinline__ void halo8(const float* px, int l, float (&h)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(px + 4 * l);
  const float4 b = *reinterpret_cast<const float4*>(px + 16 + 4 * l);
  h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
  h[4] = b.x; h[5] = b.y; h[6] = b.z; h[7] = b.w;
}

__device__ __forceinline__ void halo8(const __nv_bfloat16* px, int l, float (&h)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(px + 8 * l);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    h[2 * q] = f.x;
    h[2 * q + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ int chan0(int l, int g) {
  return sizeof(T) == 4 ? 4 * l + 16 * g : 8 * l + 4 * g;
}

// ---------------------------------------------------------------------------
// wide route: blockDim.x = TH * 16 threads, grid (tiles, chunks, B); a block
// walks the stages [blockIdx.y * spc, +spc) of 32 channels. vec: the source
// comes in 16-byte pieces (C * sizeof(T) % 16 == 0, 16-byte aligned).
template <typename T, int K>
__global__ void __launch_bounds__(128, 2)
adaptive_conv_wide_kernel(const T* __restrict__ src, const float* __restrict__ ker,
                          T* __restrict__ out, int H, int W, int C, int TH, int tiles_w,
                          int spc, int vec) {
  constexpr int KK = K * K;
  constexpr int HW = WTW + K - 1;
  constexpr int S = halo_stride<T>();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte piece
  constexpr int CPC = WCS / EPC;            // pieces per halo pixel and stage
  const int tile = TH * WTW;                // pixels = threads
  const int wstride = tile + 4;             // floats per tap row of `ws`
  const int hpx = (TH + K - 1) * HW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [KK][tile + 4]
  T* ring = reinterpret_cast<T*>(smem_raw + sizeof(float) * KK * wstride);  // [2][hpx][S]

  const int tid = threadIdx.x;
  const int l = tid % WL, r = tid / WL;  // lane of the run, run = pixels 4r..4r+3 of the tile
  const int ry = r / (WTW / WP), rx = (r % (WTW / WP)) * WP;
  const int oy = (blockIdx.x / tiles_w) * TH, ox = (blockIdx.x % tiles_w) * WTW;
  const int b = blockIdx.z;
  const int Hp = H + K - 1, Wp = W + K - 1;
  const int s0 = blockIdx.y * spc, s1 = min((C + WCS - 1) / WCS, s0 + spc);
  const T* sb = src + (size_t)b * Hp * Wp * C;

  auto load_stage = [&](int s) {
    T* hs = ring + (size_t)((s - s0) & 1) * hpx * S;
    const int c0 = s * WCS;
    if (vec) {
      for (int e = tid; e < hpx * CPC; e += tile) {
        const int pix = e / CPC, q = e % CPC;
        const int hy = oy + pix / HW, hx = ox + pix % HW, c = c0 + q * EPC;
        const bool ok = hy < Hp && hx < Wp && c < C;
        const T* g = ok ? sb + ((size_t)hy * Wp + hx) * C + c : sb;
        cp_async16(hs + pix * S + q * EPC, g, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < hpx * WCS; e += tile) {
        const int pix = e / WCS, q = e % WCS;
        const int hy = oy + pix / HW, hx = ox + pix % HW, c = c0 + q;
        const bool ok = hy < Hp && hx < Wp && c < C;
        hs[pix * S + q] = ok ? sb[((size_t)hy * Wp + hx) * C + c] : from_f<T>(0.f);
      }
    }
    cp_async_commit();
  };

  // the tile's weights, tap-major, by 4-byte cp.async (zero past the edge)
  // in the first stage's group; lanes take consecutive taps of a pixel
  // (coalesced reads)
  const float* kb = ker + (size_t)b * H * W * KK;
  for (int e = tid; e < KK * tile; e += tile) {
    const int t = e % KK, p = e / KK;
    const int y = oy + p / WTW, x = ox + p % WTW;
    const bool ok = y < H && x < W;
    cp_async4(ws + t * wstride + p, ok ? kb + ((size_t)y * W + x) * KK + t : kb, ok ? 4 : 0);
  }
  load_stage(s0);

  const int y = oy + ry;
  const bool ovec = C % 4 == 0;
  for (int s = s0; s < s1; ++s) {
    cp_async_wait<0>();
    // stage s (and, first time round, the weights) are in for every thread,
    // and every thread is done with stage s - 1, whose buffer the copies of
    // stage s + 1 now fill while stage s is computed
    __syncthreads();
    if (s + 1 < s1) load_stage(s + 1);

    const T* hs = ring + (size_t)((s - s0) & 1) * hpx * S;
    float acc[WP][8];
#pragma unroll
    for (int p = 0; p < WP; ++p)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;
    // tap rows unrolled up to K 9, so that the next row's weight and halo
    // loads issue under the current row's FMAs; above, the registers would
    // spill
#pragma unroll (K <= 9 ? K : 1)
    for (int i = 0; i < K; ++i) {
      float4 w[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        w[j] = *reinterpret_cast<const float4*>(ws + (i * K + j) * wstride + 4 * r);
      const T* hrow = hs + ((ry + i) * HW + rx) * S;
#pragma unroll
      for (int q = 0; q < WP + K - 1; ++q) {
        float h[8];
        halo8(hrow + q * S, l, h);
#pragma unroll
        for (int p = 0; p < WP; ++p) {
          const int j = q - p;
          if (j >= 0 && j < K) {
            const float wv = p == 0 ? w[j].x : (p == 1 ? w[j].y : (p == 2 ? w[j].z : w[j].w));
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[p][e] = fmaf(wv, h[e], acc[p][e]);
          }
        }
      }
    }

    if (y < H) {
#pragma unroll
      for (int p = 0; p < WP; ++p) {
        const int x = ox + rx + p;
        if (x >= W) break;
        T* o = out + (((size_t)b * H + y) * W + x) * C;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int c = s * WCS + chan0<T>(l, g);
          if (ovec && c + 3 < C) {
            store4(o + c, &acc[p][4 * g]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < C) o[c + e] = from_f<T>(acc[p][4 * g + e]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// narrow route: blockDim.x = TWN threads, one output pixel each, grid
// (H * tiles_w, 1, B); NC4 = ceil(C / 4) float4s of channels per halo pixel.
template <typename T, int NC4>
__global__ void __launch_bounds__(128)
adaptive_conv_narrow_kernel(const T* __restrict__ src, const float* __restrict__ ker,
                            T* __restrict__ out, int H, int W, int C, int K, int tiles_w) {
  const int TWN = blockDim.x, KK = K * K, HW = TWN + K - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);                // [TWN * KK + 8]
  float4* hs = reinterpret_cast<float4*>(ws + TWN * KK + 8);    // [K][HW][NC4]

  const int tid = threadIdx.x, b = blockIdx.z;
  const int y = blockIdx.x / tiles_w, x0 = (blockIdx.x % tiles_w) * TWN;
  const int n = min(TWN, W - x0);

  // weights of pixels x0..x0+n-1: the nw floats from wg on, wg[e] at
  // ws[shift + e], shift the floats wg lies past a 16-byte boundary, so that
  // the whole 16-byte pieces of the range land on 16-byte pieces of ws
  const float* wg = ker + (((size_t)b * H + y) * W + x0) * KK;
  const int nw = n * KK;
  const int shift = (int)((reinterpret_cast<uintptr_t>(wg) >> 2) & 3);
  const int head = shift ? 4 - shift : 0;  // floats before the first whole piece
  const int m1 = (nw + shift) / 4;         // pieces [head > 0, m1) lie inside the range
  for (int m = (head > 0) + tid; m < m1; m += TWN) cp_async16(ws + 4 * m, wg + 4 * m - shift, 16);
  if (tid < 8) {  // the at most 3 floats before the first piece and after the last
    const int e = tid < 4 ? tid : max(head, 4 * m1 - shift) + tid - 4;
    if (e < nw && (tid >= 4 || e < head)) ws[shift + e] = wg[e];
  }

  // source halo: rows y..y+K-1, columns x0..x0+TWN+K-2, all C channels, zero
  // past C and past the edge; f32 by 4-byte cp.async in the weights' group,
  // bf16 (converted) by plain loads
  const int Wp = W + K - 1;
  const T* sb = src + (size_t)b * (H + K - 1) * Wp * C;
  for (int e = tid; e < K * HW; e += TWN) {
    const int i = e / HW, hx = x0 + e % HW;
    const T* p = sb + ((size_t)(y + i) * Wp + hx) * C;
    if constexpr (sizeof(T) == 4) {
      float* d = reinterpret_cast<float*>(hs + e * NC4);
#pragma unroll
      for (int c = 0; c < 4 * NC4; ++c) {
        const bool ok = hx < Wp && c < C;
        cp_async4(d + c, ok ? p + c : sb, ok ? 4 : 0);
      }
    } else {
      float v[4 * NC4];
#pragma unroll
      for (int c = 0; c < 4 * NC4; ++c) v[c] = (hx < Wp && c < C) ? to_f(p[c]) : 0.f;
#pragma unroll
      for (int q = 0; q < NC4; ++q)
        hs[e * NC4 + q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (tid >= n) return;
  float4 acc[NC4];
#pragma unroll
  for (int q = 0; q < NC4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* wp = ws + shift + tid * KK;
  for (int i = 0; i < K; ++i) {
    const float4* hrow = hs + (i * HW + tid) * NC4;
    const float* wi = wp + i * K;
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      const float wv = wi[j];
#pragma unroll
      for (int q = 0; q < NC4; ++q) {
        const float4 h = hrow[j * NC4 + q];
        acc[q].x = fmaf(wv, h.x, acc[q].x);
        acc[q].y = fmaf(wv, h.y, acc[q].y);
        acc[q].z = fmaf(wv, h.z, acc[q].z);
        acc[q].w = fmaf(wv, h.w, acc[q].w);
      }
    }
  }
  T* o = out + (((size_t)b * H + y) * W + x0 + tid) * C;
#pragma unroll
  for (int q = 0; q < NC4; ++q) {
    const float v[4] = {acc[q].x, acc[q].y, acc[q].z, acc[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < C) o[4 * q + e] = from_f<T>(v[e]);
  }
}

// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int K>
int launch_wide(const void* src, const void* ker, void* out, int B, int H, int W, int C, int TH,
                int chunks, int spc, int vec, size_t smem, cudaStream_t s) {
  const int tiles_w = (W + WTW - 1) / WTW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const int nst = (C + WCS - 1) / WCS;
  if ((TH != 8 && TH != 4) || smem != wide_smem<T>(K, TH) || smem > SMEM_LIMIT ||
      spc < 1 || chunks != (nst + spc - 1) / spc || C <= 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(adaptive_conv_wide_kernel<T, K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  adaptive_conv_wide_kernel<T, K><<<dim3(tiles, chunks, B), TH * WTW, smem, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(ker), static_cast<T*>(out), H, W, C,
      TH, tiles_w, spc, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wide(const void* src, const void* ker, void* out, int B, int H, int W, int C, int K,
                  int TH, int chunks, int spc, int vec, size_t smem, cudaStream_t s) {
  switch (K) {
    case 1: return launch_wide<T, 1>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 3: return launch_wide<T, 3>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 5: return launch_wide<T, 5>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 7: return launch_wide<T, 7>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 9: return launch_wide<T, 9>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 11: return launch_wide<T, 11>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 13: return launch_wide<T, 13>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    case 15: return launch_wide<T, 15>(src, ker, out, B, H, W, C, TH, chunks, spc, vec, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int NC4>
int launch_narrow(const void* src, const void* ker, void* out, int B, int H, int W, int C, int K,
                  int TWN, size_t smem, cudaStream_t s) {
  if ((TWN != 128 && TWN != 64 && TWN != 32) || smem != narrow_smem(K, TWN, NC4) ||
      smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(adaptive_conv_narrow_kernel<T, NC4>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TWN - 1) / TWN;
  adaptive_conv_narrow_kernel<T, NC4><<<dim3(H * tiles_w, 1, B), TWN, smem, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(ker), static_cast<T*>(out), H, W, C,
      K, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_narrow(const void* src, const void* ker, void* out, int B, int H, int W, int C,
                    int K, int TWN, size_t smem, cudaStream_t s) {
  if (K < 1 || K > MAX_K || K % 2 == 0 || C < 1 || C > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 4) return launch_narrow<T, 1>(src, ker, out, B, H, W, C, K, TWN, smem, s);
  return launch_narrow<T, 2>(src, ker, out, B, H, W, C, K, TWN, smem, s);
}

}  // namespace

extern "C" {

// Largest K the kernels take (odd K from 1).
int naf_adaptive_conv_max_k() { return MAX_K; }

// src (B, H+K-1, W+K-1, C) and out (B, H, W, C) in f32 (is_bf16 = 0) or
// bf16, ker (B, H, W, K, K) f32, all contiguous; the wrapper checks the
// shapes. smem is the plan's: a launch whose plan does not match this file's
// formula is refused (cudaErrorInvalidValue).
int naf_adaptive_conv_narrow(const void* src, const void* ker, void* out, int B, int H, int W,
                             int C, int K, int tw, long long smem, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_narrow<__nv_bfloat16>(src, ker, out, B, H, W, C, K, tw, (size_t)smem, s);
  return dispatch_narrow<float>(src, ker, out, B, H, W, C, K, tw, (size_t)smem, s);
}

int naf_adaptive_conv_wide(const void* src, const void* ker, void* out, int B, int H, int W,
                           int C, int K, int th, int chunks, int spc, int vec, long long smem,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_wide<__nv_bfloat16>(src, ker, out, B, H, W, C, K, th, chunks, spc, vec,
                                        (size_t)smem, s);
  return dispatch_wide<float>(src, ker, out, B, H, W, C, K, th, chunks, spc, vec, (size_t)smem,
                              s);
}

}  // extern "C"
