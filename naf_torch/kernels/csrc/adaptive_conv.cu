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
// the C % 128 rule were for the TPU; this kernel takes any B, H, W and C and
// every odd K up to 15.
//
// What bounds it on the card: there is no contraction dimension, so no tensor
// cores; every source element is used K^2 times from on-chip memory, and the
// kernel must read src and ker once and write out once. At FeatUp's last
// stage (f32, 448^2, C 384, K 7) that is 664 MB, 0.198 ms at 3.35 TB/s, while
// the 7.55 GFLOP take 0.11 ms at 67 TFLOP/s: bytes bound it. JBU (C 3,
// K 11) moves mostly weights (121 per pixel).
//
// Design (a first, simple kernel):
//  - a block owns TH x 32 output pixels of one sample and walks over the
//    channels in stages of 32;
//  - the tile's TH*32*K^2 weights are staged in shared memory once;
//  - each stage stages the (TH+K-1) x (32+K-1) halo of 32 channels as f32,
//    channels innermost, read from global memory with 16-byte loads when
//    C % 4 == 0 (element loads otherwise, zero past C and past the edge);
//  - a thread owns 8 consecutive output pixels of a row and 4 channels: per
//    tap row i it loads the 8+K-1 halo float4s once into registers and reuses
//    them over the K taps of the row (32 f32 accumulators);
//  - lanes 0-7 of a quarter-warp read one pixel's 128 contiguous bytes of the
//    halo (no bank conflicts); the 4 pixel runs of a warp read weights at a
//    stride of 8*K^2 floats, which is 8 banks apart for odd K (broadcast
//    within a run, no conflicts across runs).
// TH is 8 for K <= 3, 4 for K <= 7 and 2 above, which keeps the shared memory
// of a block between 33 KB (K 1) and 152 KB (K 15), two or more blocks per SM
// up to K 11.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;      // output tile columns
constexpr int SEG = 8;      // consecutive output pixels per thread
constexpr int CB = 32;      // channels per shared-memory stage
constexpr int CG = CB / 4;  // 4-channel groups per stage
constexpr int MAX_K = 15;

template <int K> __host__ __device__ constexpr int tile_rows() {
  return K <= 3 ? 8 : (K <= 7 ? 4 : 2);
}

template <int K> __host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(tile_rows<K>() * TW * K * K + (tile_rows<K>() + K - 1) * (TW + K - 1) * CB) *
         sizeof(float);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void fma4(float4& acc, const float w, const float4 h) {
  acc.x = fmaf(w, h.x, acc.x);
  acc.y = fmaf(w, h.y, acc.y);
  acc.z = fmaf(w, h.z, acc.z);
  acc.w = fmaf(w, h.w, acc.w);
}

// vec: C % 4 == 0 and 16-byte aligned src/out, so 4 channels move as one load.
template <typename T, int K>
__global__ void __launch_bounds__(tile_rows<K>() * 32)
adaptive_conv_kernel(const T* __restrict__ src, const float* __restrict__ ker,
                     T* __restrict__ out, int H, int W, int C, int tiles_w, int vec) {
  constexpr int TH = tile_rows<K>();
  constexpr int KK = K * K;
  constexpr int HH = TH + K - 1;
  constexpr int HW = TW + K - 1;
  constexpr int THREADS = TH * 32;
  constexpr int R = SEG + K - 1;  // halo float4s a thread reads per tap row
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                 // [TH * TW][KK] the tile's weights
  float4* hs = reinterpret_cast<float4*>(smem + TH * TW * KK);  // [HH][HW][CG] halo

  const int tid = threadIdx.x;
  const int g = tid % CG;    // 4-channel group of the stage
  const int seg = tid / CG;  // run of SEG pixels: TW / SEG runs per tile row
  const int sy = seg / (TW / SEG);
  const int sx = (seg % (TW / SEG)) * SEG;
  const int oy = (blockIdx.x / tiles_w) * TH;
  const int ox = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y;
  const int Hp = H + K - 1, Wp = W + K - 1;
  const T* sb = src + (size_t)b * Hp * Wp * C;

  for (int e = tid; e < TH * TW * KK; e += THREADS) {
    const int p = e / KK, t = e % KK;
    const int y = oy + p / TW, x = ox + p % TW;
    ws[e] = (y < H && x < W) ? ker[(((size_t)b * H + y) * W + x) * KK + t] : 0.f;
  }

  const float* wrun = ws + (sy * TW + sx) * KK;
  const int y = oy + sy;
  for (int c0 = 0; c0 < C; c0 += CB) {
    __syncthreads();  // the weights are in; the previous stage's reads are done
    for (int e = tid; e < HH * HW * CG; e += THREADS) {
      const int gg = e % CG, pix = e / CG;
      const int hy = oy + pix / HW, hx = ox + pix % HW;
      const int c = c0 + 4 * gg;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hy < Hp && hx < Wp && c < C) {
        const T* p = sb + ((size_t)hy * Wp + hx) * C + c;
        if (vec) {
          v = load4(p);
        } else {
          v.x = to_f(p[0]);
          if (c + 1 < C) v.y = to_f(p[1]);
          if (c + 2 < C) v.z = to_f(p[2]);
          if (c + 3 < C) v.w = to_f(p[3]);
        }
      }
      hs[e] = v;
    }
    __syncthreads();

    float4 acc[SEG];
#pragma unroll
    for (int p = 0; p < SEG; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int i = 0; i < K; ++i) {
      const float4* hrow = hs + ((sy + i) * HW + sx) * CG + g;
      float4 h[R];
#pragma unroll
      for (int q = 0; q < R; ++q) h[q] = hrow[q * CG];
      const float* wi = wrun + i * K;
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int p = 0; p < SEG; ++p) fma4(acc[p], wi[p * KK + j], h[p + j]);
    }

    const int c = c0 + 4 * g;
    if (y < H && c < C) {
      T* orow = out + ((size_t)b * H + y) * W * C + c;
#pragma unroll
      for (int p = 0; p < SEG; ++p) {
        const int x = ox + sx + p;
        if (x >= W) break;
        T* o = orow + (size_t)x * C;
        if (vec) {
          store4(o, acc[p]);
        } else {
          o[0] = from_f<T>(acc[p].x);
          if (c + 1 < C) o[1] = from_f<T>(acc[p].y);
          if (c + 2 < C) o[2] = from_f<T>(acc[p].z);
          if (c + 3 < C) o[3] = from_f<T>(acc[p].w);
        }
      }
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* src, const void* ker, void* out, int B, int H, int W, int C,
                   int vec, cudaStream_t stream) {
  constexpr int TH = tile_rows<K>();
  const size_t smem = smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(adaptive_conv_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  adaptive_conv_kernel<T, K><<<dim3(tiles, B), TH * 32, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(ker), static_cast<T*>(out), H, W, C,
      tiles_w, vec);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* src, const void* ker, void* out, int B, int H, int W, int C, int K,
             int vec, cudaStream_t s) {
  switch (K) {
    case 1: return launch<T, 1>(src, ker, out, B, H, W, C, vec, s);
    case 3: return launch<T, 3>(src, ker, out, B, H, W, C, vec, s);
    case 5: return launch<T, 5>(src, ker, out, B, H, W, C, vec, s);
    case 7: return launch<T, 7>(src, ker, out, B, H, W, C, vec, s);
    case 9: return launch<T, 9>(src, ker, out, B, H, W, C, vec, s);
    case 11: return launch<T, 11>(src, ker, out, B, H, W, C, vec, s);
    case 13: return launch<T, 13>(src, ker, out, B, H, W, C, vec, s);
    case 15: return launch<T, 15>(src, ker, out, B, H, W, C, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Largest K the kernel takes (odd K from 1).
int naf_adaptive_conv_max_k() { return MAX_K; }

// src (B, H+K-1, W+K-1, C) and out (B, H, W, C) in f32 (is_bf16 = 0) or bf16,
// ker (B, H, W, K, K) f32, all contiguous. The wrapper checks the shapes.
int naf_adaptive_conv(const void* src, const void* ker, void* out, int B, int H, int W, int C,
                      int K, int vec, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(src, ker, out, B, H, W, C, K, vec, s);
  return dispatch<float>(src, ker, out, B, H, W, C, K, vec, s);
}

}  // extern "C"
