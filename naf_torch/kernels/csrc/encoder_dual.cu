// One PACKED dual-stack NAF encoder layer on Hopper (K6): both stacks'
// GN -> SiLU -> conv in one launch over a packed [pix | sem] (B, H, W, 2C)
// buffer:
//     y[..., :C] = conv1x1(SiLU(x[..., :C] * scale_p + shift_p)) + b_p
//     y[..., C:] = conv3x3_reflect(SiLU(x[..., C:] * scale_s + shift_s)) + b_s
// plus per-tile f32 [sum y, sum y^2] partials over all 2C channels, for the
// next layer's two GroupNorms.
//
// Replaces the TPU kernel naf_tpu/kernels/encoder_fused.py::
// gn_silu_conv_dual_fused (body `_dual_kernel`). Layouts are NHWC;
// scale/shift are per-sample (B, 2C) f32; bias (2C,) f32.
//
// What bounds it on the card: at the production layer (448^2, C = 128 per
// stack) it must move 205.5 MB in bf16 (61 us at 3.35 TB/s) and do 65.8 GFLOP
// (66 us on bf16 tensor cores): it is bound by operations.
//
// Two kernels, chosen by the wrapper from the io dtype alone:
//  - bf16: the tensor-core core of encoder_tc.cuh run twice in one block, the
//    1x1 GEMM over the pixel half (the tile's interior, no halo) and the 3x3
//    GEMM over the semantic half, each with its own epilogue into its half
//    of the packed output; the two halves' packed weights stream through one
//    ring, so the semantic weights load while the pixel half computes;
//  - f32: the CUDA-core kernel below, exact to the reference in f32. A block
//    owns an 8 x 16 output-pixel tile and a 64-channel slice of each half;
//    256 threads, each with 4 pixels x 8 output channels in registers, reused
//    for the two halves in turn; the block walks the 2C input channels once,
//    8 at a time, through shared memory (the pixel half's chunks as the
//    tile's interior, the semantic half's as a 10 x 18 halo tile, reflect
//    padding as index math, as K1 does), each chunk activated once; each
//    half's epilogue adds the bias, reduces sum / sum-of-squares of the f32
//    y over the tile with warp shuffles into per-tile partials (B, tiles, 2,
//    2C) with no atomics (fixed order, deterministic), and stores y into its
//    half of the packed output. The pixel weights arrive as (C, C)
//    [in][out], the semantic weights tap-major as (9, C, C).

#include "encoder_common.cuh"
#include "encoder_tc.cuh"

namespace {

constexpr int TH = 8;     // output tile rows
constexpr int TW = 16;    // output tile columns
// FW, CB and MIN_BLOCKS were the fastest of a sweep of six variants in bf16
// on the H100 (naf_torch/tools/sweep_k6.py), when this kernel also ran bf16:
// fewer channels per warp and three blocks per SM beat 16 / 16 / 2 although
// they read the input once per 64-channel slice and spill 80 bytes.
constexpr int FW = 8;     // output channels per warp (a multiple of 8)
constexpr int CB = 8;     // input channels per shared-memory stage
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;  // blocks per SM the register budget allows
constexpr int FB = THREADS / 32 * FW;  // output channels per half per block
constexpr int PX = TH * TW / 32;  // pixels per thread
constexpr int SMEM_FLOATS = CB * (TH + 2) * (TW + 2) + 9 * CB * FB;
static_assert(TH == tc::TH && TW == tc::TW, "both kernels write the same per-tile partials");

// acc += conv_KK(SiLU(x[..., in_off + c] * sc + sh)) over c < C, for this
// warp's FW output channels [f0 + FW * warp, +FW) of w (KK*KK, C, C).
template <typename T, int KK>
__device__ __forceinline__ void conv_half(const T* __restrict__ xb, const float* __restrict__ sc,
                                          const float* __restrict__ sh,
                                          const T* __restrict__ w, float* zs, float* ws,
                                          float (&acc)[PX][FW], int H, int W, int C, int in_off,
                                          int oy, int ox, int f0, bool active) {
  constexpr int P = KK / 2;
  constexpr int HH = TH + 2 * P;
  constexpr int HW = TW + 2 * P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C2 = 2 * C;
  int zoff[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int p = lane + 32 * i;
    zoff[i] = (p / TW) * HW + p % TW;
#pragma unroll
    for (int j = 0; j < FW; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += CB) {
    __syncthreads();
    for (int e = tid; e < CB * HH * HW; e += THREADS) {
      const int cc = e % CB;
      const int pix = e / CB;
      const int hy = pix / HW;
      const int hx = pix % HW;
      const int gy = reflect(oy + hy - P, H);
      const int gx = reflect(ox + hx - P, W);
      const int c = in_off + c0 + cc;
      zs[(cc * HH + hy) * HW + hx] = affine_silu(xb[((size_t)gy * W + gx) * C2 + c], sc[c], sh[c]);
    }
    for (int e = tid; e < KK * KK * CB * FB; e += THREADS) {
      const int ff = e % FB;
      const int r = e / FB;
      const int cc = r % CB;
      const int tap = r / CB;
      const int f = f0 + ff;
      ws[e] = f < C ? to_f(w[((size_t)tap * C + c0 + cc) * C + f]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;  // uniform across the warp
#pragma unroll
    for (int tap = 0; tap < KK * KK; ++tap) {
      const int dy = tap / KK;
      const int dx = tap % KK;
#pragma unroll 2
      for (int cc = 0; cc < CB; ++cc) {
        const float4* wr = reinterpret_cast<const float4*>(ws + (tap * CB + cc) * FB + warp * FW);
        float wv[FW];
#pragma unroll
        for (int q = 0; q < FW / 4; ++q) {
          const float4 t = wr[q];
          wv[4 * q] = t.x;
          wv[4 * q + 1] = t.y;
          wv[4 * q + 2] = t.z;
          wv[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float zv = zs[(cc * HH + dy) * HW + dx + zoff[i]];
#pragma unroll
          for (int j = 0; j < FW; ++j) acc[i][j] = fmaf(zv, wv[j], acc[i][j]);
        }
      }
    }
  }
}

// Bias, the tile's [sum, sumsq] partials and the store of one half. The
// bias goes into the accumulators in place, and each channel's sums are
// reduced across the warp in turn, so no second set of FW values is live.
template <typename T>
__device__ __forceinline__ void epilogue(float (&acc)[PX][FW], const float* __restrict__ bias,
                                         T* __restrict__ y, float* __restrict__ part, int b,
                                         int tile, int tiles, int H, int W, int C, int out_off,
                                         int oy, int ox, int f0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fc = out_off + f0 + warp * FW;
  const int C2 = 2 * C;
  bool valid[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int p = lane + 32 * i;
    valid[i] = oy + p / TW < H && ox + p % TW < W;
  }
  float* pp = part + ((size_t)b * tiles + tile) * 2 * C2;
#pragma unroll
  for (int j = 0; j < FW; ++j) {
    const float bj = bias[fc + j];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      acc[i][j] += bj;
      if (valid[i]) {
        s += acc[i][j];
        q += acc[i][j] * acc[i][j];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      pp[fc + j] = s;
      pp[C2 + fc + j] = q;
    }
  }
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    if (valid[i]) {
      const int p = lane + 32 * i;
      T* dst = y + (((size_t)b * H + oy + p / TW) * W + ox + p % TW) * C2 + fc;
#pragma unroll
      for (int j = 0; j < FW; j += 8) store8(dst + j, acc[i] + j);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gn_silu_conv_dual_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, const T* __restrict__ wp,
                         const T* __restrict__ wsem, const float* __restrict__ bias,
                         T* __restrict__ y, float* __restrict__ part, int H, int W, int C,
                         int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                          // [CB][TH+2][TW+2] activated input
  float* ws = smem + CB * (TH + 2) * (TW + 2);  // [taps][CB][FB] weights

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int oy = (tile / tiles_w) * TH;
  const int ox = (tile % tiles_w) * TW;
  const int f0 = blockIdx.y * FB;
  const int b = blockIdx.z;
  const bool active = f0 + (int)(threadIdx.x >> 5) * FW < C;
  const T* xb = x + (size_t)b * H * W * 2 * C;
  const float* sc = scale + (size_t)b * 2 * C;
  const float* sh = shift + (size_t)b * 2 * C;

  float acc[PX][FW];
  // pixel half: 1x1 over input channels [0, C)
  conv_half<T, 1>(xb, sc, sh, wp, zs, ws, acc, H, W, C, 0, oy, ox, f0, active);
  if (active) epilogue<T>(acc, bias, y, part, b, tile, tiles, H, W, C, 0, oy, ox, f0);
  // semantic half: 3x3 with reflect padding over input channels [C, 2C)
  conv_half<T, 3>(xb, sc, sh, wsem, zs, ws, acc, H, W, C, C, oy, ox, f0, active);
  if (active) epilogue<T>(acc, bias, y, part, b, tile, tiles, H, W, C, C, oy, ox, f0);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* shift, const void* wp,
                   const void* ws, const void* bias, void* y, void* part, int B, int H, int W,
                   int C, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const size_t smem = (size_t)SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gn_silu_conv_dual_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, (C + FB - 1) / FB, B);
  gn_silu_conv_dual_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(wp), static_cast<const T*>(ws),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(part), H, W, C,
      tiles_w);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_wgmma(const void* x, const void* scale, const void* shift, const void* wpk,
                         const void* bias, void* y, void* part, int B, int H, int W, int C,
                         cudaStream_t stream) {
  const int smem = tc::smem_plan(3, C, N).total;
  cudaError_t err = cudaFuncSetAttribute(tc::gn_silu_conv_dual_wgmma_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  dim3 grid(((H + TH - 1) / TH) * tiles_w, (C + N - 1) / N, B);
  tc::gn_silu_conv_dual_wgmma_kernel<N><<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      H, W, C, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of output tiles (the `tiles` axis of the partial sums), the same for
// both kernels.
int naf_gn_silu_conv_dual_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Shape rules the launches rely on: C % 16 == 0 (C channels per stack, 2C in
// the packed buffer), H and W >= 2 (reflect padding). The wrapper checks them.

// f32 on the CUDA cores.
int naf_gn_silu_conv_dual_fma(const void* x, const void* scale, const void* shift, const void* wp,
                              const void* ws, const void* bias, void* y, void* part, int B,
                              int H, int W, int C, void* stream) {
  return launch<float>(x, scale, shift, wp, ws, bias, y, part, B, H, W, C,
                       static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores; wpk is pack_weights_tc's stream of the pixel and
// then the semantic weights for n_block (64 or 128) output channels per block.
int naf_gn_silu_conv_dual_wgmma(const void* x, const void* scale, const void* shift,
                                const void* wpk, const void* bias, void* y, void* part, int B,
                                int H, int W, int C, int n_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_block == 128)
    return launch_wgmma<128>(x, scale, shift, wpk, bias, y, part, B, H, W, C, s);
  if (n_block == 64) return launch_wgmma<64>(x, scale, shift, wpk, bias, y, part, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
