// One fused NAF encoder layer on Hopper (K1):
//     y = conv_k(SiLU(x * scale + shift)) + bias,   k in {1, 3}, reflect padding,
// plus per-tile f32 [sum y, sum y^2] partials for the next GroupNorm.
//
// Replaces the TPU kernel naf_tpu/kernels/encoder_fused.py::gn_silu_conv_fused
// (body `_kernel`). Layouts are NHWC; scale/shift are per-sample (B, C) f32;
// bias (F,) f32. y is written at channel offset out_off of an out_total-wide
// output, so two stacks can share one packed buffer.
//
// What bounds it on the card: at the production shape (448^2, C = F = 128) a
// 3x3 layer must move ~103 MB in bf16 (31 us at 3.35 TB/s) and do 59 GFLOP
// (60 us on bf16 tensor cores): it is bound by operations. A 1x1 layer (6.6
// GFLOP, 103 MB) is bound by bytes.
//
// Two kernels, chosen by the wrapper from the io dtype alone:
//  - bf16: the tensor-core implicit GEMM of encoder_tc.cuh (wgmma, weights
//    packed by the wrapper): a block owns an 8 x 16 tile and all F <= 128
//    output channels, so it reads and activates its halo once; the products
//    run on the tensor cores, not as f32 FMA;
//  - f32: the CUDA-core kernel below, exact to the reference in f32 (TF32
//    would miss the 2e-4 bar over a 1152-term sum). A block owns an 8 x 16
//    output-pixel tile and a 64-channel slice of F; 256 threads, each with
//    4 pixels x 8 output channels in registers; input channels stream
//    through shared memory 16 at a time (the activated halo tile and that
//    chunk's weights, (k*k, C, F) tap-major); reflect padding is index math
//    on the halo load (row -1 reads row 1, row H reads row H-2); the
//    epilogue adds the bias, reduces sum / sum-of-squares of the f32 y over
//    the tile with warp shuffles into per-tile partials (B, tiles, 2, F)
//    with no atomics (fixed order, deterministic).

#include "encoder_common.cuh"
#include "encoder_tc.cuh"

namespace {

constexpr int TH = 8;     // output tile rows
constexpr int TW = 16;    // output tile columns
constexpr int FB = 64;    // output channels per block
constexpr int CB = 16;    // input channels per shared-memory stage
constexpr int THREADS = 256;
constexpr int PX = TH * TW / 32;  // pixels per thread
static_assert(TH == tc::TH && TW == tc::TW, "both kernels write the same per-tile partials");

template <typename T, int KK>
__global__ void __launch_bounds__(THREADS)
gn_silu_conv_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ part, int H, int W, int C, int F,
                    int out_total, int out_off, int tiles_w) {
  constexpr int P = KK / 2;
  constexpr int HH = TH + 2 * P;
  constexpr int HW = TW + 2 * P;
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                  // [CB][HH][HW] activated input
  float* ws = smem + CB * HH * HW;   // [KK*KK][CB][FB] weights

  const int tile = blockIdx.x;
  const int oy = (tile / tiles_w) * TH;
  const int ox = (tile % tiles_w) * TW;
  const int f0 = blockIdx.y * FB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* xb = x + (size_t)b * H * W * C;
  const float* sc = scale + (size_t)b * C;
  const float* sh = shift + (size_t)b * C;

  int py[PX], px[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    py[i] = (lane + 32 * i) / TW;
    px[i] = (lane + 32 * i) % TW;
  }
  float acc[PX][8];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CB) {
    __syncthreads();
    for (int e = tid; e < CB * HH * HW; e += THREADS) {
      const int cc = e % CB;
      const int pix = e / CB;
      const int hy = pix / HW;
      const int hx = pix % HW;
      const int gy = reflect(oy + hy - P, H);
      const int gx = reflect(ox + hx - P, W);
      const int c = c0 + cc;
      zs[(cc * HH + hy) * HW + hx] = affine_silu(xb[((size_t)gy * W + gx) * C + c], sc[c], sh[c]);
    }
    for (int e = tid; e < KK * KK * CB * FB; e += THREADS) {
      const int ff = e % FB;
      const int r = e / FB;
      const int cc = r % CB;
      const int tap = r / CB;
      ws[e] = to_f(w[((size_t)tap * C + c0 + cc) * F + f0 + ff]);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < KK * KK; ++tap) {
      const int dy = tap / KK;
      const int dx = tap % KK;
#pragma unroll 4
      for (int cc = 0; cc < CB; ++cc) {
        const float* wr = ws + (tap * CB + cc) * FB + warp * 8;
        const float4 w0 = reinterpret_cast<const float4*>(wr)[0];
        const float4 w1 = reinterpret_cast<const float4*>(wr)[1];
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float zv = zs[(cc * HH + py[i] + dy) * HW + px[i] + dx];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(zv, wv[j], acc[i][j]);
        }
      }
    }
  }

  const int fc = f0 + warp * 8;
  float s[8], q[8], bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
    bv[j] = bias[fc + j];
  }
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int gy = oy + py[i];
    const int gx = ox + px[i];
    if (gy < H && gx < W) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = acc[i][j] + bv[j];
        s[j] += v[j];
        q[j] += v[j] * v[j];
      }
      store8(y + (((size_t)b * H + gy) * W + gx) * out_total + out_off + fc, v);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
    }
  }
  if (lane == 0) {
    float* pp = part + ((size_t)b * gridDim.x + tile) * 2 * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pp[fc + j] = s[j];
      pp[F + fc + j] = q[j];
    }
  }
}

template <typename T, int KK>
cudaError_t launch(const void* x, const void* scale, const void* shift, const void* w,
                   const void* bias, void* y, void* part, int B, int H, int W, int C, int F,
                   int out_total, int out_off, cudaStream_t stream) {
  constexpr int P = KK / 2;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const size_t smem = (size_t)(CB * (TH + 2 * P) * (TW + 2 * P) + KK * KK * CB * FB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gn_silu_conv_kernel<T, KK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, F / FB, B);
  gn_silu_conv_kernel<T, KK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(part), H, W,
      C, F, out_total, out_off, tiles_w);
  return cudaGetLastError();
}

template <int KK, int N>
cudaError_t launch_wgmma(const void* x, const void* scale, const void* shift, const void* wpk,
                         const void* bias, void* y, void* part, int B, int H, int W, int C,
                         int F, int out_total, int out_off, cudaStream_t stream) {
  const int smem = tc::smem_plan(KK, C, N).total;
  cudaError_t err = cudaFuncSetAttribute(tc::gn_silu_conv_wgmma_kernel<KK, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  dim3 grid(((H + TH - 1) / TH) * tiles_w, F / N, B);
  tc::gn_silu_conv_wgmma_kernel<KK, N><<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      H, W, C, F, out_total, out_off, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of output tiles (the `tiles` axis of the partial sums), the same for
// both kernels.
int naf_gn_silu_conv_tiles(int H, int W) { return ((H + TH - 1) / TH) * ((W + TW - 1) / TW); }

// Shape rules the launches rely on: C % 16 == 0, F % 64 == 0, out_off and
// out_total multiples of 8, H and W >= 2 for k = 3. The wrapper checks them.

// f32 on the CUDA cores; w is (k*k, C, F) tap-major.
int naf_gn_silu_conv_fma(const void* x, const void* scale, const void* shift, const void* w,
                         const void* bias, void* y, void* part, int B, int H, int W, int C,
                         int F, int ksize, int out_total, int out_off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ksize == 1)
    return launch<float, 1>(x, scale, shift, w, bias, y, part, B, H, W, C, F, out_total,
                            out_off, s);
  if (ksize == 3)
    return launch<float, 3>(x, scale, shift, w, bias, y, part, B, H, W, C, F, out_total,
                            out_off, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 on the tensor cores; wpk is pack_weights_tc's stream for n_block
// (64 or 128 output channels per block, F % n_block == 0).
int naf_gn_silu_conv_wgmma(const void* x, const void* scale, const void* shift, const void* wpk,
                           const void* bias, void* y, void* part, int B, int H, int W, int C,
                           int F, int ksize, int n_block, int out_total, int out_off,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((n_block != 64 && n_block != 128) || F % n_block)
    return static_cast<int>(cudaErrorInvalidValue);
#define NAF_K1_WGMMA(KK, N)                                                                   \
  if (ksize == KK && n_block == N)                                                           \
    return launch_wgmma<KK, N>(x, scale, shift, wpk, bias, y, part, B, H, W, C, F, out_total, \
                               out_off, s);
  NAF_K1_WGMMA(1, 128)
  NAF_K1_WGMMA(3, 128)
  NAF_K1_WGMMA(1, 64)
  NAF_K1_WGMMA(3, 64)
#undef NAF_K1_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
