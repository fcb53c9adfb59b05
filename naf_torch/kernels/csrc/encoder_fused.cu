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
//
// Below them, the encoder's stem (3 -> F channels, k in {1, 3}), one launch
// per stack: the conv, its bias and the io-dtype roundings, with the first
// GroupNorm's per-tile sums on the same tiles. The JAX package computes it
// as plain XLA (_stem_conv_matmul, _channel_sums); it replaces no TPU kernel.

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

// ---------------------------------------------------------------------------
// The encoder's stem, one launch per stack:
//     y = round_io(round_io(conv_k(x)) + round_io(bias)),   x (B, H, W, 3), k in {1, 3},
// plus per-tile f32 [sum y, sum y^2] of the rounded y on the 8 x 16 tiles
// above, so that the first GroupNorm reads the same sums K1's layers give
// the next one. The rounding points are the plain version's (_stem_conv):
// the f32 conv rounds to the io dtype before the bias add, then the sum
// rounds again; in f32 neither rounds.
//
// What bounds it: 3 input channels make the conv a streaming pass below the
// tensor cores' line. At 2048^2 with F = 128 a 3x3 stem writes 1.07 GB in
// bf16 and does 29 GFLOP in f32 (0.43 ms at 67 TFLOP/s), a 1x1 stem 3.2
// GFLOP (0.32 ms at 3.35 TB/s).
//
// A block of 256 threads owns a slice of SF = 64 output channels and loops
// over (image, tile) work items: the slice's weights (F, 3, k, k) and bias,
// in the io dtype, are staged once in shared memory as f32, each
// tile's reflected (8 + 2p) x (16 + 2p) x 3 image halo per item, loaded into
// registers while the item before is computed. Thread (g, col, half)
// computes the 8 channels [8g, 8g + 8) of the slice in the tile's column
// col, rows [4 half, 4 half + 4): exact f32 FMAs, each halo value read once
// per (channel, dx) and each weight float4 once per tap, then one 16-byte
// store a pixel (two in f32). A warp holds two groups and one half of all
// 16 columns: its weight reads are two broadcast addresses, its halo reads
// 16 consecutive words, and each pixel's store covers the two groups' 32
// contiguous bytes. Each thread's sums go to shared memory and are added
// over the tile's 16 columns and two halves in a fixed order: no atomics.

namespace stem {

constexpr int C = 3;      // image channels
constexpr int SF = 64;    // output channels a block
constexpr int GROUPS = SF / 8;
constexpr int ROWS = 4;   // tile rows a thread
constexpr int HALVES = TH / ROWS;
constexpr int THREADS = TW * HALVES * GROUPS;  // 256
constexpr int HALO_MAX = C * (TH + 2) * (TW + 2);
constexpr int PREFETCH = (HALO_MAX + THREADS - 1) / THREADS;  // halo values a thread

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// y's pair (a, b) + (ba, bb) with the plain version's roundings: the conv's
// f32 sums round to the io dtype, then their sums with the bias round again.
// bits holds the pair as stored (bf16: one cvt for two).
__device__ __forceinline__ float2 round_bias(float a, float b, float ba, float bb, unsigned& bits,
                                             __nv_bfloat16*) {
  const float2 r = __bfloat1622float2(__float22bfloat162_rn(make_float2(a, b)));
  const __nv_bfloat162 o = __float22bfloat162_rn(make_float2(r.x + ba, r.y + bb));
  bits = *reinterpret_cast<const unsigned*>(&o);
  return __bfloat1622float2(o);
}
__device__ __forceinline__ float2 round_bias(float a, float b, float ba, float bb, unsigned&,
                                             float*) {
  return make_float2(a + ba, b + bb);
}

__device__ __forceinline__ void store8(float* dst, const float* v, const unsigned*) {
  ::store8(dst, v);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float*, const unsigned* bits) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(bits[0], bits[1], bits[2], bits[3]);
}

// a thread's sums: rows of 2 * SF floats, 4 more so that a warp's 16
// columns' float4 stores spread over the banks
constexpr int RS = 2 * SF + 4;

// Shared memory in floats: halo [C][HH][HW], weights [C * k * k][2][GROUPS][4]
// (a warp's two groups' float4 of a tap are adjacent), bias [SF], sums
// [HALVES][TW][RS].
__host__ __device__ constexpr int smem_floats(int kk) {
  return C * (TH + kk - 1) * (TW + kk - 1) + C * kk * kk * SF + SF + HALVES * TW * RS;
}

// The image's halo values of thread threadIdx.x for work item `item`, in the
// image's own order [hy][hx][c]; (b, tile) of the item.
template <typename T, int KK>
__device__ __forceinline__ void fetch_halo(float (&pf)[PREFETCH], const T* __restrict__ x,
                                           int item, int tiles, int tiles_w, int H, int W,
                                           int& b, int& tile) {
  constexpr int P = KK / 2;
  constexpr int HW = TW + 2 * P;
  constexpr int N = C * (TH + 2 * P) * HW;
  b = item / tiles;
  tile = item - b * tiles;
  const int ty = tile / tiles_w;
  const int oy = ty * TH;
  const int ox = (tile - ty * tiles_w) * TW;
  const T* xb = x + (size_t)b * H * W * C;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < N) {
      const int c = e % C;
      const int pix = e / C;
      const int gy = reflect(oy + pix / HW - P, H);
      const int gx = reflect(ox + pix % HW - P, W);
      pf[i] = to_f(xb[((size_t)gy * W + gx) * C + c]);
    }
  }
}

template <typename T, int KK>
__global__ void __launch_bounds__(THREADS, 3)
stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                 T* __restrict__ y, float* __restrict__ part, int B, int H, int W, int F,
                 int tiles_w, int tiles) {
  constexpr int P = KK / 2;
  constexpr int HH = TH + 2 * P;
  constexpr int HW = TW + 2 * P;
  constexpr int R = C * KK * KK;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = xs + C * HH * HW;
  float* bs = ws + R * SF;
  float* red = bs + SF;

  const int f0 = blockIdx.y * SF;
  const int nf = min(SF, F - f0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int col = (tid % 32) / 2;
  const int half = warp % HALVES;
  const int g = tid % 2 + 2 * (warp / HALVES);
  const int row0 = half * ROWS;
  const bool live = 8 * g < nf;

  for (int e = tid; e < R * SF; e += THREADS) {
    const int ff = e % SF;
    const int r = e / SF;  // c * k * k + tap: w's own inner order
    const float v = ff < nf ? to_f(w[(size_t)(f0 + ff) * R + r]) : 0.f;
    ws[(r * 2 + (ff % 8) / 4) * (SF / 2) + (ff / 8) * 4 + ff % 4] = v;
  }
  if (tid < SF) bs[tid] = tid < nf ? to_f(bias[f0 + tid]) : 0.f;  // already in the io dtype

  const int items = B * tiles;
  float pf[PREFETCH];
  int nb = 0, ntile = 0;  // (image, tile) of the item whose halo pf holds
  if ((int)blockIdx.x < items)
    fetch_halo<T, KK>(pf, x, blockIdx.x, tiles, tiles_w, H, W, nb, ntile);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = nb;
    const int tile = ntile;
    const int ty = tile / tiles_w;
    const int oy = ty * TH;
    const int ox = (tile - ty * tiles_w) * TW;
#pragma unroll
    for (int i = 0; i < PREFETCH; ++i) {
      const int e = tid + i * THREADS;
      if (e < C * HH * HW) xs[((e % C) * HH + (e / C) / HW) * HW + (e / C) % HW] = pf[i];
    }
    __syncthreads();
    if (item + (int)gridDim.x < items)
      fetch_halo<T, KK>(pf, x, item + gridDim.x, tiles, tiles_w, H, W, nb, ntile);

    float acc[ROWS][8];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int dx = 0; dx < KK; ++dx) {
        float zc[ROWS + 2 * P];
#pragma unroll
        for (int r = 0; r < ROWS + 2 * P; ++r) zc[r] = xs[(c * HH + row0 + r) * HW + col + dx];
#pragma unroll
        for (int dy = 0; dy < KK; ++dy) {
          const float* wr = ws + ((c * KK + dy) * KK + dx) * SF + g * 4;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + SF / 2);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(zc[i + dy], wv[j], acc[i][j]);
        }
      }
    }

    float s[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
    const int gx = ox + col;
    if (live && gx < W) {
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[8 * g + j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int gy = oy + row0 + i;
        if (gy < H) {
          float v[8];
          unsigned bits[4];
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            const float2 r = round_bias(acc[i][j], acc[i][j + 1], bv[j], bv[j + 1], bits[j / 2], y);
            v[j] = r.x;
            v[j + 1] = r.y;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[j] += v[j];
            q[j] = fmaf(v[j], v[j], q[j]);
          }
          store8(y + (((size_t)b * H + gy) * W + gx) * F + f0 + 8 * g, v, bits);
        }
      }
    }
    float* rr = red + (half * TW + col) * RS + 8 * g;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      *reinterpret_cast<float4*>(rr + j) = make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
      *reinterpret_cast<float4*>(rr + SF + j) = make_float4(q[j], q[j + 1], q[j + 2], q[j + 3]);
    }
    __syncthreads();
    if (tid < 2 * SF) {  // one entry of the tile's [sum | sum of squares]
      float t = 0.f;
#pragma unroll
      for (int l = 0; l < HALVES * TW; ++l) t += red[l * RS + tid];
      const int which = tid / SF;
      const int ff = tid % SF;
      if (ff < nf) part[((size_t)b * tiles + tile) * 2 * F + (size_t)which * F + f0 + ff] = t;
    }
    // the next item writes the halo only: the sums are read before its
    // barrier lets any thread write them again
  }
}

template <typename T, int KK>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, void* part, int B,
                   int H, int W, int F, cudaStream_t stream) {
  const int smem = smem_floats(KK) * (int)sizeof(float);
  auto kernel = stem_conv_kernel<T, KK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const int slices = (F + SF - 1) / SF;
  const long long items = (long long)B * tiles;
  // resident blocks, shared among the slices
  const long long resident = ((long long)(per_sm > 0 ? per_sm : 1) * sms + slices - 1) / slices;
  dim3 grid((unsigned)(items < resident ? items : resident), slices);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), static_cast<float*>(part), B, H, W, F, tiles_w, tiles);
  return cudaGetLastError();
}

}  // namespace stem

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

// The stem: x (B, H, W, 3), weight (F, 3, k, k) contiguous and bias (F,),
// all in the io dtype (bf16 when io_bf16, else f32); y (B, H, W, F) in the io
// dtype, part (B, tiles, 2, F) f32. F % 8 == 0 and, for k = 3, H, W >= 2; the
// wrapper checks them.
int naf_stem_conv(const void* x, const void* w, const void* bias, void* y, void* part, int B,
                  int H, int W, int F, int ksize, int io_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 8 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define NAF_STEM(T, BF16, KK)            \
  if (ksize == KK && io_bf16 == BF16) \
    return stem::launch<T, KK>(x, w, bias, y, part, B, H, W, F, s);
  NAF_STEM(__nv_bfloat16, 1, 1)
  NAF_STEM(__nv_bfloat16, 1, 3)
  NAF_STEM(float, 0, 1)
  NAF_STEM(float, 0, 3)
#undef NAF_STEM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
