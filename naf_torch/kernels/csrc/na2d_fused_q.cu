// Fused NAF upsampling attention on Hopper: per output pixel (b, y, x) and
// attention head h,
//   1. pool:  xp = adaptive average of enc over input rows
//             [floor(y*hi/Hq), ceil((y+1)*hi/Hq)) and the same for columns
//             (the identity when hi == Hq; one rule for pool-up and -down);
//   2. RoPE:  q[c] = xp[c]*cos_r[y,c]*cos_c[x,c] + rot[c]*sin_r[y,c]*sin_c[x,c],
//             rot[c] = -xp[c+dh/2] in the first half of each RoPE head of
//             width dh, xp[c-dh/2] in the second;
//   3. logits against the keys of the k x k LR cells idx_h[y,t], idx_w[x,s]
//             (the softmax scale is folded into the keys by the caller);
//   4. softmax in f32 (max subtracted), then sum p * V, stored in the io dtype.
//
// Replaces the TPU kernel naf_tpu/kernels/na2d_fused_q.py::_fused_q_impl
// (body `_kernel`). Queries never reach device memory: the traffic is one
// read of enc and one write of the output, plus the small LR K/V grid.
//
// What bounds it on the card: at 448^2 with 28^2 x 384 features in bf16 the
// kernel must read 103 MB of enc and write 154 MB (77 us at 3.35 TB/s); its
// 10 GFLOP are far below the tensor-core bound, so it is memory bound by
// nature. This first kernel computes on the CUDA cores with one warp per
// query, which makes it bound by shared-memory loads instead; batching a
// tile's queries into mma tiles is the next step.
//
// Design:
//  - a block per (b, tile of tqh x tqw queries, head); 8 warps, a warp per
//    query in turn;
//  - the block stages its head's K and V for the union of LR cells that the
//    tile's windows touch (a urh x urw box, chosen by the caller from the
//    window tables) in shared memory as f32;
//  - the window comes from two int32 tables, idx_h (Hq, k) and idx_w (Wq, k),
//    built on the host with natten's rule, so every ratio the plain oracle
//    takes (integer, ragged, clamped) is covered without mask arithmetic.
//
// Banded launches (the JAX kernel's row_cell0 / band_cells / out_acc /
// enc_banded) compute only the query rows [y0, y0 + band_h) of the Hq-row
// grid, with the global window rule: idx_h then holds those rows' windows,
// the RoPE row table and the pool rule stay global, and
//  - enc may hold only the input rows from enc_row0 on of an hi_full-row
//    encoder grid: query row y pools input rows [floor(y*hi_full/Hq),
//    ceil((y+1)*hi_full/Hq)) less enc_row0;
//  - the output is a buffer of out_rows rows whose row 0 is query row
//    out_row0: the whole (B, Hq, Wq, Cv) output, written in place row by
//    row (its band rows are not contiguous across the batch, so the kernel
//    takes the buffer's batch stride, never a copied slab), or a band slab.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_q_kernel(const T* __restrict__ enc, const T* __restrict__ keys,
               const T* __restrict__ values, const float* __restrict__ rows_tab,
               const float* __restrict__ cols_tab, const int* __restrict__ idx_h,
               const int* __restrict__ idx_w, const int* __restrict__ row_lo,
               const int* __restrict__ col_lo, T* __restrict__ out, int hi, int wi,
               int hi_full, int enc_row0, int Hq, int Wq, int y0, int band_h, int out_rows,
               int out_row0, int hk, int wk, int C, int n, int Cv, int ks, int dh,
               int tqh, int tqw, int urh, int urw, int tiles_w) {
  const int d = C / n;
  const int dv = Cv / n;
  const int kk2 = ks * ks;
  const int dpad = d + 4;  // keeps 16-byte rows and spreads banks
  const int ncell = urh * urw;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                           // [ncell][dpad]
  float* Vs = Ks + ncell * dpad;              // [ncell][dv]
  float* qs = Vs + round4(ncell * dv);        // [WARPS][d]
  float* ps = qs + WARPS * d;                 // [WARPS][kk2]
  int* slots = reinterpret_cast<int*>(ps + WARPS * kk2);  // [WARPS][kk2]

  const int tr = blockIdx.x / tiles_w;
  const int tc = blockIdx.x % tiles_w;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = row_lo[tr];
  const int c0 = col_lo[tc];

  for (int e = tid; e < ncell * d; e += THREADS) {
    const int cell = e / d, c = e % d;
    const size_t g = ((size_t)(b * hk + r0 + cell / urw) * wk + c0 + cell % urw) * C + h * d + c;
    Ks[cell * dpad + c] = to_f(keys[g]);
  }
  for (int e = tid; e < ncell * dv; e += THREADS) {
    const int cell = e / dv, c = e % dv;
    const size_t g = ((size_t)(b * hk + r0 + cell / urw) * wk + c0 + cell % urw) * Cv + h * dv + c;
    Vs[e] = to_f(values[g]);
  }
  __syncthreads();

  float* q = qs + warp * d;
  float* p = ps + warp * kk2;
  int* sl = slots + warp * kk2;
  const int half = dh / 2;
  const T* encb = enc + (size_t)b * hi * wi * C;

  for (int qi = warp; qi < tqh * tqw; qi += WARPS) {
    const int yl = tr * tqh + qi / tqw;  // row of the launch's band
    const int x = tc * tqw + qi % tqw;
    if (yl >= band_h || x >= Wq) continue;  // uniform across the warp
    const int y = y0 + yl;                  // global query row

    // 1-2: pooled, RoPE'd query for this head
    const int iy0 = (int)(((long long)y * hi_full) / Hq) - enc_row0;
    const int iy1 = (int)(((long long)(y + 1) * hi_full + Hq - 1) / Hq) - enc_row0;
    const int ix0 = (int)(((long long)x * wi) / Wq);
    const int ix1 = (int)(((long long)(x + 1) * wi + Wq - 1) / Wq);
    const float inv = 1.f / (float)((iy1 - iy0) * (ix1 - ix0));
    const float* rt = rows_tab + (size_t)y * 2 * C;
    const float* ct = cols_tab + (size_t)x * 2 * C;
    for (int c = lane; c < d; c += 32) {
      const int gc = h * d + c;
      const bool first = (gc % dh) < half;
      const int pc = first ? gc + half : gc - half;
      float xv = 0.f, xr = 0.f;
      for (int iy = iy0; iy < iy1; ++iy)
        for (int ix = ix0; ix < ix1; ++ix) {
          const T* px = encb + ((size_t)iy * wi + ix) * C;
          xv += to_f(px[gc]);
          xr += to_f(px[pc]);
        }
      xv *= inv;
      xr *= first ? -inv : inv;
      q[c] = xv * (rt[gc] * ct[gc]) + xr * (rt[C + gc] * ct[C + gc]);
    }
    __syncwarp();

    // 3: logits over the k x k window
    float m = -CUDART_INF_F;
    for (int j = lane; j < kk2; j += 32) {
      const int cell = (idx_h[yl * ks + j / ks] - r0) * urw + (idx_w[x * ks + j % ks] - c0);
      const float4* kr = reinterpret_cast<const float4*>(Ks + cell * dpad);
      const float4* qr = reinterpret_cast<const float4*>(q);
      float dot = 0.f;
      for (int c = 0; c < d / 4; ++c) {
        const float4 kv = kr[c], qv = qr[c];
        dot = fmaf(kv.x, qv.x, dot);
        dot = fmaf(kv.y, qv.y, dot);
        dot = fmaf(kv.z, qv.z, dot);
        dot = fmaf(kv.w, qv.w, dot);
      }
      p[j] = dot;
      sl[j] = cell;
      m = fmaxf(m, dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    // 4: softmax, then P.V
    float sum = 0.f;
    for (int j = lane; j < kk2; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    const float inv_sum = 1.f / sum;
    T* o = out + (((size_t)b * out_rows + y - out_row0) * Wq + x) * Cv + h * dv;
    for (int c = lane; c < dv; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kk2; ++j) acc = fmaf(p[j], Vs[sl[j] * dv + c], acc);
      o[c] = from_f<T>(acc * inv_sum);
    }
    __syncwarp();
  }
}

size_t smem_bytes(int d, int dv, int ks, int urh, int urw) {
  const int ncell = urh * urw;
  return (size_t)(ncell * (d + 4) + ((ncell * dv + 3) & ~3) + WARPS * d + 2 * WARPS * ks * ks) *
         sizeof(float);
}

template <typename T>
cudaError_t launch(const void* enc, const void* keys, const void* values, const void* rows_tab,
                   const void* cols_tab, const void* idx_h, const void* idx_w,
                   const void* row_lo, const void* col_lo, void* out, int B, int hi, int wi,
                   int hi_full, int enc_row0, int Hq, int Wq, int y0, int band_h, int out_rows,
                   int out_row0, int hk, int wk, int C, int n, int Cv, int ks, int dh, int tqh,
                   int tqw, int urh, int urw, cudaStream_t stream) {
  const int tiles_w = (Wq + tqw - 1) / tqw;
  const int tiles = ((band_h + tqh - 1) / tqh) * tiles_w;
  const size_t smem = smem_bytes(C / n, Cv / n, ks, urh, urw);
  cudaError_t err = cudaFuncSetAttribute(fused_q_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, n, B);
  fused_q_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(enc), static_cast<const T*>(keys), static_cast<const T*>(values),
      static_cast<const float*>(rows_tab), static_cast<const float*>(cols_tab),
      static_cast<const int*>(idx_h), static_cast<const int*>(idx_w),
      static_cast<const int*>(row_lo), static_cast<const int*>(col_lo), static_cast<T*>(out), hi,
      wi, hi_full, enc_row0, Hq, Wq, y0, band_h, out_rows, out_row0, hk, wk, C, n, Cv, ks, dh,
      tqh, tqw, urh, urw, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper sizes tiles with it.
long long naf_fused_q_smem(int d, int dv, int ks, int urh, int urw) {
  return (long long)smem_bytes(d, dv, ks, urh, urw);
}

// Shape rules the launch relies on (checked by the wrapper): C % n == 0,
// (C/n) % 4 == 0, Cv % n == 0, dh even and dividing C, every window cell
// inside its tile's [row_lo, row_lo+urh) x [col_lo, col_lo+urw) box, and,
// for a band, every pooled input row of its query rows inside enc's
// [enc_row0, enc_row0 + hi) and every query row inside the output buffer.
// The full-grid call is hi_full = hi, enc_row0 = y0 = out_row0 = 0,
// band_h = out_rows = Hq.
int naf_fused_q(const void* enc, const void* keys, const void* values, const void* rows_tab,
                const void* cols_tab, const void* idx_h, const void* idx_w, const void* row_lo,
                const void* col_lo, void* out, int B, int hi, int wi, int hi_full, int enc_row0,
                int Hq, int Wq, int y0, int band_h, int out_rows, int out_row0, int hk, int wk,
                int C, int n, int Cv, int ks, int dh, int tqh, int tqw, int urh, int urw,
                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(enc, keys, values, rows_tab, cols_tab, idx_h, idx_w, row_lo,
                                 col_lo, out, B, hi, wi, hi_full, enc_row0, Hq, Wq, y0, band_h,
                                 out_rows, out_row0, hk, wk, C, n, Cv, ks, dh, tqh, tqw, urh,
                                 urw, s);
  return launch<float>(enc, keys, values, rows_tab, cols_tab, idx_h, idx_w, row_lo, col_lo, out,
                       B, hi, wi, hi_full, enc_row0, Hq, Wq, y0, band_h, out_rows, out_row0, hk,
                       wk, C, n, Cv, ks, dh, tqh, tqw, urh, urw, s);
}

}  // extern "C"
