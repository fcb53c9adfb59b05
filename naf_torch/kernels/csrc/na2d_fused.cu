// Cross-scale neighbourhood attention on Hopper: the forward (K3) and its
// recompute-P backward (K4).
//
// Queries q (B, Hq, Wq, n, d) live on the output grid; keys k (B, hk, wk, n, d)
// and values v (B, hk, wk, n, dv) on the low-res grid. Query (y, x) of head h
// attends the k x k LR cells idx_h[y, t], idx_w[x, s] (host-built tables,
// natten's rule, every ratio the plain oracle takes). The softmax scale is
// folded into the keys by the caller, as the JAX wrapper does.
//
//   K3  out = softmax(q . k_win) . v_win                 (f32 logits and softmax)
//   K4  P recomputed per query, then
//       dP = dO . v_win^T;  delta = sum(P * dP);  dL = P * (dP - delta)
//       dq = dL . k_win (k pre-scaled);  dk_win += scale * dL^T q;  dv_win += P^T dO
//
// Replaces the TPU kernels naf_tpu/kernels/na2d_fused.py::_fused_fwd_impl
// (body `_kernel`) and ::_fused_bwd_impl (body `_bwd_kernel`, tile grads
// scatter-added by `_scatter_union_tiles`).
//
// What bounds them on the card: at 448^2 <- 28^2, n 4, d 64, dv 96 in bf16,
// K3 must read q and write out (257 MB, 77 us at 3.35 TB/s) and K4 read q, dO
// and write dq (360 MB, 107 us); their 21 / 50 GFLOP are far below the
// tensor-core rate, so both are memory bound by nature. These first kernels
// compute on the CUDA cores, a warp per query, and are bound by shared-memory
// traffic and instruction issue instead; mma tiles over a query tile are the
// next step.
//
// Design (both kernels):
//  - a block per (b, tile of tqh x tqw queries, head); 8 warps;
//  - the block stages its head's K and V for the box of LR cells that the
//    tile's windows touch (urh x urw cells from row_lo/col_lo, chosen by the
//    caller) in shared memory as f32, rows padded by 4 floats to spread banks;
//  - padded (ragged-edge) queries contribute nothing: their P, dL, q and dO
//    are zeroed before any contraction.
//
// K4's dk/dv are a scatter: every LR cell receives from the queries of many
// windows, and blocks run in no order. It takes the deterministic route (a):
//  1. per block, rounds of 8 queries (one per warp) compute P, dL and dq; then
//     each thread owns a set of channels of the box and adds the round's
//     contributions slot by slot, in a fixed order, into an f32 box
//     accumulator in shared memory (no atomics, no races);
//  2. the block writes its box to a partials buffer
//     (B, tiles, n, urh*urw, d+dv) f32, and a second kernel sums, for each LR
//     cell, the partials of the tiles whose boxes hold it, in tile order.
// The partials hold (box cells / LR cells a tile covers) times the LR grid's
// f32 size: 25x at ratio 2 with 4x4-query tiles (105 MB at the training
// shape), 81x at ratio 16 with 16x16-query tiles (163 MB at 448^2 <- 28^2).

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

__device__ __forceinline__ float dot4(const float* __restrict__ a, const float* __restrict__ b,
                                      int n4) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
  for (int c = 0; c < n4; ++c) {
    const float4 x = a4[c], y = b4[c];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Geometry {
  int Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw, tiles_w;
};

// Stage the head's K and V rows of the block's LR box as f32.
template <typename T>
__device__ void stage_box(const T* __restrict__ k, const T* __restrict__ v, float* Ks,
                          float* Vs, const Geometry& g, int b, int h, int r0, int c0) {
  const int ncell = g.urh * g.urw;
  const int dpad = g.d + 4, dvpad = g.dv + 4;
  for (int e = threadIdx.x; e < ncell * g.d; e += THREADS) {
    const int cell = e / g.d, c = e % g.d;
    const size_t src = ((size_t)(b * g.hk + r0 + cell / g.urw) * g.wk + c0 + cell % g.urw) *
                           (g.n * g.d) + h * g.d + c;
    Ks[cell * dpad + c] = to_f(k[src]);
  }
  for (int e = threadIdx.x; e < ncell * g.dv; e += THREADS) {
    const int cell = e / g.dv, c = e % g.dv;
    const size_t src = ((size_t)(b * g.hk + r0 + cell / g.urw) * g.wk + c0 + cell % g.urw) *
                           (g.n * g.dv) + h * g.dv + c;
    Vs[cell * dvpad + c] = to_f(v[src]);
  }
}

// One warp: logits of query row `qrow` (f32, in shared memory) over its
// window into p[] (softmax probabilities) and the box cell of every slot
// into sl[]. Returns nothing; p and sl are complete after the __syncwarp.
__device__ void window_softmax(const float* __restrict__ qrow, const float* __restrict__ Ks,
                               const int* __restrict__ idx_h, const int* __restrict__ idx_w,
                               const Geometry& g, int y, int x, int r0, int c0, float* p,
                               int* sl) {
  const int lane = threadIdx.x & 31;
  const int kk2 = g.ks * g.ks;
  const int dpad = g.d + 4;
  float m = -CUDART_INF_F;
  for (int j = lane; j < kk2; j += 32) {
    const int cell = (idx_h[y * g.ks + j / g.ks] - r0) * g.urw + (idx_w[x * g.ks + j % g.ks] - c0);
    const float l = dot4(qrow, Ks + cell * dpad, g.d / 4);
    p[j] = l;
    sl[j] = cell;
    m = fmaxf(m, l);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < kk2; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  const float inv = 1.f / warp_sum(sum);
  for (int j = lane; j < kk2; j += 32) p[j] *= inv;
  __syncwarp();
}

// ---------------------------------------------------------------- K3 forward
template <typename T>
__global__ void __launch_bounds__(THREADS)
na_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ idx_h, const int* __restrict__ idx_w,
              const int* __restrict__ row_lo, const int* __restrict__ col_lo,
              T* __restrict__ out, Geometry g) {
  const int kk2 = g.ks * g.ks;
  const int ncell = g.urh * g.urw;
  const int dvpad = g.dv + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                              // [ncell][d + 4]
  float* Vs = Ks + ncell * (g.d + 4);            // [ncell][dv + 4]
  float* qs = Vs + ncell * dvpad;                // [WARPS][d]
  float* ps = qs + WARPS * g.d;                  // [WARPS][kk2]
  int* slots = reinterpret_cast<int*>(ps + WARPS * kk2);  // [WARPS][kk2]

  const int tr = blockIdx.x / g.tiles_w, tc = blockIdx.x % g.tiles_w;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = row_lo[tr], c0 = col_lo[tc];
  stage_box(k, v, Ks, Vs, g, b, h, r0, c0);
  __syncthreads();

  float* qrow = qs + warp * g.d;
  float* p = ps + warp * kk2;
  int* sl = slots + warp * kk2;
  for (int qi = warp; qi < g.tqh * g.tqw; qi += WARPS) {
    const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
    if (y >= g.Hq || x >= g.Wq) continue;  // uniform across the warp
    const size_t pix = ((size_t)b * g.Hq + y) * g.Wq + x;
    const T* qg = q + pix * (g.n * g.d) + h * g.d;
    for (int c = lane; c < g.d; c += 32) qrow[c] = to_f(qg[c]);
    __syncwarp();
    window_softmax(qrow, Ks, idx_h, idx_w, g, y, x, r0, c0, p, sl);
    T* o = out + pix * (g.n * g.dv) + h * g.dv;
    for (int c = lane; c < g.dv; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kk2; ++j) acc = fmaf(p[j], Vs[sl[j] * dvpad + c], acc);
      o[c] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

// ------------------------------------------------- K4 backward, tile pass
template <typename T>
__global__ void __launch_bounds__(THREADS)
na_bwd_tile_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const int* __restrict__ idx_h,
                   const int* __restrict__ idx_w, const int* __restrict__ row_lo,
                   const int* __restrict__ col_lo, T* __restrict__ dq,
                   float* __restrict__ partial, float scale, Geometry g) {
  const int kk2 = g.ks * g.ks;
  const int ncell = g.urh * g.urw;
  const int dpad = g.d + 4, dvpad = g.dv + 4;
  const int dc = g.d + g.dv;  // channels of one box cell in the accumulator
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                              // [ncell][d + 4]
  float* Vs = Ks + ncell * dpad;                 // [ncell][dv + 4]
  float* acc = Vs + ncell * dvpad;               // [ncell][d + dv]: dk | dv
  float* qs = acc + ncell * dc;                  // [WARPS][d]
  float* gs = qs + WARPS * g.d;                  // [WARPS][dv]
  float* ps = gs + WARPS * g.dv;                 // [WARPS][kk2]  P
  float* ls = ps + WARPS * kk2;                  // [WARPS][kk2]  dP, then dL
  int* slots = reinterpret_cast<int*>(ls + WARPS * kk2);  // [WARPS][kk2]

  const int tr = blockIdx.x / g.tiles_w, tc = blockIdx.x % g.tiles_w;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = row_lo[tr], c0 = col_lo[tc];
  stage_box(k, v, Ks, Vs, g, b, h, r0, c0);
  for (int e = threadIdx.x; e < ncell * dc; e += THREADS) acc[e] = 0.f;
  __syncthreads();

  float* qrow = qs + warp * g.d;
  float* grow = gs + warp * g.dv;
  float* p = ps + warp * kk2;
  float* dl = ls + warp * kk2;
  int* sl = slots + warp * kk2;
  const int nq = g.tqh * g.tqw;
  for (int q0 = 0; q0 < nq; q0 += WARPS) {
    // phase A: one query per warp -> P, dL (shared), dq (global)
    const int qi = q0 + warp;
    const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
    if (qi < nq && y < g.Hq && x < g.Wq) {  // uniform across the warp
      const size_t pix = ((size_t)b * g.Hq + y) * g.Wq + x;
      const T* qg = q + pix * (g.n * g.d) + h * g.d;
      const T* gg = dout + pix * (g.n * g.dv) + h * g.dv;
      for (int c = lane; c < g.d; c += 32) qrow[c] = to_f(qg[c]);
      for (int c = lane; c < g.dv; c += 32) grow[c] = to_f(gg[c]);
      __syncwarp();
      window_softmax(qrow, Ks, idx_h, idx_w, g, y, x, r0, c0, p, sl);
      float part = 0.f;
      for (int j = lane; j < kk2; j += 32) {
        const float dp = dot4(grow, Vs + sl[j] * dvpad, g.dv / 4);
        dl[j] = dp;
        part = fmaf(p[j], dp, part);
      }
      const float delta = warp_sum(part);
      for (int j = lane; j < kk2; j += 32) dl[j] = p[j] * (dl[j] - delta);
      __syncwarp();
      T* dqg = dq + pix * (g.n * g.d) + h * g.d;
      for (int c = lane; c < g.d; c += 32) {
        float s = 0.f;
        for (int j = 0; j < kk2; ++j) s = fmaf(dl[j], Ks[sl[j] * dpad + c], s);
        dqg[c] = from_f<T>(s);
      }
    } else {
      // padded query: contributes nothing (zero operands, not a mask, so
      // that no garbage can reach the sums)
      for (int c = lane; c < g.d; c += 32) qrow[c] = 0.f;
      for (int c = lane; c < g.dv; c += 32) grow[c] = 0.f;
      for (int j = lane; j < kk2; j += 32) {
        p[j] = 0.f;
        dl[j] = 0.f;
        sl[j] = 0;
      }
    }
    __syncthreads();
    // phase B: each thread owns channels of the box; fixed order over the
    // round's queries and their slots, so the sums are deterministic
    for (int ch = threadIdx.x; ch < dc; ch += THREADS) {
      const bool is_k = ch < g.d;
      for (int w = 0; w < WARPS; ++w) {
        const float val = is_k ? scale * qs[w * g.d + ch] : gs[w * g.dv + ch - g.d];
        const float* coef = (is_k ? ls : ps) + w * kk2;
        const int* cells = slots + w * kk2;
        for (int j = 0; j < kk2; ++j) acc[cells[j] * dc + ch] += coef[j] * val;
      }
    }
    __syncthreads();
  }

  float* dst = partial + (((size_t)b * gridDim.x + blockIdx.x) * g.n + h) * ((size_t)ncell * dc);
  for (int e = threadIdx.x; e < ncell * dc; e += THREADS) dst[e] = acc[e];
}

// ------------------------------------------------- K4 backward, reduce pass
// One thread per (b, LR cell, head, channel of dk|dv): the sum over the
// tiles whose box holds the cell, in tile order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
na_bwd_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ row_lo,
                     const int* __restrict__ col_lo, T* __restrict__ dk, T* __restrict__ dv,
                     int B, int tiles_h, Geometry g) {
  const int dc = g.d + g.dv;
  const int ncell = g.urh * g.urw;
  const size_t total = (size_t)B * g.hk * g.wk * g.n * dc;
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % dc);
  size_t rest = e / dc;
  const int h = (int)(rest % g.n);
  rest /= g.n;
  const int c = (int)(rest % g.wk);
  rest /= g.wk;
  const int r = (int)(rest % g.hk);
  const int b = (int)(rest / g.hk);
  const int tiles = tiles_h * g.tiles_w;
  float s = 0.f;
  for (int tr = 0; tr < tiles_h; ++tr) {
    const int rr = r - row_lo[tr];
    if (rr < 0 || rr >= g.urh) continue;
    for (int tc = 0; tc < g.tiles_w; ++tc) {
      const int cc = c - col_lo[tc];
      if (cc < 0 || cc >= g.urw) continue;
      const size_t blk = ((size_t)b * tiles + tr * g.tiles_w + tc) * g.n + h;
      s += partial[(blk * ncell + rr * g.urw + cc) * dc + ch];
    }
  }
  const size_t cell = ((size_t)b * g.hk + r) * g.wk + c;
  if (ch < g.d)
    dk[(cell * g.n + h) * g.d + ch] = from_f<T>(s);
  else
    dv[(cell * g.n + h) * g.dv + ch - g.d] = from_f<T>(s);
}

size_t fwd_smem(int d, int dv, int ks, int urh, int urw) {
  const size_t ncell = (size_t)urh * urw;
  return (ncell * (d + 4) + ncell * (dv + 4) + WARPS * d + 2 * WARPS * ks * ks) * sizeof(float);
}

size_t bwd_smem(int d, int dv, int ks, int urh, int urw) {
  const size_t ncell = (size_t)urh * urw;
  return (ncell * (d + 4) + ncell * (dv + 4) + ncell * (d + dv) + WARPS * (d + dv) +
          3 * WARPS * ks * ks) * sizeof(float);
}

Geometry make_geometry(int Hq, int Wq, int hk, int wk, int n, int d, int dv, int ks, int tqh,
                       int tqw, int urh, int urw) {
  return Geometry{Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw, (Wq + tqw - 1) / tqw};
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* idx_h,
                       const void* idx_w, const void* row_lo, const void* col_lo, void* out,
                       int B, const Geometry& g, cudaStream_t stream) {
  const int tiles = ((g.Hq + g.tqh - 1) / g.tqh) * g.tiles_w;
  const size_t smem = fwd_smem(g.d, g.dv, g.ks, g.urh, g.urw);
  cudaError_t err = cudaFuncSetAttribute(na_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  na_fwd_kernel<T><<<dim3(tiles, g.n, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(idx_h), static_cast<const int*>(idx_w),
      static_cast<const int*>(row_lo), static_cast<const int*>(col_lo), static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* idx_h, const void* idx_w, const void* row_lo,
                       const void* col_lo, void* dq, void* dk, void* dv, void* partial,
                       float scale, int B, const Geometry& g, cudaStream_t stream) {
  const int tiles_h = (g.Hq + g.tqh - 1) / g.tqh;
  const size_t smem = bwd_smem(g.d, g.dv, g.ks, g.urh, g.urw);
  cudaError_t err = cudaFuncSetAttribute(na_bwd_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  na_bwd_tile_kernel<T><<<dim3(tiles_h * g.tiles_w, g.n, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const int*>(idx_h),
      static_cast<const int*>(idx_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<T*>(dq), static_cast<float*>(partial), scale,
      g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * g.hk * g.wk * g.n * (g.d + g.dv);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  na_bwd_reduce_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<T*>(dk), static_cast<T*>(dv), B, tiles_h, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of K3 / K4 needs; the wrapper sizes tiles
// with it.
long long naf_na_fwd_smem(int d, int dv, int ks, int urh, int urw) {
  return (long long)fwd_smem(d, dv, ks, urh, urw);
}

long long naf_na_bwd_smem(int d, int dv, int ks, int urh, int urw) {
  return (long long)bwd_smem(d, dv, ks, urh, urw);
}

// Shape rules the launches rely on (checked by the wrapper): d % 4 == 0,
// dv % 4 == 0, every window cell inside its tile's
// [row_lo, row_lo + urh) x [col_lo, col_lo + urw) box; k pre-scaled.
int naf_na_fwd(const void* q, const void* k, const void* v, const void* idx_h, const void* idx_w,
               const void* row_lo, const void* col_lo, void* out, int B, int Hq, int Wq, int hk,
               int wk, int n, int d, int dv, int ks, int tqh, int tqw, int urh, int urw,
               int is_bf16, void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(q, k, v, idx_h, idx_w, row_lo, col_lo, out, B, g, s);
  return launch_fwd<float>(q, k, v, idx_h, idx_w, row_lo, col_lo, out, B, g, s);
}

// partial: (B, tiles, n, urh*urw, d+dv) f32 scratch, written before read.
int naf_na_bwd(const void* q, const void* k, const void* v, const void* dout, const void* idx_h,
               const void* idx_w, const void* row_lo, const void* col_lo, void* dq, void* dk,
               void* dv_out, void* partial, float scale, int B, int Hq, int Wq, int hk, int wk,
               int n, int d, int dv, int ks, int tqh, int tqw, int urh, int urw, int is_bf16,
               void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, idx_h, idx_w, row_lo, col_lo, dq, dk,
                                     dv_out, partial, scale, B, g, s);
  return launch_bwd<float>(q, k, v, dout, idx_h, idx_w, row_lo, col_lo, dq, dk, dv_out,
                           partial, scale, B, g, s);
}

}  // extern "C"
