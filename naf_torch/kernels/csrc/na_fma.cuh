// The f32 CUDA-core pieces of the neighbourhood-attention kernels K2, K3 and
// K4 (na2d_fused_q.cu, na2d_fused.cu): a warp per query, lanes over window
// slots for the logits and over channels for the products, all in f32.
//
// The chunked route ("fma_chunked"): where no query tile's whole K/V box
// fits shared memory (wide heads and large windows: d 256, k 15 needs 263 KB
// for one query's box), a block walks its box in chunks of cr x cc LR cells
// (whole box rows where one fits, else part of a row), staging one chunk at
// a time. The chunked kernels make two passes over the chunks:
//   1. statistics: per query a running row max m and sum l of exp(logit -
//      m) over the window slots in each chunk (K4 also the running sum of
//      exp(logit - m) * dP, which gives delta = rowsum(P * dP) = dO . O);
//   2. P exactly, exp(logit - m) / l, chunk by chunk: K2/K3 accumulate out
//      in f32, K4 accumulates dq in f32 and writes each chunk's rows of its
//      box partials (the same buffer and reduce pass as the whole-box K4).
// The window of a query meets a chunk in a rectangle of slots: the tables
// idx_h / idx_w of a query are nondecreasing along the window, so its slots
// whose cell lies in a range of rows (columns) are a range of t (s).
// Accumulators live in device memory: out / dq rows are zeroed by their one
// owning warp at the start of pass 2 and added to per chunk by the same
// lanes, so the sums are deterministic and the kernels allocate nothing.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace nafma {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

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

// One chunk: LR cells [r0, r0 + rows) x [c0, c0 + cols).
struct Chunk {
  int r0, c0, rows, cols;
};

// The chunk's K rows (times scale) into Ks [cell][kstride] and V rows into
// Vs [cell][vstride], for head h of sample b; k (B, hk, wk, n, d), v (B, hk,
// wk, n, dv).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ k,
                                            const float* __restrict__ v, float* Ks, float* Vs,
                                            float scale, int hk, int wk, int n, int d, int dv,
                                            int kstride, int vstride, int b, int h,
                                            const Chunk& c) {
  const int ncell = c.rows * c.cols;
  for (int e = threadIdx.x; e < ncell * d; e += THREADS) {
    const int cell = e / d, ch = e % d;
    const size_t src =
        ((size_t)(b * hk + c.r0 + cell / c.cols) * wk + c.c0 + cell % c.cols) * (n * d) + h * d +
        ch;
    Ks[cell * kstride + ch] = k[src] * scale;
  }
  for (int e = threadIdx.x; e < ncell * dv; e += THREADS) {
    const int cell = e / dv, ch = e % dv;
    const size_t src =
        ((size_t)(b * hk + c.r0 + cell / c.cols) * wk + c.c0 + cell % c.cols) * (n * dv) +
        h * dv + ch;
    Vs[cell * vstride + ch] = v[src];
  }
}

// (first, count) of the window slots on one axis whose LR cell lies in
// [lo, lo + ext): tab holds the query's ks cells, nondecreasing.
__device__ __forceinline__ int2 slot_range(const int* __restrict__ tab, int ks, int lo, int ext) {
  int a = 0, b = 0;
  for (int t = 0; t < ks; ++t) {
    const int c = __ldg(tab + t);
    a += c < lo;
    b += c < lo + ext;
  }
  return make_int2(a, b - a);
}

// One warp: the logits of the query row qrow (shared, f32) against the
// chunk's cells in its window, into p[] (one per slot), the chunk cell of
// each slot into sl[]. th / tw: the query's rows of idx_h / idx_w. Returns
// the slot count (uniform across the warp) and the largest logit in *mx;
// p and sl are complete on return.
__device__ __forceinline__ int chunk_logits(const float* __restrict__ qrow,
                                            const float* __restrict__ Ks, int kstride, int d,
                                            const int* __restrict__ th,
                                            const int* __restrict__ tw, int ks, const Chunk& c,
                                            float* p, int* sl, float* mx) {
  const int2 rt = slot_range(th, ks, c.r0, c.rows);
  const int2 ct = slot_range(tw, ks, c.c0, c.cols);
  const int nslot = rt.y * ct.y;
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x & 31; i < nslot; i += 32) {
    const int t = rt.x + i / ct.y, s = ct.x + i % ct.y;
    const int cell = (__ldg(th + t) - c.r0) * c.cols + (__ldg(tw + s) - c.c0);
    const float l = dot4(qrow, Ks + cell * kstride, d / 4);
    p[i] = l;
    sl[i] = cell;
    m = fmaxf(m, l);
  }
  *mx = warp_max(m);
  __syncwarp();
  return nslot;
}

// Pass 1 of one query and chunk (nslot > 0): st = {m, l[, dacc]} updated
// with the chunk's logits p (largest cmx); with dp (K4), dacc, the running
// sum of exp(logit - m) * dP, too. Lane 0 stores; every lane holds the same.
__device__ __forceinline__ void online_stats(const float* p, const float* dp, int nslot,
                                             float cmx, float* st) {
  const float m = st[0];
  const float mn = fmaxf(m, cmx);
  float s = 0.f, sd = 0.f;
  for (int i = threadIdx.x & 31; i < nslot; i += 32) {
    const float e = expf(p[i] - mn);
    s += e;
    if (dp != nullptr) sd = fmaf(e, dp[i], sd);
  }
  s = warp_sum(s);
  const float f = expf(m - mn);  // 0 before the first chunk (m = -inf)
  const float l = st[1] * f + s;
  float dacc = 0.f;
  if (dp != nullptr) dacc = st[2] * f + warp_sum(sd);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    st[0] = mn;
    st[1] = l;
    if (dp != nullptr) st[2] = dacc;
  }
  __syncwarp();
}

// Pass 2: the logits p of one chunk -> P = exp(p - m) / l, in place.
__device__ __forceinline__ void chunk_probs(float* p, int nslot, const float* st) {
  const float m = st[0], inv = 1.f / st[1];
  for (int i = threadIdx.x & 31; i < nslot; i += 32) p[i] = expf(p[i] - m) * inv;
  __syncwarp();
}

// o[c] += sum_i w[i] * rows[sl[i] * stride + c] for c < width, lanes over
// channels (o in device memory, owned by this warp).
__device__ __forceinline__ void add_weighted_rows(const float* w, const int* sl, int nslot,
                                                  const float* __restrict__ rows, int stride,
                                                  int width, float* o) {
  for (int c = threadIdx.x & 31; c < width; c += 32) {
    float acc = 0.f;
    for (int i = 0; i < nslot; ++i) acc = fmaf(w[i], rows[sl[i] * stride + c], acc);
    o[c] += acc;
  }
}

// The chunks of a box of urh x urw cells from (r0, c0), in chunks of at most
// cr x cc cells, in order: chunk index i -> its cells.
__device__ __forceinline__ Chunk chunk_at(int i, int r0, int c0, int urh, int urw, int cr,
                                          int cc) {
  const int per_row = (urw + cc - 1) / cc;
  const int ra = (i / per_row) * cr, ca = (i % per_row) * cc;
  return Chunk{r0 + ra, c0 + ca, min(cr, urh - ra), min(cc, urw - ca)};
}

__host__ __device__ inline int chunk_count(int urh, int urw, int cr, int cc) {
  return ((urh + cr - 1) / cr) * ((urw + cc - 1) / cc);
}

}  // namespace nafma
