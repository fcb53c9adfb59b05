// Cross-scale neighbourhood attention on Hopper: the forward (K3) and its
// recompute-P backward (K4), each with two kernels chosen by the io dtype
// (na2d_fused.py::_route): bf16 on the tensor cores (na_tc.cuh), f32 on the
// CUDA cores (this file).
//
// Queries q (B, Hq, Wq, n, d) live on the output grid; keys k (B, hk, wk, n, d)
// and values v (B, hk, wk, n, dv) on the low-res grid. Query (y, x) of head h
// attends the k x k LR cells idx_h[y, t], idx_w[x, s] (host-built tables,
// natten's rule, every ratio the plain oracle takes). Both kernels fold the
// softmax scale into the keys as they stage them.
//
//   K3  out = softmax(q . k_win) . v_win                 (f32 logits and softmax)
//   K4  P recomputed per query, then
//       dP = dO . v_win^T;  delta = sum(P * dP);  dL = P * (dP - delta)
//       dq = dL . k_win (k scaled);  dk_win += scale * dL^T q;  dv_win += P^T dO
//
// Replaces the TPU kernels naf_tpu/kernels/na2d_fused.py::_fused_fwd_impl
// (body `_kernel`) and ::_fused_bwd_impl (body `_bwd_kernel`, tile grads
// scatter-added by `_scatter_union_tiles`).
//
// What bounds them on the card: at 448^2 <- 28^2, n 4, d 64, dv 96 in bf16,
// K3 must read q and write out (257 MB, 77 us at 3.35 TB/s) and K4 read q, dO
// and write dq (360 MB, 107 us); their 21 / 50 GFLOP take 21 / 51 us at the
// tensor cores' bf16 rate, so both are bound by bytes. The bf16 kernels
// (na_tc.cuh) therefore read each query row once, keep P and dS on chip, and
// run every product on wgmma, so that the arithmetic stays under the bytes;
// what they add to the bound is K4's box partials (below) and the K/V box
// each 64-query tile reads again from L2. The f32 kernels stay on the CUDA
// cores, a warp per query (TF32 would miss the f32 tolerance of 2e-4);
// where no tile's whole K/V box fits shared memory they walk it in chunks
// (na_fma.cuh: a statistics pass, then exact P chunk by chunk).
//
// Design of the f32 kernels:
//  - a block per (b, tile of tqh x tqw queries, head); 8 warps;
//  - the block stages its head's K (scaled) and V for the box of LR cells
//    that the tile's windows touch (urh x urw cells from row_lo/col_lo,
//    chosen by the caller) in shared memory, rows padded by 4 floats to
//    spread banks;
//  - padded (ragged-edge) queries contribute nothing: their P, dL, q and dO
//    are zeroed before any contraction.
//
// A band of query rows (the JAX kernel's row_cell0 / full_hq) runs K3 and K4
// unchanged: q, out, dO and dq hold only the band's rows, and the host passes
// the band's rows of the global window tables and their boxes; dk and dv
// cover the whole LR grid (zero where no window of the band reaches).
//
// K4's dk/dv are a scatter: every LR cell receives from the queries of many
// windows, and blocks run in no order. Both routes take the deterministic
// route: each block writes its tile's box of dk|dv to a partials buffer
// (B, tiles, n, urh*urw, d+dv) f32, and na_bwd_reduce_kernel sums, for each
// LR cell, the partials of the tiles whose boxes hold it, in tile order. The
// f32 kernel builds its box in shared memory, rounds of 8 queries (one per
// warp) at a time, each thread owning a set of channels; the bf16 kernel
// takes it from two wgmma products over its 64 queries.
// The partials hold (box cells / LR cells a tile covers) times the LR grid's
// f32 size: 25x at ratio 2 with 4x4-query tiles (the f32 kernel at the
// training shape), 81x at ratio 16 with 16x16-query tiles; the bf16 kernel's
// 64-query tiles make that 3.75x at the training shape (4 x 16 tiles, boxes
// of 10 x 12 cells: 31 MB) and 324x at 448^2 <- 28^2 (8 x 8 tiles: 650 MB),
// which the reduce pass reads with 16-byte loads, 8 in flight per thread.
// Where one launch's partials would exceed the wrapper's budget (15 GB at
// 2048^2 <- 28^2), the wrapper runs the bf16 K4 once per band of query rows,
// each reduce pass adding its sums to f32 dk, dv (add_f32), in band order.
// The bf16 K4 on boxes above 192 cells writes no partials: K3 leaves each
// query's log-sum-exp, and K4 runs as a query-major launch that writes dq and
// a key-major one that writes dk and dv, each block summing its own rows
// (na_tc.cuh, na_bwd_wgmma_chunked_kernel). At the denoiser's shape (one
// head, d 256, k 15, 448^2 <- 448^2) the partials it replaced were 13.2 GB a
// step of batch 8, written once and read once by 14 bands of reduce passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "na_fma.cuh"
#include "na_tc.cuh"

namespace {

using nafma::dot4;
using nafma::THREADS;
using nafma::warp_max;
using nafma::warp_sum;
using nafma::WARPS;

struct Geometry {
  int Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw, tiles_w;
};

// Stage the head's K (times the softmax scale) and V rows of the block's LR
// box.
__device__ void stage_box(const float* __restrict__ k, const float* __restrict__ v, float* Ks,
                          float* Vs, float scale, const Geometry& g, int b, int h, int r0,
                          int c0) {
  const int ncell = g.urh * g.urw;
  const int dpad = g.d + 4, dvpad = g.dv + 4;
  for (int e = threadIdx.x; e < ncell * g.d; e += THREADS) {
    const int cell = e / g.d, c = e % g.d;
    const size_t src = ((size_t)(b * g.hk + r0 + cell / g.urw) * g.wk + c0 + cell % g.urw) *
                           (g.n * g.d) + h * g.d + c;
    Ks[cell * dpad + c] = k[src] * scale;
  }
  for (int e = threadIdx.x; e < ncell * g.dv; e += THREADS) {
    const int cell = e / g.dv, c = e % g.dv;
    const size_t src = ((size_t)(b * g.hk + r0 + cell / g.urw) * g.wk + c0 + cell % g.urw) *
                           (g.n * g.dv) + h * g.dv + c;
    Vs[cell * dvpad + c] = v[src];
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

// ------------------------------------------------------- K3 forward, f32
__global__ void __launch_bounds__(THREADS)
na_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ idx_h,
              const int* __restrict__ idx_w, const int* __restrict__ row_lo,
              const int* __restrict__ col_lo, float* __restrict__ out, float scale, Geometry g) {
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
  stage_box(k, v, Ks, Vs, scale, g, b, h, r0, c0);
  __syncthreads();

  float* qrow = qs + warp * g.d;
  float* p = ps + warp * kk2;
  int* sl = slots + warp * kk2;
  for (int qi = warp; qi < g.tqh * g.tqw; qi += WARPS) {
    const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
    if (y >= g.Hq || x >= g.Wq) continue;  // uniform across the warp
    const size_t pix = ((size_t)b * g.Hq + y) * g.Wq + x;
    const float* qg = q + pix * (g.n * g.d) + h * g.d;
    for (int c = lane; c < g.d; c += 32) qrow[c] = qg[c];
    __syncwarp();
    window_softmax(qrow, Ks, idx_h, idx_w, g, y, x, r0, c0, p, sl);
    float* o = out + pix * (g.n * g.dv) + h * g.dv;
    for (int c = lane; c < g.dv; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kk2; ++j) acc = fmaf(p[j], Vs[sl[j] * dvpad + c], acc);
      o[c] = acc;
    }
    __syncwarp();
  }
}

// -------------------------------------------- K4 backward, tile pass, f32
__global__ void __launch_bounds__(THREADS)
na_bwd_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const int* __restrict__ idx_h, const int* __restrict__ idx_w,
                   const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                   float* __restrict__ dq, float* __restrict__ partial, float scale, Geometry g) {
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
  stage_box(k, v, Ks, Vs, scale, g, b, h, r0, c0);
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
      const float* qg = q + pix * (g.n * g.d) + h * g.d;
      const float* gg = dout + pix * (g.n * g.dv) + h * g.dv;
      for (int c = lane; c < g.d; c += 32) qrow[c] = qg[c];
      for (int c = lane; c < g.dv; c += 32) grow[c] = gg[c];
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
      float* dqg = dq + pix * (g.n * g.d) + h * g.d;
      for (int c = lane; c < g.d; c += 32) {
        float s = 0.f;
        for (int j = 0; j < kk2; ++j) s = fmaf(dl[j], Ks[sl[j] * dpad + c], s);
        dqg[c] = s;
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

// ------------------------------------------ K3 forward, f32, chunked box
// Boxes that do not fit shared memory whole (na_fma.cuh): the box in chunks
// of cr x cc cells, a statistics pass and an output pass over them.
// Shared memory: the chunk's K [cells][d + 4] and V [cells][dv + 4], per warp
// the query row and its slots' logits and cells, per query of the tile
// {m, l}.
// one block per SM (the planner sizes the chunk to shared memory): 102-128
// registers a thread, without the spills of ptxas's default of 64
__global__ void __launch_bounds__(THREADS, 1)
na_fwd_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ idx_h,
                      const int* __restrict__ idx_w, const int* __restrict__ row_lo,
                      const int* __restrict__ col_lo, float* __restrict__ out, float scale,
                      Geometry g, int cr, int cc) {
  const int kk2 = g.ks * g.ks;
  const int nc = cr * cc;
  const int nq = g.tqh * g.tqw;
  const int dpad = g.d + 4, dvpad = g.dv + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                                       // [nc][d + 4]
  float* Vs = Ks + nc * dpad;                             // [nc][dv + 4]
  float* qs = Vs + nc * dvpad;                            // [WARPS][d]
  float* ps = qs + WARPS * g.d;                           // [WARPS][kk2]
  int* slots = reinterpret_cast<int*>(ps + WARPS * kk2);  // [WARPS][kk2]
  float* stats = reinterpret_cast<float*>(slots + WARPS * kk2);  // [nq][2]

  const int tr = blockIdx.x / g.tiles_w, tc = blockIdx.x % g.tiles_w;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = row_lo[tr], c0 = col_lo[tc];
  for (int e = threadIdx.x; e < nq; e += THREADS) {
    stats[2 * e] = -CUDART_INF_F;
    stats[2 * e + 1] = 0.f;
  }
  float* qrow = qs + warp * g.d;
  float* p = ps + warp * kk2;
  int* sl = slots + warp * kk2;
  const int chunks = nafma::chunk_count(g.urh, g.urw, cr, cc);
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1)  // out rows start at zero, each added to by its own lanes
      for (int qi = warp; qi < nq; qi += WARPS) {
        const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
        if (y >= g.Hq || x >= g.Wq) continue;
        float* o = out + (((size_t)b * g.Hq + y) * g.Wq + x) * (g.n * g.dv) + h * g.dv;
        for (int c = lane; c < g.dv; c += 32) o[c] = 0.f;
      }
    for (int ci = 0; ci < chunks; ++ci) {
      const nafma::Chunk ch = nafma::chunk_at(ci, r0, c0, g.urh, g.urw, cr, cc);
      __syncthreads();  // every warp is done with the last chunk
      nafma::stage_chunk(k, v, Ks, Vs, scale, g.hk, g.wk, g.n, g.d, g.dv, dpad, dvpad, b, h, ch);
      __syncthreads();
      for (int qi = warp; qi < nq; qi += WARPS) {
        const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
        if (y >= g.Hq || x >= g.Wq) continue;  // uniform across the warp
        const size_t pix = ((size_t)b * g.Hq + y) * g.Wq + x;
        const float* qg = q + pix * (g.n * g.d) + h * g.d;
        for (int c = lane; c < g.d; c += 32) qrow[c] = qg[c];
        __syncwarp();
        float mx;
        const int ns = nafma::chunk_logits(qrow, Ks, dpad, g.d, idx_h + y * g.ks,
                                           idx_w + x * g.ks, g.ks, ch, p, sl, &mx);
        if (ns > 0) {
          float* st = stats + 2 * qi;
          if (pass == 0) {
            nafma::online_stats(p, nullptr, ns, mx, st);
          } else {
            nafma::chunk_probs(p, ns, st);
            nafma::add_weighted_rows(p, sl, ns, Vs, dvpad, g.dv,
                                     out + pix * (g.n * g.dv) + h * g.dv);
          }
        }
        __syncwarp();  // p, sl and qrow are free for the warp's next query
      }
    }
  }
}

// -------------------------------------- K4 backward, f32, chunked box
// Pass 1: {m, l, dacc} per query (dacc / l = delta = rowsum(P * dP)). Pass
// 2, per chunk: rounds of 8 queries as the whole-box kernel takes them (P,
// dP, dL and dq += dL . K_chunk per warp; then each thread owns channels of
// the chunk's dk | dv accumulator, summing the round's slots in a fixed
// order), and the chunk's cells of the box partials written at their box
// positions, so the reduce pass is the whole-box kernel's.
// one block per SM (the planner sizes the chunk to shared memory): 102-128
// registers a thread, without the spills of ptxas's default of 64
__global__ void __launch_bounds__(THREADS, 1)
na_bwd_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const int* __restrict__ idx_h, const int* __restrict__ idx_w,
                      const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                      float* __restrict__ dq, float* __restrict__ partial, float scale, Geometry g,
                      int cr, int cc) {
  const int kk2 = g.ks * g.ks;
  const int nc = cr * cc;
  const int nq = g.tqh * g.tqw;
  const int ncell = g.urh * g.urw;
  const int dpad = g.d + 4, dvpad = g.dv + 4;
  const int dc = g.d + g.dv;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                            // [nc][d + 4]
  float* Vs = Ks + nc * dpad;                  // [nc][dv + 4]
  float* acc = Vs + nc * dvpad;                // [nc][d + dv]: dk | dv of the chunk
  float* qs = acc + nc * dc;                   // [WARPS][d]
  float* gs = qs + WARPS * g.d;                // [WARPS][dv]
  float* ps = gs + WARPS * g.dv;               // [WARPS][kk2]  logits, then P
  float* ls = ps + WARPS * kk2;                // [WARPS][kk2]  dP, then dL
  int* slots = reinterpret_cast<int*>(ls + WARPS * kk2);  // [WARPS][kk2]
  int* nslots = slots + WARPS * kk2;                       // [WARPS]
  float* stats = reinterpret_cast<float*>(nslots + WARPS);  // [nq][3]

  const int tr = blockIdx.x / g.tiles_w, tc = blockIdx.x % g.tiles_w;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = row_lo[tr], c0 = col_lo[tc];
  for (int e = threadIdx.x; e < nq; e += THREADS) {
    stats[3 * e] = -CUDART_INF_F;
    stats[3 * e + 1] = 0.f;
    stats[3 * e + 2] = 0.f;
  }
  float* qrow = qs + warp * g.d;
  float* grow = gs + warp * g.dv;
  float* p = ps + warp * kk2;
  float* dl = ls + warp * kk2;
  int* sl = slots + warp * kk2;
  float* dst = partial + (((size_t)b * gridDim.x + blockIdx.x) * g.n + h) * ((size_t)ncell * dc);
  const int chunks = nafma::chunk_count(g.urh, g.urw, cr, cc);
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1)  // dq rows start at zero, each added to by its own lanes
      for (int qi = warp; qi < nq; qi += WARPS) {
        const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
        if (y >= g.Hq || x >= g.Wq) continue;
        float* dqg = dq + (((size_t)b * g.Hq + y) * g.Wq + x) * (g.n * g.d) + h * g.d;
        for (int c = lane; c < g.d; c += 32) dqg[c] = 0.f;
      }
    for (int ci = 0; ci < chunks; ++ci) {
      const nafma::Chunk ch = nafma::chunk_at(ci, r0, c0, g.urh, g.urw, cr, cc);
      const int cells = ch.rows * ch.cols;
      __syncthreads();  // every thread is done with the last chunk
      nafma::stage_chunk(k, v, Ks, Vs, scale, g.hk, g.wk, g.n, g.d, g.dv, dpad, dvpad, b, h, ch);
      if (pass == 1)
        for (int e = threadIdx.x; e < cells * dc; e += THREADS) acc[e] = 0.f;
      __syncthreads();
      for (int q0 = 0; q0 < nq; q0 += WARPS) {
        // phase A: one query per warp -> logits, dP (pass 1: statistics;
        // pass 2: P, dL and dq)
        const int qi = q0 + warp;
        const int y = tr * g.tqh + qi / g.tqw, x = tc * g.tqw + qi % g.tqw;
        int ns = 0;
        if (qi < nq && y < g.Hq && x < g.Wq) {  // uniform across the warp
          const size_t pix = ((size_t)b * g.Hq + y) * g.Wq + x;
          const float* qg = q + pix * (g.n * g.d) + h * g.d;
          const float* gg = dout + pix * (g.n * g.dv) + h * g.dv;
          for (int c = lane; c < g.d; c += 32) qrow[c] = qg[c];
          for (int c = lane; c < g.dv; c += 32) grow[c] = gg[c];
          __syncwarp();
          float mx;
          ns = nafma::chunk_logits(qrow, Ks, dpad, g.d, idx_h + y * g.ks, idx_w + x * g.ks,
                                   g.ks, ch, p, sl, &mx);
          for (int i = lane; i < ns; i += 32)
            dl[i] = nafma::dot4(grow, Vs + sl[i] * dvpad, g.dv / 4);
          __syncwarp();
          float* st = stats + 3 * qi;
          if (ns > 0 && pass == 0) {
            nafma::online_stats(p, dl, ns, mx, st);
          } else if (ns > 0) {
            nafma::chunk_probs(p, ns, st);
            const float delta = st[2] / st[1];
            for (int i = lane; i < ns; i += 32) dl[i] = p[i] * (dl[i] - delta);
            __syncwarp();
            nafma::add_weighted_rows(dl, sl, ns, Ks, dpad, g.d,
                                     dq + pix * (g.n * g.d) + h * g.d);
          }
        }
        if (pass == 0) {
          __syncwarp();  // the warp's rows are free for its next query
          continue;
        }
        if (lane == 0) nslots[warp] = ns;
        __syncthreads();
        // phase B: each thread owns channels of the chunk's dk | dv; fixed
        // order over the round's queries and their slots
        for (int chn = threadIdx.x; chn < dc; chn += THREADS) {
          const bool is_k = chn < g.d;
          for (int w = 0; w < WARPS; ++w) {
            const int n_w = nslots[w];
            const float val = is_k ? scale * qs[w * g.d + chn] : gs[w * g.dv + chn - g.d];
            const float* coef = (is_k ? ls : ps) + w * kk2;
            const int* wc = slots + w * kk2;
            for (int j = 0; j < n_w; ++j) acc[wc[j] * dc + chn] += coef[j] * val;
          }
        }
        __syncthreads();
      }
      if (pass == 1)  // the chunk's cells of the box partials, at their box positions
        for (int e = threadIdx.x; e < cells * dc; e += THREADS) {
          const int cell = e / dc, c = e % dc;
          const int box = (ch.r0 - r0 + cell / ch.cols) * g.urw + ch.c0 - c0 + cell % ch.cols;
          dst[(size_t)box * dc + c] = acc[e];
        }
    }
  }
}

// ------------------------------------------------- K4 backward, reduce pass
// [first, last) of the tiles on one axis whose boxes [lo, lo + ext) hold
// cell c: box origins never decrease along an axis, so they are a range.
__device__ __forceinline__ int2 box_range(const int* __restrict__ lo, int tiles, int ext, int c) {
  int first = 0;
  while (first < tiles && lo[first] + ext <= c) ++first;
  int last = first;
  while (last < tiles && lo[last] <= c) ++last;
  return make_int2(first, last);
}

// 4 channels of dk or dv; `add`: added to what dst holds (f32 only).
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v, bool add);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 v, bool add) {
  float4* d = reinterpret_cast<float4*>(dst);
  if (add) {
    const float4 o = *d;
    v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
  }
  *d = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 v, bool) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
}

// One thread per (b, LR cell, head, 4 channels of dk|dv): the sum over the
// tiles whose box holds the cell, in tile order, with 8 loads of 16 bytes
// in flight (d and dv are multiples of 4 on both routes); with `add`, added
// to the f32 dk, dv of the query bands before it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
na_bwd_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ row_lo,
                     const int* __restrict__ col_lo, T* __restrict__ dk, T* __restrict__ dv,
                     int B, int tiles_h, Geometry g, bool add) {
  constexpr int LOADS = 8;
  const int dc = g.d + g.dv;
  const int dc4 = dc / 4;
  const int ncell = g.urh * g.urw;
  const size_t total = (size_t)B * g.hk * g.wk * g.n * dc4;
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % dc4) * 4;
  size_t rest = e / dc4;
  const int h = (int)(rest % g.n);
  rest /= g.n;
  const int c = (int)(rest % g.wk);
  rest /= g.wk;
  const int r = (int)(rest % g.hk);
  const int b = (int)(rest / g.hk);
  const int tiles = tiles_h * g.tiles_w;
  const int2 trs = box_range(row_lo, tiles_h, g.urh, r);
  const int2 tcs = box_range(col_lo, g.tiles_w, g.urw, c);
  const int ntc = tcs.y - tcs.x;
  const int nt = (trs.y - trs.x) * ntc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < nt; i0 += LOADS) {
    float4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = min(i0 + u, nt - 1);
      const int tr = trs.x + i / ntc;
      const int tc = tcs.x + i % ntc;
      const size_t blk = ((size_t)b * tiles + tr * g.tiles_w + tc) * g.n + h;
      const size_t cell = (size_t)(r - row_lo[tr]) * g.urw + c - col_lo[tc];
      v[u] = *reinterpret_cast<const float4*>(partial + (blk * ncell + cell) * dc + ch);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (i0 + u < nt) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
  }
  const size_t cell = ((size_t)b * g.hk + r) * g.wk + c;
  if (ch < g.d)
    store4<T>(dk + (cell * g.n + h) * g.d + ch, s, add);
  else
    store4<T>(dv + (cell * g.n + h) * g.dv + ch - g.d, s, add);
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

// The chunked kernels at nc cells a chunk and nq queries a tile.
size_t fwd_chunk_smem(int d, int dv, int ks, int nq, int nc) {
  return ((size_t)nc * (d + 4) + (size_t)nc * (dv + 4) + WARPS * d + 2 * WARPS * ks * ks +
          2 * nq) * sizeof(float);
}

size_t bwd_chunk_smem(int d, int dv, int ks, int nq, int nc) {
  return ((size_t)nc * (d + 4) + (size_t)nc * (dv + 4) + (size_t)nc * (d + dv) +
          WARPS * (d + dv) + 3 * WARPS * ks * ks + WARPS + 3 * nq) * sizeof(float);
}

Geometry make_geometry(int Hq, int Wq, int hk, int wk, int n, int d, int dv, int ks, int tqh,
                       int tqw, int urh, int urw) {
  return Geometry{Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw, (Wq + tqw - 1) / tqw};
}

natc::Geom tc_geometry(const Geometry& g) {
  // q and out hold the grid's rows: row0 = out_row0 = 0, out_rows = Hq
  return natc::Geom{g.Hq, g.Wq, g.hk, g.wk, g.n, g.d, g.dv, g.tqh, g.tqw, g.urh, g.urw,
                    g.tiles_w, 0, g.Hq, 0};
}

int tiles_of(const Geometry& g) { return ((g.Hq + g.tqh - 1) / g.tqh) * g.tiles_w; }

// Sums each LR cell's box partials in tile order into dk, dv (with `add`,
// f32, onto what they hold).
template <typename T>
cudaError_t launch_reduce(const void* partial, const void* row_lo, const void* col_lo, void* dk,
                          void* dv, int B, const Geometry& g, cudaStream_t stream,
                          bool add = false) {
  const size_t total = (size_t)B * g.hk * g.wk * g.n * ((g.d + g.dv) / 4);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  na_bwd_reduce_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<T*>(dk), static_cast<T*>(dv), B,
      (g.Hq + g.tqh - 1) / g.tqh, g, add);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* idx_h,
                       const void* idx_w, const void* row_lo, const void* col_lo, void* out,
                       float scale, int B, const Geometry& g, cudaStream_t stream) {
  const size_t smem = fwd_smem(g.d, g.dv, g.ks, g.urh, g.urw);
  cudaError_t err = cudaFuncSetAttribute(na_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  na_fwd_kernel<<<dim3(tiles_of(g), g.n, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(idx_h), static_cast<const int*>(idx_w),
      static_cast<const int*>(row_lo), static_cast<const int*>(col_lo),
      static_cast<float*>(out), scale, g);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* idx_h, const void* idx_w, const void* row_lo,
                       const void* col_lo, void* dq, void* dk, void* dv, void* partial,
                       float scale, int B, const Geometry& g, bool add, cudaStream_t stream) {
  const size_t smem = bwd_smem(g.d, g.dv, g.ks, g.urh, g.urw);
  cudaError_t err = cudaFuncSetAttribute(na_bwd_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  na_bwd_tile_kernel<<<dim3(tiles_of(g), g.n, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(idx_h),
      static_cast<const int*>(idx_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<float*>(dq), static_cast<float*>(partial),
      scale, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<float>(partial, row_lo, col_lo, dk, dv, B, g, stream);
}

cudaError_t launch_fwd_chunked(const void* q, const void* k, const void* v, const void* idx_h,
                               const void* idx_w, const void* row_lo, const void* col_lo,
                               void* out, float scale, int B, const Geometry& g, int cr, int cc,
                               cudaStream_t stream) {
  const size_t smem = fwd_chunk_smem(g.d, g.dv, g.ks, g.tqh * g.tqw, cr * cc);
  cudaError_t err = cudaFuncSetAttribute(na_fwd_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  na_fwd_chunked_kernel<<<dim3(tiles_of(g), g.n, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(idx_h), static_cast<const int*>(idx_w),
      static_cast<const int*>(row_lo), static_cast<const int*>(col_lo),
      static_cast<float*>(out), scale, g, cr, cc);
  return cudaGetLastError();
}

cudaError_t launch_bwd_chunked(const void* q, const void* k, const void* v, const void* dout,
                               const void* idx_h, const void* idx_w, const void* row_lo,
                               const void* col_lo, void* dq, void* dk, void* dv, void* partial,
                               float scale, int B, const Geometry& g, int cr, int cc, bool add,
                               cudaStream_t stream) {
  const size_t smem = bwd_chunk_smem(g.d, g.dv, g.ks, g.tqh * g.tqw, cr * cc);
  cudaError_t err = cudaFuncSetAttribute(na_bwd_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  na_bwd_chunked_kernel<<<dim3(tiles_of(g), g.n, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(idx_h),
      static_cast<const int*>(idx_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<float*>(dq), static_cast<float*>(partial),
      scale, g, cr, cc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<float>(partial, row_lo, col_lo, dk, dv, B, g, stream, add);
}

template <int NB>
cudaError_t launch_fwd_tc_nb(const void* q, const void* k, const void* v, const void* cnt_h,
                             const void* cnt_w, const void* row_lo, const void* col_lo, void* out,
                             float scale, int B, const Geometry& g, cudaStream_t stream) {
  const int smem = natc::smem_bytes(g.d, g.dv, NB, false);
  cudaError_t err = cudaFuncSetAttribute(natc::na_fwd_wgmma_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // as many blocks per SM as shared memory holds
    err = cudaFuncSetAttribute(natc::na_fwd_wgmma_kernel<NB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  using natc::bf16;
  natc::na_fwd_wgmma_kernel<NB><<<dim3(tiles_of(g), g.n, B), natc::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(cnt_h), static_cast<const uint8_t*>(cnt_w),
      static_cast<const int*>(row_lo), static_cast<const int*>(col_lo), static_cast<bf16*>(out),
      scale, tc_geometry(g));
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_bwd_tc_nb(const void* q, const void* k, const void* v, const void* dout,
                             const void* cnt_h, const void* cnt_w, const void* row_lo,
                             const void* col_lo, void* dq, void* partial, float scale, int B,
                             const Geometry& g, cudaStream_t stream) {
  const int smem = natc::smem_bytes(g.d, g.dv, NB, true);
  cudaError_t err = cudaFuncSetAttribute(natc::na_bwd_wgmma_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // as many blocks per SM as shared memory holds
    err = cudaFuncSetAttribute(natc::na_bwd_wgmma_kernel<NB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  using natc::bf16;
  natc::na_bwd_wgmma_kernel<NB><<<dim3(tiles_of(g), g.n, B), natc::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const uint8_t*>(cnt_h),
      static_cast<const uint8_t*>(cnt_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<bf16*>(dq), static_cast<float*>(partial),
      scale, tc_geometry(g));
  return cudaGetLastError();
}

// Boxes above the largest NB: the chunked kernels over nbox cells. K3 also
// writes each query's log-sum-exp (lse, f32 (B, Hq, Wq, n)).
cudaError_t launch_fwd_tc_chunked(const void* q, const void* k, const void* v, const void* cnt_h,
                                  const void* cnt_w, const void* row_lo, const void* col_lo,
                                  void* out, void* lse, float scale, int B, const Geometry& g,
                                  int nbox, cudaStream_t stream) {
  const auto kernel = natc::na_fwd_wgmma_chunked_kernel<natc::NBC>;
  const int smem = natc::smem_bytes_chunked(g.d, g.dv, false);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using natc::bf16;
  kernel<<<dim3(tiles_of(g), g.n, B), natc::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(cnt_h), static_cast<const uint8_t*>(cnt_w),
      static_cast<const int*>(row_lo), static_cast<const int*>(col_lo), static_cast<bf16*>(out),
      static_cast<float*>(lse), nbox, scale, tc_geometry(g));
  return cudaGetLastError();
}

// The key-major launch's transposed geometry: its rows are the LR grid's
// keys in tiles of tkh x tkw, its boxes the qurh x qurw query cells from
// (qlo_r[key tile row], qlo_c[key tile col]) of the query grid.
natc::Geom kv_geometry(const Geometry& g, int tkh, int tkw, int qurh, int qurw) {
  return natc::Geom{g.hk, g.wk, g.Hq, g.Wq, g.n, g.d, g.dv, tkh, tkw, qurh, qurw,
                    (g.wk + tkw - 1) / tkw, 0, g.hk, 0};
}

// One of K4's two chunked launches (natc::Role) over boxes of nbox cells.
template <natc::Role R>
cudaError_t launch_bwd_role(const void* q, const void* k, const void* v, const void* dout,
                            const void* out, const void* lse, const void* cnt_h,
                            const void* cnt_w, const void* row_lo, const void* col_lo,
                            const void* walk, void* dst, void* dst2, float scale, int B,
                            const natc::Geom& tg, int nbox, cudaStream_t stream) {
  const auto kernel = natc::na_bwd_wgmma_chunked_kernel<natc::NBC, R>;
  const int smem = natc::smem_bytes_chunked(tg.d, tg.dv, true);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using natc::bf16;
  const int tiles = ((tg.Hq + tg.tqh - 1) / tg.tqh) * tg.tiles_w;
  kernel<<<dim3(tiles, tg.n, B), natc::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<const uint8_t*>(cnt_h),
      static_cast<const uint8_t*>(cnt_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<const int*>(walk), static_cast<bf16*>(dst),
      static_cast<bf16*>(dst2), nbox, scale, tg);
  return cudaGetLastError();
}

// The tensor-core route's shape rules: 64-query tiles, d and dv multiples
// of 16, a box of at most NB cells, NB one the kernels take
// (natc::nb_supported).
bool tc_shape_ok(const Geometry& g, int nb) {
  return natc::nb_supported(nb, g.urw) && g.tqh * g.tqw == natc::M && g.d % 16 == 0 &&
         g.dv % 16 == 0 && g.d > 0 && g.dv > 0 && g.urh * g.urw <= nb;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the f32 K3 / K4 needs; the wrapper
// sizes tiles with it.
long long naf_na_fwd_smem(int d, int dv, int ks, int urh, int urw) {
  return (long long)fwd_smem(d, dv, ks, urh, urw);
}

long long naf_na_bwd_smem(int d, int dv, int ks, int urh, int urw) {
  return (long long)bwd_smem(d, dv, ks, urh, urw);
}

// Dynamic shared memory one block of the bf16 K3 (backward = 0) / K4 (1)
// needs, as the wrapper's planner computes it.
long long naf_na_tc_smem(int d, int dv, int nb, int backward) {
  return nb > 192 ? natc::smem_bytes_chunked(d, dv, backward != 0)
                  : natc::smem_bytes(d, dv, nb, backward != 0);
}

// f32, on the CUDA cores. Shape rules the launches rely on (checked by the
// wrapper): d % 4 == 0, dv % 4 == 0, every window cell inside its tile's
// [row_lo, row_lo + urh) x [col_lo, col_lo + urw) box.
int naf_na_fwd_fma(const void* q, const void* k, const void* v, const void* idx_h,
                   const void* idx_w, const void* row_lo, const void* col_lo, void* out,
                   float scale, int B, int Hq, int Wq, int hk, int wk, int n, int d, int dv,
                   int ks, int tqh, int tqw, int urh, int urw, void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw);
  return launch_fwd(q, k, v, idx_h, idx_w, row_lo, col_lo, out, scale, B, g,
                    static_cast<cudaStream_t>(stream));
}

// partial: (B, tiles, n, urh*urw, d+dv) f32 scratch, written before read.
// add_f32 = 1: the sums added to what dk, dv hold (a band of query rows at
// a time, q / dO / dq the band's rows).
int naf_na_bwd_fma(const void* q, const void* k, const void* v, const void* dout,
                   const void* idx_h, const void* idx_w, const void* row_lo, const void* col_lo,
                   void* dq, void* dk, void* dv_out, void* partial, float scale, int B, int Hq,
                   int Wq, int hk, int wk, int n, int d, int dv, int ks, int tqh, int tqw, int urh,
                   int urw, int add_f32, void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw);
  return launch_bwd(q, k, v, dout, idx_h, idx_w, row_lo, col_lo, dq, dk, dv_out, partial, scale,
                    B, g, add_f32 != 0, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one block of the chunked f32 K3 / K4 needs at nq
// queries a tile and nc cells a chunk.
long long naf_na_fwd_chunk_smem(int d, int dv, int ks, int nq, int nc) {
  return (long long)fwd_chunk_smem(d, dv, ks, nq, nc);
}

long long naf_na_bwd_chunk_smem(int d, int dv, int ks, int nq, int nc) {
  return (long long)bwd_chunk_smem(d, dv, ks, nq, nc);
}

// f32, chunked (boxes that do not fit shared memory whole): the box in
// chunks of at most cr x cc cells. Shape rules as naf_na_fwd_fma's.
int naf_na_fwd_fma_chunked(const void* q, const void* k, const void* v, const void* idx_h,
                           const void* idx_w, const void* row_lo, const void* col_lo, void* out,
                           float scale, int B, int Hq, int Wq, int hk, int wk, int n, int d,
                           int dv, int ks, int tqh, int tqw, int urh, int urw, int cr, int cc,
                           void* stream) {
  if (cr < 1 || cc < 1 || cr > urh || cc > urw) return cudaErrorInvalidValue;
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw);
  return launch_fwd_chunked(q, k, v, idx_h, idx_w, row_lo, col_lo, out, scale, B, g, cr, cc,
                            static_cast<cudaStream_t>(stream));
}

// partial and add_f32 as naf_na_bwd_fma's.
int naf_na_bwd_fma_chunked(const void* q, const void* k, const void* v, const void* dout,
                           const void* idx_h, const void* idx_w, const void* row_lo,
                           const void* col_lo, void* dq, void* dk, void* dv_out, void* partial,
                           float scale, int B, int Hq, int Wq, int hk, int wk, int n, int d,
                           int dv, int ks, int tqh, int tqw, int urh, int urw, int cr, int cc,
                           int add_f32, void* stream) {
  if (cr < 1 || cc < 1 || cr > urh || cc > urw) return cudaErrorInvalidValue;
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, ks, tqh, tqw, urh, urw);
  return launch_bwd_chunked(q, k, v, dout, idx_h, idx_w, row_lo, col_lo, dq, dk, dv_out, partial,
                            scale, B, g, cr, cc, add_f32 != 0, static_cast<cudaStream_t>(stream));
}

// bf16, on the tensor cores (na_tc.cuh). cnt_h (Hq, urh) / cnt_w (Wq, urw)
// uint8: how often each box cell occurs in the query's window. nb above 192:
// the chunked kernel, which also writes lse (f32 (B, Hq, Wq, n)); below, lse
// is not read and may be null.
int naf_na_fwd_wgmma(const void* q, const void* k, const void* v, const void* cnt_h,
                     const void* cnt_w, const void* row_lo, const void* col_lo, void* out,
                     void* lse, float scale, int B, int Hq, int Wq, int hk, int wk, int n, int d,
                     int dv, int tqh, int tqw, int urh, int urw, int nb, void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, 0, tqh, tqw, urh, urw);
  if (!tc_shape_ok(g, nb)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 192) {
    if (lse == nullptr) return cudaErrorInvalidValue;
    return launch_fwd_tc_chunked(q, k, v, cnt_h, cnt_w, row_lo, col_lo, out, lse, scale, B, g,
                                 nb, s);
  }
  switch (nb) {
#define X(N) \
  case N:    \
    return launch_fwd_tc_nb<N>(q, k, v, cnt_h, cnt_w, row_lo, col_lo, out, scale, B, g, s);
    NATC_NB_CASES(X)
#undef X
  }
  return cudaErrorInvalidValue;
}

// partial: (B, tiles, n, urh*urw, d+dv) f32 scratch, written before read.
// add_f32 = 0: dk, dv bf16, written; 1: f32, the sums added to what they
// hold (a band of query rows at a time, q / dO / dq the band's rows). Boxes
// of at most 192 cells; larger ones take naf_na_bwd_wgmma_chunked.
int naf_na_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* cnt_h, const void* cnt_w, const void* row_lo,
                     const void* col_lo, void* dq, void* dk, void* dv_out, void* partial,
                     float scale, int B, int Hq, int Wq, int hk, int wk, int n, int d, int dv,
                     int tqh, int tqw, int urh, int urw, int nb, int add_f32, void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, 0, tqh, tqw, urh, urw);
  if (!tc_shape_ok(g, nb) || nb > 192) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (nb) {
#define X(N)                                                                                   \
  case N:                                                                                      \
    err = launch_bwd_tc_nb<N>(q, k, v, dout, cnt_h, cnt_w, row_lo, col_lo, dq, partial, scale, \
                              B, g, s);                                                        \
    break;
    NATC_NB_CASES(X)
#undef X
  }
  if (err != cudaSuccess) return err;
  if (add_f32) return launch_reduce<float>(partial, row_lo, col_lo, dk, dv_out, B, g, s, true);
  return launch_reduce<__nv_bfloat16>(partial, row_lo, col_lo, dk, dv_out, B, g, s);
}

// bf16 K4 on boxes above 192 cells (nb), from K3's out (B, Hq, Wq, n, dv) and
// lse (f32 (B, Hq, Wq, n)): the query-major launch (K3's plan: tiles, boxes,
// cnt_h, cnt_w, row_lo, col_lo) writes dq; the key-major one writes dk and dv
// over tkh x tkw key tiles whose query boxes (qurh x qurw cells from qlo_r,
// qlo_c, nbk a multiple of 128 above their cells) hold every query whose
// window holds one of the tile's keys, with cntt_h (hk, qurh) / cntt_w (wk,
// qurw) uint8: how often the key occurs in the window of each query of its
// box, and walk (int32, per key tile row) the box cells its blocks visit. A
// band of query rows takes the band's rows of the tables: its dk and dv are
// its queries' share.
int naf_na_bwd_wgmma_chunked(const void* q, const void* k, const void* v, const void* dout,
                             const void* out, const void* lse, const void* cnt_h,
                             const void* cnt_w, const void* row_lo, const void* col_lo,
                             const void* cntt_h, const void* cntt_w, const void* qlo_r,
                             const void* qlo_c, const void* walk, void* dq, void* dk,
                             void* dv_out, float scale,
                             int B, int Hq, int Wq, int hk, int wk, int n, int d, int dv, int tqh,
                             int tqw, int urh, int urw, int nb, int tkh, int tkw, int qurh,
                             int qurw, int nbk, void* stream) {
  const Geometry g = make_geometry(Hq, Wq, hk, wk, n, d, dv, 0, tqh, tqw, urh, urw);
  if (!tc_shape_ok(g, nb) || nb <= 192 || tkh * tkw != natc::M || nbk % natc::NBC != 0 ||
      (long long)qurh * qurw > nbk || (long long)nbk * qurw >= (1ll << 32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_bwd_role<natc::Role::DQ>(q, k, v, dout, out, lse, cnt_h, cnt_w,
                                                    row_lo, col_lo, nullptr, dq, nullptr, scale,
                                                    B, tc_geometry(g), nb, s);
  if (err != cudaSuccess) return err;
  return launch_bwd_role<natc::Role::DKV>(q, k, v, dout, out, lse, cntt_h, cntt_w, qlo_r, qlo_c,
                                          walk, dk, dv_out, scale, B,
                                          kv_geometry(g, tkh, tkw, qurh, qurw), nbk, s);
}

}  // extern "C"
