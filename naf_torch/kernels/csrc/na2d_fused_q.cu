// Fused NAF upsampling attention on Hopper (K2): per output pixel (b, y, x)
// and attention head h,
//   1. pool:  xp = adaptive average of enc over input rows
//             [floor(y*hi/Hq), ceil((y+1)*hi/Hq)) and the same for columns
//             (the identity when hi == Hq; one rule for pool-up and -down);
//   2. RoPE:  q[c] = xp[c]*cos_r[y,c]*cos_c[x,c] + rot[c]*sin_r[y,c]*sin_c[x,c],
//             rot[c] = -xp[c+dh/2] in the first half of each RoPE head of
//             width dh, xp[c-dh/2] in the second;
//   3. logits against the keys (times the softmax scale) of the k x k LR
//             cells idx_h[y,t], idx_w[x,s];
//   4. softmax in f32 (max subtracted), then sum p * V, stored in the io dtype.
//
// Replaces the TPU kernel naf_tpu/kernels/na2d_fused_q.py::_fused_q_impl
// (body `_kernel`). Queries never reach device memory: the traffic is one
// read of enc and one write of the output, plus the small LR K/V grid.
//
// Two kernels, chosen by the io dtype (na2d_fused_q.py, as K3's route):
//
// bf16, on the tensor cores (fused_q_wgmma_kernel): K3's forward tile of
// na_tc.cuh (a warpgroup per 64-query tile, head and sample; the K/V box of
// LR cells staged by cp.async, keys scaled as they land; S = Q K^T and P V
// on wgmma; the window as + log(count) on the f32 logits, for a tile whose
// queries share one window (at a ratio of 8 or more most 8 x 8 tiles; they
// run first) from one row of biases in shared memory instead of two table
// loads per logit;
// boxes above 192 cells in chunks of 128), with a prologue that builds the
// 64 x d query tile on chip while the box's copies are in flight: each
// thread takes (query row, 8-channel vector) items of head h, sums the row's
// pool window with 8-byte loads of enc into f32 (its own 4-channel groups
// and their RoPE partners, read from the pixel's whole channel row, so
// partners in another attention head or a RoPE half of no multiple of 8
// channels need no layout of their own; partners that are no 4-aligned group
// take 2-byte loads), applies the f32 tables, rounds to bf16 and stores 16
// bytes into the swizzled tile; the prologue is bound by memory latency.
// Rows past the grid's or the band's edge and channels past d are
// zero. Keys and values arrive with their head channels padded to a multiple
// of 16 (zero channels: the logits do not change); enc is read as it lies,
// and only the real dv channels of the output are stored, so a shared output
// buffer is written in place.
//
// f32, on the CUDA cores (fused_q_kernel): a block per (b, tile of tqh x
// tqw queries, head), 8 warps, a warp per query in turn; the block stages
// its head's scaled K and V for the tile's box in shared memory as f32; the
// window comes from the int32 tables idx_h (Hq, k), idx_w (Wq, k). The
// caller folds the softmax scale into its keys.
//
// What bounds it on the card: at 448^2 with 28^2 x 384 features in bf16 the
// kernel must read 103 MB of enc and write 154 MB (77 us at 3.35 TB/s); its
// 21 GFLOP take 21 us at the tensor cores' bf16 rate, so it is bound by
// bytes; at 448^2 -> 2048^2 it writes 3.2 GB (1.0 ms). The bf16 kernel keeps
// the arithmetic on wgmma so that it stays under the bytes; what it adds to
// them is the K/V box each 64-query tile reads again from L2 and the pool
// window each query reads again from L1.
//
// Banded launches (the JAX kernel's row_cell0 / band_cells / out_acc /
// enc_banded) compute only the query rows [y0, y0 + band_h) of the Hq-row
// grid, with the global window rule: the window (or count) tables then hold
// those rows, the RoPE row table and the pool rule stay global, and
//  - enc may hold only the input rows from enc_row0 on of an hi_full-row
//    encoder grid: query row y pools input rows [floor(y*hi_full/Hq),
//    ceil((y+1)*hi_full/Hq)) less enc_row0;
//  - the output is a buffer of out_rows rows whose row 0 is query row
//    out_row0: the whole (B, Hq, Wq, Cv) output, written in place row by
//    row (its band rows are not contiguous across the batch, so the kernel
//    takes the buffer's batch stride, never a copied slab), or a band slab.

#include <climits>

#include "na_fma.cuh"
#include "na_tc.cuh"

namespace {

using natc::bf16;

// ---------------------------------------------------------- bf16, wgmma

// What the prologue reads: enc (B, hi, wi, C) holding the input rows from
// enc_row0 on of an hi_full-row grid pooled onto Hq query rows, the cos|sin
// tables (Hq, 2C) / (Wq, 2C) in f32, d the real channels per attention head
// and dh the RoPE head width.
struct QSrc {
  const bf16* enc;
  const float* rows_tab;
  const float* cols_tab;
  int hi, wi, hi_full, enc_row0, Hq, C, d, dh;
};

// The 4 bf16 (8 bytes) at p, or zeros where !on.
__device__ __forceinline__ uint2 ld4(const bf16* p, bool on) {
  return on ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
}

// acc[0..4) += the 4 bf16 of raw, in f32.
__device__ __forceinline__ void add4(float* acc, uint2 raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  acc[0] += a.x;
  acc[1] += a.y;
  acc[2] += b.x;
  acc[3] += b.y;
}

// The 8 floats at p (16-byte aligned) into v, or zeros for the 4 from p + 4
// where !two.
__device__ __forceinline__ void ld8f(float (&v)[8], const float* p, bool two) {
  *reinterpret_cast<float4*>(v) = __ldg(reinterpret_cast<const float4*>(p));
  *reinterpret_cast<float4*>(v + 4) =
      two ? __ldg(reinterpret_cast<const float4*>(p + 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The tile's pooled, RoPE'd queries of head t.h as bf16 into the swizzled
// 64 x g.d tile at qs (g.d: d padded to a multiple of 16, zero channels).
// A thread's item is 8 channels of one query row: 2 groups of 4 (the second
// past d where d % 8 == 4). Its table rows are loaded first; then each pixel
// of its pool window (up to 2 x 2 in pool-up, 5 x 5 in pool-down) is read
// with its own and its partner groups' loads issued together, and summed.
__device__ __forceinline__ void build_q(const QSrc& src, const natc::Geom& g,
                                        const natc::Tile& t, unsigned char* qs) {
  const int nv = g.d >> 3;  // 16-byte vectors per tile row
  const int half = src.dh >> 1;
  const bool vec_partner = (half & 3) == 0;  // partners of a 4-aligned group are one
  const size_t row_stride = (size_t)src.wi * src.C;
  const bf16* encb = src.enc + (size_t)t.b * src.hi * row_stride;
  for (int e = threadIdx.x; e < natc::M * nv; e += natc::THREADS) {
    const int r = e / nv;
    const int c0 = (e - r * nv) * 8;  // channel of the head
    const int yl = t.y0 + r / g.tqw;  // row of the launch's grid
    const int x = t.x0 + r % g.tqw;
    float q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = 0.f;
    if (yl < g.Hq && x < g.Wq && c0 < src.d) {
      const int y = g.row0 + yl;  // global query row
      // the pool window in 32-bit arithmetic: the entry point keeps
      // (Hq + 1) * hi_full and (Wq + 1) * wi below 2^31
      const int iy0 = y * src.hi_full / src.Hq;
      const int ny = ((y + 1) * src.hi_full + src.Hq - 1) / src.Hq - iy0;
      const int ix0 = x * src.wi / g.Wq;
      const int nx = ((x + 1) * src.wi + g.Wq - 1) / g.Wq - ix0;
      const bf16* px0 =
          encb + (size_t)(iy0 - src.enc_row0) * row_stride + (size_t)ix0 * src.C;
      const bool two = c0 + 4 < src.d;
      const int gc = t.h * src.d + c0;
      int pc[8];
      bool first[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        first[i] = (gc + i) % src.dh < half;
        pc[i] = first[i] ? gc + i + half : gc + i - half;
      }
      float rc[8], rs[8], cc[8], cs[8];
      const float* rt = src.rows_tab + (size_t)y * 2 * src.C + gc;
      const float* ct = src.cols_tab + (size_t)x * 2 * src.C + gc;
      ld8f(rc, rt, two);
      ld8f(rs, rt + src.C, two);
      ld8f(cc, ct, two);
      ld8f(cs, ct + src.C, two);
      float xv[8], xr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = xr[i] = 0.f;
      for (int iy = 0; iy < ny; ++iy)
        for (int ix = 0; ix < nx; ++ix) {
          const bf16* px = px0 + iy * row_stride + ix * src.C;
          const uint2 o0 = ld4(px + gc, true), o1 = ld4(px + gc + 4, two);
          const uint2 p0 = ld4(px + pc[0], vec_partner), p1 = ld4(px + pc[4], two && vec_partner);
          add4(xv, o0);
          add4(xv + 4, o1);
          add4(xr, p0);
          add4(xr + 4, p1);
        }
      if (!vec_partner)  // partners that are no 4-aligned group: one by one
        for (int iy = 0; iy < ny; ++iy)
          for (int ix = 0; ix < nx; ++ix) {
            const bf16* px = px0 + iy * row_stride + ix * src.C;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (i < 4 || two) xr[i] += __bfloat162float(px[pc[i]]);
          }
      const float inv = 1.f / (float)(ny * nx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        q[i] = (xv[i] * inv) * (rc[i] * cc[i]) +
               (xr[i] * (first[i] ? -inv : inv)) * (rs[i] * cs[i]);
    }
    const uint4 packed = make_uint4(natc::pack2(q[0], q[1]), natc::pack2(q[2], q[3]),
                                    natc::pack2(q[4], q[5]), natc::pack2(q[6], q[7]));
    *reinterpret_cast<uint4*>(qs + natc::swz(natc::M, r, c0)) = packed;
  }
}

__device__ __forceinline__ unsigned char* tile_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u = natc::smem_u32(smem_raw);
  return smem_raw + (((raw_u + 1023u) & ~1023u) - raw_u);
}

// A block per (64-query tile, head, sample); out (B, out_rows, Wq, n * dv).
// Block x takes tile order[x]: the n_uniform tiles whose queries lie inside
// the grid and share one window come first, and take it as one row of
// biases (natc::UniformCounts) after the K/V box. A grid whose blocks of
// the two kinds run side by side on the SMs is slower than either kind
// alone (on an H100); blocks start in about the order of their index, so
// the two kinds meet only where the first ends.
template <int NB>
__global__ void __launch_bounds__(natc::THREADS)
fused_q_wgmma_kernel(QSrc src, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const uint8_t* __restrict__ cnt_h, const uint8_t* __restrict__ cnt_w,
                     const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                     const int* __restrict__ order, int n_uniform, bf16* __restrict__ out,
                     int dv, float scale, natc::Geom g) {
  unsigned char* qs = tile_base();
  const natc::Tile t = natc::tile_at(g, row_lo, col_lo, __ldg(order + blockIdx.x));
  float* bias = nullptr;
  if ((int)blockIdx.x < n_uniform)
    bias = reinterpret_cast<float*>(qs + natc::tile_bytes(natc::M, g.d) +
                                    natc::tile_bytes(NB, g.d) + natc::tile_bytes(NB, g.dv));
  auto build = [&](unsigned char* dst) {
    natc::UniformCounts<NB> counts;
    if (bias != nullptr) counts.load(g, t, cnt_h, cnt_w);  // in flight under the prologue
    build_q(src, g, t, dst);
    if (bias != nullptr) counts.store(bias);
  };
  natc::fwd_tile<NB, true>(build, k, v, cnt_h, cnt_w, t, out, dv, scale, g, qs, bias);
}

// Boxes above the largest NB: nbox cells in chunks of natc::NBC.
__global__ void __launch_bounds__(natc::THREADS)
fused_q_wgmma_chunked_kernel(QSrc src, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const uint8_t* __restrict__ cnt_h, const uint8_t* __restrict__ cnt_w,
                             const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                             bf16* __restrict__ out, int dv, int nbox, float scale,
                             natc::Geom g) {
  unsigned char* qs = tile_base();
  const natc::Tile t = natc::tile_of(g, row_lo, col_lo);
  natc::fwd_tile_chunked<natc::NBC, true>([&](unsigned char* dst) { build_q(src, g, t, dst); },
                                          k, v, cnt_h, cnt_w, t, out, dv, nbox, scale, g, qs);
}

// K3's forward block, and the single-pass kernel's row of NB window biases.
int tc_smem(int d, int dv, int nb) {
  return nb > 192 ? natc::smem_bytes_chunked(d, dv, false)
                  : natc::smem_bytes(d, dv, nb, false) + nb * (int)sizeof(float);
}

// Opt the kernel into `smem` bytes of dynamic shared memory and as many
// blocks per SM as shared memory holds.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int NB>
cudaError_t launch_tc(const QSrc& src, const bf16* k, const bf16* v, const uint8_t* cnt_h,
                      const uint8_t* cnt_w, const int* row_lo, const int* col_lo,
                      const int* order, int n_uniform, bf16* out, int dv, float scale,
                      const natc::Geom& g, dim3 grid, cudaStream_t stream) {
  const int smem = tc_smem(g.d, g.dv, NB);
  cudaError_t err = prepare(fused_q_wgmma_kernel<NB>, smem);
  if (err != cudaSuccess) return err;
  fused_q_wgmma_kernel<NB><<<grid, natc::THREADS, smem, stream>>>(
      src, k, v, cnt_h, cnt_w, row_lo, col_lo, order, n_uniform, out, dv, scale, g);
  return cudaGetLastError();
}

// ------------------------------------------------------ f32, CUDA cores

using nafma::THREADS;
using nafma::WARPS;

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Steps 1-2 for one warp: the pooled, RoPE'd query of head h at global row
// y (enc's input rows from enc_row0 on of an hi_full-row grid) and column x
// into q[0, d) (shared), lanes over channels; complete after the __syncwarp.
__device__ __forceinline__ void pooled_query(const float* __restrict__ encb,
                                             const float* __restrict__ rows_tab,
                                             const float* __restrict__ cols_tab, int hi_full,
                                             int enc_row0, int Hq, int wi, int Wq, int C, int d,
                                             int dh, int h, int y, int x, float* q) {
  const int half = dh / 2;
  const int iy0 = (int)(((long long)y * hi_full) / Hq) - enc_row0;
  const int iy1 = (int)(((long long)(y + 1) * hi_full + Hq - 1) / Hq) - enc_row0;
  const int ix0 = (int)(((long long)x * wi) / Wq);
  const int ix1 = (int)(((long long)(x + 1) * wi + Wq - 1) / Wq);
  const float inv = 1.f / (float)((iy1 - iy0) * (ix1 - ix0));
  const float* rt = rows_tab + (size_t)y * 2 * C;
  const float* ct = cols_tab + (size_t)x * 2 * C;
  for (int c = threadIdx.x & 31; c < d; c += 32) {
    const int gc = h * d + c;
    const bool first = (gc % dh) < half;
    const int pc = first ? gc + half : gc - half;
    float xv = 0.f, xr = 0.f;
    for (int iy = iy0; iy < iy1; ++iy)
      for (int ix = ix0; ix < ix1; ++ix) {
        const float* px = encb + ((size_t)iy * wi + ix) * C;
        xv += px[gc];
        xr += px[pc];
      }
    xv *= inv;
    xr *= first ? -inv : inv;
    q[c] = xv * (rt[gc] * ct[gc]) + xr * (rt[C + gc] * ct[C + gc]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
fused_q_kernel(const float* __restrict__ enc, const float* __restrict__ keys,
               const float* __restrict__ values, const float* __restrict__ rows_tab,
               const float* __restrict__ cols_tab, const int* __restrict__ idx_h,
               const int* __restrict__ idx_w, const int* __restrict__ row_lo,
               const int* __restrict__ col_lo, float* __restrict__ out, int hi, int wi,
               int hi_full, int enc_row0, int Hq, int Wq, int y0, int band_h, int out_rows,
               int out_row0, int hk, int wk, int C, int n, int Cv, int ks, int dh, int tqh,
               int tqw, int urh, int urw, int tiles_w) {
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
    Ks[cell * dpad + c] = keys[g];
  }
  for (int e = tid; e < ncell * dv; e += THREADS) {
    const int cell = e / dv, c = e % dv;
    const size_t g = ((size_t)(b * hk + r0 + cell / urw) * wk + c0 + cell % urw) * Cv + h * dv + c;
    Vs[e] = values[g];
  }
  __syncthreads();

  float* q = qs + warp * d;
  float* p = ps + warp * kk2;
  int* sl = slots + warp * kk2;
  const float* encb = enc + (size_t)b * hi * wi * C;

  for (int qi = warp; qi < tqh * tqw; qi += WARPS) {
    const int yl = tr * tqh + qi / tqw;  // row of the launch's band
    const int x = tc * tqw + qi % tqw;
    if (yl >= band_h || x >= Wq) continue;  // uniform across the warp
    const int y = y0 + yl;                  // global query row

    // 1-2: pooled, RoPE'd query for this head
    pooled_query(encb, rows_tab, cols_tab, hi_full, enc_row0, Hq, wi, Wq, C, d, dh, h, y, x, q);

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
    float* o = out + (((size_t)b * out_rows + y - out_row0) * Wq + x) * Cv + h * dv;
    for (int c = lane; c < dv; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kk2; ++j) acc = fmaf(p[j], Vs[sl[j] * dv + c], acc);
      o[c] = acc * inv_sum;
    }
    __syncwarp();
  }
}

// f32, chunked (na_fma.cuh): boxes that do not fit shared memory whole, in
// chunks of cr x cc cells, a statistics pass and an output pass; each query
// is pooled and RoPE'd again per chunk (from L1/L2: one read of its pool
// window and tables against k^2 d multiply-adds). Shared memory: the
// chunk's K [cells][d + 4] and V [cells][dv], per warp the query and its
// slots' logits and cells, per query of the tile {m, l}.
// one block per SM (the planner sizes the chunk to shared memory): 102-128
// registers a thread, without the spills of ptxas's default of 64
__global__ void __launch_bounds__(THREADS, 1)
fused_q_chunked_kernel(const float* __restrict__ enc, const float* __restrict__ keys,
                       const float* __restrict__ values, const float* __restrict__ rows_tab,
                       const float* __restrict__ cols_tab, const int* __restrict__ idx_h,
                       const int* __restrict__ idx_w, const int* __restrict__ row_lo,
                       const int* __restrict__ col_lo, float* __restrict__ out, int hi, int wi,
                       int hi_full, int enc_row0, int Hq, int Wq, int y0, int band_h,
                       int out_rows, int out_row0, int hk, int wk, int C, int n, int Cv, int ks,
                       int dh, int tqh, int tqw, int urh, int urw, int tiles_w, int cr, int cc) {
  const int d = C / n;
  const int dv = Cv / n;
  const int kk2 = ks * ks;
  const int dpad = d + 4;
  const int nc = cr * cc;
  const int nq = tqh * tqw;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                           // [nc][dpad]
  float* Vs = Ks + nc * dpad;                 // [nc][dv]
  float* qs = Vs + round4(nc * dv);           // [WARPS][d]
  float* ps = qs + WARPS * d;                 // [WARPS][kk2]
  int* slots = reinterpret_cast<int*>(ps + WARPS * kk2);         // [WARPS][kk2]
  float* stats = reinterpret_cast<float*>(slots + WARPS * kk2);  // [nq][2]

  const int tr = blockIdx.x / tiles_w, tc = blockIdx.x % tiles_w;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = row_lo[tr], c0 = col_lo[tc];
  for (int e = threadIdx.x; e < nq; e += THREADS) {
    stats[2 * e] = -CUDART_INF_F;
    stats[2 * e + 1] = 0.f;
  }
  float* q = qs + warp * d;
  float* p = ps + warp * kk2;
  int* sl = slots + warp * kk2;
  const float* encb = enc + (size_t)b * hi * wi * C;
  auto out_row = [&](int y, int x) {
    return out + (((size_t)b * out_rows + y - out_row0) * Wq + x) * Cv + h * dv;
  };
  const int chunks = nafma::chunk_count(urh, urw, cr, cc);
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1)  // out rows start at zero, each added to by its own lanes
      for (int qi = warp; qi < nq; qi += WARPS) {
        const int yl = tr * tqh + qi / tqw, x = tc * tqw + qi % tqw;
        if (yl >= band_h || x >= Wq) continue;
        float* o = out_row(y0 + yl, x);
        for (int c = lane; c < dv; c += 32) o[c] = 0.f;
      }
    for (int ci = 0; ci < chunks; ++ci) {
      const nafma::Chunk ch = nafma::chunk_at(ci, r0, c0, urh, urw, cr, cc);
      __syncthreads();  // every warp is done with the last chunk
      nafma::stage_chunk(keys, values, Ks, Vs, 1.f, hk, wk, n, d, dv, dpad, dv, b, h, ch);
      __syncthreads();
      for (int qi = warp; qi < nq; qi += WARPS) {
        const int yl = tr * tqh + qi / tqw, x = tc * tqw + qi % tqw;
        if (yl >= band_h || x >= Wq) continue;  // uniform across the warp
        const int y = y0 + yl;
        pooled_query(encb, rows_tab, cols_tab, hi_full, enc_row0, Hq, wi, Wq, C, d, dh, h, y, x,
                     q);
        float mx;
        const int ns = nafma::chunk_logits(q, Ks, dpad, d, idx_h + yl * ks, idx_w + x * ks, ks,
                                           ch, p, sl, &mx);
        if (ns > 0) {
          float* st = stats + 2 * qi;
          if (pass == 0) {
            nafma::online_stats(p, nullptr, ns, mx, st);
          } else {
            nafma::chunk_probs(p, ns, st);
            nafma::add_weighted_rows(p, sl, ns, Vs, dv, dv, out_row(y, x));
          }
        }
        __syncwarp();  // q, p and sl are free for the warp's next query
      }
    }
  }
}

size_t chunk_smem_bytes(int d, int dv, int ks, int nq, int nc) {
  return (size_t)(nc * (d + 4) + ((nc * dv + 3) & ~3) + WARPS * d + 2 * WARPS * ks * ks +
                  2 * nq) * sizeof(float);
}

size_t smem_bytes(int d, int dv, int ks, int urh, int urw) {
  const int ncell = urh * urw;
  return (size_t)(ncell * (d + 4) + ((ncell * dv + 3) & ~3) + WARPS * d + 2 * WARPS * ks * ks) *
         sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the f32 kernel needs; the wrapper
// sizes tiles with it.
long long naf_fused_q_smem(int d, int dv, int ks, int urh, int urw) {
  return (long long)smem_bytes(d, dv, ks, urh, urw);
}

// Dynamic shared memory one block of the bf16 kernel needs for a box
// padded to nb cells (na2d_fused_q.py::_tc_smem: K3's forward block, and
// up to 192 cells a row of nb window biases).
long long naf_fused_q_tc_smem(int d, int dv, int nb) { return tc_smem(d, dv, nb); }

// f32, on the CUDA cores. Shape rules the launch relies on (checked by the
// wrapper): C % n == 0, (C/n) % 4 == 0, Cv % n == 0, dh even and dividing
// C, keys scaled by the caller, every window cell inside its tile's
// [row_lo, row_lo+urh) x [col_lo, col_lo+urw) box, and, for a band, every
// pooled input row of its query rows inside enc's [enc_row0, enc_row0 + hi)
// and every query row inside the output buffer. The full-grid call is
// hi_full = hi, enc_row0 = y0 = out_row0 = 0, band_h = out_rows = Hq.
int naf_fused_q_fma(const void* enc, const void* keys, const void* values, const void* rows_tab,
                    const void* cols_tab, const void* idx_h, const void* idx_w,
                    const void* row_lo, const void* col_lo, void* out, int B, int hi, int wi,
                    int hi_full, int enc_row0, int Hq, int Wq, int y0, int band_h, int out_rows,
                    int out_row0, int hk, int wk, int C, int n, int Cv, int ks, int dh, int tqh,
                    int tqw, int urh, int urw, void* stream) {
  const int tiles_w = (Wq + tqw - 1) / tqw;
  const int tiles = ((band_h + tqh - 1) / tqh) * tiles_w;
  const size_t smem = smem_bytes(C / n, Cv / n, ks, urh, urw);
  cudaError_t err = cudaFuncSetAttribute(fused_q_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_q_kernel<<<dim3(tiles, n, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(keys),
      static_cast<const float*>(values), static_cast<const float*>(rows_tab),
      static_cast<const float*>(cols_tab), static_cast<const int*>(idx_h),
      static_cast<const int*>(idx_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<float*>(out), hi, wi, hi_full, enc_row0, Hq,
      Wq, y0, band_h, out_rows, out_row0, hk, wk, C, n, Cv, ks, dh, tqh, tqw, urh, urw, tiles_w);
  return cudaGetLastError();
}

// Dynamic shared memory one block of the chunked f32 kernel needs at nq
// queries a tile and nc cells a chunk.
long long naf_fused_q_chunk_smem(int d, int dv, int ks, int nq, int nc) {
  return (long long)chunk_smem_bytes(d, dv, ks, nq, nc);
}

// f32, chunked: arguments and shape rules as naf_fused_q_fma's, the box in
// chunks of at most cr x cc cells.
int naf_fused_q_fma_chunked(const void* enc, const void* keys, const void* values,
                            const void* rows_tab, const void* cols_tab, const void* idx_h,
                            const void* idx_w, const void* row_lo, const void* col_lo, void* out,
                            int B, int hi, int wi, int hi_full, int enc_row0, int Hq, int Wq,
                            int y0, int band_h, int out_rows, int out_row0, int hk, int wk, int C,
                            int n, int Cv, int ks, int dh, int tqh, int tqw, int urh, int urw,
                            int cr, int cc, void* stream) {
  if (cr < 1 || cc < 1 || cr > urh || cc > urw) return cudaErrorInvalidValue;
  const int tiles_w = (Wq + tqw - 1) / tqw;
  const int tiles = ((band_h + tqh - 1) / tqh) * tiles_w;
  const size_t smem = chunk_smem_bytes(C / n, Cv / n, ks, tqh * tqw, cr * cc);
  cudaError_t err = cudaFuncSetAttribute(fused_q_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_q_chunked_kernel<<<dim3(tiles, n, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(keys),
      static_cast<const float*>(values), static_cast<const float*>(rows_tab),
      static_cast<const float*>(cols_tab), static_cast<const int*>(idx_h),
      static_cast<const int*>(idx_w), static_cast<const int*>(row_lo),
      static_cast<const int*>(col_lo), static_cast<float*>(out), hi, wi, hi_full, enc_row0, Hq,
      Wq, y0, band_h, out_rows, out_row0, hk, wk, C, n, Cv, ks, dh, tqh, tqw, urh, urw, tiles_w,
      cr, cc);
  return cudaGetLastError();
}

// bf16, on the tensor cores. keys (B, hk, wk, n, dp) and values (B, hk, wk,
// n, dvp) with zero channels past the real d = C / n and dv; unscaled keys
// (the kernel scales them as K3 does). cnt_h (band_h, urh) / cnt_w (Wq,
// urw) uint8: how often each box cell occurs in the query's window (the
// band's rows); order int32: the launch's tiles, the n_uniform whose
// queries are inside the grid and share one row of each table first; nb
// above 192: the chunked kernel (block x takes tile x; order and n_uniform
// unused). Band arguments as above; out (B, out_rows, Wq, n * dv).
int naf_fused_q_wgmma(const void* enc, const void* keys, const void* values,
                      const void* rows_tab, const void* cols_tab, const void* cnt_h,
                      const void* cnt_w, const void* row_lo, const void* col_lo,
                      const void* order, void* out, float scale, int B, int hi, int wi,
                      int hi_full, int enc_row0, int Hq, int Wq, int y0, int band_h,
                      int out_rows, int out_row0, int hk, int wk, int C, int n, int dp, int dvp,
                      int dv, int dh, int tqh, int tqw, int urh, int urw, int nb, int n_uniform,
                      void* stream) {
  const int d = n > 0 ? C / n : 0;
  if (n <= 0 || C % n || d % 4 || dp % 16 || dp < d || dvp % 16 || dvp < dv || dv <= 0 ||
      dh <= 0 || dh % 2 || C % dh || tqh * tqw != natc::M || urh * urw > nb ||
      !natc::nb_supported(nb, urw) || n_uniform < 0 ||
      (long long)(Hq + 1) * hi_full >= INT_MAX ||
      (long long)(Wq + 1) * wi >= INT_MAX)
    return cudaErrorInvalidValue;
  // the tile grid is the band's rows; the output buffer's row 0 is out_row0
  const natc::Geom g{band_h, Wq, hk, wk, n, dp, dvp, tqh, tqw, urh, urw, (Wq + tqw - 1) / tqw,
                     y0, out_rows, out_row0};
  const QSrc src{static_cast<const bf16*>(enc), static_cast<const float*>(rows_tab),
                 static_cast<const float*>(cols_tab), hi, wi, hi_full, enc_row0, Hq, C, d, dh};
  const dim3 grid(((band_h + tqh - 1) / tqh) * g.tiles_w, n, B);
  const auto* k = static_cast<const bf16*>(keys);
  const auto* v = static_cast<const bf16*>(values);
  const auto* ch = static_cast<const uint8_t*>(cnt_h);
  const auto* cw = static_cast<const uint8_t*>(cnt_w);
  const auto* rl = static_cast<const int*>(row_lo);
  const auto* cl = static_cast<const int*>(col_lo);
  const auto* ord = static_cast<const int*>(order);
  auto* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 192) {
    const int smem = tc_smem(dp, dvp, nb);
    cudaError_t err = prepare(fused_q_wgmma_chunked_kernel, smem);
    if (err != cudaSuccess) return err;
    fused_q_wgmma_chunked_kernel<<<grid, natc::THREADS, smem, s>>>(src, k, v, ch, cw, rl, cl, o,
                                                                    dv, nb, scale, g);
    return cudaGetLastError();
  }
  switch (nb) {
#define X(N) \
  case N:    \
    return launch_tc<N>(src, k, v, ch, cw, rl, cl, ord, n_uniform, o, dv, scale, g, grid, s);
    NATC_NB_CASES(X)
#undef X
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
