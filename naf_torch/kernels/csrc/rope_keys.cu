// The NAF keys and RoPE tables on Hopper (the keys kernel). In one launch:
//
//   keys     (B, hk, wk, C) = adaptive_pool(rope(adaptive_pool(enc, (oh, ow))), (hk, wk))
//   rows_tab (oh, 2C) f32   = [cos_r | sin_r]   of RoPE.tables(oh, ow)
//   cols_tab (ow, 2C) f32   = [cos_c | sin_c]
//
// from the encoder output enc (B, hi, wi, C), NHWC, in bf16 or f32, and the
// RoPE period buffer (dh / 4 f32). Both pools take the adaptive rule of
// ops/pool.py (output o of an axis of n pooled to m averages
// [floor(o*n/m), ceil((o+1)*n/m))); the pool onto (oh, ow) is the identity
// when enc already has that size, a pool-up from a smaller guide, a pool-down
// from a larger one.
//
// Replaces no TPU kernel: the JAX package computes the keys and tables as
// plain jnp (naf_tpu/nn/rope.py, RoPE.pooled and RoPE.tables). Their torch
// counterparts, the plain version in rope_keys.py, materialise the RoPE'd
// grid at full resolution (about five bf16 tensors of enc's size at a 2048^2
// guide) and copy the pool matrices and the coordinates from the host by
// pageable copies, each of which holds the host until the device catches up.
//
// What bounds it: the bytes. It reads enc once (2.15 GB at a 2048^2 guide,
// 0.64 ms at 3.35 TB/s) and writes hk*wk*C keys and the two small tables; a
// few f32 operations per element read are far below the card's rate.
//
// Design:
//  - A channel c of a head's first half and its rotate-half partner
//    p = c + dh/2 share one frequency, and RoPE turns the pair as a complex
//    number: z = x[c] + i x[p] becomes z e^(i theta). Every channel's angle
//    depends on one axis only (rope.py): in each head of width dh, channels
//    [0, dh/4) and [dh/2, 3dh/4) take the row angle of frequency j % (dh/4),
//    the others the column angle. So each key pair factors exactly:
//        key[c] + i key[p] = sum_i R(i) sum_j Q(j) z[i, j]
//    with complex axis weights: along the angle axis the composite of the
//    two pools (pool-down of pool-up) with each middle position's e^(i theta)
//    folded in, along the free axis the plain composite (imaginary part 0).
//    Nothing is written at full resolution.
//  - A block owns one key row ky of one sample, KX consecutive key columns
//    and GB channel groups. A group is V channels of a head's first half and
//    their V partners (V = 8, 4 or 2, the widest dividing dh / 2): one
//    thread reads both V-channel runs of a pixel with vector loads (16 bytes
//    each for bf16 at V = 8) along NHWC's contiguous W*C and keeps V complex
//    f32 keys. The R threads of one (key column, group) split the window's
//    rows; per row a thread first sums the columns times their complex
//    weights, then multiplies the sum by the row's weight into its keys. At
//    the end the R partial keys meet in shared memory and one thread stores
//    the 2V keys, one bf16 store per key. The host picks GB, R and KX so
//    that a block has up to 256 threads and the grid (key columns / KX x
//    channel-group blocks, hk, B) fills the SMs at 28 key rows as at 128.
//  - No host arrays. Each block computes its window from index arithmetic
//    and the composite weights of its rows and columns from the coordinates
//    and periods into shared memory, in chunks of at most CH enc rows and
//    columns (one chunk each at the ratios the port serves); every thread
//    of the grid also writes a share of the two tables. Coordinates and
//    angles take the f32 operations of rope.py's _axis_coords and
//    RoPE._angles in the same order, and sinf / cosf (no fast math), so the
//    tables equal RoPE.tables on the card.

#include <algorithm>
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;  // most enc rows (columns) of a window weighted per chunk: rope_keys.CH
constexpr int MAX_THREADS = 256;
constexpr float TWO_PI = 6.28318530717958647692f;  // f32(2 pi), as torch rounds the scalar

struct Args {
  const float* periods;
  float* rows_tab;
  float* cols_tab;
  int B, hi, wi, oh, ow, hk, wk, C, dh;
  int GB, R, KX, rch, cch;  // groups, row split and key columns a block; chunk rows, columns
};

// The adaptive window of output o when n items pool onto m: [win_lo, win_hi),
// in 32-bit arithmetic (the entry point keeps (every size + 1)^2 below 2^31).
__device__ __forceinline__ int win_lo(int o, int n, int m) {
  return (int)((unsigned)(o * n) / (unsigned)m);
}
__device__ __forceinline__ int win_hi(int o, int n, int m) {
  return (int)((unsigned)((o + 1) * n + m - 1) / (unsigned)m);
}

// RoPE's angle at position y of an axis of n (rope.py: _axis_coords, then
// RoPE._angles), in its f32 operations and order.
__device__ __forceinline__ float angle(int y, int n, float period) {
  const float coord = 2.0f * ((float)y + 0.5f) / (float)n - 1.0f;
  return (TWO_PI * coord) / period;
}

// The composite weights of enc position e along one axis for the key whose
// middle window is [y0, y1) (n_in enc positions pooled onto n_mid): the sum
// over the middle positions y of that window whose own window holds e of
// 1 / ((y1 - y0) * |window of y|) into `plain`, and of the same times
// e^(i theta(y)) into `angled`. The y whose window holds e are the window of
// e pooled the other way.
__device__ void axis_weights(int e, int y0, int y1, int n_in, int n_mid, float period,
                             float2& angled, float& plain) {
  const int lo = max(y0, win_lo(e, n_mid, n_in)), hi = min(y1, win_hi(e, n_mid, n_in));
  const float inv_k = 1.0f / (float)(y1 - y0);
  angled = make_float2(0.f, 0.f);
  plain = 0.f;
  for (int y = lo; y < hi; ++y) {
    const float p = inv_k / (float)(win_hi(y, n_in, n_mid) - win_lo(y, n_in, n_mid));
    float s, c;
    sincosf(angle(y, n_mid, period), &s, &c);
    angled.x += p * c;
    angled.y += p * s;
    plain += p;
  }
}

// V elements of T at p into f32, by the widest aligned vector loads.
template <int W>
__device__ __forceinline__ void ld_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void st_words(void* p, const uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    *reinterpret_cast<unsigned*>(p) = w[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2],
                                                  w[4 * q + 3]);
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[V]) {
  uint32_t w[V / 2];
  ld_words<V / 2>(p, w);
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  uint32_t w[V];
  ld_words<V>(p, w);
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = __uint_as_float(w[k]);
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
  uint32_t w[V / 2];
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  st_words<V / 2>(p, w);
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* x) {
  uint32_t w[V];
#pragma unroll
  for (int k = 0; k < V; ++k) w[k] = __float_as_uint(x[k]);
  st_words<V>(p, w);
}

// This thread's share of rows_tab and cols_tab: element by element over the
// whole grid. Row-angle slots of the row table and column-angle slots of the
// column table carry cos / sin of their angle, every other slot 1.
__device__ void write_tables(const Args& a) {
  const long long nthreads = (long long)gridDim.x * gridDim.y * gridDim.z * blockDim.x;
  const long long tid =
      ((long long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  // 32-bit offsets: the entry point keeps (oh + ow) * 2C below 2^31
  const unsigned c2 = 2 * a.C, half = a.dh >> 1, nf = a.dh >> 2, nrow = a.oh * c2;
  for (long long e = tid; e < nrow + a.ow * c2; e += nthreads) {
    const bool row = e < nrow;
    const unsigned off = (unsigned)(row ? e : e - nrow);
    const unsigned pos = off / c2, cc = off % c2;
    const unsigned j = (cc % a.C) % a.dh;  // channel of its RoPE head
    float val = 1.0f;
    if ((j % half >= nf) != row) {  // the row table's row slots, the column table's columns
      const float ang = angle((int)pos, row ? a.oh : a.ow, __ldg(a.periods + j % nf));
      val = cc >= (unsigned)a.C ? sinf(ang) : cosf(ang);
    }
    (row ? a.rows_tab : a.cols_tab)[off] = val;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) rope_keys_kernel(const T* __restrict__ enc,
                                                                T* __restrict__ keys, Args a) {
  write_tables(a);

  const int half = a.dh >> 1, nf = a.dh >> 2;
  const int gblocks = (a.C / (2 * V) + a.GB - 1) / a.GB;
  const int gl = threadIdx.x % a.GB;
  const int kxl = (threadIdx.x / a.GB) % a.KX;
  const int r = threadIdx.x / (a.GB * a.KX);
  const int g = (blockIdx.x % gblocks) * a.GB + gl;  // channel group
  const int kx0 = (blockIdx.x / gblocks) * a.KX;
  const int kx = kx0 + kxl, ky = blockIdx.y, b = blockIdx.z;
  const bool active = g < a.C / (2 * V) && kx < a.wk;
  const int hg = half / V;              // groups a head
  const int cl0 = (g % hg) * V;         // first channel of the head's first half
  const int c0 = (g / hg) * a.dh + cl0; // its partners from c0 + half

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2* roww = reinterpret_cast<float2*>(smem);  // [rch][half] complex weights of enc rows
  float2* colw = roww + a.rch * half;              // [KX][cch][half] of enc columns

  // the key row's middle rows [y0, y1) and enc rows; each key column's
  // middle columns and enc columns, and the widest
  const int y0 = win_lo(ky, a.oh, a.hk), y1 = win_hi(ky, a.oh, a.hk);
  const int i_lo = win_lo(y0, a.hi, a.oh), i_hi = win_hi(y1 - 1, a.hi, a.oh);
  __shared__ int4 kwin[MAX_THREADS];
  if (threadIdx.x < a.KX) {
    const int k = kx0 + threadIdx.x;
    int4 w = make_int4(0, 1, 0, 0);
    if (k < a.wk) {
      w.x = win_lo(k, a.ow, a.wk);
      w.y = win_hi(k, a.ow, a.wk);
      w.z = win_lo(w.x, a.wi, a.ow);
      w.w = win_hi(w.y - 1, a.wi, a.ow);
    }
    kwin[threadIdx.x] = w;
  }
  __syncthreads();
  int jspan = 0;
  for (int t = 0; t < a.KX; ++t) jspan = max(jspan, kwin[t].w - kwin[t].z);
  const int j_lo = kwin[kxl].z, j_n = kwin[kxl].w - j_lo;

  float acc[2 * V];  // the keys of c0.. and of their partners: V complex numbers
#pragma unroll
  for (int e = 0; e < 2 * V; ++e) acc[e] = 0.f;
  const size_t row_stride = (size_t)a.wi * a.C;
  const T* base = enc + (size_t)b * a.hi * row_stride + c0;

  for (int rc = i_lo; rc < i_hi; rc += a.rch) {
    const int nr = min(a.rch, i_hi - rc);
    for (int cc = 0; cc < jspan; cc += a.cch) {
      __syncthreads();  // the previous chunk's weights are read
      // per (position, frequency f): the angled weight of the channel whose
      // angle lies on this axis (row f, column nf + f) and the plain one of
      // the other (row nf + f, column f)
      for (int e = threadIdx.x; e < nr * nf; e += blockDim.x) {
        const int ii = e / nf, f = e % nf;
        float2 w;
        float p;
        axis_weights(rc + ii, y0, y1, a.hi, a.oh, __ldg(a.periods + f), w, p);
        roww[ii * half + f] = w;
        roww[ii * half + nf + f] = make_float2(p, 0.f);
      }
      for (int e = threadIdx.x; e < a.KX * a.cch * nf; e += blockDim.x) {
        const int t = e / (a.cch * nf), jj = (e / nf) % a.cch, f = e % nf;
        const int4 kw = kwin[t];
        float2 w = make_float2(0.f, 0.f);
        float p = 0.f;
        if (kw.z + cc + jj < kw.w)
          axis_weights(kw.z + cc + jj, kw.x, kw.y, a.wi, a.ow, __ldg(a.periods + f), w, p);
        float2* q = colw + (t * a.cch + jj) * half;
        q[f] = make_float2(p, 0.f);
        q[nf + f] = w;
      }
      __syncthreads();
      if (!active) continue;
      const int ncol = min(a.cch, j_n - cc);
      const float4* qw = reinterpret_cast<const float4*>(colw + (kxl * a.cch) * half + cl0);
      for (int i = rc + r; i < rc + nr; i += a.R) {
        float sc[V], sp[V];  // row i's column sum: sum_j Q(j) z[i, j]
#pragma unroll
        for (int e = 0; e < V; ++e) sc[e] = sp[e] = 0.f;
        const T* px = base + (size_t)i * row_stride + (size_t)(j_lo + cc) * a.C;
#pragma unroll 4
        for (int jj = 0; jj < ncol; ++jj) {
          float xc[V], xp[V];
          load<V>(px + (size_t)jj * a.C, xc);
          load<V>(px + (size_t)jj * a.C + half, xp);
          const float4* q = qw + (size_t)jj * (half / 2);
#pragma unroll
          for (int e = 0; e < V; e += 2) {
            const float4 w = q[e / 2];  // Q of channels e and e + 1
            sc[e] += w.x * xc[e] - w.y * xp[e];
            sp[e] += w.x * xp[e] + w.y * xc[e];
            sc[e + 1] += w.z * xc[e + 1] - w.w * xp[e + 1];
            sp[e + 1] += w.z * xp[e + 1] + w.w * xc[e + 1];
          }
        }
        const float4* rw = reinterpret_cast<const float4*>(roww + (i - rc) * half + cl0);
#pragma unroll
        for (int e = 0; e < V; e += 2) {
          const float4 w = rw[e / 2];  // R of channels e and e + 1
          acc[e] += w.x * sc[e] - w.y * sp[e];
          acc[V + e] += w.x * sp[e] + w.y * sc[e];
          acc[e + 1] += w.z * sc[e + 1] - w.w * sp[e + 1];
          acc[V + e + 1] += w.z * sp[e + 1] + w.w * sc[e + 1];
        }
      }
    }
  }

  // the R row splits' partial keys meet in shared memory
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int e = 0; e < 2 * V; e += 4)
    red[threadIdx.x * (V / 2) + e / 4] = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  __syncthreads();
  if (r != 0 || !active) return;
  for (int rr = 1; rr < a.R; ++rr) {
    const float4* o = red + (threadIdx.x + rr * a.GB * a.KX) * (V / 2);
#pragma unroll
    for (int e = 0; e < 2 * V; e += 4) {
      const float4 v = o[e / 4];
      acc[e] += v.x;
      acc[e + 1] += v.y;
      acc[e + 2] += v.z;
      acc[e + 3] += v.w;
    }
  }
  T* out = keys + (((size_t)b * a.hk + ky) * a.wk + kx) * a.C + c0;
  store<V>(out, acc);
  store<V>(out + half, acc + V);
}

template <typename T, int V>
int launch(const void* enc, void* keys, const Args& a, int smem, cudaStream_t s) {
  const int groups = a.C / (2 * V);
  const dim3 grid(((a.wk + a.KX - 1) / a.KX) * ((groups + a.GB - 1) / a.GB), a.hk, a.B);
  auto* kern = rope_keys_kernel<T, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, a.GB * a.R * a.KX, smem, s>>>(static_cast<const T*>(enc), static_cast<T*>(keys),
                                             a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int v, const void* enc, void* keys, const Args& a, int smem, cudaStream_t s) {
  switch (v) {
    case 8: return launch<T, 8>(enc, keys, a, smem, s);
    case 4: return launch<T, 4>(enc, keys, a, smem, s);
    case 2: return launch<T, 2>(enc, keys, a, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// enc (B, hi, wi, C) and keys (B, hk, wk, C) in bf16 (is_bf16) or f32,
// contiguous and 16-byte aligned; periods (dh / 4) f32; rows_tab (oh, 2C) and
// cols_tab (ow, 2C) f32. v channels a thread run, gb groups, r row splits and
// kx key columns a block, rch / cch rows / columns a chunk and smem bytes as
// rope_keys.py's _plan computes them; a launch outside these rules is refused.
int naf_rope_keys(const void* enc, const void* periods, void* keys, void* rows_tab,
                  void* cols_tab, int B, int hi, int wi, int oh, int ow, int hk, int wk, int C,
                  int dh, int v, int gb, int r, int kx, int rch, int cch, int smem, int is_bf16,
                  void* stream) {
  const int size = std::max({hi, wi, oh, ow, hk, wk});
  if (B <= 0 || hi <= 0 || wi <= 0 || oh <= 0 || ow <= 0 || hk <= 0 || wk <= 0 || dh <= 0 ||
      dh % 4 || C % dh || (v != 8 && v != 4 && v != 2) || (dh / 2) % v || gb <= 0 ||
      gb > C / (2 * v) || r <= 0 || kx <= 0 || gb * r * kx > MAX_THREADS || rch <= 0 ||
      rch > CH || cch <= 0 || cch > CH || hk > 65535 || B > 65535 ||
      (long long)(size + 1) * (size + 1) >= INT_MAX ||
      2LL * C * (oh + ow) >= INT_MAX ||
      (long long)smem < 4LL * gb * r * kx * 2 * v ||
      (long long)smem < 8LL * (rch + kx * cch) * (dh / 2))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(periods), static_cast<float*>(rows_tab),
               static_cast<float*>(cols_tab), B, hi, wi, oh, ow, hk, wk, C, dh, gb, r, kx, rch,
               cch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(v, enc, keys, a, smem, s);
  return dispatch<float>(v, enc, keys, a, smem, s);
}

}  // extern "C"
