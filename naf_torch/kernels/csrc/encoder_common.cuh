// Helpers shared by the fused encoder-layer kernels (K1 encoder_fused.cu and
// K6 encoder_dual.cu): io-dtype conversions, 8-channel stores, torch's
// reflect rule as index math, and the GroupNorm-affine + SiLU prologue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The activated input rounds to the io dtype before the contraction, as the
// JAX kernels do before their dots.
template <typename T> __device__ __forceinline__ float round_io(float v);
template <> __device__ __forceinline__ float round_io<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_io<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// SiLU(x * scale + shift) in f32, rounded to the io dtype.
template <typename T>
__device__ __forceinline__ float affine_silu(T x, float scale, float shift) {
  const float z = to_f(x) * scale + shift;
  return round_io<T>(z / (1.f + expf(-z)));
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                 pack_bf16x2(v[6], v[7]));
}

// torch's reflect rule; the clamp only matters for ragged-tile pixels whose
// outputs are never stored.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

}  // namespace
