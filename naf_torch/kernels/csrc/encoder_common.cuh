// Helpers shared by the fused encoder-layer kernels (K1 encoder_fused.cu and
// K6 encoder_dual.cu): the f32 kernels' io conversions, 8-channel stores and
// GroupNorm-affine + SiLU prologue, bf16 packing, and torch's reflect rule as
// index math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }

// SiLU(x * scale + shift) in f32. The JAX kernels round the activated input
// to the io dtype before their dots; in f32 that is no rounding.
__device__ __forceinline__ float affine_silu(float x, float scale, float shift) {
  const float z = x * scale + shift;
  return z / (1.f + expf(-z));
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

// torch's reflect rule; the clamp only matters for ragged-tile pixels whose
// outputs are never stored.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

}  // namespace
