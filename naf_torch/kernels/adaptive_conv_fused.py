"""Spatially varying convolution: kernel K5 and its plain version.

Counterpart of ``naf_tpu/kernels/adaptive_conv_fused.py``. FeatUp's
AdaptiveConv applies a per-pixel k x k kernel to an already padded source:

    out[b, y, x, :] = sum_{i,j} kernel[b, y, x, i, j] * source_padded[b, y+i, x+j, :]

with source_padded (B, H+k-1, W+k-1, C) and kernel (B, H, W, k, k). The
weights and the accumulation are f32; the output is in
``promote(source, kernel)``, as in the JAX package.

``csrc/adaptive_conv.cu`` reads the source and the weights once and writes
the output once; it takes any B, H, W, C and every odd k up to 15, in f32 or
bf16, and raises past that. :func:`adaptive_conv_fused` launches it on CUDA
tensors (count in ``adaptive_conv_fused.launches``) and takes the plain
version :func:`adaptive_conv_fused_ref` for CPU tensors only. The gradient is
``naf_torch.ops.adaptive_conv.adaptive_conv``'s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from naf_torch.kernels import _build

__all__ = ["adaptive_conv_fused", "adaptive_conv_fused_ref", "MAX_K"]

MAX_K = 15  # csrc/adaptive_conv.cu's naf_adaptive_conv_max_k()


def _shapes(source_padded, kernel):
    if source_padded.ndim != 4 or kernel.ndim != 5:
        raise ValueError("adaptive conv takes source (B, H+k-1, W+k-1, C) and "
                         "kernel (B, H, W, k, k)")
    b, hp, wp, c = source_padded.shape
    kh, kw = kernel.shape[3], kernel.shape[4]
    h, w = hp - kh + 1, wp - kw + 1
    if kernel.shape[:3] != (b, h, w):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit source "
                         f"{tuple(source_padded.shape)}")
    return b, h, w, c, kh, kw


def adaptive_conv_fused_ref(source_padded, kernel):
    """Plain version of K5: one multiply-add pass per tap, f32 weights and
    accumulation, ``promote(source, kernel)`` out."""
    b, h, w, c, kh, kw = _shapes(source_padded, kernel)
    dtype = torch.promote_types(source_padded.dtype, kernel.dtype)
    src = source_padded.to(dtype)
    wgt = kernel.float()
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=source_padded.device)
    for i in range(kh):
        for j in range(kw):
            acc += src[:, i : i + h, j : j + w, :].float() * wgt[:, :, :, i, j, None]
    return acc.to(dtype)


@functools.cache
def _lib():
    lib = _build.load("adaptive_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_adaptive_conv_max_k.argtypes = []
    lib.naf_adaptive_conv_max_k.restype = i32
    lib.naf_adaptive_conv.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    lib.naf_adaptive_conv.restype = i32
    if lib.naf_adaptive_conv_max_k() != MAX_K:
        raise RuntimeError("adaptive_conv.cu's largest k does not match MAX_K")
    return lib


def _launch(source_padded, kernel):
    """Launch K5 on CUDA tensors."""
    if source_padded.device.type != "cuda" or kernel.device != source_padded.device:
        raise ValueError(f"K5 launches on CUDA tensors on one device, got "
                         f"{source_padded.device} and {kernel.device}")
    b, h, w, c, kh, kw = _shapes(source_padded, kernel)
    if kh != kw or kh % 2 != 1 or kh > MAX_K:
        raise ValueError(f"K5 takes square kernels of odd size up to {MAX_K}, got {kh}x{kw}")
    if b > 65535:
        raise ValueError(f"K5 takes at most 65535 samples per launch, got {b}")
    dtype = torch.promote_types(source_padded.dtype, kernel.dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 computes in float32 or bfloat16, got {dtype}")
    src = source_padded.to(dtype).contiguous()
    wgt = kernel.float().contiguous()
    out = torch.empty((b, h, w, c), dtype=dtype, device=src.device)
    if out.numel() == 0:
        return out
    vec = int(c % 4 == 0 and src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(src.device):
        err = _lib().naf_adaptive_conv(
            src.data_ptr(), wgt.data_ptr(), out.data_ptr(), b, h, w, c, kh, vec,
            int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"adaptive_conv kernel launch failed: cudaError {err}")
    adaptive_conv_fused.launches += 1
    return out


def adaptive_conv_fused(source_padded, kernel):
    """Spatially varying conv (not differentiable; see ``ops.adaptive_conv``).

    source_padded (B, H+k-1, W+k-1, C), kernel (B, H, W, k, k) -> (B, H, W, C)
    in ``promote(source, kernel)``. CPU tensors take the plain version; CUDA
    tensors launch K5."""
    if source_padded.device.type == "cpu":
        return adaptive_conv_fused_ref(source_padded, kernel)
    return _launch(source_padded, kernel)


adaptive_conv_fused.launches = 0
