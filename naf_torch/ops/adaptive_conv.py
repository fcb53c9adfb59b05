"""Spatially varying convolution and window unfolding, NHWC (counterpart of
``naf_tpu/ops/adaptive_conv.py``).

``adaptive_conv`` stands in for FeatUp's AdaptiveConv CUDA extension: a
per-pixel k x k kernel applied to a padded source. It is a
``torch.autograd.Function``: its forward is kernel K5 on CUDA tensors and
K5's plain version on CPU tensors (``kernels.adaptive_conv_fused``); its
backward is the JAX package's plain formulas, one pass per tap in f32:

    d_source[u, v, c]    = sum_{i,j} kernel[u-i, v-j, i, j] * g[u-i, v-j, c]
    d_kernel[y, x, i, j] = sum_c source[y+i, x+j, c] * g[y, x, c]

``unfold_nhwc`` stacks the k x k neighbourhoods as a window axis (torch
``nn.Unfold`` order), and ``reflect_pad2d`` pads the two spatial axes.
"""

from __future__ import annotations

import torch

from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused

__all__ = ["adaptive_conv", "unfold_nhwc", "reflect_pad2d"]


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the two spatial axes of a ...HWC tensor (one gather)."""
    if pad == 0:
        return x
    h, w = x.shape[-3], x.shape[-2]
    if pad >= min(h, w):
        raise ValueError(f"reflect padding {pad} needs H, W > {pad}, got {h}x{w}")
    ih = _reflect_index(h, pad, x.device)
    iw = _reflect_index(w, pad, x.device)
    return x[..., ih[:, None], iw, :]


def unfold_nhwc(x: torch.Tensor, diameter: int) -> torch.Tensor:
    """(B, H+2r, W+2r, C) padded input -> (B, k*k, H, W, C) windows, window
    p = i * k + j at row-major offset (i, j)."""
    h = x.shape[1] - (diameter - 1)
    w = x.shape[2] - (diameter - 1)
    return torch.stack([x[:, i : i + h, j : j + w, :]
                        for i in range(diameter) for j in range(diameter)], dim=1)


class _AdaptiveConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, source_padded, kernel):
        ctx.save_for_backward(source_padded, kernel)
        return adaptive_conv_fused(source_padded, kernel)

    @staticmethod
    def backward(ctx, g):
        source_padded, kernel = ctx.saved_tensors
        b, hp, wp, c = source_padded.shape
        kh, kw = kernel.shape[3], kernel.shape[4]
        h, w = hp - kh + 1, wp - kw + 1
        gf = g.float()
        d_src = d_ker = None
        if ctx.needs_input_grad[0]:
            d_src = torch.zeros((b, hp, wp, c), dtype=torch.float32, device=g.device)
            for i in range(kh):
                for j in range(kw):
                    d_src[:, i : i + h, j : j + w] += gf * kernel[:, :, :, i, j, None].float()
            d_src = d_src.to(source_padded.dtype)
        if ctx.needs_input_grad[1]:
            d_ker = torch.empty((b, h, w, kh, kw), dtype=torch.float32, device=g.device)
            for i in range(kh):
                for j in range(kw):
                    win = source_padded[:, i : i + h, j : j + w].float()
                    d_ker[..., i, j] = (win * gf).sum(-1)
            d_ker = d_ker.to(kernel.dtype)
        return d_src, d_ker


def adaptive_conv(source_padded: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-pixel convolution (FeatUp AdaptiveConv semantics, NHWC).

    source_padded (B, H+k-1, W+k-1, C), kernel (B, H, W, k, k) -> (B, H, W, C)
    in ``promote(source, kernel)``; differentiable in both inputs."""
    return _AdaptiveConv.apply(source_padded, kernel)
