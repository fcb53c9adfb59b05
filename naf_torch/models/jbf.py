"""Joint bilateral filter upsampler, NHWC (counterpart of ``naf_tpu/models/jbf.py``).

kornia's ``joint_bilateral_blur`` as an unfold and a Gaussian weighting over
a small fixed window, in plain torch as in the JAX package. Pipeline: a 4x
bilinear pre-upsample, the filter guided by the normalized image, a bilinear
resize to the output size.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from naf_torch.ops.adaptive_conv import reflect_pad2d, unfold_nhwc
from naf_torch.ops.resize import resize_bilinear
from naf_torch.utils.spans import to_device

__all__ = ["JBF", "joint_bilateral_blur"]


def joint_bilateral_blur(inp: torch.Tensor, guidance: torch.Tensor, kernel_size: int = 5,
                         sigma_color: float = 0.1, sigma_space: float = 1.5) -> torch.Tensor:
    """kornia.filters.joint_bilateral_blur semantics, NHWC, reflect border."""
    r = kernel_size // 2
    gw = unfold_nhwc(reflect_pad2d(guidance, r), kernel_size)  # (B, k2, H, W, C)
    diff2 = ((gw - guidance[:, None]) ** 2).sum(-1)  # (B, k2, H, W)
    color_kernel = torch.exp(-0.5 / (sigma_color ** 2) * diff2)

    ax = np.arange(kernel_size, dtype=np.float32) - r
    g1 = np.exp(-0.5 * (ax / sigma_space) ** 2)
    space = (g1[:, None] * g1[None, :]).reshape(-1)
    space = to_device(space / space.sum(), inp.device, inp.dtype)

    kernel = color_kernel * space[None, :, None, None]
    kernel = kernel / kernel.sum(1, keepdim=True)
    iw = unfold_nhwc(reflect_pad2d(inp, r), kernel_size)  # (B, k2, H, W, C)
    return (iw * kernel[..., None]).sum(1)


class JBF(nn.Module):
    """The restorer contract ``forward(image_norm, image, output_size)``."""

    def __init__(self, kernel_size: int = 5, sigma_color: float = 0.1,
                 sigma_spatial: float = 1.5):
        super().__init__()
        self.kernel_size = kernel_size
        self.sigma_color = sigma_color
        self.sigma_spatial = sigma_spatial

    def forward(self, image_norm, image, output_size, *args, **kwargs):
        h, w = image.shape[1], image.shape[2]
        up = resize_bilinear(image, (h * 4, w * 4))
        guide = resize_bilinear(image_norm, (h * 4, w * 4))
        out = joint_bilateral_blur(up, guide, self.kernel_size, self.sigma_color,
                                   self.sigma_spatial)
        return resize_bilinear(out, output_size)
