"""FeatUp and JBU baselines, NHWC (counterpart of ``naf_tpu/models/featup.py``).

``JBULearnedRange`` is a learned joint bilateral filter: a softmax range
kernel over the (2r+1)^2 window of a projected guidance, times a Gaussian
spatial kernel, applied to the bicubic-upsampled source by ``adaptive_conv``
(kernel K5 on CUDA tensors). ``FeatUp`` is a ChannelNorm and a stack of up to
four 2x JBU stages with a shared fixup projection, ``proj(x) * 0.1 + x``;
``JBU`` is one filter at the output size.

Module names are the reference's (``upsampler.up{1..4}.range_proj.{0,3}``,
``.fixup_proj.{0,3}``, ``range_temp``, ``sigma_spatial``,
``upsampler.fixup_proj.1``, ``norm.norm``), so
``naf_tpu.models.featup.featup_params_from_torch`` reads this module's
``state_dict()`` as it reads a hub checkpoint's; the reference's Dropout2d
slots are identities (inference). ``featup_state_dict_from_torch`` maps a
hub checkpoint to this module's state dict.
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from naf_torch.ops.adaptive_conv import adaptive_conv, reflect_pad2d
from naf_torch.ops.pool import adaptive_avg_pool2d
from naf_torch.ops.resize import resize_bicubic, resize_bilinear
from naf_torch.utils.spans import to_device

__all__ = ["Conv1x1", "JBULearnedRange", "JBUStack", "ChannelNorm", "FeatUp", "JBU",
           "featup_state_dict_from_torch"]


class Conv1x1(nn.Conv2d):
    """A 1x1 ``nn.Conv2d`` (weight (O, I, 1, 1)) applied to an NHWC tensor as
    a matmul, in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.flatten(1).to(x.dtype), b)


@functools.lru_cache(maxsize=16)
def _patch_sq(d: int) -> np.ndarray:
    """Squared distances of the d x d window on a [-1, 1] grid, row-major."""
    dist = np.linspace(-1, 1, d, dtype=np.float32)
    return (dist[:, None] ** 2 + dist[None, :] ** 2).reshape(-1)


def _proj(cin: int, cout: int) -> nn.Sequential:
    """The reference's Sequential(Conv2d, GELU, Dropout2d, Conv2d): convs at 0 and 3."""
    return nn.Sequential(Conv1x1(cin, cout), nn.GELU(), nn.Identity(), Conv1x1(cout, cout))


class JBULearnedRange(nn.Module):
    def __init__(self, guidance_dim: int = 3, key_dim: int = 32, radius: int = 3,
                 combine: bool = True):
        super().__init__()
        self.radius = radius
        self.combine = combine
        d = 2 * radius + 1
        self.range_proj = _proj(guidance_dim, key_dim)
        if combine:
            self.fixup_proj = _proj(d * d + guidance_dim, d * d)
        self.range_temp = nn.Parameter(torch.tensor(0.0))
        self.sigma_spatial = nn.Parameter(torch.tensor(1.0))

    def forward(self, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        # The filter runs in f32 whatever the input dtype, as in the JAX package.
        out_dtype = source.dtype
        source, guidance = source.float(), guidance.float()
        r = self.radius
        d = 2 * r + 1
        b, gh, gw = guidance.shape[:3]

        # learned range kernel over the window, (B, H, W, d^2): per window
        # row i, the d column offsets are a strided view of the padded rows,
        # so each row is one multiply-reduce, not d of them, and the
        # (B, d^2, H, W, key) unfold is never held
        proj = self.range_proj(guidance)
        padded = reflect_pad2d(proj, r)
        temp = torch.exp(self.range_temp.float()).clamp(1e-4, 1e4)
        rows = [(padded[:, i : i + gh].unfold(2, d, 1) * proj[..., None]).sum(-2)
                for i in range(d)]  # each (B, H, W, d), offset j last
        kernel = torch.softmax(torch.cat(rows, dim=-1) * temp, dim=-1)

        # Gaussian spatial kernel
        patch_sq = to_device(_patch_sq(d), kernel.device)
        spatial = torch.exp(-patch_sq / (2 * self.sigma_spatial.float() ** 2))
        kernel = kernel * spatial
        kernel = kernel / kernel.sum(-1, keepdim=True).clamp_min(1e-7)

        if self.combine:
            # both terms use the kernel before the fixup
            kernel = kernel + 0.1 * self.fixup_proj(torch.cat([kernel, guidance], dim=-1))

        hr_source = resize_bicubic(source, (gh, gw))
        out = adaptive_conv(reflect_pad2d(hr_source, r), kernel.reshape(b, gh, gw, d, d))
        return out.to(out_dtype)


class JBUStack(nn.Module):
    def __init__(self, feat_dim: int, ratio: int = 16):
        super().__init__()
        if ratio not in (2, 4, 8, 16):
            raise ValueError("ratio must be one of 2/4/8/16 (reference JBUStack assert, "
                             "src/model/featup.py:32)")
        self.ratio = ratio
        self.up1 = JBULearnedRange(3, 32, radius=3)
        self.up2 = JBULearnedRange(3, 32, radius=3)
        self.up3 = JBULearnedRange(3, 32, radius=3)
        self.up4 = JBULearnedRange(3, 32, radius=3)
        self.fixup_proj = nn.Sequential(nn.Identity(), Conv1x1(feat_dim, feat_dim))

    def forward(self, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        n = {2: 1, 4: 2, 8: 3, 16: 4}[self.ratio]
        x = source
        for up in (self.up1, self.up2, self.up3, self.up4)[:n]:
            h, w = x.shape[1], x.shape[2]
            x = up(x, adaptive_avg_pool2d(guidance, (2 * h, 2 * w)))
        # The reference applies the fixup after every stage, feeds the next
        # stage the unfixed x and returns the last fixup only: that one is
        # all that is computed here.
        return self.fixup_proj(x) * 0.1 + x


class ChannelNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class FeatUp(nn.Module):
    """``forward(image, features, output_size)``: the output is ``ratio``
    times the feature grid, whatever ``output_size`` says (as in the
    reference)."""

    def __init__(self, feature_dim: int = 384, ratio: int = 16, use_norm: bool = True):
        super().__init__()
        self.use_norm = use_norm
        if use_norm:
            self.norm = ChannelNorm(feature_dim)
        self.upsampler = JBUStack(feature_dim, ratio)

    def forward(self, image, features, output_size=None, *args, **kwargs):
        if self.use_norm:
            features = self.norm(features)
        return self.upsampler(features, image)


class JBU(nn.Module):
    """Single learned-JBU filtering baseline; the restorer contract
    ``forward(image_norm, image, output_size)``."""

    def __init__(self, dim: int = 256, radius: int = 5, combine: bool = False):
        super().__init__()
        self.bilateral_filter = JBULearnedRange(3, dim // 4, radius=radius, combine=combine)

    def forward(self, image_norm, image, output_size, *args, **kwargs):
        guidance = resize_bilinear(image_norm, output_size)
        source = resize_bilinear(image, output_size)
        return self.bilateral_filter(source, guidance)


def featup_state_dict_from_torch(state: Mapping) -> dict:
    """FeatUp hub checkpoint -> this module's state dict: the reference's
    load-time remap (keep ``upsampler.*`` and ``model.1.norm.*`` of
    ``state["state_dict"]``, rename ``model.1.`` -> ``norm.``)."""
    if "state_dict" in state:
        state = state["state_dict"]
    return {k.replace("model.1.", "norm."): to_device(v, "cpu", torch.float32).detach()
            for k, v in state.items() if "upsampler" in k or "model.1.norm" in k}
