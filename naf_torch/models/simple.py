"""Trivial upsampler baselines, NHWC (counterpart of ``naf_tpu/models/simple.py``)."""

from __future__ import annotations

from torch import nn

from naf_torch.ops.resize import resize_bilinear, resize_nearest_exact

__all__ = ["Bilinear", "Nearest"]


class Bilinear(nn.Module):
    def forward(self, image, features, output_size, *args, **kwargs):
        return resize_bilinear(features, output_size)


class Nearest(nn.Module):
    def forward(self, image, features, output_size, *args, **kwargs):
        return resize_nearest_exact(features, output_size)
