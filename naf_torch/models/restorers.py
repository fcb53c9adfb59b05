"""Image-restoration baselines IRCNN and REDNet, NHWC (counterpart of
``naf_tpu/models/restorers.py``; reference src/model/ircnn.py:27-67,
src/model/rednet.py:11-59).

Both take the restoration contract ``forward(noisy_norm, noisy,
output_size)`` and predict the noise residual. IRCNN: seven 3 x 3 convs,
dilations 1, 2, 3, 4, 3, 2, 1. REDNet: a stride-2 conv encoder and a
transposed-conv decoder with a skip every other layer.

The JAX decoder is flax's ``ConvTranspose``, which does not flip its kernel
(``transpose_kernel=False``): with explicit padding (1, 1) and stride 1 it
is a plain 3 x 3 convolution with padding 1 (``deconv{i}`` are ``Conv2d``
here); its last layer, stride 2 with "SAME" padding, is a convolution of
the input dilated by 2 and padded (2, 1) (``lax.conv_transpose``'s rule),
which is torch's ``conv_transpose2d`` at stride 2, padding 0, with the
kernel flipped and the last output row and column dropped: 2n out of n in,
at even and odd n. ``naf_torch.convert.rednet_state_dict_from_jax`` flips
that kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from naf_torch.ops.resize import resize_bilinear

__all__ = ["IRCNN", "REDNet", "SameConvTranspose2d"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _input(noisy, output_size):
    if output_size and tuple(noisy.shape[1:3]) != tuple(output_size):
        return resize_bilinear(noisy, tuple(output_size))
    return noisy


class IRCNN(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 64):
        super().__init__()
        self.dilations = (1, 2, 3, 4, 3, 2, 1)
        self.convs = nn.ModuleList(
            nn.Conv2d(in_nc if i == 0 else nc, out_nc if i == 6 else nc, 3, padding=dil,
                      dilation=dil)
            for i, dil in enumerate(self.dilations))

    def forward(self, noisy_norm, noisy, output_size: Optional[Tuple[int, int]] = None):
        x = _input(noisy, output_size)
        inp = x
        y = _nchw(x)
        for i, conv in enumerate(self.convs):
            y = conv(y)
            if i < 6:
                y = F.relu(y)
        return inp - _nhwc(y)  # predicts the noise (ircnn.py:64-67)


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``ConvTranspose(stride=s, padding="SAME")`` on NCHW tensors:
    ``conv_transpose2d`` at padding 0, cut to s * n per axis. The weight is
    torch's (in, out, kh, kw), the flax kernel flipped."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)

    def forward(self, x):
        s = self.stride[0]
        h, w = x.shape[-2] * s, x.shape[-1] * s
        y = super().forward(x)
        # torch pads the dilated input by k - 1 before its flipped kernel,
        # lax.conv_transpose by pad_a: output i of flax is output
        # i + k - 1 - pad_a of torch
        lead = self.kernel_size[0] - 1 - _same_pad_before(self.kernel_size[0], s)
        return y[..., lead : lead + h, lead : lead + w]


def _same_pad_before(k: int, s: int) -> int:
    """The leading pad of ``lax.conv_transpose``'s "SAME" rule."""
    return k - 1 if s > k - 1 else math.ceil((k + s - 2) / 2)


class REDNet(nn.Module):
    def __init__(self, input_dim: int = 3, num_layers: int = 15, num_features: int = 64):
        super().__init__()
        self.num_layers = num_layers
        self.convs = nn.ModuleList(
            nn.Conv2d(input_dim if i == 0 else num_features, num_features, 3,
                      stride=2 if i == 0 else 1, padding=1)
            for i in range(num_layers))
        self.deconvs = nn.ModuleList(
            nn.Conv2d(num_features, num_features, 3, padding=1) for _ in range(num_layers - 1))
        self.deconvs.append(SameConvTranspose2d(num_features, input_dim, 3, stride=2))
        self.n_skips = math.ceil(num_layers / 2) - 1

    def forward(self, noisy_norm, noisy, output_size: Optional[Tuple[int, int]] = None):
        x = _input(noisy, output_size)
        residual = x
        y = _nchw(x)
        feats = []
        for i, conv in enumerate(self.convs):
            y = F.relu(conv(y))
            if (i + 1) % 2 == 0 and len(feats) < self.n_skips:
                feats.append(y)
        skip = 0
        for i, deconv in enumerate(self.deconvs):
            last = i == self.num_layers - 1
            y = deconv(y)
            if not last:
                y = F.relu(y)
            if (i + 1 + self.num_layers) % 2 == 0 and skip < len(feats):
                y = y + feats[-(skip + 1)]
                skip += 1
                if not last:
                    y = F.relu(y)
        return residual - _nhwc(y)  # predicts the noise (rednet.py:57-59)
