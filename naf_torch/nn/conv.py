"""Conv encoder stack, NHWC (counterpart of ``naf_tpu/nn/conv.py``).

``Encoder`` = entry conv + N ``EncBlock``s, where EncBlock is
GN -> SiLU -> conv -> GN -> SiLU -> conv with reflect padding (NAF's
default has no shortcut and no residual). Parameter names are the
reference state dict's: ``0`` is the stem, ``i.norm1 / conv1 / norm2 / conv2``
the blocks, as ``nn.Conv2d`` and ``nn.GroupNorm`` (eps 1e-5, contiguous
channel groups), so a reference checkpoint loads with ``load_state_dict``.

Modules take and return NHWC tensors; the NCHW views they hand to torch's
conv and GroupNorm are permutations, not copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ReflectConv", "EncBlock", "Encoder"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ReflectConv(nn.Conv2d):
    """Conv2d with 'same' reflect padding (torch ``padding_mode='reflect'``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.kernel_size[0] // 2
        xc = _nchw(x)
        if p:
            xc = F.pad(xc, (p, p, p, p), mode="reflect")
        return _nhwc(F.conv2d(xc, self.weight, self.bias))


class EncBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, num_groups: int = 8,
                 bias: bool = True):
        super().__init__()
        self.norm1 = nn.GroupNorm(num_groups, channels, eps=1e-5)
        self.conv1 = ReflectConv(channels, channels, kernel_size, bias)
        self.norm2 = nn.GroupNorm(num_groups, channels, eps=1e-5)
        self.conv2 = ReflectConv(channels, channels, kernel_size, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(F.silu(_nhwc(self.norm1(_nchw(x)))))
        return self.conv2(F.silu(_nhwc(self.norm2(_nchw(x)))))


class Encoder(nn.Sequential):
    """Entry conv + ``num_layers`` EncBlocks (reference ``encoder()``)."""

    def __init__(self, hidden_dim: int, in_channels: int = 3, kernel_size: int = 1,
                 ks_res: int = 1, num_layers: int = 2, num_groups: int = 8,
                 bias: bool = True):
        super().__init__(
            ReflectConv(in_channels, hidden_dim, kernel_size, bias),
            *[EncBlock(hidden_dim, ks_res, num_groups, bias) for _ in range(num_layers)],
        )
        self.num_layers = num_layers
        self.num_groups = num_groups
        self.eps = 1e-5
