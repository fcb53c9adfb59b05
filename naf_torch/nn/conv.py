"""Conv encoder stack, NHWC (counterpart of ``naf_tpu/nn/conv.py``).

``Encoder`` = entry conv + N ``EncBlock``s, where EncBlock is
GN -> SiLU -> conv -> GN -> SiLU -> conv with reflect padding (NAF's
default has no shortcut and no residual). Parameter names are the
reference state dict's: ``0`` is the stem, ``i.norm1 / conv1 / norm2 / conv2``
the blocks, as ``nn.Conv2d`` and ``nn.GroupNorm`` (eps 1e-5, contiguous
channel groups), so a reference checkpoint loads with ``load_state_dict``.

Modules take and return NHWC tensors; the NCHW views they hand to torch's
conv are permutations, not copies. GroupNorm runs as
:func:`group_norm_nhwc`: torch's own kernel reduces one (sample, group) row
per block, 8 blocks at batch 1, which took 2.5-5 ms per 448^2 layer on an
H100; ``torch.var_mean`` spreads the same statistics over the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ReflectConv", "EncBlock", "Encoder", "group_norm_nhwc"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def group_norm_nhwc(x: torch.Tensor, num_groups: int, weight=None, bias=None,
                    eps: float = 1e-5) -> torch.Tensor:
    """``F.group_norm`` of an NHWC tensor (contiguous channel groups, biased
    variance, f32 statistics), in x's dtype."""
    c = x.shape[-1]
    xg = x.unflatten(-1, (num_groups, c // num_groups)).float()
    dims = tuple(range(1, x.ndim - 1)) + (x.ndim,)
    var, mean = torch.var_mean(xg, dim=dims, correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).flatten(-2)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def _norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm_nhwc(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


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
    """With ``residual`` the block returns conv2(...) + its input, through a
    1x1 ``shortcut`` conv when ``conv_shortcut`` (JAFAR's blocks are
    residual, without a shortcut)."""

    def __init__(self, channels: int, kernel_size: int = 3, num_groups: int = 8,
                 bias: bool = True, residual: bool = False, conv_shortcut: bool = False):
        super().__init__()
        self.residual = residual
        self.norm1 = nn.GroupNorm(num_groups, channels, eps=1e-5)
        self.conv1 = ReflectConv(channels, channels, kernel_size, bias)
        self.norm2 = nn.GroupNorm(num_groups, channels, eps=1e-5)
        self.conv2 = ReflectConv(channels, channels, kernel_size, bias)
        if conv_shortcut:
            self.shortcut = ReflectConv(channels, channels, 1, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.silu(_norm(self.norm1, x)))
        y = self.conv2(F.silu(_norm(self.norm2, y)))
        if not self.residual:
            return y
        return y + (self.shortcut(x) if hasattr(self, "shortcut") else x)


class Encoder(nn.Sequential):
    """Entry conv + ``num_layers`` EncBlocks (reference ``encoder()``)."""

    def __init__(self, hidden_dim: int, in_channels: int = 3, kernel_size: int = 1,
                 ks_res: int = 1, num_layers: int = 2, num_groups: int = 8,
                 bias: bool = True, residual: bool = False):
        super().__init__(
            ReflectConv(in_channels, hidden_dim, kernel_size, bias),
            *[EncBlock(hidden_dim, ks_res, num_groups, bias, residual)
              for _ in range(num_layers)],
        )
        self.num_layers = num_layers
        self.num_groups = num_groups
        self.residual = residual
        self.eps = 1e-5
