"""Vision Transformer for frozen feature extraction: the DINOv2 variant
(counterpart of ``naf_tpu/backbones/vit.py``), NHWC.

``(B, H, W, 3) normalised image -> (B, H/ps, W/ps, C)`` patch features of
the last block, layer-normed (timm ``forward_intermediates(n=1, norm=True)``
semantics). The DINOv2 family: conv patchify, a cls token, learned position
embeddings on a ``pos_grid`` x ``pos_grid`` grid resized to the image's
patch grid, pre-norm blocks with LayerScale, LayerNorm eps 1e-6, GELU MLP,
no register tokens, no RoPE. Parameter names are timm's, so a timm
checkpoint loads with ``load_state_dict``.

The position grid is resized as the JAX package resizes it,
``jax.image.resize(..., "bicubic")``: Keys' cubic kernel with a = -0.5, and,
when shrinking, antialiased (the kernel widened by the inverse scale and
each output's weights renormalised). That is not ``F.interpolate(mode=
"bicubic")`` (a = -0.75, no antialias), so the per-axis weight matrices are
built on the host (:func:`resize_weights`). Plain torch ops throughout: the
JAX ViT runs no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ViT", "ViTConfig", "resize_weights", "resize_bicubic_jax"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    layerscale: bool = True
    ln_eps: float = 1e-6
    pos_grid: int = 37  # position-embedding grid side at pretraining time


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) f32 weights of ``jax.image.resize(..., "bicubic")`` on one
    axis (scale-and-translate with antialiasing, translation 0)."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T).astype(np.float32)


def resize_bicubic_jax(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the (H, W) axes of a (B, H, W, C) tensor as
    ``jax.image.resize(x, (B, *size, C), "bicubic")`` does, in f32."""
    h, w = x.shape[1], x.shape[2]
    wh = torch.from_numpy(resize_weights(h, int(size[0]))).to(x.device)
    ww = torch.from_numpy(resize_weights(w, int(size[1]))).to(x.device)
    return torch.einsum("oh,bhwc,pw->bopc", wh, x.float(), ww)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        n = self.num_heads
        d = c // n
        qkv = self.qkv(x).reshape(b, t, 3, n, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (d ** -0.5), qkv[1], qkv[2]
        # the softmax runs in f32, its weights in the io dtype (as in JAX)
        w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(x.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, t, c)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, layerscale: bool,
                 ln_eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim) if layerscale else nn.Identity()
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim) if layerscale else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class ViT(nn.Module):
    """DINOv2-style ViT with timm parameter names."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        c = config.embed_dim
        self.config = config
        self.patch_embed = PatchEmbed(config.patch_size, c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + config.pos_grid ** 2, c))
        self.blocks = nn.ModuleList(
            Block(c, config.num_heads, config.mlp_ratio, config.layerscale, config.ln_eps)
            for _ in range(config.depth))
        self.norm = nn.LayerNorm(c, eps=config.ln_eps)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights, as the JAX package's random init draws
        them: lecun-normal kernels, zero biases, position embeddings
        N(0, 0.02), zero cls token, LayerScale and LayerNorm scales of one."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, LayerScale):
                    m.gamma.fill_(1.0)
            normal(self.pos_embed, 0.02)
            self.cls_token.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/ps, W/ps, C) last-block patch features."""
        cfg = self.config
        b, h, w, _ = x.shape
        ps = cfg.patch_size
        if h % ps or w % ps:
            raise ValueError(f"image size {(h, w)} not divisible by patch {ps}")
        gh, gw = h // ps, w // ps
        c = cfg.embed_dim
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C)
        pos = self.pos_embed
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        if (gh, gw) != (cfg.pos_grid, cfg.pos_grid):
            grid = patch_pos.reshape(1, cfg.pos_grid, cfg.pos_grid, c)
            patch_pos = resize_bicubic_jax(grid, (gh, gw)).to(pos.dtype).reshape(1, gh * gw, c)
        x = x + patch_pos
        cls = (self.cls_token + cls_pos).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1:].reshape(b, gh, gw, c)
