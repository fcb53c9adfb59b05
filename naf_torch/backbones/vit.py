"""Vision Transformer for frozen feature extraction (counterpart of
``naf_tpu/backbones/vit.py``), NHWC.

``(B, H, W, 3) normalised image -> (B, H/ps, W/ps, C)`` patch features of
the last block, layer-normed (timm ``forward_intermediates(n=1, norm=True)``
semantics). ``ViTConfig``'s knobs cover the families of the backbone
registry: conv patchify (with or without bias), a cls token and register
tokens, learned position embeddings on a ``pos_grid`` x ``pos_grid`` grid
(with or without a cls position) resized to the image's patch grid, an
optional LayerNorm before the first block, pre-norm blocks with optional
LayerScale, a qkv projection with or without bias, a GELU MLP or a SwiGLU
FFN (DINOv3 ViT-7B/16: ``fc2(silu(fc1_g(x)) * fc1_x(x))``), and a rotary
embedding of the patch tokens' q and k in every block: DINOv3's rotate-half
RoPE (cell centres in [-1, 1]) or the Perception Encoder's interleaved one
(integer patch coordinates). The prefix of cls and register tokens passes
the RoPE unchanged. Parameter names are timm's (``reg_token``, ``norm_pre``,
SwiGLU's ``fc1_g`` / ``fc1_x`` / ``fc2``), so a timm checkpoint loads with
``load_state_dict``; ``naf_torch.backbones.convert`` maps other layouts onto
them. Each block's FFN runs under the span ``naf.backbone.mlp``.

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
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from naf_torch.utils.spans import span, to_device

__all__ = ["ViT", "ViTConfig", "SwiGLU", "rope_tables", "resize_weights", "resize_jax",
           "resize_bicubic_jax"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_reg_tokens: int = 0
    layerscale: bool = True
    ln_eps: float = 1e-6
    pos_grid: int = 37  # position-embedding grid side at pretraining time
    use_cls_pos: bool = True  # the position table has a row for the cls token
    rope_theta: Optional[float] = None  # None: no RoPE
    rope_style: str = "rotate_half"  # DINOv3; "interleaved": Perception Encoder
    use_abs_pos: Optional[bool] = None  # None: learned positions iff no RoPE
    ln_pre: bool = False  # LayerNorm before the first block (CLIP, PE)
    patch_bias: bool = True
    ffn: str = "gelu"  # "gelu": fc2(gelu(fc1 x)); "swiglu": fc2(silu(fc1_g x) * fc1_x x)
    mlp_hidden: Optional[int] = None  # the FFN's hidden width; None: embed_dim * mlp_ratio
    qkv_bias: bool = True

    @property
    def abs_pos(self) -> bool:
        return self.rope_theta is None if self.use_abs_pos is None else self.use_abs_pos

    @property
    def hidden(self) -> int:
        """The FFN's hidden width."""
        return int(self.embed_dim * self.mlp_ratio) if self.mlp_hidden is None else self.mlp_hidden


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"cubic": _keys_cubic, "linear": lambda x: np.maximum(0.0, 1.0 - x)}


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str = "cubic") -> np.ndarray:
    """(out, in) f32 weights of ``jax.image.resize(..., method)`` on one
    axis, ``method`` "cubic" or "linear" (scale-and-translate with
    antialiasing, translation 0)."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T).astype(np.float32)


def resize_jax(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """Resize the (H, W) axes of a (B, H, W, C) tensor as
    ``jax.image.resize(x, (B, *size, C), method)`` does ("cubic" or
    "linear"), in f32."""
    h, w = x.shape[1], x.shape[2]
    wh = to_device(resize_weights(h, int(size[0]), method), x.device)
    ww = to_device(resize_weights(w, int(size[1]), method), x.device)
    return torch.einsum("oh,bhwc,pw->bopc", wh, x.float(), ww)


def resize_bicubic_jax(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bicubic")`` of a (B, H, W, C) tensor, in f32."""
    return resize_jax(x, size, "cubic")


def rope_tables(cfg: ViTConfig, gh: int, gw: int):
    """(sin, cos) f32 tables of the patch tokens' RoPE on a (gh, gw) grid:
    (gh*gw, d) for rotate-half, (gh*gw, d/2) for interleaved; None without
    RoPE. Built in numpy f32 as the JAX package builds them."""
    if cfg.rope_theta is None:
        return None
    d = cfg.embed_dim // cfg.num_heads
    n = d // 4
    if cfg.rope_style == "interleaved":
        # integer patch coordinates; x-angles in the first d/4 pairs, y in the second
        freqs = 1.0 / (cfg.rope_theta ** (4 * np.arange(n, dtype=np.float32) / d))
        t = np.arange(gh * gw, dtype=np.float32)
        t_x, t_y = t % gw, np.floor(t / gw)
        angles = np.concatenate([t_x[:, None] * freqs[None, :], t_y[:, None] * freqs[None, :]],
                                axis=1)
    elif cfg.rope_style == "rotate_half":
        # cell centres mapped to [-1, 1], 2 pi in the angle, the angles tiled twice
        ch = (np.arange(gh, dtype=np.float32) + 0.5) / gh
        cw = (np.arange(gw, dtype=np.float32) + 0.5) / gw
        coords = 2.0 * np.stack(np.meshgrid(ch, cw, indexing="ij"), -1).reshape(-1, 2) - 1.0
        inv_freq = 1.0 / (cfg.rope_theta ** (2 * np.arange(n, dtype=np.float32) / (d // 2)))
        angles = 2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]
        angles = np.tile(angles.reshape(gh * gw, d // 2), (1, 2))
    else:
        raise ValueError(f"unknown rope_style {cfg.rope_style!r}")
    angles = torch.from_numpy(np.ascontiguousarray(angles, dtype=np.float32))
    return torch.sin(angles), torch.cos(angles)


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, style: str) -> torch.Tensor:
    """RoPE of x (..., T, d) by per-token tables (T, d) or (T, d/2)."""
    if style == "interleaved":  # adjacent pairs (2p, 2p+1) rotated by angle p
        xp = x.unflatten(-1, (-1, 2))
        even, odd = xp[..., 0], xp[..., 1]
        return torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1).flatten(-2)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_style: str = "rotate_half",
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.rope_style = rope_style
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, rope=None, n_prefix: int = 0) -> torch.Tensor:
        b, t, c = x.shape
        n = self.num_heads
        d = c // n
        qkv = self.qkv(x).reshape(b, t, 3, n, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if rope is not None:  # patch tokens only; the cls/register prefix passes
            sin, cos = (a.to(x.dtype) for a in rope)
            q, k = (torch.cat([a[:, :, :n_prefix], _rotate(a[:, :, n_prefix:], sin, cos,
                                                             self.rope_style)], dim=2)
                    for a in (q, k))
        q = q * (d ** -0.5)
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


class SwiGLU(nn.Module):
    """The gated FFN of DINOv3 ViT-7B/16: the gate ``fc1_g`` through SiLU
    times the up projection ``fc1_x``, then the down projection ``fc2``
    (the dinov3 repository's ``w1``, ``w2``, ``w3``; HF's ``gate_proj``,
    ``up_proj``, ``down_proj``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1_g = nn.Linear(dim, hidden)
        self.fc1_x = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1_g(x)) * self.fc1_x(x))


_FFN = {"gelu": Mlp, "swiglu": SwiGLU}


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int, layerscale: bool,
                 ln_eps: float, rope_style: str = "rotate_half", ffn: str = "gelu",
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, rope_style, qkv_bias)
        self.ls1 = LayerScale(dim) if layerscale else nn.Identity()
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = _FFN[ffn](dim, hidden)
        self.ls2 = LayerScale(dim) if layerscale else nn.Identity()

    def forward(self, x: torch.Tensor, rope=None, n_prefix: int = 0) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), rope, n_prefix))
        with span("naf.backbone.mlp"):
            y = self.mlp(self.norm2(x))
        return x + self.ls2(y)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int, bias: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size, bias=bias)


class ViT(nn.Module):
    """ViT with timm parameter names, configured by ``ViTConfig``."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        c = config.embed_dim
        self.config = config
        self.patch_embed = PatchEmbed(config.patch_size, c, config.patch_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        if config.num_reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros(1, config.num_reg_tokens, c))
        if config.abs_pos:
            n_pos = int(config.use_cls_pos) + config.pos_grid ** 2
            self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, c))
        if config.ln_pre:
            self.norm_pre = nn.LayerNorm(c, eps=config.ln_eps)
        self.blocks = nn.ModuleList(
            Block(c, config.num_heads, config.hidden, config.layerscale, config.ln_eps,
                  config.rope_style, config.ffn, config.qkv_bias)
            for _ in range(config.depth))
        self.norm = nn.LayerNorm(c, eps=config.ln_eps)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights, as the JAX package's random init draws
        them: lecun-normal kernels, zero biases, position embeddings
        N(0, 0.02), zero cls and register tokens, LayerScale and LayerNorm
        scales of one."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, LayerScale):
                    m.gamma.fill_(1.0)
            if self.config.abs_pos:
                normal(self.pos_embed, 0.02)
            self.cls_token.zero_()
            if self.config.num_reg_tokens:
                self.reg_token.zero_()

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
        cls = self.cls_token
        if cfg.abs_pos:
            pos = self.pos_embed
            if cfg.use_cls_pos:
                cls = cls + pos[:, :1]
                pos = pos[:, 1:]
            if (gh, gw) != (cfg.pos_grid, cfg.pos_grid):
                grid = pos.reshape(1, cfg.pos_grid, cfg.pos_grid, c)
                pos = resize_bicubic_jax(grid, (gh, gw)).to(pos.dtype).reshape(1, gh * gw, c)
            x = x + pos
        tokens = [cls.expand(b, 1, c)]
        if cfg.num_reg_tokens:
            tokens.append(self.reg_token.expand(b, -1, c))
        x = torch.cat(tokens + [x], dim=1)
        n_prefix = 1 + cfg.num_reg_tokens
        rope = rope_tables(cfg, gh, gw)
        if rope is not None:
            rope = tuple(to_device(a, x.device) for a in rope)
        if cfg.ln_pre:
            x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x, rope, n_prefix)
        x = self.norm(x)
        return x[:, n_prefix:].reshape(b, gh, gw, c)
