"""JAFAR: global cross-attention upsampler, NHWC (counterpart of
``naf_tpu/models/jafar.py``).

A conv image encoder with learnable-frequency RoPE gives queries (pooled to
the output size) and keys (pooled to the feature grid, then modulated by the
encoded features through an SFT); every query attends ALL h*w keys, and the
head-averaged softmax scores are applied to the raw features. The attention
is plain torch, as it is plain einsum in the JAX package: at 448^2 <- 28^2 it
holds (1, 4, 200704, 784) f32 logits, about 2.5 GB.

Parameter names follow the JAX tree (``image_encoder``, ``rope.freqs``,
``query_encoder``, ``key_encoder``, ``key_features_encoder``,
``sft_key.{gamma,beta}``, ``cross_decode_conv``,
``cross_decode.{norm_q,norm_k,q_proj,k_proj}``). flax's RMSNorm has eps 1e-6
and its DenseGeneral((n, d)) is a Linear to n*d; the GroupNorms have no
parameters, and the 3x3 ``cross_decode_conv`` zero-pads ("SAME").
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from naf_torch.models.featup import Conv1x1
from naf_torch.nn.conv import Encoder, group_norm_nhwc
from naf_torch.ops.pool import adaptive_avg_pool2d

__all__ = ["JAFAR", "JafarRoPE", "SFT", "GlobalCrossAttention"]


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class JafarRoPE(nn.Module):
    """Learnable-frequency RoPE; ``freqs`` (2, dim) starts at the reference's
    init."""

    def __init__(self, dim: int, theta: float = 100.0):
        super().__init__()
        f1 = theta ** np.linspace(0, -1, dim // 4, dtype=np.float32)
        f1 = np.concatenate([f1, f1])
        f2 = np.zeros((2, dim), np.float32)
        f2[0, : dim // 2] = f1
        f2[1, dim // 2 :] = f1
        self.freqs = nn.Parameter(torch.from_numpy(f2 * 2 * math.pi))

    def forward(self, x, coords):
        angle = coords @ self.freqs.to(x.dtype)  # (hw, dim)
        return x * torch.cos(angle) + _rotate_half(x) * torch.sin(angle)


class SFT(nn.Module):
    """Spatial feature transform: ``gamma(f) * GroupNorm(x) + beta(f)``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.gamma = Conv1x1(in_channels, out_channels, bias=False)
        self.beta = Conv1x1(in_channels, out_channels, bias=False)

    def forward(self, image, features):
        return self.gamma(features) * group_norm_nhwc(image, 8) + self.beta(features)


class GlobalCrossAttention(nn.Module):
    """Head-averaged attention scores applied to the raw values."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm_q = nn.RMSNorm(dim, eps=1e-6)
        self.norm_k = nn.RMSNorm(dim, eps=1e-6)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v_raw):
        b, nq, dim = q.shape
        n = self.num_heads
        d = dim // n
        qh = self.q_proj(self.norm_q(q)).reshape(b, nq, n, d)
        kh = self.k_proj(self.norm_k(k)).reshape(b, k.shape[1], n, d)
        # f32 logits, as JAX's preferred_element_type gives them
        logits = torch.einsum("bind,bjnd->bnij", qh.float() * d ** -0.5, kh.float())
        scores = torch.softmax(logits, dim=-1).mean(dim=1)  # average the heads
        return torch.einsum("bij,bjd->bid", scores.to(v_raw.dtype), v_raw)


def _enc(dim: int, in_channels: int, kernel_size: int = 1) -> Encoder:
    return Encoder(dim, in_channels, kernel_size=kernel_size, ks_res=kernel_size,
                   num_layers=2, bias=False, residual=True)


class JAFAR(nn.Module):
    def __init__(self, dim: int = 128, v_dim: int = 384, kernel_size: int = 1,
                 num_heads: int = 4):
        super().__init__()
        self.dim = dim
        self.v_dim = v_dim
        self.image_encoder = _enc(dim, 3, kernel_size)
        self.rope = JafarRoPE(dim)
        self.query_encoder = _enc(dim, dim)
        self.key_encoder = _enc(dim, dim)
        self.key_features_encoder = _enc(dim, v_dim)
        self.sft_key = SFT(dim, dim)
        self.cross_decode_conv = nn.Conv2d(dim, dim, 3, padding=1, bias=False)
        self.cross_decode = GlobalCrossAttention(dim, num_heads)

    def forward(self, image, features, output_size, *args, **kwargs):
        b = image.shape[0]
        oh, ow = int(output_size[0]), int(output_size[1])
        hk, wk = features.shape[1], features.shape[2]

        x = self.image_encoder(image)
        h, w = x.shape[1], x.shape[2]
        # coords: the linspace(0, 1) grid of the encoder, "ij" order
        ch = np.linspace(0, 1, h, dtype=np.float32)
        cw = np.linspace(0, 1, w, dtype=np.float32)
        coords = np.stack(np.meshgrid(ch, cw, indexing="ij"), -1).reshape(-1, 2)
        coords = torch.from_numpy(coords).to(x.device, x.dtype)
        x = self.rope(x.reshape(b, h * w, self.dim), coords).reshape(b, h, w, self.dim)

        queries = group_norm_nhwc(adaptive_avg_pool2d(self.query_encoder(x), (oh, ow)), 8)
        keys = adaptive_avg_pool2d(self.key_encoder(x), (hk, wk))
        f_normed = features / torch.linalg.vector_norm(
            features, dim=-1, keepdim=True).clamp_min(1e-12)
        keys = self.sft_key(keys, self.key_features_encoder(f_normed))

        q = self.cross_decode_conv(queries.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out = self.cross_decode(q.reshape(b, oh * ow, self.dim),
                                keys.reshape(b, hk * wk, self.dim),
                                features.reshape(b, hk * wk, self.v_dim))
        return out.reshape(b, oh, ow, self.v_dim)
