"""Axial 2-D rotary position embedding, NHWC (counterpart of ``naf_tpu/nn/rope.py``).

Per-axis coordinates normalised to [-1, 1], a geometric period spectrum of
size d_head//4, angles laid out per head as [u..., v..., u..., v...] and
applied with rotate-half. Every channel's angle depends on one axis only,
so the sin/cos fields factor into an (h, C) row table times a (w, C) column
table with ones in the other axis's slots (:meth:`RoPE.tables`).

The ``periods`` buffer carries the reference state-dict name
(``image_encoder.rope.periods``) and stays float32 across ``module.to(dtype)``:
rounding it to bf16 would change every angle. Train-time coordinate
augmentations (shift / jitter / rescale) come with the training slice.
"""

from __future__ import annotations

import functools
import math
import numpy as np
import torch
from torch import nn

from naf_torch.ops.pool import _pool_matrix, adaptive_avg_pool2d

__all__ = ["RoPE", "rope_periods", "rotate_half"]


def rope_periods(d_head: int, base: float = 100.0) -> np.ndarray:
    """Period spectrum of size d_head//4 (reference rope.py:128-135)."""
    n = d_head // 4
    return (base ** (2 * np.arange(n, dtype=np.float32) / (d_head // 2))).astype(np.float32)


def _axis_coords(h: int, w: int):
    """Per-axis coordinates in [-1, 1], each axis normalised by its own length
    (the reference's "separate" mode); the 2-D grid is their outer product."""
    ch = 2.0 * (np.arange(h, dtype=np.float32) + 0.5) / h - 1.0
    cw = 2.0 * (np.arange(w, dtype=np.float32) + 0.5) / w - 1.0
    return ch, cw


@functools.lru_cache(maxsize=32)
def _rotate_half_matrix(num_heads: int, d_head: int) -> np.ndarray:
    """(C, C) signed permutation: ``x @ M`` is per-head rotate-half [-x2, x1]."""
    c = num_heads * d_head
    m = np.zeros((c, c), dtype=np.float32)
    half = d_head // 2
    for head in range(num_heads):
        o = head * d_head
        for j in range(half):
            m[o + half + j, o + j] = -1.0
            m[o + j, o + half + j] = 1.0
    return m


def rotate_half(x: torch.Tensor, d_head: int) -> torch.Tensor:
    """Per-head rotate-half of the last axis: [x1, x2] -> [-x2, x1] (exact)."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], shape[-1] // d_head, 2, d_head // 2)
    return torch.stack([-xh[..., 1, :], xh[..., 0, :]], dim=-2).reshape(shape)


class RoPE(nn.Module):
    """Applies axial RoPE to an NHWC feature map, per attention head."""

    def __init__(self, embed_dim: int, num_heads: int, base: float = 100.0):
        super().__init__()
        if embed_dim % (4 * num_heads) != 0:
            raise ValueError("embed_dim must be divisible by 4 * num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.d_head = embed_dim // num_heads
        self.register_buffer("periods", torch.from_numpy(rope_periods(self.d_head, base)))

    def _apply(self, fn, recurse=True):
        # Follow device moves but never a dtype cast of the periods.
        periods = self.periods
        out = super()._apply(fn, recurse)
        self.periods = periods.to(self.periods.device)
        return out

    def _angles(self, coords: np.ndarray) -> torch.Tensor:
        c = torch.from_numpy(coords).to(self.periods.device)
        return (2.0 * math.pi) * c[:, None] / self.periods.float()

    def tables(self, h: int, w: int):
        """f32 (sin_r, cos_r) of shape (h, C) and (sin_c, cos_c) of shape (w, C)."""
        ch, cw = _axis_coords(h, w)
        au, av = self._angles(ch), self._angles(cw)
        one_u, one_v = torch.ones_like(au), torch.ones_like(av)
        n = self.num_heads
        sin_r = torch.cat([au.sin(), one_u, au.sin(), one_u], -1).repeat(1, n)
        cos_r = torch.cat([au.cos(), one_u, au.cos(), one_u], -1).repeat(1, n)
        sin_c = torch.cat([one_v, av.sin(), one_v, av.sin()], -1).repeat(1, n)
        cos_c = torch.cat([one_v, av.cos(), one_v, av.cos()], -1).repeat(1, n)
        return sin_r, cos_r, sin_c, cos_c

    def rotate_matrix(self, dtype=torch.float32) -> torch.Tensor:
        """(C, C) signed-permutation rotate-half matrix for this head shape."""
        return torch.from_numpy(_rotate_half_matrix(self.num_heads, self.d_head)).to(
            self.periods.device, dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if c != self.embed_dim:
            raise ValueError(f"expected {self.embed_dim} channels, got {c}")
        sin_r, cos_r, sin_c, cos_c = (t.to(x.dtype) for t in self.tables(h, w))
        rot = rotate_half(x, self.d_head)
        return (x * cos_r[:, None] * cos_c[None]
                + rot * sin_r[:, None] * sin_c[None])

    def pooled(self, x: torch.Tensor, up_hw, down_hw) -> torch.Tensor:
        """``adaptive_pool(rope(adaptive_pool(x, up_hw)), down_hw)`` without
        materialising the up_hw grid: the NAF keys.

        Both pools are separable row/column matrices and every RoPE channel's
        sin/cos is a row table times a column table, so each channel's keys
        collapse to ``(Pd_r diag(cos_r[:, c]) Pu_r) x_c (Pd_c diag(cos_c[:, c]) Pu_c)^T``
        plus the same with sin and the rotated x. When x already has the
        up_hw size, RoPE then pool-down is exact and cheaper.
        """
        b, hi, wi, c = x.shape
        oh, ow = int(up_hw[0]), int(up_hw[1])
        kh, kw = int(down_hw[0]), int(down_hw[1])
        if (hi, wi) == (oh, ow):
            return adaptive_avg_pool2d(self(x), (kh, kw))
        ch, cw = _axis_coords(oh, ow)
        nfreq = self.d_head // 4
        dev = self.periods.device

        def axis_mats(out_len, mid_len, in_len, coords):
            """Unique (2*nfreq + 1, out, in) pool-down * table * pool-up mats:
            cos and sin of each frequency, and the all-ones slot."""
            ang = self._angles(coords)
            pu = torch.from_numpy(_pool_matrix(in_len, mid_len)).to(dev)
            pd = torch.from_numpy(_pool_matrix(mid_len, out_len)).to(dev)
            ones = torch.ones((mid_len, 1), dtype=torch.float32, device=dev)
            uniq = torch.cat([ang.cos(), ang.sin(), ones], dim=-1)
            return torch.einsum("oi,iu,ij->uoj", pd, uniq, pu)

        def expand(a_uniq, row_axis: bool):
            # per head [u(nf), v(nf), u(nf), v(nf)]: the cos table holds cos
            # in this axis's slots and ones in the other's; likewise sin.
            f = np.arange(nfreq)
            one = 2 * nfreq
            if row_axis:
                cos_map = np.concatenate([f, [one] * nfreq] * 2)
                sin_map = np.concatenate([f + nfreq, [one] * nfreq] * 2)
            else:
                cos_map = np.concatenate([[one] * nfreq, f] * 2)
                sin_map = np.concatenate([[one] * nfreq, f + nfreq] * 2)
            cos_map = torch.from_numpy(np.tile(cos_map, self.num_heads)).to(dev)
            sin_map = torch.from_numpy(np.tile(sin_map, self.num_heads)).to(dev)
            return a_uniq[cos_map], a_uniq[sin_map]

        dt = x.dtype
        ar_cos, ar_sin = (a.to(dt) for a in expand(axis_mats(kh, oh, hi, ch), True))
        ac_cos, ac_sin = (a.to(dt) for a in expand(axis_mats(kw, ow, wi, cw), False))
        rot = rotate_half(x, self.d_head)
        term_c = torch.einsum("ckj,bjwc->bkwc", ar_cos, x)
        term_c = torch.einsum("clw,bkwc->bklc", ac_cos, term_c)
        term_s = torch.einsum("ckj,bjwc->bkwc", ar_sin, rot)
        term_s = torch.einsum("clw,bkwc->bklc", ac_sin, term_s)
        return (term_c + term_s).to(dt)
