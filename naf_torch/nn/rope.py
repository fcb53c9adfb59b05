"""Axial 2-D rotary position embedding, NHWC (counterpart of ``naf_tpu/nn/rope.py``).

Per-axis coordinates normalised to [-1, 1], a geometric period spectrum of
size d_head//4, angles laid out per head as [u..., v..., u..., v...] and
applied with rotate-half. Every channel's angle depends on one axis only,
so the sin/cos fields factor into an (h, C) row table times a (w, C) column
table with ones in the other axis's slots (:meth:`RoPE.tables`).

The ``periods`` buffer carries the reference state-dict name
(``image_encoder.rope.periods``) and stays float32 across ``module.to(dtype)``:
rounding it to bf16 would change every angle.

Train-time coordinate augmentations (shift / jitter / rescale, reference
rope.py:107-124) act per axis, so they compose with the separable tables.
Their draws come from an explicit ``torch.Generator`` (:meth:`RoPE.draw`), or
are given as numbers (a ``RopeDraws``), so that a test can feed the draws the
JAX package made with ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from naf_torch.ops.pool import _pool_matrix, adaptive_avg_pool2d

__all__ = ["RoPE", "RopeDraws", "rope_periods", "rotate_half"]


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


@dataclasses.dataclass(frozen=True)
class RopeDraws:
    """One step's coordinate augmentation: ``shift`` added to the (row, col)
    coordinates, then ``jitter`` and ``rescale`` multiplying them. None
    leaves that augmentation out."""

    shift: Optional[Tuple[float, float]] = None
    jitter: Optional[Tuple[float, float]] = None
    rescale: Optional[float] = None


class RoPE(nn.Module):
    """Applies axial RoPE to an NHWC feature map, per attention head.

    shift_coords / jitter_coords / rescale_coords are the train-time
    augmentation bounds of the reference constructor (None disables each)."""

    def __init__(self, embed_dim: int, num_heads: int, base: float = 100.0,
                 shift_coords: Optional[float] = None, jitter_coords: Optional[float] = None,
                 rescale_coords: Optional[float] = None):
        super().__init__()
        if embed_dim % (4 * num_heads) != 0:
            raise ValueError("embed_dim must be divisible by 4 * num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.d_head = embed_dim // num_heads
        self.shift_coords = shift_coords
        self.jitter_coords = jitter_coords
        self.rescale_coords = rescale_coords
        self.register_buffer("periods", torch.from_numpy(rope_periods(self.d_head, base)))

    def _apply(self, fn, recurse=True):
        # Follow device moves but never a dtype cast of the periods.
        periods = self.periods
        out = super()._apply(fn, recurse)
        self.periods = periods.to(self.periods.device)
        return out

    def _angles(self, coords) -> torch.Tensor:
        c = torch.as_tensor(coords, dtype=torch.float32).to(self.periods.device)
        return (2.0 * math.pi) * c[:, None] / self.periods.float()

    def draw(self, generator: Optional[torch.Generator] = None) -> RopeDraws:
        """Sample one step's augmentation from ``generator`` (on the CPU):
        shift uniform in [-s, s] per axis, jitter and rescale log-uniform in
        [1/j, j] per axis and [1/r, r] for both axes (reference rope.py:107-124)."""
        def uniform(n, bound):
            u = torch.rand(n, generator=generator, dtype=torch.float64)
            return ((2.0 * u - 1.0) * bound).tolist()

        shift = jitter = rescale = None
        if self.shift_coords is not None:
            shift = tuple(uniform(2, self.shift_coords))
        if self.jitter_coords is not None:
            jitter = tuple(math.exp(a) for a in uniform(2, math.log(self.jitter_coords)))
        if self.rescale_coords is not None:
            rescale = math.exp(uniform(1, math.log(self.rescale_coords))[0])
        return RopeDraws(shift, jitter, rescale)

    def tables(self, h: int, w: int, train: bool = False,
               generator: Optional[torch.Generator] = None,
               draws: Optional[RopeDraws] = None):
        """f32 (sin_r, cos_r) of shape (h, C) and (sin_c, cos_c) of shape (w, C).

        With ``train``, the axis coordinates take the augmentation given in
        ``draws``, or drawn from ``generator``; with neither, none (as the
        JAX package does without an rng)."""
        ch, cw = (torch.from_numpy(a) for a in _axis_coords(h, w))
        if train and draws is None and generator is not None:
            draws = self.draw(generator)
        if train and draws is not None:
            f32 = lambda a: torch.tensor(a, dtype=torch.float32)
            if draws.shift is not None:
                ch, cw = ch + f32(draws.shift[0]), cw + f32(draws.shift[1])
            if draws.jitter is not None:
                ch, cw = ch * f32(draws.jitter[0]), cw * f32(draws.jitter[1])
            if draws.rescale is not None:
                ch, cw = ch * f32(draws.rescale), cw * f32(draws.rescale)
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

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RopeDraws] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        if c != self.embed_dim:
            raise ValueError(f"expected {self.embed_dim} channels, got {c}")
        sin_r, cos_r, sin_c, cos_c = (
            t.to(x.dtype) for t in self.tables(h, w, train, generator, draws))
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
