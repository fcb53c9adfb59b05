"""Restormer, the restoration transformer (counterpart of
``naf_tpu/models/restormer.py``; reference src/model/restormer.py).

A 4-level U-Net of transformer blocks: MDTA (attention over the channel axis
of each head: L2-normalized rows over the pixels, a learned temperature per
head) and GDFN (a gated depthwise-conv feed-forward), pixel-unshuffle down
and pixel-shuffle up, and a residual to the input image. The forward takes
and returns NHWC, as the JAX module does, and runs NCHW inside; the JAX
package's pixel (un)shuffle channel order (``_pixel_unshuffle`` /
``_pixel_shuffle``: channel c * r^2 + i * r + j for row offset i and column
offset j) is torch's ``F.pixel_unshuffle`` / ``F.pixel_shuffle``. Parameter
names follow the JAX tree (``enc1_0`` -> ``enc1.0``), so
``naf_torch.convert.restormer_state_dict_from_jax`` only renames and
transposes.

Where a gradient is taken, each transformer block runs under
``torch.utils.checkpoint`` and is recomputed in the backward: at 448^2 and
batch 8 (the denoising runs' size) the blocks' saved activations would take
about 155 GiB in bf16, twice an H100's memory. The values are the same. The
recompute calls the block on the parameter tensors it ran with, so that a
forward under ``torch.func.functional_call`` (the trainers' bf16 copies)
recomputes on those copies too.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from naf_torch.ops.resize import resize_bilinear

__all__ = ["Restormer", "ChanLayerNorm", "MDTA", "GDFN", "TransformerBlock"]


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW tensor (restormer.py:22-68),
    eps 1e-5: ``F.layer_norm`` on the channels-last view (f32 statistics,
    and only they are kept for the backward besides the input); without
    bias the input is only scaled by 1 / sqrt(var + eps)."""

    def __init__(self, dim: int, with_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if with_bias else None

    def forward(self, x):
        if self.bias is None:
            var = torch.var(x.float(), dim=1, keepdim=True, correction=0)
            return (x * torch.rsqrt(var + 1e-5).to(x.dtype)) * self.weight[:, None, None]
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, 1e-5)
        return y.permute(0, 3, 1, 2)


class MDTA(nn.Module):
    """Transposed (channel-axis) self-attention (restormer.py:93-124)."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=use_bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3, bias=use_bias)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = nn.Conv2d(dim, dim, 1, bias=use_bias)

    def forward(self, x):
        b, c, h, w = x.shape
        n = self.num_heads
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        q, k, v = (t.reshape(b, n, c // n, h * w) for t in (q, k, v))
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        # f32 softmax of the (d x d) logits, as the JAX module takes them
        attn = torch.matmul(q, k.transpose(-2, -1)).float() * self.temperature.float()
        out = torch.matmul(attn.softmax(dim=-1).to(v.dtype), v)
        return self.project_out(out.reshape(b, c, h, w))


class GDFN(nn.Module):
    """Gated depthwise-conv feed-forward (restormer.py:71-90)."""

    def __init__(self, dim: int, expansion: float = 2.66, use_bias: bool = False):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=use_bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1, groups=hidden * 2,
                                bias=use_bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=use_bias)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 use_bias: bool = False, ln_bias: bool = True):
        super().__init__()
        self.norm1 = ChanLayerNorm(dim, ln_bias)
        self.attn = MDTA(dim, num_heads, use_bias)
        self.norm2 = ChanLayerNorm(dim, ln_bias)
        self.ffn = GDFN(dim, expansion, use_bias)
        self.param_names = [name for name, _ in self.named_parameters()]

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class Restormer(nn.Module):
    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                 use_bias: bool = False, ln_bias: bool = True):
        super().__init__()
        d = dim

        def blocks(width, n_heads, n):
            return nn.ModuleList(TransformerBlock(width, n_heads, ffn_expansion_factor,
                                                  use_bias, ln_bias) for _ in range(n))

        conv3 = lambda cin, cout, bias: nn.Conv2d(cin, cout, 3, padding=1, bias=bias)  # noqa: E731
        self.patch_embed = conv3(inp_channels, d, use_bias)
        self.enc1 = blocks(d, heads[0], num_blocks[0])
        self.down1_2 = conv3(d, d // 2, False)
        self.enc2 = blocks(d * 2, heads[1], num_blocks[1])
        self.down2_3 = conv3(d * 2, d, False)
        self.enc3 = blocks(d * 4, heads[2], num_blocks[2])
        self.down3_4 = conv3(d * 4, d * 2, False)
        self.latent = blocks(d * 8, heads[3], num_blocks[3])
        self.up4_3 = conv3(d * 8, d * 16, False)
        self.reduce3 = nn.Conv2d(d * 8, d * 4, 1, bias=use_bias)
        self.dec3 = blocks(d * 4, heads[2], num_blocks[2])
        self.up3_2 = conv3(d * 4, d * 8, False)
        self.reduce2 = nn.Conv2d(d * 4, d * 2, 1, bias=use_bias)
        self.dec2 = blocks(d * 2, heads[1], num_blocks[1])
        self.up2_1 = conv3(d * 2, d * 4, False)
        self.dec1 = blocks(d * 2, heads[0], num_blocks[0])
        self.refine = blocks(d * 2, heads[0], num_refinement_blocks)
        self.output = conv3(d * 2, out_channels, use_bias)

    @staticmethod
    def _run(blocks, x):
        for blk in blocks:
            if not (torch.is_grad_enabled() and x.requires_grad):
                x = blk(x)
                continue
            # the tensors the block holds now (a functional_call's, if any)
            params = {n: functools.reduce(getattr, n.split("."), blk) for n in blk.param_names}
            x = checkpoint(functools.partial(functional_call, blk, params), (x,),
                           use_reentrant=False)
        return x

    def forward(self, noisy_norm, noisy, output_size: Optional[Tuple[int, int]] = None):
        inp = noisy
        if output_size and tuple(noisy.shape[1:3]) != tuple(output_size):
            inp = resize_bilinear(noisy, tuple(output_size))
        x = inp.permute(0, 3, 1, 2)
        e1 = self._run(self.enc1, self.patch_embed(x))
        e2 = self._run(self.enc2, F.pixel_unshuffle(self.down1_2(e1), 2))
        e3 = self._run(self.enc3, F.pixel_unshuffle(self.down2_3(e2), 2))
        lat = self._run(self.latent, F.pixel_unshuffle(self.down3_4(e3), 2))
        y = torch.cat([F.pixel_shuffle(self.up4_3(lat), 2), e3], dim=1)
        y = self._run(self.dec3, self.reduce3(y))
        y = torch.cat([F.pixel_shuffle(self.up3_2(y), 2), e2], dim=1)
        y = self._run(self.dec2, self.reduce2(y))
        y = torch.cat([F.pixel_shuffle(self.up2_1(y), 2), e1], dim=1)
        y = self._run(self.refine, self._run(self.dec1, y))
        return self.output(y).permute(0, 2, 3, 1) + inp
