"""NAF: zero-shot feature upsampling by cross-scale neighborhood attention, NHWC.

Counterpart of ``naf_tpu/models/naf.py``:

  image (B, H_img, W_img, 3) --ImageEncoder--> x (B, H_o, W_o, dim) with RoPE
  queries = x
  keys    = adaptive_avg_pool(x -> (h, w))
  values  = lr_feats (B, h, w, C)
  out     = CrossScaleAttention(q, k, v)       (B, H_o, W_o, C)

The image encoder concatenates a 1x1-kernel "pixel" stack and a 3x3-kernel
"semantic" stack (dim/2 channels each), guards inputs larger than 4x the
output by a bilinear downscale, pools to the output size and applies RoPE.

Inference (no ``return_weights``) takes the fused path: both encoder stacks
on kernel K1 into one packed buffer, the keys and RoPE tables by the keys
kernel (``kernels.rope_keys``: the separable pooled-RoPE collapse in one
launch), then kernel K2 (pool-up + RoPE + attention in one pass). On CPU
tensors the same path runs the kernels' plain versions.

Training (``train=True``) takes the modular path, as the JAX package does:
the encoder (K1 on CUDA), pool to the output size, RoPE with the train-time
coordinate rescale, pooled keys, then ``CrossScaleAttention``, whose "auto"
implementation runs kernels K3 forward and K4 backward on CUDA tensors.
``return_weights`` takes the modular path with the plain attention oracle.

``band_rows`` (inference) runs the attention in row bands of the output with
the global window rule: the encoder, keys and RoPE tables once, then one K2
launch per band, each writing its rows into one shared output in place. With
``na_impl="xla"`` a band raises, as the JAX package's plain attention does
(K2 takes every shape the port serves, so the JAX package's fallback through
``CrossScaleAttention`` bands, for shapes its TPU kernel refuses, has no
counterpart here). Training ignores ``band_rows``, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from naf_torch.kernels.encoder_fused import encoder_stack_fused_packed
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
from naf_torch.kernels.rope_keys import rope_keys
from naf_torch.nn.attention import CrossScaleAttention
from naf_torch.nn.conv import Encoder
from naf_torch.nn.rope import RoPE, RopeDraws
from naf_torch.ops.pool import adaptive_avg_pool2d
from naf_torch.ops.resize import resize_bilinear
from naf_torch.utils.spans import span

__all__ = ["NAF", "ImageEncoder", "band_cells", "band_encoder_rows"]


class ImageEncoder(nn.Module):
    def __init__(self, out_channels: int = 256, heads_rope: int = 4,
                 rope_base: float = 100.0, img_layers: int = 2, use_encoder: bool = True,
                 rope_rescale: Optional[float] = None):
        super().__init__()
        hidden = out_channels // 2
        self.use_encoder = use_encoder
        if use_encoder:
            self.encoder = Encoder(hidden, kernel_size=1, ks_res=1, num_layers=img_layers)
            self.sem_encoder = Encoder(hidden, kernel_size=3, ks_res=3, num_layers=img_layers)
        self.rope = RoPE(out_channels, heads_rope, base=rope_base, rescale_coords=rope_rescale)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Both conv stacks, no pooling or RoPE. CUDA tensors run every
        GN -> SiLU -> conv layer on K1 into one packed buffer. CPU tensors
        run the modules' own forward (``nn.GroupNorm``), as the JAX package
        does off the TPU, and not the fused-layer math of K1's plain version:
        the CPU model is the independent check that the card's output is
        held against. Without the encoder (``use_encoder=False``) the input
        passes through unchanged, as in the JAX package."""
        if not self.use_encoder:
            return x
        if x.device.type == "cuda":
            return encoder_stack_fused_packed(self.encoder, self.sem_encoder, x)
        return torch.cat([self.encoder(x), self.sem_encoder(x)], dim=-1)

    def encode_guarded(self, x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
        """Input guard + both stacks, without pooling or RoPE (those are
        fused downstream into K2); the span ``naf.encoder``."""
        with span("naf.encoder"):
            oh, ow = int(output_size[0]), int(output_size[1])
            h, w = x.shape[1], x.shape[2]
            if (h, w) != self.guard_size(h, w, oh, ow):
                x = resize_bilinear(x, self.guard_size(h, w, oh, ow))
            return self.encode(x)

    @staticmethod
    def guard_size(h: int, w: int, oh: int, ow: int) -> Tuple[int, int]:
        """Post-guard input size: inputs above 4x the output are bilinear-
        downscaled (reference naf.py:39-48, with its min(h, 4oh, 4ow) form)."""
        if h > 4 * oh or w > 4 * ow:
            return (min(h, 4 * oh, 4 * ow), min(w, 4 * ow, 4 * oh))
        return (h, w)

    def forward(self, x: torch.Tensor, output_size: Tuple[int, int], train: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RopeDraws] = None) -> torch.Tensor:
        oh, ow = int(output_size[0]), int(output_size[1])
        x = self.encode_guarded(x, (oh, ow))
        return self.rope(adaptive_avg_pool2d(x, (oh, ow)), train, generator, draws)


class NAF(nn.Module):
    """Flagship upsampler: ``forward(image, features, output_size)``, NHWC.

    Defaults are the reference's (src/model/naf.py:73-84, config/model/naf.yaml):
    dim 256, 4 attention heads, 4 RoPE heads, kernel 9, 2 encoder layers, a
    train-time RoPE rescale bound of 2. ``na_impl`` is the attention
    implementation ("auto" | "pallas" | "xla" | "fused_q", as in the JAX
    package): "xla" also keeps inference on the modular path with the plain
    oracle; the others take the fused path for inference.
    """

    def __init__(self, dim: int = 256, heads_attn: int = 4, heads_rope: int = 4,
                 kernel_size: int = 9, use_encoder: bool = True, rope_base: float = 100.0,
                 rope_rescale: Optional[float] = 2.0, img_layers: int = 2,
                 na_impl: str = "auto"):
        super().__init__()
        if na_impl not in ("auto", "pallas", "xla", "fused_q"):
            raise ValueError(f"unknown na_impl {na_impl!r}")
        self.heads_attn = heads_attn
        self.kernel_size = kernel_size
        self.na_impl = na_impl
        self.image_encoder = ImageEncoder(dim, heads_rope, rope_base, img_layers, use_encoder,
                                          rope_rescale)
        self.upsampler = CrossScaleAttention(
            dim, heads_attn, kernel_size, impl="auto" if na_impl == "fused_q" else na_impl)

    def forward(self, image: torch.Tensor, features: torch.Tensor,
                output_size: Tuple[int, int], return_weights: bool = False,
                train: bool = False, band_rows: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RopeDraws] = None):
        """``train`` applies the RoPE coordinate augmentation given in
        ``draws`` or drawn from ``generator`` (none without either, as the
        JAX package does without an rng)."""
        if band_rows is not None and not return_weights and not train:
            return self._banded(image, features, output_size, band_rows)
        if not train and not return_weights and self.na_impl != "xla":
            return self._fused_q(image, features, output_size)
        x = self.image_encoder(image, output_size, train, generator, draws)
        keys = adaptive_avg_pool2d(x, features.shape[1:3])  # KeyEncoder
        return self.upsampler(x, keys, features, return_weights=return_weights)

    def _fused_q_inputs(self, image, features, output_size):
        """Encoder output, pooled keys and the cos|sin row/column tables of
        the fused path; the keys and tables (one launch of the keys kernel
        on the card, ``kernels.rope_keys``) are the span ``naf.keys``."""
        oh, ow = int(output_size[0]), int(output_size[1])
        hk, wk = features.shape[1], features.shape[2]
        enc = self.image_encoder.encode_guarded(image, (oh, ow))
        with span("naf.keys"):
            enc = enc.contiguous()
            return (enc, *rope_keys(self.image_encoder.rope, enc, (oh, ow), (hk, wk)))

    def _fused_q(self, image, features, output_size):
        enc, keys, rows_tab, cols_tab = self._fused_q_inputs(image, features, output_size)
        with span("naf.attention"):
            return naf_upsample_attention(
                enc, keys, features.contiguous(), rows_tab, cols_tab,
                self.image_encoder.rope.d_head, num_heads=self.heads_attn,
                kernel_size=self.kernel_size,
            )

    def _banded(self, image, features, output_size, band_rows: int):
        """Row-banded attention (exact; inference only). The encoder runs at
        full resolution (its GroupNorm statistics are global per image); the
        attention runs per band of ``band_rows`` output rows with global
        window indexing."""
        cells_per_band = band_cells(int(output_size[0]), features.shape[1], band_rows)
        if self.na_impl == "xla":
            raise NotImplementedError("banded attention requires the pallas impl")
        return self._fused_q_banded(image, features, output_size, cells_per_band)

    @torch.no_grad()
    def _fused_q_banded(self, image, features, output_size, cells_per_band: int):
        """The fused path in bands: the encoder output, keys and tables once,
        then one K2 launch per band, each writing its cell rows into the
        shared output in place (the bands cover every row). Inference only:
        the output carries no gradient."""
        oh, ow = int(output_size[0]), int(output_size[1])
        enc, keys, rows_tab, cols_tab = self._fused_q_inputs(image, features, output_size)
        feats = features.contiguous()
        out = torch.empty((image.shape[0], oh, ow, features.shape[-1]), dtype=enc.dtype,
                          device=enc.device)
        for c0 in range(0, features.shape[1], cells_per_band):
            with span("naf.attention"):
                naf_upsample_attention(
                    enc, keys, feats, rows_tab, cols_tab, self.image_encoder.rope.d_head,
                    num_heads=self.heads_attn, kernel_size=self.kernel_size, row_cell0=c0,
                    band_cells=cells_per_band, out_acc=out)
        return out


def band_cells(out_h: int, lr_h: int, band_rows: int) -> int:
    """LR cell rows per band of ``band_rows`` output rows; raises unless the
    bands are whole cell rows that tile the output."""
    if out_h % lr_h or out_h % band_rows or band_rows % (out_h // lr_h):
        raise ValueError("band_rows must divide output height and be a multiple of the "
                         "cell stride (output_height // lr_height)")
    return band_rows // (out_h // lr_h)


def band_encoder_rows(out_h: int, lr_h: int, cells: int, enc_h: int) -> int:
    """Encoder rows per band of ``cells`` LR cell rows (:func:`band_cells`)
    of an ``out_h``-row output whose encoder output has ``enc_h`` rows;
    raises unless a band maps to whole encoder rows."""
    rows = cells * (out_h // lr_h) * enc_h
    if rows % out_h:
        raise ValueError(f"a band of {cells} cell rows maps to no whole encoder rows ({enc_h} "
                         f"rows for {out_h} output rows); adjust band_rows or the image size")
    return rows // out_h
