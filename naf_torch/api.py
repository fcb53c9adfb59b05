"""Public zero-shot upsampling API (counterpart of ``naf_tpu/api.py``).

    model = load_naf_params()                          # seeded random weights, on CUDA
    model = load_naf_params("naf_release.pth")         # a reference-format checkpoint
    hr = naf(model, image, lr_feats, (H, W))           # NCHW in and out

or the stateful wrapper, which runs under ``torch.inference_mode``:

    ups = NAFUpsampler()
    hr = ups(image, lr_feats, (H, W))

Outputs above 2K, in row bands of the output (NHWC):

    hr = naf_streamed(model, image, lr_feats, (4096, 4096), band_rows=512)

Entry points run on CUDA unless the caller asks for another device
(``device="cpu"`` runs the plain PyTorch path). Without CUDA and without a
device, they raise rather than fall back to the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from naf_torch.models.naf import NAF, band_cells, band_encoder_rows
from naf_torch.utils.spans import span, to_device

__all__ = ["naf", "load_naf_params", "NAFUpsampler", "naf_streamed"]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev


@torch.no_grad()
def _init_weights(model: nn.Module, seed: int) -> None:
    """torch's default Conv2d / ConvTranspose2d / Linear init (uniform
    +-1/sqrt(fan_in) for weight and bias), drawn on the CPU from a generator
    seeded with ``seed``; norms and other parameters keep their
    constructors' values."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)


def load_naf_params(checkpoint: Optional[str] = None, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.float32, **model_kwargs) -> NAF:
    """Build a ``NAF`` module in eval mode on ``device`` with ``dtype`` weights.

    checkpoint: optional path to a reference-format state dict (e.g. the
    released naf_release.pth), loaded with ``load_state_dict``; without one
    the weights are random, drawn from ``seed``. model_kwargs are NAF
    hyperparameters (dim, heads_attn, kernel_size, ...).
    """
    dev = _device(device)
    model = NAF(**model_kwargs)
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if "state_dict" in state and not any("encoder" in k for k in state):
            state = state["state_dict"]
        model.load_state_dict(state)
    else:
        _init_weights(model, seed)
    return model.to(dev, dtype).eval()


def naf(model: NAF, image, lr_feats, target_size: Tuple[int, int],
        channels_last: bool = False) -> torch.Tensor:
    """Upsample ``lr_feats`` to ``target_size``, guided by ``image``.

    The reference forward contract: image (B, 3, H_img, W_img), lr_feats
    (B, C, h, w) -> (B, C, *target_size); NHWC with channels_last=True.
    Inputs move to the model's device and dtype. The call is the span
    ``naf.call`` (``naf_torch.utils.spans``).
    """
    with span("naf.call"):
        ref = next(model.parameters())
        image = to_device(image, ref.device, ref.dtype)
        lr_feats = to_device(lr_feats, ref.device, ref.dtype)
        if not channels_last:
            image = image.permute(0, 2, 3, 1)
            lr_feats = lr_feats.permute(0, 2, 3, 1)
        out = model(image.contiguous(), lr_feats.contiguous(),
                    (int(target_size[0]), int(target_size[1])))
        return out if channels_last else out.permute(0, 3, 1, 2)


class NAFUpsampler:
    """Stateful wrapper mirroring the hub module's usage; inference only."""

    def __init__(self, model: Optional[NAF] = None, checkpoint: Optional[str] = None,
                 seed: int = 0, device="cuda", dtype: torch.dtype = torch.float32,
                 **model_kwargs):
        if model is None:
            model = load_naf_params(checkpoint, seed, device, dtype, **model_kwargs)
        self.model = model

    def __call__(self, image, lr_feats, target_size, channels_last: bool = False):
        with torch.inference_mode():
            return naf(self.model, image, lr_feats, target_size, channels_last)


@torch.inference_mode()
def naf_streamed(model: NAF, image, lr_feats, target_size: Tuple[int, int], band_rows: int,
                 stream_encoder: Optional[bool] = None) -> torch.Tensor:
    """Upsample to a huge output (4096^2 and beyond) in row bands. NHWC in
    and out: image (B, H_img, W_img, 3), lr_feats (B, h, w, C) ->
    (B, *target_size, C); inference only.

    The output buffer is allocated once and each band of ``band_rows`` output
    rows is written into it in place by one K2 launch, so the peak memory is
    the output, the encoder output and one band's working set.

    ``stream_encoder`` also streams the encoder, for guide images whose
    encoder output would not fit beside the output: the banded two-pass
    GroupNorm encoder (``naf_torch.kernels.encoder_banded``) computes each
    layer's statistics in banded sweeps, a second sweep sums the pooled keys
    band by band (``RoPE.pooled`` is linear in the rows), and each attention
    band recomputes only its own encoder rows, so the full-resolution encoder
    output never exists. It turns on by itself above 1.5 GiB of encoder
    output.
    """
    ref = next(model.parameters())
    image = to_device(image, ref.device, ref.dtype)
    lr_feats = to_device(lr_feats, ref.device, ref.dtype).contiguous()
    oh, ow = int(target_size[0]), int(target_size[1])
    hk = lr_feats.shape[1]
    cells_per_band = band_cells(oh, hk, band_rows)
    enc = model.image_encoder
    hi, wi = enc.guard_size(image.shape[1], image.shape[2], oh, ow)
    if stream_encoder is None:
        enc_bytes = hi * wi * enc.rope.embed_dim * image.element_size()
        stream_encoder = enc_bytes > 1.5 * 2**30
    if stream_encoder:
        return _naf_streamed_banded_encoder(model, image, lr_feats, oh, ow, hi, wi,
                                            cells_per_band)
    return model._fused_q_banded(image.contiguous(), lr_feats, (oh, ow), cells_per_band)


def _naf_streamed_banded_encoder(model: NAF, image, lr_feats, oh: int, ow: int, hi: int,
                                 wi: int, cells_per_band: int) -> torch.Tensor:
    """:func:`naf_streamed` with the banded encoder: a stats sweep per
    stack, a keys sweep, then the attention bands, each on its own encoder
    rows (``enc_banded``). The encoder's last chain runs twice (keys and
    attention); the compute is cheap at this scale, the memory is not."""
    from naf_torch.kernels.encoder_banded import (
        encoder_stack_banded_rows,
        encoder_stack_stats,
    )
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
    from naf_torch.ops.resize import resize_bilinear

    ienc = model.image_encoder
    if not ienc.use_encoder:
        raise ValueError("stream_encoder needs the image encoder (use_encoder=True)")
    hk, wk = lr_feats.shape[1], lr_feats.shape[2]
    eb = band_encoder_rows(oh, hk, cells_per_band, hi)
    if tuple(image.shape[1:3]) != (hi, wi):
        image = resize_bilinear(image, (hi, wi))
    image = image.contiguous()
    stacks = (ienc.encoder, ienc.sem_encoder)
    stats = [encoder_stack_stats(s, image, band_rows=eb) for s in stacks]
    rope = ienc.rope
    rows_tab, cols_tab = rope.k2_tables(oh, ow)

    def enc_band(r0):
        return torch.cat([encoder_stack_banded_rows(s, image, r0, eb, st)
                          for s, st in zip(stacks, stats)], dim=-1)

    # sweep 1: the pooled keys, summed band by band in f32, cast once
    keys = None
    for r0 in range(0, hi, eb):
        kb = rope.pooled(enc_band(r0), (oh, ow), (hk, wk), row0=r0, full_h=hi).float()
        keys = kb if keys is None else keys + kb
    keys = keys.to(image.dtype).contiguous()

    # sweep 2: each attention band on its own encoder rows
    out = torch.empty((image.shape[0], oh, ow, lr_feats.shape[-1]), dtype=image.dtype,
                      device=image.device)
    for c0 in range(0, hk, cells_per_band):
        naf_upsample_attention(
            enc_band(c0 // cells_per_band * eb), keys, lr_feats, rows_tab, cols_tab, rope.d_head,
            num_heads=model.heads_attn, kernel_size=model.kernel_size, row_cell0=c0,
            band_cells=cells_per_band, out_acc=out, enc_banded=True)
    return out
