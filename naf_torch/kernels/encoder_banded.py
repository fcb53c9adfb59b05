"""Row-banded encoder stack with two-pass GroupNorm: bounded peak memory.

Counterpart of ``naf_tpu/kernels/encoder_banded.py``. The NAF image encoder
runs at the guarded input resolution; at a 4096^2 guide one stack's
activations are 4.3 GB each (bf16, 128 channels), and the full-resolution
chain cannot live beside a 12.9 GB output. GroupNorm statistics are global
per image, so each stack is split into

  1. a stats phase (:func:`encoder_stack_stats`): for each layer depth d, a
     banded sweep recomputes the chain from the image up to conv_d, with the
     already-final statistics of the shallower layers, and sums conv_d's
     channel sums over each band's own rows. Nothing is kept across bands:
     the working set is one band and its halo. The price is recompute,
     (L+1)(L+2)/2 banded layer passes for an L-layer stack instead of L+1;
  2. an output phase (:func:`encoder_stack_banded_rows`): any row range of
     the final output from the image and those statistics, so a consumer
     (K2 with ``enc_banded``) streams encoder bands and the full-resolution
     encoder output never exists.

Halo rule: rows [r0, r1) at depth d need image rows [r0 - H, r1 + H),
H = k_stem//2 + d*(k_res//2). An interior band edge is not an image edge,
so the reflect padding of each conv there is wrong; those halo rows are
computed and then sliced away, and the padding is trusted only where the
band edge is the image edge.

Every band layer runs through ``gn_silu_conv_fused``: kernel K1 on CUDA
tensors, its plain version on CPU tensors. Modules are the port's
``Encoder`` (no residual, convs with biases).
"""

from __future__ import annotations

import torch

from naf_torch.kernels.encoder_fused import (
    _channel_sums,
    _gn_affine,
    _stack_params,
    _stack_spec,
    _stem_conv,
    gn_silu_conv_fused,
)

__all__ = ["encoder_stack_stats", "encoder_stack_banded_rows", "encoder_stack_banded"]


def _layer_params(encoder):
    """[(weight, bias, gamma, beta), ...] of the L = 2*num_layers
    GN -> SiLU -> conv layers, in execution order, and the stem's
    (weight, bias)."""
    params = _stack_params(encoder)
    layers = [(w, b, g, beta) for g, beta, w, b in
              (params[i : i + 4] for i in range(2, len(params), 4))]
    return (params[0], params[1]), layers


def _band_chain(encoder, x, r0: int, r1: int, depth: int, stats):
    """Rows [r0, r1) of conv_depth's output (depth 0 is the stem), computed
    from the image rows the chain needs; ``stats`` holds the (scale, shift)
    of the ``depth`` GroupNorms the chain passes through."""
    (stem_w, stem_b), layers = _layer_params(encoder)
    h = x.shape[1]
    halo = stem_w.shape[-1] // 2 + depth * (layers[0][0].shape[-1] // 2 if layers else 0)
    a, b = max(0, r0 - halo), min(h, r1 + halo)
    y = _stem_conv(x[:, a:b].contiguous(), stem_w, stem_b)
    for d in range(depth):
        weight, bias, _, _ = layers[d]
        scale, shift = stats[d]
        y, _ = gn_silu_conv_fused(y, scale, shift, weight, bias)
    return y[:, r0 - a : r1 - a]


def encoder_stack_stats(encoder, x, band_rows: int = 512):
    """Each layer's folded GroupNorm (scale, shift), (B, C) f32 each, in
    layer order, from banded sweeps of ``band_rows`` image rows: peak memory
    is one band's activations. x (B, H, W, 3) NHWC."""
    _, num_groups, eps = _stack_spec(encoder)
    _, layers = _layer_params(encoder)
    _, h, w, _ = x.shape
    stats = []
    for depth, (_, _, gamma, beta) in enumerate(layers):
        psums = None
        for r0 in range(0, h, band_rows):
            y = _band_chain(encoder, x, r0, min(h, r0 + band_rows), depth, stats)
            ps = _channel_sums(y)
            psums = ps if psums is None else psums + ps
        stats.append(_gn_affine(psums, gamma, beta, h * w, num_groups, eps))
    return stats


def encoder_stack_banded_rows(encoder, x, row0: int, nrows: int, stats):
    """Rows [row0, row0 + nrows) of the stack's output, from the image and
    ``stats`` (:func:`encoder_stack_stats`)."""
    return _band_chain(encoder, x, row0, row0 + nrows, 2 * encoder.num_layers, stats)


def encoder_stack_banded(encoder, x, band_rows: int = 512):
    """The whole stack's output through the banded two-pass pipeline: the
    same values as the full-resolution stack, with intermediate activations
    bounded to one band (the assembled output is whole; stream
    :func:`encoder_stack_banded_rows` to avoid even that)."""
    h = x.shape[1]
    stats = encoder_stack_stats(encoder, x, band_rows)
    return torch.cat([encoder_stack_banded_rows(encoder, x, r0, min(h, r0 + band_rows) - r0,
                                                stats)
                      for r0 in range(0, h, band_rows)], dim=1)
