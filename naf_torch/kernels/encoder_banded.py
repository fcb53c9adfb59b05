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

Each band runs the encoder's one chain (``encoder_fused._chain``), with its
halo rule and its choice between the kernels (the stem kernel and K1, on
CUDA tensors, inference-only) and their plain versions. The statistics
passed between the phases are each layer's input channel sums [sum, sumsq]
over the whole image, (B, 2, C) f32, which the chain folds into the
GroupNorm's scale and shift where it reads them. The JAX package passes the
folded pairs; here the fold stays in the chain, the one place that folds
GroupNorm statistics, at the price of refolding each layer's (B, C) pair at
every band call. Modules are the port's ``Encoder`` (no residual, convs
with biases).
"""

from __future__ import annotations

import torch

from naf_torch.kernels.encoder_fused import _chain, _channel_sums, _stack_params, _stack_spec

__all__ = ["encoder_stack_stats", "encoder_stack_banded_rows", "encoder_stack_banded"]


def encoder_stack_stats(encoder, x, band_rows: int = 512):
    """Each layer's GroupNorm statistics, in layer order: the channel sums
    (B, 2, C) f32 [sum, sumsq] of its input over the whole image, from
    banded sweeps of ``band_rows`` image rows: peak memory is one band's
    activations. x (B, H, W, 3) NHWC."""
    params, spec = _stack_params(encoder), _stack_spec(encoder)
    h = x.shape[1]
    sums = []
    for depth in range(2 * encoder.num_layers):
        sums.append(sum(_channel_sums(_chain(x, params, spec, (r0, min(h, r0 + band_rows)),
                                             depth, lambda i, f: sums[i]))
                        for r0 in range(0, h, band_rows)))
    return sums


def encoder_stack_banded_rows(encoder, x, row0: int, nrows: int, stats):
    """Rows [row0, row0 + nrows) of the stack's output, from the image and
    ``stats`` (:func:`encoder_stack_stats`)."""
    return _chain(x, _stack_params(encoder), _stack_spec(encoder), (row0, row0 + nrows),
                  stats=lambda i, f: stats[i])


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
