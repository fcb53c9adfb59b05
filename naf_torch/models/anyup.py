"""AnyUp baseline, NHWC (counterpart of ``naf_tpu/models/anyup.py``).

A conv image encoder at the output resolution gives the queries and, pooled
to the feature grid, the keys; a windowed cross-scale attention of radius
``radius`` aggregates the raw input features as values, which is what makes
the upsampler agnostic to the backbone's feature width. The image is
bilinear-resized to the output size first (the reference wrapper's rule).
On CUDA tensors the attention's "auto" implementation runs kernel K3.

``anyup_state_dict_from_torch`` maps an AnyUp state dict in the reference's
``encoder()``-Sequential naming to this module's state dict, with the JAX
converter's strict accounting: a key it does not consume raises.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch import nn

from naf_torch.nn.attention import CrossScaleAttention
from naf_torch.nn.conv import Encoder
from naf_torch.ops.pool import adaptive_avg_pool2d
from naf_torch.ops.resize import resize_bilinear

__all__ = ["AnyUpsampler", "anyup_state_dict_from_torch"]


class AnyUpsampler(nn.Module):
    """``forward(image, features, output_size)`` -> (B, H_o, W_o, C).

    dim/radius/groups are the reference wrapper's defaults."""

    def __init__(self, dim: int = 256, radius: int = 3, groups: int = 8, img_layers: int = 2):
        super().__init__()
        self.encoder = Encoder(dim, kernel_size=3, ks_res=3, num_layers=img_layers)
        self.attention = CrossScaleAttention(dim, groups, 2 * radius + 1)

    def forward(self, image: torch.Tensor, features: torch.Tensor,
                output_size: Tuple[int, int], *args, **kwargs) -> torch.Tensor:
        oh, ow = int(output_size[0]), int(output_size[1])
        x = self.encoder(resize_bilinear(image, (oh, ow)))
        keys = adaptive_avg_pool2d(x, features.shape[1:3])
        return self.attention(x, keys, features)


def anyup_state_dict_from_torch(state_dict: Mapping, img_layers: int = 2) -> dict:
    """AnyUp state dict -> ``AnyUpsampler`` state dict.

    The learned state is the conv image encoder, keyed ``{prefix}.0`` (entry
    conv) and ``{prefix}.{1+i}.norm{1,2} / conv{1,2}`` (blocks), where the
    prefix is found among ``encoder``, ``upsampler.encoder``,
    ``model.encoder`` and bare indices. Raises KeyError on a key it does not
    consume and ValueError on shapes that do not fit the architecture."""
    keys = list(state_dict)
    if not keys:
        raise KeyError("empty state dict")
    for prefix in ("encoder", "upsampler.encoder", "model.encoder", ""):
        if (f"{prefix}.0.weight" if prefix else "0.weight") in state_dict:
            break
    else:
        raise KeyError("could not locate the encoder entry conv in the checkpoint (tried "
                       "encoder/upsampler.encoder/model.encoder/bare); keys: "
                       f"{sorted(keys)[:8]}...")
    dot = f"{prefix}." if prefix else ""
    names = ["0"] + [f"{i + 1}.{m}" for i in range(img_layers)
                     for m in ("norm1", "conv1", "norm2", "conv2")]
    out, consumed = {}, set()
    for name in names:
        for leaf in ("weight", "bias"):
            key = f"{dot}{name}.{leaf}"
            if key in state_dict:
                out[f"encoder.{name}.{leaf}"] = torch.as_tensor(state_dict[key]).detach().to(
                    "cpu", torch.float32)
                consumed.add(key)
    leftovers = [k for k in keys if k not in consumed]
    if leftovers:
        raise KeyError("checkpoint keys not consumed by the AnyUp converter (would be "
                       f"silently dropped): {sorted(leftovers)}")
    stem = out["encoder.0.weight"]
    if stem.ndim != 4 or stem.shape[1] != 3:
        raise ValueError(f"stem weight (OIHW) must have 3 input channels, got {tuple(stem.shape)}")
    dim = stem.shape[0]
    for i in range(img_layers):
        for conv in ("conv1", "conv2"):
            w = out.get(f"encoder.{i + 1}.{conv}.weight")
            if w is None or tuple(w.shape[:2]) != (dim, dim):
                raise ValueError(f"encoder.{i + 1}.{conv}: expected a ({dim}, {dim}, *, *) "
                                 f"OIHW weight, got {None if w is None else tuple(w.shape)}")
        for norm in ("norm1", "norm2"):
            w = out.get(f"encoder.{i + 1}.{norm}.weight")
            if w is None or tuple(w.shape) != (dim,):
                raise ValueError(f"encoder.{i + 1}.{norm}: expected a ({dim},) affine, got "
                                 f"{None if w is None else tuple(w.shape)}")
    return out
