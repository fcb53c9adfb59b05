"""JAX parameter tree -> the port's state dict.

Counterpart of ``naf_tpu/convert.py`` in the other direction: it turns the
``image_encoder`` tree of ``naf_tpu.models.NAF`` (a nested dict of arrays,
read with ``np.asarray``) into a state dict with the reference names, which
``naf_torch.models.NAF.load_state_dict`` takes.

Layout conversions: conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
GroupNorm scale/bias -> weight/bias; ``image_encoder.rope.periods`` from
``rope_base`` (the JAX package recomputes it instead of storing it).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from naf_torch.nn.rope import rope_periods

__all__ = ["state_dict_from_jax_params", "encoder_state_dict_from_jax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(tree: Mapping, prefix: str, out: dict) -> None:
    conv = tree["conv"]
    out[f"{prefix}.weight"] = _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        out[f"{prefix}.bias"] = _t(conv["bias"])


def encoder_state_dict_from_jax(tree: Mapping, num_layers: int, prefix: str = "") -> dict:
    """One ``naf_tpu.nn.Encoder`` tree -> ``naf_torch.nn.Encoder`` state dict."""
    dot = f"{prefix}." if prefix else ""
    out: dict = {}
    _conv(tree["stem"], f"{dot}0", out)
    for i in range(num_layers):
        blk = tree[f"block{i}"]
        t = f"{dot}{i + 1}"
        for norm in ("norm1", "norm2"):
            out[f"{t}.{norm}.weight"] = _t(blk[norm]["scale"])
            out[f"{t}.{norm}.bias"] = _t(blk[norm]["bias"])
        for conv in ("conv1", "conv2"):
            _conv(blk[conv], f"{t}.{conv}", out)
    return out


def state_dict_from_jax_params(params: Mapping, img_layers: int = 2,
                               rope_base: float = 100.0, heads_rope: int = 4) -> dict:
    """Convert ``naf_tpu`` NAF params (``model.init(...)["params"]``) to the
    port's state dict (f32 tensors on the CPU)."""
    out: dict = {}
    for stack in ("encoder", "sem_encoder"):
        out.update(encoder_state_dict_from_jax(
            params["image_encoder"][stack], img_layers, f"image_encoder.{stack}"))
    dim = 2 * out["image_encoder.encoder.0.weight"].shape[0]
    out["image_encoder.rope.periods"] = torch.from_numpy(
        rope_periods(dim // heads_rope, rope_base))
    return out
