"""JAX parameter tree -> the port's state dict.

Counterpart of ``naf_tpu/convert.py`` in the other direction: it turns the
``image_encoder`` tree of ``naf_tpu.models.NAF`` (a nested dict of arrays,
read with ``np.asarray``) into a state dict with the reference names, which
``naf_torch.models.NAF.load_state_dict`` takes; and the trees of the
baselines FeatUp, JBU, AnyUp and JAFAR into their port modules' state dicts.

Layout conversions: conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
GroupNorm / LayerNorm scale/bias and RMSNorm scale -> weight/bias;
DenseGeneral((n, d)) kernel (in, n, d) -> Linear weight (n*d, in);
``image_encoder.rope.periods`` from ``rope_base`` (the JAX package recomputes
it instead of storing it).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from naf_torch.nn.rope import rope_periods

__all__ = [
    "state_dict_from_jax_params",
    "encoder_state_dict_from_jax",
    "featup_state_dict_from_jax",
    "jbu_state_dict_from_jax",
    "anyup_state_dict_from_jax",
    "jafar_state_dict_from_jax",
]


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
        for conv in ("conv1", "conv2", "shortcut"):
            if conv in blk:
                _conv(blk[conv], f"{t}.{conv}", out)
    return out


def _flax_conv(tree: Mapping, prefix: str, out: dict) -> None:
    """A bare flax ``nn.Conv`` {kernel (kh, kw, I, O), bias?} -> Conv2d names."""
    _conv({"conv": tree}, prefix, out)


def _dense(tree: Mapping, prefix: str, out: dict) -> None:
    """flax ``DenseGeneral((n, d))``: kernel (in, n, d) -> Linear weight (n*d, in)."""
    k = np.asarray(tree["kernel"])
    out[f"{prefix}.weight"] = _t(k.reshape(k.shape[0], -1).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(np.asarray(tree["bias"]).reshape(-1))


def _jbu_filter(tree: Mapping, prefix: str, out: dict) -> None:
    """One ``JBULearnedRange`` tree (range_proj1/2, fixup_proj1/2 when the
    filter combines, range_temp, sigma_spatial)."""
    for leaf, name in (("range_proj1", "range_proj.0"), ("range_proj2", "range_proj.3"),
                       ("fixup_proj1", "fixup_proj.0"), ("fixup_proj2", "fixup_proj.3")):
        if leaf in tree:
            _flax_conv(tree[leaf], f"{prefix}.{name}", out)
    out[f"{prefix}.range_temp"] = _t(tree["range_temp"])
    out[f"{prefix}.sigma_spatial"] = _t(tree["sigma_spatial"])


def featup_state_dict_from_jax(params: Mapping) -> dict:
    """``naf_tpu`` FeatUp params -> ``naf_torch.models.featup.FeatUp`` state
    dict (the stages present in the tree: JAX initializes only those that its
    ratio runs)."""
    out: dict = {}
    if "norm" in params:
        out["norm.norm.weight"] = _t(params["norm"]["norm"]["scale"])
        out["norm.norm.bias"] = _t(params["norm"]["norm"]["bias"])
    ups = params["upsampler"]
    _flax_conv(ups["fixup_proj"], "upsampler.fixup_proj.1", out)
    for up in ("up1", "up2", "up3", "up4"):
        if up in ups:
            _jbu_filter(ups[up], f"upsampler.{up}", out)
    return out


def jbu_state_dict_from_jax(params: Mapping) -> dict:
    """``naf_tpu`` JBU params -> ``naf_torch.models.featup.JBU`` state dict."""
    out: dict = {}
    _jbu_filter(params["bilateral_filter"], "bilateral_filter", out)
    return out


def anyup_state_dict_from_jax(params: Mapping, img_layers: int = 2) -> dict:
    """``naf_tpu`` AnyUpsampler params -> ``naf_torch.models.anyup`` state dict."""
    return encoder_state_dict_from_jax(params["encoder"], img_layers, "encoder")


def jafar_state_dict_from_jax(params: Mapping) -> dict:
    """``naf_tpu`` JAFAR params -> ``naf_torch.models.jafar.JAFAR`` state dict.

    RMSNorm scale -> weight; DenseGeneral((n, d)) -> Linear (n*d, in); the
    parameter-free GroupNorms have no entries."""
    out: dict = {}
    for enc in ("image_encoder", "query_encoder", "key_encoder", "key_features_encoder"):
        out.update(encoder_state_dict_from_jax(params[enc], 2, enc))
    out["rope.freqs"] = _t(params["rope"]["freqs"])
    for name in ("gamma", "beta"):
        _flax_conv(params["sft_key"][name], f"sft_key.{name}", out)
    _flax_conv(params["cross_decode_conv"], "cross_decode_conv", out)
    att = params["cross_decode"]
    for norm in ("norm_q", "norm_k"):
        out[f"cross_decode.{norm}.weight"] = _t(att[norm]["scale"])
    for proj in ("q_proj", "k_proj"):
        _dense(att[proj], f"cross_decode.{proj}", out)
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
