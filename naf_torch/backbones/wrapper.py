"""Uniform backbone access (counterpart of ``naf_tpu/backbones/wrapper.py``,
reference PretrainedViTWrapper, src/backbone/vit_wrapper.py:46-180).

``PretrainedViTWrapper(name, checkpoint=...)`` resolves a model family from
the name as the JAX package does (the patch size from ``patch(\\d+)``, with
Franca and CAPI at 14 and ConvNeXt at 32; the width from a size fragment;
the registry's normalisation and input size, and ImageNet statistics at 448
for any other name), then loads a local checkpoint through the family's
converter (``naf_torch.backbones.convert``; nothing is downloaded) or draws
seeded random weights in the family's layout:

    wrapper = PretrainedViTWrapper("vit_base_patch16_dinov3.lvd1689m", device="cuda")
    wrapper(image_nhwc_normalised)  -> (B, H/ps, W/ps, C)
    wrapper.normalize(image01)      -> the backbone's own normalisation
    wrapper.config                  -> {"mean", "std", "input_size", "ps"}
    wrapper.embed_dim, wrapper.patch_size

The ``dvt_`` / ``fit3d_`` prefixes of finetuned weights are stripped
(``finetune_tag``). Franca's RASA head runs after the trunk.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from naf_torch.api import _device
from naf_torch.backbones.vit import ViT, ViTConfig
from naf_torch.utils.spans import to_device

__all__ = ["PretrainedViTWrapper", "load_multiple_backbones", "BACKBONE_REGISTRY",
           "backbone_config", "RasaHead"]

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

# name fragment -> width; heads are width / 64
_SIZES = {"small": 384, "base": 768, "large": 1024, "giant": 1536, "tiny": 192,
          "vits": 384, "vitb": 768, "vitl": 1024, "vit7b": 4096}

_IDENTITY = dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))  # RADIO normalises inside
_HALF = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))  # SigLIP, Perception Encoder

BACKBONE_REGISTRY = {
    "vit_base_patch16_224.dino": dict(input_size=224),
    "radio_v2.5-b": dict(input_size=512, **_IDENTITY),
    "radio_v2.5-l": dict(input_size=512, **_IDENTITY),
    "franca_vitb14": dict(input_size=448),
    "franca_vitl14": dict(input_size=448),
    "capi_vitl14": dict(input_size=448),
    "vit_base_patch14_dinov2.lvd142m": dict(input_size=518),
    "vit_small_patch14_dinov2.lvd142m": dict(input_size=518),
    "vit_base_patch14_reg4_dinov2": dict(input_size=518),
    "vit_base_patch16_dinov3.lvd1689m": dict(input_size=512),
    "vit_large_patch16_dinov3.lvd1689m": dict(input_size=512),
    "vit_base_patch16_siglip_512.v2_webli": dict(input_size=512, **_HALF),
    "vit_large_patch16_224.mae": dict(input_size=224),
    "vit_pe_core_small_patch16_384.fb": dict(input_size=384, **_HALF),
    "vit_pe_core_tiny_patch16_384.fb": dict(input_size=384, **_HALF),
    "vit_pe_spatial_tiny_patch16_512.fb": dict(input_size=512, **_HALF),
    "vit_pe_spatial_small_patch16_512.fb": dict(input_size=512, **_HALF),
}


def _patch_size_from_name(name: str) -> int:
    m = re.search(r"patch(\d+)", name)
    ps = int(m.group(1)) if m else 16
    if "franca" in name or "capi" in name:
        ps = 14
    if "convnext" in name:
        ps = 32
    return ps


def _embed_dim_from_name(name: str) -> int:
    for frag, dim in _SIZES.items():
        if frag in name:
            return dim
    return 768


def _strip_finetune_tag(name: str) -> Tuple[str, Optional[str]]:
    for tag in ("dvt_", "fit3d_"):
        if name.startswith(tag):
            return name[len(tag):], tag[:-1]
    return name, None


def backbone_config(name: str, num_heads: Optional[int] = None,
                    embed_dim: Optional[int] = None, depth: Optional[int] = None):
    """(``config`` dict, random-weight ``ViTConfig``) of a backbone name,
    resolved as the JAX package resolves it: depth 12; DINOv3 with 4
    registers, no cls position and RoPE theta 100; the Perception Encoder
    with the interleaved RoPE, learned positions, a pre-LayerNorm, no patch
    bias, no LayerScale and eps 1e-5; LayerScale on for every other family.
    ``embed_dim`` / ``depth`` shrink a random backbone (heads follow the
    width unless ``num_heads`` is given)."""
    name, _ = _strip_finetune_tag(name)
    ps = _patch_size_from_name(name)
    reg = BACKBONE_REGISTRY.get(name, {})
    size = reg.get("input_size", 448)
    config = {"mean": tuple(reg.get("mean", IMAGENET_DEFAULT_MEAN)),
              "std": tuple(reg.get("std", IMAGENET_DEFAULT_STD)),
              "input_size": (3, size, size), "ps": ps}
    dim = embed_dim or _embed_dim_from_name(name)
    is_pe = "_pe_" in name or name.startswith("pe_")
    dinov3 = "dinov3" in name
    vit = ViTConfig(
        patch_size=ps, embed_dim=dim, depth=depth or 12,
        num_heads=num_heads or max(dim // 64, 1), pos_grid=size // ps,
        rope_theta=10000.0 if is_pe else 100.0 if dinov3 else None,
        num_reg_tokens=4 if dinov3 else 0, use_cls_pos=not dinov3,
        rope_style="interleaved" if is_pe else "rotate_half",
        use_abs_pos=True if is_pe else None, ln_pre=is_pe, patch_bias=not is_pe,
        layerscale=not is_pe, ln_eps=1e-5 if is_pe else 1e-6,
    )
    return config, vit


class RasaHead(nn.Module):
    """Franca's RASA head: per-token linear layers over the patch features,
    exact GELU between them (none after the last)."""

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.layers = nn.ModuleList()
        for w, b in layers:
            lin = nn.Linear(w.shape[1], w.shape[0])
            with torch.no_grad():
                lin.weight.copy_(w)
                lin.bias.copy_(b)
            self.layers.append(lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.gelu(x)
        return x


def _load_checkpoint(name: str, path: str, heads: int):
    """(ViT state, ViTConfig, RASA layers or None) of a local checkpoint,
    converted by the name's family."""
    from naf_torch.backbones import convert

    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    if "model" in state and not any(k.startswith("blocks.") for k in state):
        state = state["model"]
    if "radio" in name:
        return (*convert.convert_radio(state, heads), None)
    if "franca" in name:
        return convert.convert_franca(state, heads)
    if "capi" in name:
        return (*convert.convert_capi(state, heads), None)
    return (*convert.vit_from_torch(state, heads), None)


class PretrainedViTWrapper:
    """A frozen backbone. ``checkpoint``: a local torch checkpoint in any
    layout of ``naf_torch.backbones.convert``; without one the weights are
    random, drawn from ``seed``. ``num_heads`` overrides the name's head
    count; ``embed_dim`` and ``depth`` override its width and depth for a
    random backbone only (small test and smoke runs), since a checkpoint
    fixes both."""

    def __init__(self, name: str, checkpoint: Optional[str] = None,
                 num_heads: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, device="cuda", embed_dim: Optional[int] = None,
                 depth: Optional[int] = None):
        name, self.finetune_tag = _strip_finetune_tag(name)
        self.name = name
        if checkpoint is not None and (embed_dim is not None or depth is not None):
            raise ValueError("embed_dim and depth come from the checkpoint; give them only "
                             "for a random backbone")
        self.config, vit_config = backbone_config(name, num_heads, embed_dim, depth)
        self.rasa = None
        if checkpoint is not None:
            heads = num_heads or max(_embed_dim_from_name(name) // 64, 1)
            state, vit_config, rasa = _load_checkpoint(name, checkpoint, heads)
            model = ViT(vit_config)
            model.load_state_dict(state)
            if rasa is not None:
                self.rasa = RasaHead(rasa).to(_device(device), dtype).eval().requires_grad_(False)
        else:
            model = ViT(vit_config)
            model.reset_parameters(torch.Generator().manual_seed(seed))
        self.vit_config = vit_config
        self.dtype = dtype
        self.model = model.to(_device(device), dtype).eval().requires_grad_(False)
        self.embed_dim = vit_config.embed_dim
        self.patch_size = vit_config.patch_size
        self.config["ps"] = self.patch_size

    def to(self, device) -> "PretrainedViTWrapper":
        self.model = self.model.to(_device(device))
        if self.rasa is not None:
            self.rasa = self.rasa.to(_device(device))
        return self

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised image -> (B, H/ps, W/ps, C)."""
        feats = self.model(image)
        return feats if self.rasa is None else self.rasa(feats)

    def normalize(self, image01: torch.Tensor) -> torch.Tensor:
        """Apply this backbone's normalisation to a [0, 1] NHWC image."""
        mean = to_device(self.config["mean"], image01.device, image01.dtype)
        std = to_device(self.config["std"], image01.device, image01.dtype)
        return (image01 - mean) / std


def load_multiple_backbones(cfg, dtype: torch.dtype = torch.float32, device="cuda"):
    """List-or-single backbone config -> list of wrappers (reference
    utils/training.py:193-231): training consumes the first. ``cfg`` is the
    ``backbone`` config group: ``name`` a string or a list; ``checkpoint`` a
    string, a list aligned with ``name``, or absent (random weights);
    optional ``num_heads`` / ``embed_dim`` / ``depth`` shrink a random one."""
    names = cfg["name"] if isinstance(cfg["name"], (list, tuple)) else [cfg["name"]]
    ckpts = cfg.get("checkpoint")
    if not isinstance(ckpts, (list, tuple)):
        ckpts = [ckpts] * len(names)
    if len(ckpts) != len(names):
        raise ValueError(f"backbone.checkpoint has {len(ckpts)} entries for {len(names)} names")
    extra = {k: cfg[k] for k in ("num_heads", "embed_dim", "depth") if cfg.get(k) is not None}
    return [PretrainedViTWrapper(n, checkpoint=c, dtype=dtype, device=device, **extra)
            for n, c in zip(names, ckpts)]
