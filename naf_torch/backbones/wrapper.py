"""Uniform backbone access (counterpart of ``naf_tpu/backbones/wrapper.py``,
reference PretrainedViTWrapper, src/backbone/vit_wrapper.py:46-180).

The port covers the DINOv2 family: seeded random weights, or a timm-format
state dict (``.pth``) read from disk (nothing is downloaded).

    wrapper = PretrainedViTWrapper("vit_base_patch14_dinov2.lvd142m", device="cuda")
    wrapper(image_nhwc_normalised)  -> (B, H/ps, W/ps, C)
    wrapper.normalize(image01)      -> the backbone's own normalisation
    wrapper.config                  -> {"mean", "std", "input_size", "ps"}
    wrapper.embed_dim, wrapper.patch_size

DINOv3, Perception Encoder, register and RADIO/Franca/CAPI variants are
later slices; naming one raises.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from naf_torch.api import _device
from naf_torch.backbones.vit import ViT, ViTConfig

__all__ = ["PretrainedViTWrapper", "load_multiple_backbones", "BACKBONE_REGISTRY"]

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

_SIZES = {"small": 384, "base": 768, "large": 1024, "giant": 1536, "tiny": 192}

BACKBONE_REGISTRY = {
    "vit_base_patch14_dinov2.lvd142m": dict(input_size=518),
    "vit_small_patch14_dinov2.lvd142m": dict(input_size=518),
}


def _patch_size_from_name(name: str) -> int:
    m = re.search(r"patch(\d+)", name)
    return int(m.group(1)) if m else 16


def _embed_dim_from_name(name: str) -> int:
    for frag, dim in _SIZES.items():
        if frag in name:
            return dim
    return 768


class PretrainedViTWrapper:
    """A frozen DINOv2 ViT. ``checkpoint``: a timm-format state dict; without
    one the weights are random, drawn from ``seed``. ``num_heads``
    overrides the name's head count; ``embed_dim`` and ``depth`` override
    its width and depth for a random backbone only (small test and smoke
    runs), since a checkpoint fixes both."""

    def __init__(self, name: str, checkpoint: Optional[str] = None,
                 num_heads: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, device="cuda", embed_dim: Optional[int] = None,
                 depth: Optional[int] = None):
        if name not in BACKBONE_REGISTRY:
            raise NotImplementedError(f"backbone {name!r} is not ported; the port covers "
                                      f"{sorted(BACKBONE_REGISTRY)}")
        self.name = name
        self.patch_size = _patch_size_from_name(name)
        size = BACKBONE_REGISTRY[name]["input_size"]
        self.config = {
            "mean": IMAGENET_DEFAULT_MEAN,
            "std": IMAGENET_DEFAULT_STD,
            "input_size": (3, size, size),
            "ps": self.patch_size,
        }
        state = None
        if checkpoint is not None and (embed_dim is not None or depth is not None):
            raise ValueError("embed_dim and depth come from the checkpoint; give them only "
                             "for a random backbone")
        if checkpoint is not None:
            state = torch.load(checkpoint, map_location="cpu", weights_only=True)
            if "state_dict" in state:
                state = state["state_dict"]
            if "model" in state and not any(k.startswith("blocks.") for k in state):
                state = state["model"]
            dim = state["patch_embed.proj.weight"].shape[0]
            depth = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
            pos_grid = int(round((state["pos_embed"].shape[1] - 1) ** 0.5))
        else:
            dim = embed_dim or _embed_dim_from_name(name)
            depth = depth or 12
            pos_grid = size // self.patch_size
        self.vit_config = ViTConfig(
            patch_size=self.patch_size, embed_dim=dim, depth=depth,
            num_heads=num_heads or max(dim // 64, 1), pos_grid=pos_grid,
        )
        model = ViT(self.vit_config)
        if state is not None:
            model.load_state_dict(state)
        else:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(_device(device), dtype).eval().requires_grad_(False)
        self.embed_dim = dim

    def to(self, device) -> "PretrainedViTWrapper":
        self.model = self.model.to(_device(device))
        return self

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised image -> (B, H/ps, W/ps, C)."""
        return self.model(image)

    def normalize(self, image01: torch.Tensor) -> torch.Tensor:
        """Apply this backbone's normalisation to a [0, 1] NHWC image."""
        mean = torch.tensor(self.config["mean"], dtype=image01.dtype, device=image01.device)
        std = torch.tensor(self.config["std"], dtype=image01.dtype, device=image01.device)
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
