"""Model registry (counterpart of ``naf_tpu/models/registry.py``).

``build_model(name, embed_dim, ratio)`` returns an NHWC module with the
upsampler contract ``forward(image, features, output_size)``, or, for the
restorers JBU and JBF, ``forward(image_norm, image, output_size)``.
``ModelWrapper`` owns one such model with seeded random weights or a
converted checkpoint and serves it like ``naf_torch.api.NAFUpsampler``:

    ups = ModelWrapper("FeatUp")                        # seeded random weights, on CUDA
    hr = ups(image, lr_feats, (448, 448))               # NCHW in and out
    ups = ModelWrapper("JBU", device="cpu")             # the plain path on the CPU
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from naf_torch.api import _device, _init_weights

__all__ = ["build_model", "ModelWrapper", "register", "MODEL_REGISTRY"]

# Restorers of the JAX registry that the denoising slice ports.
_DENOISING_SLICE = ("IRCNN", "REDNet", "Restormer")


def _factories() -> Dict[str, Callable]:
    from naf_torch.models.anyup import AnyUpsampler
    from naf_torch.models.featup import JBU, FeatUp
    from naf_torch.models.jafar import JAFAR
    from naf_torch.models.jbf import JBF
    from naf_torch.models.naf import NAF
    from naf_torch.models.simple import Bilinear, Nearest

    return {
        "AnyUp": lambda embed_dim, ratio: AnyUpsampler(),
        "Bilinear": lambda embed_dim, ratio: Bilinear(),
        "FeatUp": lambda embed_dim, ratio: FeatUp(feature_dim=embed_dim, ratio=ratio),
        "JAFAR": lambda embed_dim, ratio: JAFAR(v_dim=embed_dim),
        "JBF": lambda embed_dim, ratio: JBF(),
        "JBU": lambda embed_dim, ratio: JBU(),
        "NAF": lambda embed_dim, ratio: NAF(),
        "Nearest": lambda embed_dim, ratio: Nearest(),
    }


MODEL_REGISTRY: Dict[str, Callable] = {}


def register(name: str, factory: Callable):
    """Add ``factory(embed_dim, ratio) -> nn.Module`` under ``name``."""
    MODEL_REGISTRY[name] = factory


def build_model(name: str, embed_dim: int = 384, ratio: int = 16) -> nn.Module:
    factories = {**_factories(), **MODEL_REGISTRY}
    if name in factories:
        return factories[name](embed_dim, ratio)
    if name in _DENOISING_SLICE:
        raise NotImplementedError(f"{name} is ported with the denoising slice of naf_torch "
                                  "(ROADMAP.md)")
    raise ValueError(f"Unknown upsampler: {name} (have {sorted(factories)})")


def _checkpoint_state(name: str, path: str) -> dict:
    """A torch checkpoint as the named model's state dict: FeatUp through the
    hub remap, AnyUp through its key map, NAF as a reference state dict."""
    if name not in ("FeatUp", "AnyUp", "NAF"):
        raise NotImplementedError(f"no checkpoint key map for {name}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if name == "FeatUp":
        from naf_torch.models.featup import featup_state_dict_from_torch

        return featup_state_dict_from_torch(state)
    if name == "AnyUp":
        from naf_torch.models.anyup import anyup_state_dict_from_torch

        return anyup_state_dict_from_torch(state)
    if "state_dict" in state and not any("encoder" in k for k in state):
        state = state["state_dict"]
    return state


class ModelWrapper:
    """One registry model on ``device`` in ``dtype``, in eval mode, served
    under ``torch.inference_mode``. Runs on CUDA unless the caller asks for
    another device, and raises without CUDA."""

    def __init__(self, name: str, embed_dim: int = 384, ratio: int = 16,
                 checkpoint: Optional[str] = None, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.device = _device(device)
        self.dtype = dtype
        self.name = name
        model = build_model(name, embed_dim, ratio)
        if checkpoint is not None:
            model.load_state_dict(_checkpoint_state(name, checkpoint))
        else:
            _init_weights(model, seed)
        self.model = model.to(self.device, dtype).eval()

    def __call__(self, image, features, output_size, channels_last: bool = False):
        """``(image, features, output_size)``, or ``(image_norm, image,
        output_size)`` for JBU and JBF, passed through unchanged. NCHW in and
        out by default, NHWC with ``channels_last=True``; inputs move to the
        model's device and dtype."""
        with torch.inference_mode():
            image = torch.as_tensor(image).to(self.device, self.dtype)
            features = torch.as_tensor(features).to(self.device, self.dtype)
            if not channels_last:
                image, features = image.permute(0, 2, 3, 1), features.permute(0, 2, 3, 1)
            out = self.model(image.contiguous(), features.contiguous(),
                             (int(output_size[0]), int(output_size[1])))
            return out if channels_last else out.permute(0, 3, 1, 2)
