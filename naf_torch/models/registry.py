"""Model registry (counterpart of ``naf_tpu/models/registry.py``).

``build_model(name, embed_dim, ratio)`` returns an NHWC module with the
upsampler contract ``forward(image, features, output_size)``, or, for JBU
and JBF and the restorers IRCNN, REDNet and Restormer, ``forward(image_norm,
image, output_size)``.
``ModelWrapper`` owns one such model with seeded random weights or a
converted checkpoint and serves it like ``naf_torch.api.NAFUpsampler``:

    ups = ModelWrapper("FeatUp")                        # seeded random weights, on CUDA
    hr = ups(image, lr_feats, (448, 448))               # NCHW in and out
    ups = ModelWrapper("JBU", device="cpu")             # the plain path on the CPU
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch
from torch import nn

from naf_torch.api import _device, _init_weights
from naf_torch.utils.spans import to_device

__all__ = ["build_model", "build_from_config", "instantiate", "ModelWrapper", "register",
           "MODEL_REGISTRY"]

def _factories() -> Dict[str, Callable]:
    from naf_torch.models.anyup import AnyUpsampler
    from naf_torch.models.featup import JBU, FeatUp
    from naf_torch.models.jafar import JAFAR
    from naf_torch.models.jbf import JBF
    from naf_torch.models.naf import NAF
    from naf_torch.models.restorers import IRCNN, REDNet
    from naf_torch.models.restormer import Restormer
    from naf_torch.models.simple import Bilinear, Nearest

    return {
        "AnyUp": lambda embed_dim, ratio: AnyUpsampler(),
        "Bilinear": lambda embed_dim, ratio: Bilinear(),
        "FeatUp": lambda embed_dim, ratio: FeatUp(feature_dim=embed_dim, ratio=ratio),
        "IRCNN": lambda embed_dim, ratio: IRCNN(),
        "JAFAR": lambda embed_dim, ratio: JAFAR(v_dim=embed_dim),
        "JBF": lambda embed_dim, ratio: JBF(),
        "JBU": lambda embed_dim, ratio: JBU(),
        "NAF": lambda embed_dim, ratio: NAF(),
        "Nearest": lambda embed_dim, ratio: Nearest(),
        "REDNet": lambda embed_dim, ratio: REDNet(),
        "Restormer": lambda embed_dim, ratio: Restormer(),
    }


MODEL_REGISTRY: Dict[str, Callable] = {}


def register(name: str, factory: Callable):
    """Add ``factory(embed_dim, ratio) -> nn.Module`` under ``name``."""
    MODEL_REGISTRY[name] = factory


def build_model(name: str, embed_dim: int = 384, ratio: int = 16) -> nn.Module:
    factories = {**_factories(), **MODEL_REGISTRY}
    if name in factories:
        return factories[name](embed_dim, ratio)
    raise ValueError(f"Unknown upsampler: {name} (have {sorted(factories)})")


# ``config/model`` names of the upsamplers that take (image, features, size),
# and their registry names
CONFIG_NAMES = {"naf": "NAF", "bilinear": "Bilinear", "nearest": "Nearest", "featup": "FeatUp",
                "anyup": "AnyUp", "jafar": "JAFAR"}


def instantiate(cls, model_cfg: dict, name: str) -> nn.Module:
    """``cls`` built from a ``config/model`` node, as the JAX CLIs'
    ``instantiate`` builds its ``_target_``: the node's keys that ``cls``
    takes as arguments; keys it does not take (another model's, as when one
    command line serves several models) are named and left out."""
    takes = inspect.signature(cls).parameters
    keys = [k for k in model_cfg if k not in ("_target_", "name")]
    unused = [k for k in keys if k not in takes]
    if unused:
        print(f"model={name} takes no {', '.join(unused)}; left out", flush=True)
    return cls(**{k: model_cfg[k] for k in keys if k in takes})


def build_from_config(model_cfg: dict, checkpoint: Optional[str] = None,
                      seed: int = 0) -> nn.Module:
    """The upsampler of a ``config/model`` node: the port's class of the
    registry entry its ``name`` names (``instantiate``), with the weights of
    ``checkpoint``, or random ones drawn from ``seed``."""
    from naf_torch.models.anyup import AnyUpsampler
    from naf_torch.models.featup import FeatUp
    from naf_torch.models.jafar import JAFAR
    from naf_torch.models.naf import NAF
    from naf_torch.models.simple import Bilinear, Nearest

    classes = {"NAF": NAF, "Bilinear": Bilinear, "Nearest": Nearest, "FeatUp": FeatUp,
               "AnyUp": AnyUpsampler, "JAFAR": JAFAR}
    name = model_cfg.get("name")
    if name not in CONFIG_NAMES:
        raise NotImplementedError(f"model {name!r} is not an (image, features, size) upsampler "
                                  f"of the registry (have {sorted(CONFIG_NAMES)})")
    model = instantiate(classes[CONFIG_NAMES[name]], model_cfg, name)
    if checkpoint is not None:
        model.load_state_dict(_checkpoint_state(CONFIG_NAMES[name], checkpoint))
    else:
        _init_weights(model, seed)
    return model


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
        output_size)`` for JBU, JBF and the restorers, passed through
        unchanged. NCHW in and
        out by default, NHWC with ``channels_last=True``; inputs move to the
        model's device and dtype."""
        with torch.inference_mode():
            image = to_device(image, self.device, self.dtype)
            features = to_device(features, self.device, self.dtype)
            if not channels_last:
                image, features = image.permute(0, 2, 3, 1), features.permute(0, 2, 3, 1)
            out = self.model(image.contiguous(), features.contiguous(),
                             (int(output_size[0]), int(output_size[1])))
            return out if channels_last else out.permute(0, 3, 1, 2)
