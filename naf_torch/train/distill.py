"""Self-distillation feature targets (counterpart of
``naf_tpu/train/distill.py``, reference utils/training.py:24-50).

hr_feats = backbone(image); lr_feats = backbone(bilinear_downscale(image)).
The model learns to predict hr_feats from (image, lr_feats), which is what
makes NAF zero-shot across scales. The downscale size is drawn on the host
with numpy's ``RandomState``, so the port draws the sizes the JAX package
draws from the same seed.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from naf_torch.ops.resize import resize_bilinear

__all__ = ["round_to_nearest_multiple", "sample_lr_size", "compute_feats"]


def round_to_nearest_multiple(value: float, multiple: int = 14) -> int:
    return int(multiple * round(value / multiple))


def sample_lr_size(hw: Tuple[int, int], patch_size: int, down_factor: str = "fixed",
                   rng: Optional[np.random.RandomState] = None, min_rescale: float = 0.25,
                   max_rescale: float = 0.60) -> Tuple[int, int]:
    """Host-side LR image size (utils/training.py:36-46)."""
    if down_factor == "random":
        rng = rng or np.random
        factor = float(rng.uniform(min_rescale, max_rescale))
    elif down_factor == "fixed":
        factor = 0.5
    else:
        raise ValueError(f"unknown down_factor {down_factor}")
    return (round_to_nearest_multiple(hw[0] * factor, patch_size),
            round_to_nearest_multiple(hw[1] * factor, patch_size))


@torch.no_grad()
def compute_feats(backbone_apply: Callable, image: torch.Tensor, lr_size: Tuple[int, int]):
    """hr/lr feature targets of an NHWC image, without gradients."""
    hr_feats = backbone_apply(image)
    lr_feats = backbone_apply(resize_bilinear(image, lr_size))
    return hr_feats, lr_feats
