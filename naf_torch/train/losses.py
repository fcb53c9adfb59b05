"""Training losses (counterpart of ``naf_tpu/train/losses.py``, reference
src/loss.py:7-45).

``Loss(loss_type)`` returns a callable producing {"total": scalar}; only
"mse" exists in the reference. The optional min-max branch normalises pred
and target by the target's per-position channel range (the NHWC channel
axis).
"""

from __future__ import annotations

import torch

__all__ = ["mse_loss", "Loss"]


def mse_loss(pred: torch.Tensor, target: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    pred = pred.float()
    target = target.float()
    if normalize:
        t_min = target.amin(dim=-1, keepdim=True)
        t_max = target.amax(dim=-1, keepdim=True)
        denom = t_max - t_min + 1e-6
        pred = (pred - t_min) / denom
        target = (target - t_min) / denom
    return ((pred - target) ** 2).mean()


class Loss:
    """Reference Loss wrapper: returns {"total": loss}."""

    def __init__(self, loss_type: str = "mse", dim: int = 384):
        if loss_type != "mse":
            raise NotImplementedError(f"Loss type {loss_type} not implemented")
        self.dim = dim

    def __call__(self, pred, target, normalize: bool = False):
        return {"total": mse_loss(pred, target, normalize=normalize)}
