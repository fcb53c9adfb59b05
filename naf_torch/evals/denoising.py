"""Denoising metrics and losses (counterpart of ``naf_tpu/evals/denoising.py``,
reference denoising.py:25-177), NHWC.

``NoiseGenerator`` (gaussian / salt-and-pepper, optional "range" strength)
draws from a ``torch.Generator`` where the JAX package splits a key: the two
give different numbers from one seed, so tests hand both packages the same
noise. ``psnr``, the Gaussian-window ``ssim``, the 3 x 3 average-pool
``ssim_loss`` and ``DenoisingLoss`` (w_l1 L1 + w_l2 L2 + w_ssim (1 - SSIM))
compute in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from naf_torch.utils.spans import to_device

__all__ = ["NoiseGenerator", "DenoisingLoss", "psnr", "ssim", "ssim_loss"]


class NoiseGenerator:
    """Noise injection; a strength of "range" draws U(0.1, 0.5) per call."""

    def __init__(self, noise_type: str = "gaussian"):
        if noise_type not in ("gaussian", "salt_pepper"):
            raise ValueError(f"Unknown noise type: {noise_type}")
        self.noise_type = noise_type

    def __call__(self, gen: torch.Generator, image: torch.Tensor, noise_params=None):
        """``image`` with noise drawn from ``gen`` (a generator on the
        image's device)."""
        params = noise_params or {}
        draw = lambda fn: fn(image.shape, generator=gen, device=image.device)  # noqa: E731
        if self.noise_type == "gaussian":
            std = params.get("std", 0.1)
            if std == "range":
                std = 0.1 + 0.4 * torch.rand((), generator=gen, device=image.device)
            return image + draw(torch.randn).to(image.dtype) * std
        prob = params.get("prob", 0.1)
        if prob == "range":
            prob = 0.1 + 0.4 * torch.rand((), generator=gen, device=image.device)
        mask = draw(torch.rand) < prob
        salt = draw(torch.rand) > 0.5
        return torch.where(mask, salt.to(image.dtype), image)


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 20.0 * torch.log10(max_val / torch.sqrt(mse))


def _gaussian_window(window_size: int) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * (window_size / 6.0) ** 2))
    g /= g.sum()
    return g[:, None] * g[None, :]


def _depthwise_filter(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Per-channel 2-D filter of an NHWC tensor, zero padding k // 2, in full
    f32 (cuDNN's TF32 off, as the JAX package asks for HIGHEST precision)."""
    k, c = window.shape[0], x.shape[-1]
    w = to_device(window, x.device, x.dtype).expand(c, 1, k, k)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1)


def _ssim_map(pred, target, filt, c1, c2):
    mu1, mu2 = filt(pred), filt(target)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(pred * pred) - mu1_sq
    s2 = filt(target * target) - mu2_sq
    s12 = filt(pred * target) - mu12
    return ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def ssim(pred, target, window_size: int = 11, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Gaussian-window SSIM (reference denoising.py:74-106), NHWC."""
    win = _gaussian_window(window_size)
    filt = lambda t: _depthwise_filter(t, win)  # noqa: E731
    return _ssim_map(pred.float(), target.float(), filt, c1, c2).mean()


def _avg_pool3(x):
    """3 x 3 stride-1 average pool, zero-padded (F.avg_pool2d(x, 3, 1, 1))."""
    return _depthwise_filter(x, np.full((3, 3), 1.0 / 9.0, np.float32))


def ssim_loss(pred, target, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """1 - the average-pool SSIM (reference denoising.py:149-166)."""
    return 1.0 - _ssim_map(pred.float(), target.float(), _avg_pool3, c1, c2).mean()


class DenoisingLoss:
    """w_l1 * L1 + w_l2 * L2 + w_ssim * (1 - SSIM) (denoising.py:129-177)."""

    def __init__(self, l1_weight=1.0, l2_weight=1.0, ssim_weight=0.1):
        self.l1_weight = l1_weight
        self.l2_weight = l2_weight
        self.ssim_weight = ssim_weight

    def __call__(self, pred, target) -> dict:
        losses = {}
        p, t = pred.float(), target.float()
        if self.l1_weight > 0:
            losses["l1"] = torch.mean(torch.abs(p - t)) * self.l1_weight
        if self.l2_weight > 0:
            losses["l2"] = torch.mean((p - t) ** 2) * self.l2_weight
        if self.ssim_weight > 0:
            losses["ssim"] = ssim_loss(p, t) * self.ssim_weight
        losses["total"] = sum(losses.values())
        return losses
