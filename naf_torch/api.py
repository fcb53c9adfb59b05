"""Public zero-shot upsampling API (counterpart of ``naf_tpu/api.py``).

    model = load_naf_params()                          # seeded random weights, on CUDA
    model = load_naf_params("naf_release.pth")         # a reference-format checkpoint
    hr = naf(model, image, lr_feats, (H, W))           # NCHW in and out

or the stateful wrapper, which runs under ``torch.inference_mode``:

    ups = NAFUpsampler()
    hr = ups(image, lr_feats, (H, W))

Entry points run on CUDA unless the caller asks for another device
(``device="cpu"`` runs the plain PyTorch path). Without CUDA and without a
device, they raise rather than fall back to the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from naf_torch.models.naf import NAF

__all__ = ["naf", "load_naf_params", "NAFUpsampler"]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev


@torch.no_grad()
def _init_weights(model: nn.Module, seed: int) -> None:
    """torch's default Conv2d / Linear init (uniform +-1/sqrt(fan_in) for
    weight and bias), drawn on the CPU from a generator seeded with ``seed``;
    norms and other parameters keep their constructors' values."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)


def load_naf_params(checkpoint: Optional[str] = None, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.float32, **model_kwargs) -> NAF:
    """Build a ``NAF`` module in eval mode on ``device`` with ``dtype`` weights.

    checkpoint: optional path to a reference-format state dict (e.g. the
    released naf_release.pth), loaded with ``load_state_dict``; without one
    the weights are random, drawn from ``seed``. model_kwargs are NAF
    hyperparameters (dim, heads_attn, kernel_size, ...).
    """
    dev = _device(device)
    model = NAF(**model_kwargs)
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if "state_dict" in state and not any("encoder" in k for k in state):
            state = state["state_dict"]
        model.load_state_dict(state)
    else:
        _init_weights(model, seed)
    return model.to(dev, dtype).eval()


def naf(model: NAF, image, lr_feats, target_size: Tuple[int, int],
        channels_last: bool = False) -> torch.Tensor:
    """Upsample ``lr_feats`` to ``target_size``, guided by ``image``.

    The reference forward contract: image (B, 3, H_img, W_img), lr_feats
    (B, C, h, w) -> (B, C, *target_size); NHWC with channels_last=True.
    Inputs move to the model's device and dtype.
    """
    ref = next(model.parameters())
    image = torch.as_tensor(image).to(ref.device, ref.dtype)
    lr_feats = torch.as_tensor(lr_feats).to(ref.device, ref.dtype)
    if not channels_last:
        image = image.permute(0, 2, 3, 1)
        lr_feats = lr_feats.permute(0, 2, 3, 1)
    out = model(image.contiguous(), lr_feats.contiguous(),
                (int(target_size[0]), int(target_size[1])))
    return out if channels_last else out.permute(0, 3, 1, 2)


class NAFUpsampler:
    """Stateful wrapper mirroring the hub module's usage; inference only."""

    def __init__(self, model: Optional[NAF] = None, checkpoint: Optional[str] = None,
                 seed: int = 0, device="cuda", dtype: torch.dtype = torch.float32,
                 **model_kwargs):
        if model is None:
            model = load_naf_params(checkpoint, seed, device, dtype, **model_kwargs)
        self.model = model

    def __call__(self, image, lr_feats, target_size, channels_last: bool = False):
        with torch.inference_mode():
            return naf(self.model, image, lr_feats, target_size, channels_last)
