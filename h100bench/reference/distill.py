"""The published self-distillation step in plain float32 PyTorch
(valeoai/NAF ``train.py``): the teacher's patch tokens of the image are the
targets, the teacher's tokens of the image downscaled by half are the
values, NAF upsamples those guided by the image (resized to the crop), MSE,
then AdamW. Independent of the program: its own NAF and ViT, the RoPE
rescale drawn as the port documents it (a generator seeded from (seed,
step) by numpy's ``SeedSequence``, one float64 uniform, log-uniform in
[1/2, 2]).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.naf import naf_forward
from h100bench.reference.vit import vit_forward

__all__ = ["rope_rescale", "resize", "distill_steps"]

IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def rope_rescale(seed: int, step: int, bound: float) -> float:
    """The step's RoPE coordinate rescale."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state))
    u = torch.rand(1, generator=g, dtype=torch.float64).item()
    return math.exp((2.0 * u - 1.0) * math.log(bound))


def resize(x, size):
    """Bilinear resize of an NHWC tensor (align_corners False, no antialias)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def _id(t):
    return t


def distill_steps(naf_init: dict, teacher: dict, config: dict, batches, seed: int, q8=_id):
    """Run the steps on ``batches`` ((B, H, W, 3) images in [0, 1], f32)
    from the f32 NAF weights ``naf_init``; returns (each step's loss, the
    first step's gradient per leaf, each leaf's change after the last
    step). TF32 is off for the duration."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _steps(naf_init, teacher, config, batches, seed, q8)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _steps(naf_init, teacher, config, batches, seed, q8):
    tr, tcfg, model = config["train"], config["teacher"], config["model"]
    dev = next(iter(naf_init.values())).device
    stats = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    im_mean, im_std = stats(IMAGENET[0]), stats(IMAGENET[1])
    ps = tcfg["patch_size"]
    size = config["img_size"]
    lr_side = int(ps * round(size * 0.5 / ps))
    hr = size // ps
    crop = min(224, 4 * hr)
    vit_p = {k: v.float() for k, v in teacher.items()}
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in naf_init.items()}
    opt = torch.optim.AdamW(params.values(), lr=tr["lr"], betas=(tr["b1"], tr["b2"]), eps=1e-8,
                            weight_decay=tr["weight_decay"], foreach=False)
    losses, grad1 = [], None
    for step, img in enumerate(batches):
        x = (img - im_mean) / im_std  # the model's and the teacher's statistics are ImageNet's
        with torch.no_grad():
            target = vit_forward(vit_p, tcfg, x, q8)
            values = vit_forward(vit_p, tcfg, resize(x, (lr_side, lr_side)), q8)
        pred = naf_forward(params, model, resize(x, (crop, crop)), values, (hr, hr),
                           rescale=rope_rescale(seed, step, model["rope_rescale"]), q8=q8)
        loss = ((pred - target) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grad1 is None:
            grad1 = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    delta = {k: params[k].detach() - naf_init[k].float() for k in params}
    return losses, grad1, delta
