"""Denoising / restoration training (counterpart of ``naf_tpu/train/denoise.py``,
reference denoising.py:180-421).

Model contract: ``model(noisy_norm, noisy, (H, W)) -> denoised``, NHWC (NAF
takes the noisy image itself as its "features", denoising.py:212-213, and
runs its inference path, ``train=False``, as the JAX ``model.apply`` does:
kernels K1 and K2 forward, K2's twin through K3 and K4 backward; the
restorers predict the noise residual). Loss: w_l1 L1 + w_l2 L2 + w_ssim
(1 - SSIM). The step follows the JAX ``_step_core``: noise, ImageNet
normalisation, the model in the working dtype on f32 master parameters
(``torch.func.functional_call`` on cast copies), then AdamW (optax
``adamw``'s update: b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay),
in place.

``train_denoiser(..., device_stack=..., batch_size=...)`` runs ``log_every``
steps per call of :func:`make_denoise_chunk`, each batch gathered on the
device from the resident stack by an index vector; the chunk's losses stay
on the device in one tensor, read once per chunk (a Python loop is the
counterpart of the JAX ``lax.scan``). The noise of step s is drawn from a
generator seeded from (seed, s) on the batch's device (``step_generator``),
so a step is reproducible on its own. Validation runs in f32: PSNR / SSIM
on clamped outputs and a [noisy | denoised | clean] panel.

Each step is annotated for ``torch.profiler`` with the spans
(``naf_torch.utils.spans``) ``denoise.forward``, ``denoise.backward`` and
``denoise.optimizer``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from naf_torch.api import _device, _init_weights
from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.data.device_cache import index_batches
from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator, psnr, ssim
from naf_torch.ops.resize import resize_bilinear
from naf_torch.train.trainer import _cast_params, step_generator
from naf_torch.utils.spans import span, to_device

__all__ = ["DenoiseConfig", "make_denoise_step", "make_denoise_chunk", "train_denoiser",
           "validate_denoiser"]


@dataclasses.dataclass
class DenoiseConfig:
    train_steps: int = 25_000
    val_steps: int = 100
    img_size: int = 448
    lr: float = 2e-4
    weight_decay: float = 1e-5
    noise_type: str = "gaussian"
    noise_params: Optional[dict] = None
    l1_weight: float = 1.0
    l2_weight: float = 5.0
    ssim_weight: float = 0.2
    use_bf16: bool = True
    log_every: int = 50
    log_dir: str = "runs/denoise"
    seed: int = 0


def make_optimizer(model: torch.nn.Module, cfg: DenoiseConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = to_device(IMAGENET_DEFAULT_MEAN, x.device, x.dtype)
    std = to_device(IMAGENET_DEFAULT_STD, x.device, x.dtype)
    return (x - mean) / std


def make_denoise_step(model, optimizer, criterion, noise_gen, noise_params, img_hw,
                      use_bf16: bool):
    """Returns ``step(clean, gen) -> loss``: one step on clean (B, H, W, 3)
    f32 images with noise drawn from ``gen`` by ``noise_gen(gen, clean,
    noise_params)``; it updates the model's parameters and the optimizer in
    place and returns the loss as a device scalar."""
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    img_hw = (int(img_hw[0]), int(img_hw[1]))

    def step(clean: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        noisy = noise_gen(gen, clean, noise_params)
        noisy_norm = _normalize(noisy)
        with span("denoise.forward"):
            params = _cast_params(model, dtype)
            pred = functional_call(model, (params, dict(model.named_buffers())),
                                   (noisy_norm.to(dtype), noisy.to(dtype), img_hw))
            loss = criterion(pred, clean)["total"]
        with span("denoise.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("denoise.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def make_denoise_chunk(step, seed: int):
    """Returns ``chunk(stack, idx, step0) -> losses``: ``idx`` (K, B) batch
    indices into the resident ``stack`` (N, H, W, 3); step ``step0 + i``
    gathers its batch on the device and draws its noise from
    ``step_generator(seed, step0 + i)``. The K losses come back as one
    device tensor; nothing inside waits on the card."""

    def chunk(stack: torch.Tensor, idx: np.ndarray, step0: int) -> torch.Tensor:
        idx_dev = to_device(np.ascontiguousarray(idx, np.int64), stack.device)
        losses = torch.empty(idx_dev.shape[0], device=stack.device)
        for i in range(idx_dev.shape[0]):
            clean = stack.index_select(0, idx_dev[i])
            losses[i] = step(clean, step_generator(seed, step0 + i, stack.device))
        return losses

    return chunk


def train_denoiser(model, data_iter: Optional[Iterator], cfg: DenoiseConfig,
                   params: Optional[dict] = None, *, device_stack: Optional[torch.Tensor] = None,
                   batch_size: Optional[int] = None, device="cuda"):
    """Train ``model`` on ``device`` (CUDA unless asked otherwise); data_iter
    yields clean (B, H, W, 3) float [0, 1] batches. Without ``params`` (a
    state dict) the weights are drawn from ``cfg.seed``.

    Alternatively ``device_stack`` ((N, H, W, 3) f32 on the device, see
    ``naf_torch.data.device_cached_stack``) with ``batch_size``: training
    then runs ``log_every`` steps per chunk with on-device batch gathers, in
    the epoch order of the JAX package (``np.random.RandomState(seed)``).
    Metrics go to ``log_dir/metrics.jsonl``. Returns the model, f32."""
    dev = _device(device)
    if params is None:
        _init_weights(model, cfg.seed)
    else:
        model.load_state_dict(params)
    model.to(dev, torch.float32)
    optimizer = make_optimizer(model, cfg)
    criterion = DenoisingLoss(cfg.l1_weight, cfg.l2_weight, cfg.ssim_weight)
    img_hw = (cfg.img_size, cfg.img_size)
    step_fn = make_denoise_step(model, optimizer, criterion, NoiseGenerator(cfg.noise_type),
                                cfg.noise_params, img_hw, cfg.use_bf16)
    os.makedirs(cfg.log_dir, exist_ok=True)
    t0 = time.time()

    def log(mf, rec, total):
        mf.write(json.dumps(rec) + "\n")
        mf.flush()
        print(f"step {rec['step'] + 1}/{total} loss {rec['loss']:.5f}", flush=True)

    with open(os.path.join(cfg.log_dir, "metrics.jsonl"), "a") as mf:
        if device_stack is not None:
            if batch_size is None:
                raise ValueError("device_stack requires batch_size")
            if tuple(device_stack.shape[1:3]) != img_hw:
                raise ValueError(f"device_stack spatial {tuple(device_stack.shape[1:3])} != "
                                 f"{img_hw}")
            chunk_fn = make_denoise_chunk(step_fn, cfg.seed)
            stream = index_batches(device_stack.shape[0], batch_size,
                                   rng=np.random.RandomState(cfg.seed))
            done = 0
            while done < cfg.train_steps:
                k = min(max(cfg.log_every, 1), cfg.train_steps - done)
                losses = chunk_fn(device_stack, np.stack([next(stream) for _ in range(k)]), done)
                done += k
                log(mf, {"step": done - 1, "loss": float(losses[-1]),
                         "elapsed_s": round(time.time() - t0, 1)}, cfg.train_steps)
            return model
        for step in range(cfg.train_steps):
            clean = to_device(np.asarray(next(data_iter)), dev, torch.float32)
            if tuple(clean.shape[1:3]) != img_hw:
                clean = resize_bilinear(clean, img_hw)
            loss = step_fn(clean, step_generator(cfg.seed, step, dev))
            if step % cfg.log_every == 0:
                log(mf, {"step": step, "loss": float(loss),
                         "elapsed_s": round(time.time() - t0, 1)}, cfg.train_steps)
    return model


@torch.no_grad()
def validate_denoiser(model, data_iter, cfg: DenoiseConfig, viz_path: Optional[str] = None):
    """PSNR / SSIM over ``cfg.val_steps`` validation batches in f32 (the
    model's f32 parameters, as ``train_denoiser`` returns them), on the
    model's device (denoising.py:268-312): noise from (seed + 1, step), the
    model's output clamped to [0, 1]. With ``viz_path``, writes a [noisy |
    denoised | clean] PNG of the first image (the reference's TensorBoard
    image, denoising.py:218-222)."""
    dev = next(model.parameters()).device
    noise_gen = NoiseGenerator(cfg.noise_type)
    img_hw = (cfg.img_size, cfg.img_size)
    psnrs, ssims = [], []
    for step, batch in enumerate(data_iter):
        if step >= cfg.val_steps:
            break
        clean = to_device(batch, dev, torch.float32)
        if tuple(clean.shape[1:3]) != img_hw:
            clean = resize_bilinear(clean, img_hw)
        noisy = noise_gen(step_generator(cfg.seed + 1, step, dev), clean, cfg.noise_params)
        pred = model(_normalize(noisy), noisy, img_hw).clamp(0, 1)
        psnrs.append(psnr(pred, clean))
        ssims.append(ssim(pred, clean))
        if viz_path is not None and step == 0:
            try:
                from PIL import Image

                panel = torch.cat([t[0] for t in (noisy, pred, clean)], dim=1)
                panel = (panel.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
                Image.fromarray(panel).save(viz_path)
            except Exception as e:  # a panel never stops a run, as in the JAX loop
                print(f"denoise viz panel failed: {e}")
    return {"psnr": float(torch.stack(psnrs).mean()), "ssim": float(torch.stack(ssims).mean())}
