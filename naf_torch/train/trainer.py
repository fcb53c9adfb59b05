"""NAF upsampler training loop (counterpart of ``naf_tpu/train/trainer.py``,
reference train.py:30-174).

Self-distillation: hr_feats = backbone(image); lr_feats = backbone(downscaled
image); the model predicts hr_feats from (image, lr_feats) with MSE
(train.py:120-137). The numerics follow the JAX train step:

- f32 master parameters and AdamW state; with ``use_bf16`` each step casts
  the parameters to bf16 (``torch.func.functional_call``) and computes in
  bf16, and the gradients flow back through the casts to the f32 masters;
- the backbone targets under ``no_grad``;
- ``torch.optim.AdamW(lr, betas, eps=1e-8, weight_decay)``, which is optax
  ``adamw``'s update, over all parameters; the port updates the parameters
  and the optimizer state in place;
- the RoPE coordinate augmentation drawn per step from a generator seeded
  from (seed, step), so a step is reproducible on its own;
- ``use_checkpointing`` recomputes the model forward in the backward pass
  (``torch.utils.checkpoint``).

Each step is annotated for ``torch.profiler`` with the ranges
``naf.backbone``, ``naf.forward``, ``naf.backward`` and ``naf.optimizer``.
Metrics stream to ``metrics.jsonl``; checkpoints (parameters, AdamW state and
step, ``torch.save``) make a resume exact.

Not ported yet: the scanned-dispatch ``device_stack`` path and the
data-parallel ``mesh``.
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
from torch.profiler import record_function

from naf_torch.api import _device, _init_weights
from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.nn.rope import RopeDraws
from naf_torch.ops.resize import resize_bilinear
from naf_torch.train.distill import sample_lr_size
from naf_torch.train.losses import mse_loss

__all__ = [
    "TrainConfig", "make_train_step", "make_optimizer", "train_upsampler",
    "step_generator", "save_checkpoint", "load_checkpoint", "versioned_dir",
]


@dataclasses.dataclass
class TrainConfig:
    train_steps: int = 25_000  # config/base.yaml
    img_size: int = 512  # config/base.yaml
    lr: float = 2e-4  # config/optimizer/adamw.yaml
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 1e-4
    batch_size: int = 4  # config/dataloader/train.yaml
    down_factor: str = "fixed"  # "fixed" (0.5) | "random" (U(0.25, 0.60))
    use_bf16: bool = True
    use_checkpointing: bool = False  # recompute the model forward
    log_every: int = 100
    ckpt_every: Optional[int] = None  # default: train_steps // 4
    viz_every: Optional[int] = None  # default: ckpt_every; 0 disables
    log_dir: str = "runs/naf"
    seed: int = 0


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's RoPE augmentation, from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _cast_params(model, dtype):
    return {k: p.to(dtype) for k, p in model.named_parameters()}


def make_train_step(model, backbone, optimizer, use_bf16: bool,
                    use_checkpointing: bool = False, seed: int = 0):
    """Returns ``step(image_ups, image_back, step_idx, lr_size, out_hw,
    crop_hw, draws=None) -> loss``: one distillation step that updates the
    model's parameters and the optimizer in place. ``draws`` (a
    ``RopeDraws``) replaces the step's own augmentation draw."""
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    rope = model.image_encoder.rope

    def step(image_ups, image_back, step_idx: int, lr_size, out_hw, crop_hw,
             draws: Optional[RopeDraws] = None):
        with record_function("naf.backbone"), torch.no_grad():
            hr_feats = backbone(image_back.to(dtype))
            lr_feats = backbone(resize_bilinear(image_back, lr_size).to(dtype))
        if draws is None:
            draws = rope.draw(step_generator(seed, step_idx))
        with record_function("naf.forward"):
            # the model input image: min(224, 4 * hr_size) (train.py:126)
            img_hr = resize_bilinear(image_ups, crop_hw).to(dtype)
            params = _cast_params(model, dtype)
            buffers = dict(model.named_buffers())

            def forward(img, feats):
                return functional_call(model, (params, buffers), (img, feats, out_hw),
                                       {"train": True, "draws": draws})

            if use_checkpointing:
                pred = torch.utils.checkpoint.checkpoint(forward, img_hr, lr_feats,
                                                         use_reentrant=False)
            else:
                pred = forward(img_hr, lr_feats)
            loss = mse_loss(pred, hr_feats)
        with record_function("naf.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("naf.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def _viz(model, backbone, use_bf16, image_ups, image_back, lr_size, out_hw, crop_hw):
    """The distillation triple at eval time (no augmentation): (hr_feats,
    lr_feats, pred) for a qualitative panel."""
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    hr_feats = backbone(image_back.to(dtype))
    lr_feats = backbone(resize_bilinear(image_back, lr_size).to(dtype))
    img_hr = resize_bilinear(image_ups, crop_hw).to(dtype)
    pred = functional_call(model, (_cast_params(model, dtype), dict(model.named_buffers())),
                           (img_hr, lr_feats, out_hw))
    return hr_feats, lr_feats, pred


def write_viz_panel(log_dir, step, image, hr_feats, lr_feats, pred):
    """[image | PCA(lr) | PCA(pred) | PCA(hr target)] -> PNG, with one joint
    PCA so colours compare across panels."""
    from naf_torch.utils.visualization import plot_feats

    path = os.path.join(log_dir, f"panel_step{step:07d}.png")
    f32 = lambda t: t[0].float().cpu().numpy()
    plot_feats(f32(image), [f32(lr_feats), f32(pred), f32(hr_feats)], path=path)
    return path


def train_upsampler(model, backbone, data_iter: Iterator[np.ndarray], cfg: TrainConfig,
                    params: Optional[dict] = None, opt_state: Optional[dict] = None,
                    start_step: int = 0, device="cuda"):
    """Train ``model`` against the frozen ``backbone`` on images from
    ``data_iter`` (NHWC float [0, 1], (B, img_size, img_size, 3)), on
    ``device`` (CUDA unless asked otherwise; without CUDA it raises).

    ``params`` (a state dict) and ``opt_state`` (an AdamW state dict) resume
    from a checkpoint at ``start_step``; without ``params`` the model's
    weights are drawn from ``cfg.seed``. Returns the model, its parameters
    f32 on ``device``."""
    dev = _device(device)
    if params is None:
        _init_weights(model, cfg.seed)
    else:
        model.load_state_dict(params)
    model.to(dev, torch.float32)
    backbone.to(dev)
    optimizer = make_optimizer(model, cfg)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    step_fn = make_train_step(model, backbone, optimizer, cfg.use_bf16,
                              cfg.use_checkpointing, seed=cfg.seed)

    rng = np.random.RandomState(cfg.seed)
    ps = backbone.patch_size
    for _ in range(start_step):  # the lr sizes the skipped steps drew
        sample_lr_size((cfg.img_size, cfg.img_size), ps, cfg.down_factor, rng)
    stats = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    # the model's input takes ImageNet statistics, the backbone's its own
    im_mean, im_std = stats(IMAGENET_DEFAULT_MEAN), stats(IMAGENET_DEFAULT_STD)
    b_mean, b_std = stats(backbone.config["mean"]), stats(backbone.config["std"])

    log_dir = versioned_dir(cfg.log_dir)
    ckpt_every = cfg.ckpt_every or max(cfg.train_steps // 4, 1)
    viz_every = ckpt_every if cfg.viz_every is None else cfg.viz_every
    t0 = time.time()
    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as mf:
        for step in range(start_step, cfg.train_steps):
            batch = next(data_iter)
            img = torch.as_tensor(np.asarray(batch), dtype=torch.float32).to(dev)
            img_ups = (img - im_mean) / im_std
            img_back = (img - b_mean) / b_std
            lr_size = sample_lr_size(tuple(img.shape[1:3]), ps, cfg.down_factor, rng)
            hr_hw = (img.shape[1] // ps, img.shape[2] // ps)
            crop_hw = tuple(min(224, 4 * v) for v in hr_hw)
            loss = step_fn(img_ups, img_back, step, lr_size, hr_hw, crop_hw)

            if step % cfg.log_every == 0:
                loss_v = float(loss)
                rec = {"step": step, "loss": loss_v, "lr_size": list(lr_size),
                       "elapsed_s": round(time.time() - t0, 1)}
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                print(f"step {step}/{cfg.train_steps} loss {loss_v:.5f}", flush=True)
            if viz_every and ((step + 1) % viz_every == 0 or step + 1 == cfg.train_steps):
                try:
                    triple = _viz(model, backbone, cfg.use_bf16, img_ups, img_back, lr_size,
                                  hr_hw, crop_hw)
                    write_viz_panel(log_dir, step + 1, img, *triple)
                except Exception as e:  # a panel never stops a run, as in the JAX loop
                    print(f"viz panel failed at step {step + 1}: {e}", flush=True)
            if (step + 1) % ckpt_every == 0 or step + 1 == cfg.train_steps:
                save_checkpoint(log_dir, step + 1, model, optimizer)
    return model


def versioned_dir(base: str) -> str:
    """``base/version_N`` with N = max existing + 1 (reference
    utils/training.py:53-65 logger semantics)."""
    os.makedirs(base, exist_ok=True)
    versions = [int(d.split("_")[-1]) for d in os.listdir(base)
                if d.startswith("version_") and d.split("_")[-1].isdigit()]
    path = os.path.join(base, f"version_{max(versions, default=-1) + 1}")
    os.makedirs(path, exist_ok=True)
    return path


def save_checkpoint(log_dir: str, step: int, model, optimizer=None) -> str:
    """``log_dir/ckpt_{step}.pt``: {"params", "opt_state", "step"}."""
    path = os.path.abspath(os.path.join(log_dir, f"ckpt_{step}.pt"))
    payload = {"params": model.state_dict(), "step": step}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    torch.save(payload, path)
    return path


def load_checkpoint(path: str) -> dict:
    """A checkpoint written by :func:`save_checkpoint`, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
