"""Denoising / restoration training CLI (counterpart of ``denoising.py``,
reference denoising.py).

    python -m naf_torch.denoising model=naf|ircnn|rednet|restormer [key=value ...]

e.g. the repository's own denoiser run (``benchmarks/denoising.json``) on the
card:

    python -m naf_torch.denoising model=naf model.kernel_size=15 model.heads_attn=1 \\
        model.heads_rope=1 denoising.noise_params.std=0.5 train_dataloader.batch_size=8 \\
        train_steps=10 val_steps=4 dataset.root=benchmarks/real_shard/ade20k/images/training \\
        dataset.val_root=benchmarks/real_shard/ade20k/images/validation

and a smoke run on the CPU:

    python -m naf_torch.denoising synthetic=true device=cpu img_size=32 train_steps=2 \\
        model.dim=32 model.heads_attn=1 model.heads_rope=1 model.kernel_size=5

The config is ``config/base_denoising.yaml`` with the repository's override
syntax. NAF doubles as a restoration model: the noisy image itself is its
"features" input (reference denoising.py:212-213). ``synthetic=true``
replaces the image folders with seeded random images; ``dataset.val_root``
names a held-out folder (default: the training folder); a corpus of at most
``device_cache_max_images`` images (512) is decoded once and kept on the
device, its batches gathered there and ``log_every`` steps (50) run per
chunk, and a larger one streams through the ``DataLoader``; ``sanity`` runs
one step and one validation batch; ``device`` defaults to ``cuda``. The
image-folder listings are cached under ``build/listings/`` of the checkout.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from naf_torch.config import load_config
from naf_torch.train.denoise import DenoiseConfig, train_denoiser, validate_denoiser

LISTINGS = Path(__file__).resolve().parents[1] / "build" / "listings"


def synthetic_images(batch_size: int, img_size: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    while True:
        yield rng.rand(batch_size, img_size, img_size, 3).astype(np.float32)


def build_denoiser(model_cfg: dict):
    """The port's model named by a ``config/model`` node (its ``_target_``
    names the JAX class), built by ``models.registry.instantiate``."""
    from naf_torch.models.naf import NAF
    from naf_torch.models.registry import instantiate
    from naf_torch.models.restorers import IRCNN, REDNet
    from naf_torch.models.restormer import Restormer

    classes = {"naf": NAF, "ircnn": IRCNN, "rednet": REDNet, "restormer": Restormer}
    name = model_cfg.get("name", "naf")
    if name not in classes:
        raise ValueError(f"no denoising model {name!r} (have {sorted(classes)})")
    return instantiate(classes[name], model_cfg, name)


def denoise_config(cfg: dict) -> DenoiseConfig:
    den = cfg["denoising"]
    dcfg = DenoiseConfig(
        train_steps=cfg["train_steps"], val_steps=cfg.get("val_steps", 100),
        img_size=cfg["img_size"], lr=cfg["optimizer"]["lr"],
        weight_decay=cfg["optimizer"].get("weight_decay", 1e-5),
        noise_type=den["noise_type"], noise_params=den.get("noise_params"),
        l1_weight=den["loss"]["l1_weight"], l2_weight=den["loss"]["l2_weight"],
        ssim_weight=den["loss"]["ssim_weight"], use_bf16=cfg.get("use_bf16", True),
        log_every=cfg.get("log_every", 50), log_dir=cfg.get("run_dir", "runs/denoise"),
        seed=cfg.get("seed", 0),
    )
    if cfg.get("sanity"):
        dcfg.train_steps = dcfg.val_steps = 1
    return dcfg


def _folder(root: str, img_size: int):
    from naf_torch.data import ImageFolderDataset, image_transform

    LISTINGS.mkdir(parents=True, exist_ok=True)
    cache = LISTINGS / os.path.abspath(root).strip(os.sep).replace(os.sep, "_")
    return ImageFolderDataset(root, transform=lambda im: image_transform(im, img_size),
                              root_cache=str(cache))


def load_data(cfg: dict, dcfg: DenoiseConfig, device):
    """(train_iter, device_stack, val_iter): seeded random images, or the
    image folders, each resident on the device when it holds at most
    ``device_cache_max_images`` images (train: ``device_stack``; val: an
    iterator of device batches) and streamed otherwise."""
    bs, vbs = cfg["train_dataloader"]["batch_size"], cfg["val_dataloader"]["batch_size"]
    if cfg.get("synthetic"):
        return (synthetic_images(bs, dcfg.img_size), None,
                synthetic_images(vbs, dcfg.img_size, seed=1))
    from naf_torch.data import DataLoader
    from naf_torch.data.device_cache import device_cached_batches, device_cached_stack

    ds = _folder(cfg["dataset"]["root"], dcfg.img_size)
    val_root = cfg["dataset"].get("val_root")
    val_ds = _folder(val_root, dcfg.img_size) if val_root else ds
    cache_max = cfg.get("device_cache_max_images", 512)

    def forever(loader):
        while True:
            for b in loader:
                yield b["image"]

    train_iter = stack = None
    if len(ds) <= cache_max:
        stack = device_cached_stack(ds, device)
    else:
        train_iter = forever(DataLoader(
            ds, bs, shuffle=True, num_workers=cfg["train_dataloader"].get("num_workers", 4),
            drop_last=True))
    if len(val_ds) <= cache_max:
        val_iter = device_cached_batches(val_ds, vbs, shuffle=False, device=device)
    else:
        val_iter = forever(DataLoader(val_ds, vbs, shuffle=False, num_workers=2,
                                      drop_last=True))
    return train_iter, stack, val_iter


def main(argv):
    overrides = [a for a in argv if "=" in a]
    cfg = load_config("base_denoising", overrides)
    device = cfg.get("device", "cuda")
    dcfg = denoise_config(cfg)
    model = build_denoiser(cfg["model"])
    train_iter, stack, val_iter = load_data(cfg, dcfg, device)
    model = train_denoiser(model, train_iter, dcfg, device_stack=stack,
                           batch_size=cfg["train_dataloader"]["batch_size"], device=device)
    metrics = validate_denoiser(model, val_iter, dcfg,
                                viz_path=os.path.join(dcfg.log_dir, "val_panel.png"))
    print(f"validation: PSNR {metrics['psnr']:.2f} dB, SSIM {metrics['ssim']:.4f}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
