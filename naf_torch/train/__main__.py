"""NAF upsampler training CLI (counterpart of ``train.py``).

    python -m naf_torch.train [key=value ...]

e.g.

    python -m naf_torch.train synthetic=true img_size=448 train_steps=20
    python -m naf_torch.train dataroot=/data train_steps=25000
    python -m naf_torch.train synthetic=true device=cpu img_size=56 train_steps=2 \\
        model.dim=32 model.heads_attn=2 model.heads_rope=2 model.kernel_size=5 \\
        backbone.depth=1 backbone.embed_dim=64 train_dataloader.batch_size=1

The config groups and the override syntax are the repository's
(``config/base.yaml``). ``synthetic=true`` replaces the image folder with
seeded random images; ``model_ckpt`` resumes from a port checkpoint
(``ckpt_<step>.pt``) or starts from a reference-format ``.pth``; ``sanity``
runs one step; ``device`` defaults to ``cuda``. Only ``model=naf`` is ported.

``img_size`` must be a multiple of the backbone's patch (14 for DINOv2):
``config/base.yaml``'s 512 is not, and the ViT raises on it, as the JAX
package's does.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from naf_torch.backbones import load_multiple_backbones
from naf_torch.config import load_config
from naf_torch.models.naf import NAF
from naf_torch.train.trainer import TrainConfig, load_checkpoint, train_upsampler

_MODEL_KEYS = ("dim", "heads_attn", "heads_rope", "kernel_size", "use_encoder", "rope_base",
               "rope_rescale", "img_layers", "na_impl")


def synthetic_images(batch_size: int, img_size: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    while True:
        yield rng.rand(batch_size, img_size, img_size, 3).astype(np.float32)


def folder_images(cfg):
    from naf_torch.data import DataLoader, ImageFolderDataset, image_transform

    ds = ImageFolderDataset(cfg["dataset"]["root"],
                            transform=lambda im: image_transform(im, cfg["img_size"]))
    loader = DataLoader(
        ds, batch_size=cfg["train_dataloader"]["batch_size"],
        shuffle=cfg["train_dataloader"].get("shuffle", True),
        num_workers=cfg["train_dataloader"].get("num_workers", 4), drop_last=True,
    )
    while True:
        for batch in loader:
            yield batch["image"]


def build_model(model_cfg: dict) -> NAF:
    """The port's NAF from a ``config/model`` node (its ``_target_`` names
    the JAX class, so the keys are read here)."""
    if model_cfg.get("name", "naf") != "naf":
        raise NotImplementedError(f"model {model_cfg.get('name')!r} is not ported")
    return NAF(**{k: model_cfg[k] for k in _MODEL_KEYS if k in model_cfg})


def main(argv):
    overrides = [a for a in argv if "=" in a]
    cfg = load_config("base", overrides)
    device = cfg.get("device", "cuda")
    use_bf16 = bool(cfg.get("use_bf16", True))
    backbone = load_multiple_backbones(
        cfg["backbone"], dtype=torch.bfloat16 if use_bf16 else torch.float32, device=device)[0]
    model = build_model(cfg["model"])

    tcfg = TrainConfig(
        train_steps=cfg["train_steps"], img_size=cfg["img_size"], lr=cfg["optimizer"]["lr"],
        b1=cfg["optimizer"].get("b1", 0.9), b2=cfg["optimizer"].get("b2", 0.999),
        weight_decay=cfg["optimizer"].get("weight_decay", 1e-5),
        batch_size=cfg["train_dataloader"]["batch_size"],
        down_factor=cfg.get("down_factor", "fixed"), use_bf16=use_bf16,
        use_checkpointing=cfg.get("use_checkpointing", False),
        log_dir=cfg.get("run_dir", "runs/naf"), seed=cfg.get("seed", 0),
    )
    if cfg.get("sanity"):
        tcfg.train_steps = 1

    params = opt_state = None
    start = 0
    ckpt = cfg.get("model_ckpt")
    if ckpt:  # resume / finetune (reference train.py:71-73)
        if ckpt.endswith(".pth"):
            state = torch.load(ckpt, map_location="cpu", weights_only=True)
            params = state.get("state_dict", state)
        else:
            saved = load_checkpoint(ckpt)
            params, opt_state, start = saved["params"], saved.get("opt_state"), saved["step"]
        print(f"loaded model checkpoint from {ckpt}")

    data = (synthetic_images(tcfg.batch_size, tcfg.img_size) if cfg.get("synthetic")
            else folder_images(cfg))
    model = train_upsampler(model, backbone, data, tcfg, params=params, opt_state=opt_state,
                            start_step=start, device=device)
    print(f"done; checkpoints + metrics in {tcfg.log_dir}")
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
