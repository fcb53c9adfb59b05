"""Linear-probe semantic segmentation (counterpart of
``naf_tpu/evals/seg_probing.py`` and of the CLI
``evaluation/eval_seg_probing.py``).

A 1 x 1 classifier is trained over frozen backbone + upsampler features
with cross entropy (ignore index 255, the mean over valid pixels); quality
is the pixel accuracy and the mean IoU of a streaming confusion matrix
(torchmetrics' multiclass Accuracy and JaccardIndex, reference
eval_seg_probing.py:54-55,221-257). The optimizer is the JAX package's
``optax.adamw`` under a cosine decay over ``num_epochs * steps_per_epoch``
steps: betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4, optax's defaults
(``torch.optim.AdamW``'s own decay is 1e-2). One horizontal-flip draw per
batch comes from the host ``RandomState``.

The CLI reads ``config/eval_probing.yaml`` with the repository's override
syntax:

    python -m naf_torch.evals.seg_probing dataset=ade20k dataroot=/data model=naf
    python -m naf_torch.evals.seg_probing synthetic=true num_epochs=1 device=cpu \\
        img_size=28 model.dim=32 model.heads_attn=2 model.heads_rope=2 \\
        backbone.depth=1 backbone.embed_dim=64 backbone.num_heads=2

``device`` defaults to ``cuda``; ``dtype`` (float32, as the JAX CLI runs,
or bfloat16) is the backbone's and the upsampler's; ``backbone.checkpoint``
loads a local checkpoint (``naf_torch.backbones.convert``);
``eval.model_ckpt`` loads the upsampler's weights.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from naf_torch.api import _device
from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.ops.resize import resize_bilinear

IGNORE = 255

__all__ = ["SegMetrics", "LinearProbe", "ProbeConfig", "build_feature_fn", "main"]

class SegMetrics:
    """Streaming confusion matrix -> accuracy and mean IoU."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        """pred / target: integer arrays of one shape, the ignored pixels removed."""
        n = self.num_classes
        idx = target.astype(np.int64) * n + pred.astype(np.int64)
        self.confusion += np.bincount(idx, minlength=n * n).reshape(n, n)

    def compute(self) -> dict:
        c = self.confusion.astype(np.float64)
        acc = np.diag(c).sum() / max(c.sum(), 1)
        inter = np.diag(c)
        union = c.sum(0) + c.sum(1) - inter
        # the mean over the classes present (torchmetrics' macro JaccardIndex)
        valid = union > 0
        iou = np.where(valid, inter / np.maximum(union, 1), np.nan)
        miou = np.nanmean(iou) if valid.any() else 0.0
        return {"accuracy": float(acc), "iou": float(miou)}


@dataclasses.dataclass
class ProbeConfig:
    num_classes: int = 151
    num_epochs: int = 20  # config/eval_probing.yaml
    lr: float = 1e-3
    steps_per_epoch: int = 1000  # the cosine schedule's horizon
    hflip_prob: float = 0.5  # eval_seg_probing.py:178-181
    seed: int = 0


class LinearProbe:
    """Trains and evaluates the 1 x 1 classifier over frozen features.

    ``feature_fn(image01, target_hw) -> (B, H, W, C)`` wraps the frozen
    backbone + upsampler (normalisation inside); ``image01`` is a (B, H, W, 3)
    [0, 1] f32 tensor on ``device``. The classifier's kernel is drawn
    U(-1/sqrt(C), 1/sqrt(C)) from a generator seeded with ``cfg.seed``
    (``set_weights`` replaces it), its bias is zero.
    """

    def __init__(self, feature_fn: Callable, embed_dim: int, cfg: ProbeConfig, device="cuda"):
        self.feature_fn = feature_fn
        self.cfg = cfg
        self.device = _device(device)
        scale = 1.0 / math.sqrt(embed_dim)
        gen = torch.Generator().manual_seed(cfg.seed)
        kernel = (torch.rand(embed_dim, cfg.num_classes, generator=gen) * 2 - 1) * scale
        self.kernel = kernel.to(self.device).requires_grad_(True)
        self.bias = torch.zeros(cfg.num_classes, device=self.device, requires_grad=True)
        self.opt = torch.optim.AdamW([self.kernel, self.bias], lr=cfg.lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)
        horizon = cfg.num_epochs * cfg.steps_per_epoch
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda step: 0.5 * (1 + math.cos(math.pi * min(step, horizon) / horizon)))

    @torch.no_grad()
    def set_weights(self, kernel, bias) -> None:
        """Replace the classifier's (C, K) kernel and (K,) bias."""
        self.kernel.copy_(torch.as_tensor(np.asarray(kernel)))
        self.bias.copy_(torch.as_tensor(np.asarray(bias)))

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        return feats.float() @ self.kernel + self.bias

    def _loss(self, feats: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = self._logits(feats).reshape(-1, self.cfg.num_classes)
        labels = target.reshape(-1).long()
        valid = labels != IGNORE
        ce = F.cross_entropy(logits, torch.where(valid, labels, 0), reduction="none")
        return (ce * valid).sum() / valid.sum().clamp(min=1)

    @torch.no_grad()
    def _features(self, image, target_hw) -> torch.Tensor:
        target_hw = tuple(int(v) for v in target_hw)
        image = torch.as_tensor(np.ascontiguousarray(image)).to(self.device, torch.float32)
        feats = self.feature_fn(image, target_hw)
        if tuple(feats.shape[1:3]) != target_hw:
            # the reference resizes the logits; the classifier is linear, so
            # resizing the features first gives the same logits
            feats = resize_bilinear(feats, target_hw)
        return feats

    def train_epoch(self, loader: Iterator, rng: np.random.RandomState) -> float:
        losses = []
        for image, target in loader:
            if rng.rand() < self.cfg.hflip_prob:
                image, target = image[:, :, ::-1], target[:, :, ::-1]
            feats = self._features(image, target.shape[-2:])
            target = torch.as_tensor(np.ascontiguousarray(target)).to(self.device)
            loss = self._loss(feats, target)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
            self.schedule.step()
            losses.append(float(loss.detach()))
        return float(np.mean(losses)) if losses else 0.0

    @torch.no_grad()
    def evaluate(self, loader: Iterator) -> dict:
        metrics = SegMetrics(self.cfg.num_classes)
        for image, target in loader:
            feats = self._features(image, target.shape[-2:])
            pred = self._logits(feats).argmax(dim=-1).cpu().numpy()
            target = np.asarray(target)
            valid = target != IGNORE
            metrics.update(pred[valid], target[valid])
        return metrics.compute()


def build_feature_fn(backbone, model, dtype: torch.dtype):
    """``feature_fn(image01, target_hw)``: the backbone on its own
    normalisation of the image, the upsampler on the ImageNet-normalised
    image, both in ``dtype``."""
    def feature_fn(image01, target_hw):
        mean = torch.tensor(IMAGENET_DEFAULT_MEAN, device=image01.device)
        std = torch.tensor(IMAGENET_DEFAULT_STD, device=image01.device)
        lr = backbone(backbone.normalize(image01).to(dtype))
        return model(((image01 - mean) / std).to(dtype), lr, tuple(int(v) for v in target_hw))

    return feature_fn


def synthetic_loader(n, batch, size, n_cls, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        img = rng.rand(batch, size, size, 3).astype(np.float32)
        lbl = rng.randint(0, n_cls, (batch, size, size)).astype(np.int32)
        yield img, lbl


def dataset_loader(cfg, split):
    """Batches of the ``dataset`` node's reader: the port's class of the name
    its ``_target_`` gives the JAX one, with the node's keys."""
    from naf_torch.data import DataLoader, datasets
    from naf_torch.data.transforms import image_transform, label_transform

    node = {k: v for k, v in cfg["dataset"].items() if k not in ("_target_", "name", "tag")}
    ds = getattr(datasets, cfg["dataset"]["_target_"].rsplit(".", 1)[1])(
        **{**node, "split": split},
        transform=lambda im: image_transform(im, cfg["img_size"]),
        target_transform=lambda lb: label_transform(lb, cfg["target_size"]))
    dl_cfg = cfg["train_dataloader" if split == "train" else "val_dataloader"]
    loader = DataLoader(ds, dl_cfg["batch_size"], shuffle=(split == "train"),
                        num_workers=dl_cfg.get("num_workers", 4), drop_last=(split == "train"))
    for batch in loader:
        yield batch["image"], batch["label"]


def build_models(cfg):
    """(backbone, upsampler, dtype, device) of an eval config: the backbone
    by ``naf_torch.backbones``, the upsampler by the model registry."""
    from naf_torch.backbones import load_multiple_backbones
    from naf_torch.models.registry import build_from_config

    device = _device(cfg.get("device", "cuda"))
    dtype = getattr(torch, cfg.get("dtype", "float32"))
    backbone = load_multiple_backbones(cfg["backbone"], dtype=dtype, device=device)[0]
    model = build_from_config(cfg["model"], checkpoint=cfg["eval"].get("model_ckpt") or None)
    return backbone, model.to(device, dtype).eval().requires_grad_(False), dtype, device


def main(argv):
    """Train the probe and evaluate it; returns {"accuracy", "iou",
    "epoch_s"} (the seconds of each training epoch)."""
    overrides = [a for a in argv if "=" in a]
    from naf_torch.config import load_config

    cfg = load_config("eval_probing", overrides)
    synthetic = bool(cfg.get("synthetic", False))
    n_cls = 7 if synthetic else cfg["metrics"]["seg"]["num_classes"]
    backbone, model, dtype, device = build_models(cfg)
    size = cfg["img_size"]
    steps = 10 if synthetic else 1000
    probe = LinearProbe(build_feature_fn(backbone, model, dtype), backbone.embed_dim,
                        ProbeConfig(num_classes=n_cls, num_epochs=cfg["num_epochs"],
                                    lr=cfg["optimizer"]["lr"], steps_per_epoch=steps),
                        device=device)
    host_rng = np.random.RandomState(0)
    epochs = 1 if cfg.get("sanity") else cfg["num_epochs"]
    epoch_s = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        train = (synthetic_loader(steps, 2, size, n_cls, seed=epoch) if synthetic
                 else dataset_loader(cfg, "train"))
        loss = probe.train_epoch(train, host_rng)
        epoch_s.append(time.perf_counter() - t0)
        print(f"epoch {epoch}: loss {loss:.4f} ({epoch_s[-1]:.2f} s)", flush=True)
    val = synthetic_loader(5, 2, size, n_cls, seed=123) if synthetic else dataset_loader(cfg, "val")
    metrics = probe.evaluate(val)
    print(json.dumps(metrics), flush=True)
    return {**metrics, "epoch_s": epoch_s}


if __name__ == "__main__":
    main(sys.argv[1:])
