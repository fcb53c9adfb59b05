"""The DAVIS video segmentation runner (counterpart of
``naf_tpu/evals/video_seg_runner.py``, reference
evaluation/eval_video_seg.py:357-806): per video, feature extraction, label
propagation, indexed-PNG output, and the J&F evaluation of the results.
Tensors are NHWC on the backbone's device.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.evals.video_seg import (
    davis_eval_boundary,
    davis_eval_iou,
    davis_statistics,
    label_propagation,
    norm_mask,
)
from naf_torch.ops.resize import resize_bicubic, resize_bilinear, resize_nearest_exact

__all__ = ["extract_feature", "run_video", "evaluate_davis_results"]


def _read_frame(path: str, patch_size: int, device):
    """Image -> ((1, H', W', 3) f32 [0, 1] on ``device``, H, W), H' and W'
    rounded down to patch multiples by a bilinear resize
    (eval_video_seg.py:564-581)."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    h, w = arr.shape[:2]
    frame = torch.from_numpy(arr)[None].to(device)
    th, tw = h // patch_size * patch_size, w // patch_size * patch_size
    if (th, tw) != (h, w):
        frame = resize_bilinear(frame, (th, tw))
    return frame, h, w


def extract_feature(backbone, upsampler_fn, frame: torch.Tensor, ups_factor: int):
    """(1, H, W, 3) [0, 1] frame -> (1, h*f, w*f, C) upsampled features
    (eval_video_seg.py:564-598): the backbone on its own normalisation, the
    upsampler on the ImageNet-normalised frame, bicubic-resized to the
    output size."""
    lr_feats = backbone(backbone.normalize(frame).to(backbone.dtype))
    hr_hw = (lr_feats.shape[1] * ups_factor, lr_feats.shape[2] * ups_factor)
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, device=frame.device)
    std = torch.tensor(IMAGENET_DEFAULT_STD, device=frame.device)
    img_ups = resize_bicubic((frame - mean) / std, hr_hw)
    return upsampler_fn(img_ups, lr_feats, hr_hw)


def _first_seg(mask_path: str, h: int, w: int, device):
    """First-frame annotation -> (one-hot (1, K, h, w) at the feature grid,
    the indexed mask)."""
    from PIL import Image

    seg = np.asarray(Image.open(mask_path))
    n_obj = int(seg.max()) + 1
    onehot = np.stack([(seg == i).astype(np.float32) for i in range(n_obj)], axis=-1)
    small = resize_nearest_exact(torch.from_numpy(onehot)[None].to(device), (h, w))[0]
    return small.permute(2, 0, 1)[None], seg


@torch.no_grad()
def run_video(backbone, upsampler_fn: Callable, frame_paths, first_mask_path: str,
              out_dir: str, ups_factor: int = 1, n_last_frames: int = 7, size_mask: int = 12,
              topk: int = 5, palette: Optional[bytes] = None):
    """Propagate the first-frame annotation through a video; writes indexed
    PNGs that the DAVIS evaluator reads (eval_video_seg.py:357-459)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    ps = backbone.config["ps"]
    device = next(backbone.model.parameters()).device

    frame1, ori_h, ori_w = _read_frame(frame_paths[0], ps, device)
    feat1 = extract_feature(backbone, upsampler_fn, frame1, ups_factor)
    fh, fw = feat1.shape[1], feat1.shape[2]
    first_seg, seg_ori = _first_seg(first_mask_path, fh, fw, device)
    feat1_flat = feat1[0].reshape(fh * fw, -1).T  # (C, h*w)

    def save_indexed(path, mask_np):
        img = Image.fromarray(mask_np.astype(np.uint8), mode="P")
        if palette is not None:
            img.putpalette(palette)
        img.save(path)

    save_indexed(os.path.join(out_dir, "00000.png"), seg_ori)
    ctx = deque(maxlen=n_last_frames)  # (features (C, hw), segmentation (1, K, h, w))
    for cnt in range(1, len(frame_paths)):
        frame, _, _ = _read_frame(frame_paths[cnt], ps, device)
        feat_tar = extract_feature(backbone, upsampler_fn, frame, ups_factor)
        feat_tar_flat = feat_tar[0].reshape(fh * fw, -1)  # (hw, C)
        feats = torch.stack([feat1_flat] + [f for f, _ in ctx])  # (n, C, hw)
        segs = torch.cat([first_seg] + [s for _, s in ctx])  # (n, K, h, w)
        seg_tar = label_propagation(feat_tar_flat, feats, segs.reshape(*segs.shape[:2], -1),
                                    fh, fw, size_mask=size_mask, topk=topk)  # (K, h, w)
        ctx.append((feat_tar_flat.T, seg_tar[None]))

        up_hw = (seg_tar.shape[1] * ps // ups_factor, seg_tar.shape[2] * ps // ups_factor)
        up = resize_bilinear(seg_tar.permute(1, 2, 0)[None], up_hw)[0]
        up = norm_mask(up.permute(2, 0, 1))
        pred = up.argmax(dim=0).cpu().numpy().astype(np.uint8)
        pred = np.asarray(Image.fromarray(pred).resize((ori_w, ori_h), Image.NEAREST))
        name = os.path.basename(frame_paths[cnt]).replace(".jpg", ".png")
        save_indexed(os.path.join(out_dir, name), pred)


def evaluate_davis_results(davis_root: str, results_dir: str, subset: str = "val"):
    """(J&F summary, per-object J and F) over the saved result PNGs
    (eval_video_seg.py:688-757); the first and last frame of each sequence
    are left out, as the semi-supervised protocol does."""
    from PIL import Image

    with open(os.path.join(davis_root, "ImageSets", "2017", f"{subset}.txt")) as f:
        sequences = [line.strip() for line in f if line.strip()]
    metrics = {m: {"M": [], "R": [], "D": []} for m in ("J", "F")}
    per_seq = {}
    for seq in sequences:
        mask_dir = os.path.join(davis_root, "Annotations", "480p", seq)
        gts, preds = [], []
        for fn in sorted(os.listdir(mask_dir))[1:-1]:
            pred_path = os.path.join(results_dir, seq, fn)
            if not os.path.exists(pred_path):
                continue
            gts.append(np.asarray(Image.open(os.path.join(mask_dir, fn))))
            preds.append(np.asarray(Image.open(pred_path)))
        if not gts:
            continue
        gts, preds = np.stack(gts), np.stack(preds)
        for obj in range(1, int(gts.max()) + 1):
            stats = {"J": davis_statistics(davis_eval_iou(gts == obj, preds == obj)),
                     "F": davis_statistics(davis_eval_boundary(gts == obj, preds == obj))}
            for m, (mean, recall, decay) in stats.items():
                metrics[m]["M"].append(mean)
                metrics[m]["R"].append(recall)
                metrics[m]["D"].append(decay)
            per_seq[f"{seq}_{obj}"] = {"J": stats["J"][0], "F": stats["F"][0]}
    summary = {
        "J&F-Mean": float((np.mean(metrics["J"]["M"]) + np.mean(metrics["F"]["M"])) / 2),
        "J-Mean": float(np.mean(metrics["J"]["M"])),
        "J-Recall": float(np.mean(metrics["J"]["R"])),
        "J-Decay": float(np.mean(metrics["J"]["D"])),
        "F-Mean": float(np.mean(metrics["F"]["M"])),
        "F-Recall": float(np.mean(metrics["F"]["R"])),
        "F-Decay": float(np.mean(metrics["F"]["D"])),
    }
    return summary, per_seq
