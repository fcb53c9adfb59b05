"""DAVIS video label propagation and its J&F evaluation (counterpart of
``naf_tpu/evals/video_seg.py`` and of the CLI ``evaluation/eval_video_seg.py``).

Non-parametric propagation (reference eval_video_seg.py:498-560): per
frame, the affinity exp(<normalised target features, normalised context
features> / 0.1) in f32 (TF32 off on the card) under a spatial
neighbourhood mask; every affinity below a query's k-th largest over all
context keys is zeroed (on ties more than k stay, as in the JAX package);
the columns are normalised and applied to the context segmentations. The
context is the first frame and the last n frames.

J (region IoU), F (boundary: Sobel edges and a Euclidean distance
transform) and the mean / recall / decay statistics follow the vendored
DAVIS evaluator (eval_video_seg.py:145-269), numpy and scipy.

The CLI reads ``config/eval_video_seg.yaml``:

    python -m naf_torch.evals.video_seg dataset.root=/data/DAVIS model=naf eval.ups_factor=2

It propagates the first-frame annotation of every video of the split,
writes indexed PNGs under ``run_dir`` (default ``build/video_seg``), then
prints and writes the J&F summary. ``device`` defaults to ``cuda``;
``dtype`` (float32 or bfloat16) is the backbone's and the upsampler's;
``main(argv, model_state)`` takes the upsampler's trained weights from the
caller, as the JAX CLI's ``model_params`` does.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import sys
import warnings
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from naf_torch.utils.spans import to_device

__all__ = [
    "restrict_neighborhood",
    "label_propagation",
    "norm_mask",
    "davis_eval_iou",
    "davis_eval_boundary",
    "davis_statistics",
    "main",
]

BUILD = Path(__file__).resolve().parents[2] / "build"


@functools.lru_cache(maxsize=16)
def restrict_neighborhood(h: int, w: int, size_mask: int) -> np.ndarray:
    """(h*w, h*w) mask of the pairs with |di| <= m and |dj| <= m
    (eval_video_seg.py:462-485)."""
    qi, qj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    qi, qj = qi.reshape(-1, 1), qj.reshape(-1, 1)
    mask = (np.abs(qi - qi.T) <= size_mask) & (np.abs(qj - qj.T) <= size_mask)
    return mask.astype(np.float32)


def norm_mask(mask: torch.Tensor) -> torch.Tensor:
    """Per-channel min-max normalisation of the channels with a positive
    maximum (eval_video_seg.py:488-496); mask (C, H, W)."""
    mx = mask.amax(dim=(1, 2), keepdim=True)
    mn = mask.amin(dim=(1, 2), keepdim=True)
    normed = (mask - mn) / (mx - mn).clamp(min=1e-12)
    return torch.where(mx > 0, normed, mask)


@contextlib.contextmanager
def _f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def label_propagation(feat_tar: torch.Tensor, feat_sources: torch.Tensor, segs: torch.Tensor,
                      h: int, w: int, size_mask: int = 12, topk: int = 5) -> torch.Tensor:
    """One propagation step -> (K, h, w) target segmentation scores.

    feat_tar (h*w, C) target-frame features; feat_sources (n_ctx, C, h*w)
    context features; segs (n_ctx, K, h*w) context segmentations."""
    with _f32_matmuls():
        ft = feat_tar / feat_tar.norm(dim=1, keepdim=True).clamp(min=1e-12)
        fs = feat_sources / feat_sources.norm(dim=1, keepdim=True).clamp(min=1e-12)
        aff = torch.exp(torch.einsum("qc,ncs->nqs", ft.float(), fs.float()) / 0.1)
        if size_mask > 0:
            aff = aff * to_device(restrict_neighborhood(h, w, size_mask), aff.device)
        aff = aff.transpose(1, 2).reshape(-1, h * w)  # (n_ctx * s, q)
        kth = torch.topk(aff, topk, dim=0).values[topk - 1]  # each query's k-th largest
        aff = torch.where(aff < kth, 0.0, aff)
        aff = aff / aff.sum(dim=0, keepdim=True)
        k = segs.shape[1]
        segs_flat = segs.transpose(0, 1).reshape(k, -1)  # (K, n_ctx * s)
        return (segs_flat.float() @ aff).reshape(k, h, w)


# ---------------------------------------------------------------- J & F ----


def davis_eval_iou(annotation: np.ndarray, segmentation: np.ndarray) -> np.ndarray:
    """Region similarity J (eval_video_seg.py:145-167)."""
    a = annotation.astype(bool)
    s = segmentation.astype(bool)
    inters = np.sum(a & s, axis=(-2, -1))
    union = np.sum(a | s, axis=(-2, -1))
    j = inters / np.maximum(union, 1e-12)
    return np.where(np.isclose(union, 0), 1.0, j)


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Sobel boundary map (eval_video_seg.py:209-227); the border mirrored as
    cv2.filter2D's default BORDER_REFLECT_101."""
    from scipy.ndimage import correlate

    s = seg.astype(bool).astype(np.float32)
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ex = correlate(s, kx, mode="mirror")
    ey = correlate(s, kx.T, mode="mirror")
    return np.sqrt(ex ** 2 + ey ** 2) > 0.1


def _f_measure(fg: np.ndarray, gt: np.ndarray, bound_th: float = 0.008) -> float:
    from scipy.ndimage import distance_transform_edt

    bound_pix = bound_th if bound_th >= 1 else np.ceil(bound_th * np.linalg.norm(fg.shape))
    fb = _seg2bmap(fg)
    gb = _seg2bmap(gt)
    fg_dist = distance_transform_edt(~fb)
    gt_dist = distance_transform_edt(~gb)
    precision = np.sum(fb * (gt_dist <= bound_pix)) / (np.sum(fb) + 1e-10)
    recall = np.sum(gb * (fg_dist <= bound_pix)) / (np.sum(gb) + 1e-10)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def davis_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray) -> np.ndarray:
    """Boundary F per frame (eval_video_seg.py:231-250)."""
    if annotation.ndim == 3:
        return np.array([_f_measure(segmentation[i], annotation[i])
                         for i in range(annotation.shape[0])])
    return np.array(_f_measure(segmentation, annotation))


def davis_statistics(per_frame: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall, decay) (eval_video_seg.py:253-269)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        m = np.nanmean(per_frame)
        o = np.nanmean(per_frame > 0.5)
    n_bins = 4
    ids = (np.round(np.linspace(1, len(per_frame), n_bins + 1) + 1e-10) - 1).astype(int)
    bins = [per_frame[ids[i]: ids[i + 1] + 1] for i in range(n_bins)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        d = np.nanmean(bins[0]) - np.nanmean(bins[3])
    return float(m), float(o), float(d)


# ------------------------------------------------------------------ CLI ----


def main(argv, model_state=None):
    """Propagate every video of the split and evaluate; returns the J&F
    summary. ``model_state``: the upsampler's trained weights, injected
    (``seg_probing.build_models``)."""
    from PIL import Image

    from naf_torch.config import load_config
    from naf_torch.evals.seg_probing import build_models
    from naf_torch.evals.video_seg_runner import evaluate_davis_results, run_video

    overrides = [a for a in argv if "=" in a]
    cfg = load_config("eval_video_seg", [f"run_dir={BUILD / 'video_seg'}", *overrides])
    davis_root = cfg["dataset"]["root"]
    backbone, model, dtype, _ = build_models(cfg, model_state)

    @torch.no_grad()
    def upsampler_fn(img, feats, hw):
        return model(img.to(dtype), feats.to(dtype), tuple(hw))

    subset = cfg["dataset"].get("split", "val")
    with open(os.path.join(davis_root, "ImageSets", "2017", f"{subset}.txt")) as f:
        videos = [line.strip() for line in f if line.strip()]
    out_root = os.path.join(
        cfg["run_dir"],
        f"davis_vidseg_{cfg['eval']['ups_factor']}_{cfg['model'].get('name', 'model')}")
    for video in videos:
        frames = sorted(glob.glob(os.path.join(davis_root, "JPEGImages", "480p", video, "*.jpg")))
        first_mask = os.path.join(davis_root, "Annotations", "480p", video, "00000.png")
        print(f"propagating {video} ({len(frames)} frames)", flush=True)
        palette = Image.open(first_mask).getpalette()
        run_video(backbone, upsampler_fn, frames, first_mask, os.path.join(out_root, video),
                  ups_factor=cfg["eval"]["ups_factor"], n_last_frames=cfg["eval"]["n_last_frames"],
                  size_mask=cfg["eval"]["size_mask_neighborhood"], topk=cfg["eval"]["topk"],
                  palette=bytes(palette) if palette else None)
        if cfg.get("sanity"):
            break
    summary, per_seq = evaluate_davis_results(davis_root, out_root, subset)
    print(json.dumps(summary, indent=2), flush=True)
    with open(os.path.join(out_root, "results.json"), "w") as f:
        json.dump({"summary": summary, "per_sequence": per_seq}, f, indent=2)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
