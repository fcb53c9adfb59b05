"""Feature visualisation: joint-PCA RGB projection and side-by-side panels
(counterpart of ``naf_tpu/utils/visualization.py``, reference
utils/visualization.py:18-190), numpy only.

``pca_rgb(feats_list)`` fits one PCA over all given feature maps jointly (so
colours are comparable across panels) and returns [0, 1] RGB images;
``plot_feats`` builds a horizontal panel (image | pca(feat_0) | ...) with
nearest-neighbour resizing and writes it as a PNG (PIL).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["pca_rgb", "plot_feats"]


def pca_rgb(feats: Sequence[np.ndarray], dim: int = 3):
    """Joint PCA of NHWC feature maps -> list of (H, W, dim) in [0, 1]."""
    flats = [np.asarray(f, np.float32).reshape(-1, f.shape[-1]) for f in feats]
    stacked = np.concatenate(flats, axis=0)
    mean = stacked.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(stacked - mean, full_matrices=False)
    comps = vt[:dim].T  # (C, dim)
    projected = [(f - mean) @ comps for f in flats]
    allp = np.concatenate(projected, axis=0)
    lo = np.percentile(allp, 1, axis=0)
    hi = np.percentile(allp, 99, axis=0)
    return [np.clip((f - lo) / np.maximum(hi - lo, 1e-8), 0, 1).reshape(*feat.shape[:-1], dim)
            for f, feat in zip(projected, feats)]


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's NEAREST resize of an (H, W, C) array: source pixel
    floor((i + 0.5) * H / h) per axis."""
    rows = np.minimum(((np.arange(h) + 0.5) * img.shape[0] / h).astype(np.int64),
                      img.shape[0] - 1)
    cols = np.minimum(((np.arange(w) + 0.5) * img.shape[1] / w).astype(np.int64),
                      img.shape[1] - 1)
    return img[rows][:, cols]


def plot_feats(image: Optional[np.ndarray], feats: Sequence[np.ndarray],
               path: Optional[str] = None, panel_size: Optional[int] = None):
    """Horizontal panel [image | pca(feat_0) | pca(feat_1) | ...] -> uint8
    array (and a PNG at ``path`` if given). ``image`` is (H, W, 3) in [0, 1]."""
    rgbs = pca_rgb([np.asarray(f)[0] if f.ndim == 4 else np.asarray(f) for f in feats])
    panels = []
    if image is not None:
        img = np.asarray(image)
        panels.append(np.clip(img[0] if img.ndim == 4 else img, 0, 1))
    panels.extend(rgbs)
    size = panel_size or max(p.shape[0] for p in panels)
    resized = []
    for p in panels:
        u8 = (p * 255).astype(np.uint8)
        width = max(int(p.shape[1] * size / p.shape[0]), 1)
        resized.append(_resize_nearest(u8, size, width))
    panel = np.concatenate(resized, axis=1)
    if path is not None:
        from PIL import Image

        Image.fromarray(panel).save(path)
    return panel
