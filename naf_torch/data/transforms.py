"""Image/label transforms with torchvision-equivalent semantics, numpy/PIL
(the port's own copy of ``naf_tpu/data/transforms.py``).

Mirrors the reference pipelines (utils/training.py:76-93): images get
shorter-side Resize (bilinear) + CenterCrop + [0,1] float conversion; labels
get NEAREST-EXACT Resize + CenterCrop and stay integer. Outputs are NHWC
numpy arrays. PIL is imported where an image is read or resized.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from naf_torch.ops.window import nearest_exact_src_index

__all__ = [
    "resize_shorter_side",
    "center_crop",
    "image_transform",
    "label_transform",
]


def _target_size(w: int, h: int, size: Union[int, Tuple[int, int]]):
    if isinstance(size, (tuple, list)):
        return int(size[1]), int(size[0])  # (w, h)
    size = int(size)
    if w <= h:
        return size, max(int(round(h * size / w)), 1)
    return max(int(round(w * size / h)), 1), size


def resize_shorter_side(img, size, interpolation=None):
    """torchvision Resize of a PIL image: int size scales the shorter edge
    (bilinear unless ``interpolation`` names another PIL filter)."""
    from PIL import Image

    if interpolation is None:
        interpolation = Image.BILINEAR
    w, h = img.size
    tw, th = _target_size(w, h, size)
    if (tw, th) == (w, h):
        return img
    return img.resize((tw, th), interpolation)


def center_crop(arr: np.ndarray, size: Union[int, Tuple[int, int]]):
    """torchvision CenterCrop on an (H, W, ...) array; pads if too small."""
    if isinstance(size, int):
        size = (size, size)
    th, tw = size
    h, w = arr.shape[:2]
    if h < th or w < tw:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)] + [(0, 0)] * (
            arr.ndim - 2
        )
        arr = np.pad(arr, pad)
        h, w = arr.shape[:2]
    i = (h - th) // 2
    j = (w - tw) // 2
    return arr[i : i + th, j : j + tw]


def _nearest_exact_resize_np(label: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-exact resize of an (H, W) integer array (torch semantics)."""
    th, tw = size
    rows = nearest_exact_src_index(label.shape[0], th)
    cols = nearest_exact_src_index(label.shape[1], tw)
    return label[rows][:, cols]


def image_transform(img, img_size: int) -> np.ndarray:
    """Resize(shorter=img_size, bilinear) + CenterCrop(img_size) + [0,1] f32,
    (H, W, 3)."""
    img = resize_shorter_side(img.convert("RGB"), img_size)
    arr = np.asarray(img, np.float32) / 255.0
    return center_crop(arr, img_size)


def label_transform(label, target_size: int) -> np.ndarray:
    """NEAREST-EXACT Resize(shorter=target_size) + CenterCrop, int32 (H, W)."""
    arr = np.asarray(label)
    if arr.ndim == 3:
        arr = arr[..., 0]
    h, w = arr.shape
    tw, th = _target_size(w, h, target_size)
    arr = _nearest_exact_resize_np(arr, (th, tw))
    return center_crop(arr, target_size).astype(np.int32)
