"""Image resizing with torch ``F.interpolate`` semantics, NHWC.

Counterpart of ``naf_tpu/ops/resize.py``. Each function works on the two axes
just before the channel axis; leading axes are free.

- ``resize_bilinear`` (align_corners=False, no antialias):
  ``src = max(0, (dst + 0.5) * in / out - 0.5)``, a lerp of the floor and
  ceil neighbours, separable per axis. It is the NAF input guard
  (``ImageEncoder.guard_size``) and the baselines' resize.
- ``resize_nearest_exact``: ``src = floor((dst + 0.5) * in / out)``, clamped,
  from a float64 index table per axis, as the JAX package builds it.
- ``resize_bicubic`` (A = -0.75, align_corners=False, no antialias, border
  taps clamped): torch ``F.interpolate(mode="bicubic")`` semantics, from the
  JAX package's 4-tap tables folded into one (out, in) matrix per axis, so
  each axis is one matmul, as ``ops.pool`` does it (torch's own bicubic
  kernel loops over the channels per pixel and is slow at 384 channels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from naf_torch.utils.spans import to_device

__all__ = ["resize_bilinear", "resize_nearest_exact", "resize_bicubic"]


@functools.lru_cache(maxsize=256)
def _bilinear_index_weight(in_size: int, out_size: int):
    """(lo, hi, frac) tables for one axis (torch bilinear, no antialias)."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) * (in_size / out_size) - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


@functools.lru_cache(maxsize=256)
def _nearest_exact_index(in_size: int, out_size: int) -> np.ndarray:
    """Source-index table for one axis (torch nearest-exact rule)."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.floor((dst + 0.5) * (in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


@functools.lru_cache(maxsize=256)
def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) f32 matrix of one axis: the 4 taps of torch's bicubic
    (A = -0.75, align_corners=False), clamped taps added up."""
    a = -0.75
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    idx = np.clip(np.stack([base - 1, base, base + 1, base + 2], axis=1), 0, in_size - 1)
    x = np.abs(np.stack([frac + 1, frac, 1 - frac, 2 - frac], axis=1))
    w = np.where(x <= 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                 np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.repeat(np.arange(out_size)[:, None], 4, axis=1)
    np.add.at(mat, (rows, idx), w.astype(np.float32))
    return mat


def _lerp_axis(x: torch.Tensor, axis: int, in_size: int, out_size: int) -> torch.Tensor:
    lo, hi, frac = _bilinear_index_weight(in_size, out_size)
    x_lo = x.index_select(axis, to_device(lo, x.device))
    x_hi = x.index_select(axis, to_device(hi, x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    t = to_device(frac, x.device, x_lo.dtype).reshape(shape)
    return x_lo + (x_hi - x_lo) * t


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear (align_corners=False, no antialias) resize of a ...HWC tensor."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_in, w_in) == (h_out, w_out):
        return x
    orig_dtype = x.dtype
    if not x.is_floating_point():
        x = x.float()
    if h_in != h_out:
        x = _lerp_axis(x, x.ndim - 3, h_in, h_out)
    if w_in != w_out:
        x = _lerp_axis(x, x.ndim - 2, w_in, w_out)
    return x if orig_dtype.is_floating_point else x.to(orig_dtype)


def resize_nearest_exact(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-exact resize of a ...HWC tensor to ``size=(H, W)``."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    if h_in != h_out:
        x = x.index_select(x.ndim - 3, to_device(_nearest_exact_index(h_in, h_out), x.device))
    if w_in != w_out:
        x = x.index_select(x.ndim - 2, to_device(_nearest_exact_index(w_in, w_out), x.device))
    return x


def resize_bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bicubic (align_corners=False, no antialias) resize of a ...HWC tensor
    (torch ``F.interpolate(mode="bicubic")`` semantics); non-float inputs
    resize in f32 and round back, as in the JAX package."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_in, w_in) == (h_out, w_out):
        return x
    orig_dtype = x.dtype
    if not x.is_floating_point():
        x = x.float()
    if h_in != h_out:
        mh = to_device(_bicubic_matrix(h_in, h_out), x.device, x.dtype)
        x = torch.einsum("oh,...hwc->...owc", mh, x)
    if w_in != w_out:
        mw = to_device(_bicubic_matrix(w_in, w_out), x.device, x.dtype)
        x = torch.einsum("ow,...hwc->...hoc", mw, x)
    return x if orig_dtype.is_floating_point else x.to(orig_dtype)
