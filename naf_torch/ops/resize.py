"""Bilinear resize with torch ``F.interpolate`` semantics, NHWC.

Counterpart of ``naf_tpu/ops/resize.py::resize_bilinear`` (align_corners=False,
no antialias): ``src = max(0, (dst + 0.5) * in / out - 0.5)``, a lerp of the
floor and ceil neighbours, separable per axis. It is the NAF input guard
(``ImageEncoder.guard_size``). Nearest-exact and bicubic come with the slices
that use them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_bilinear"]


@functools.lru_cache(maxsize=256)
def _bilinear_index_weight(in_size: int, out_size: int):
    """(lo, hi, frac) tables for one axis (torch bilinear, no antialias)."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) * (in_size / out_size) - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def _lerp_axis(x: torch.Tensor, axis: int, in_size: int, out_size: int) -> torch.Tensor:
    lo, hi, frac = _bilinear_index_weight(in_size, out_size)
    x_lo = x.index_select(axis, torch.from_numpy(lo).to(x.device))
    x_hi = x.index_select(axis, torch.from_numpy(hi).to(x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    t = torch.from_numpy(frac).to(x.device, x_lo.dtype).reshape(shape)
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
