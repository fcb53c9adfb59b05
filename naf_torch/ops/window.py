"""Neighborhood-attention window index math (natten semantics), numpy only.

Counterpart of ``naf_tpu/ops/window.py``; the port keeps its own copy so it
never imports the JAX package. Dilated 2-D neighborhood attention is
separable per axis: a query at ``i`` on an axis of length ``L`` with odd
kernel ``k`` and dilation ``d`` attends ``start(i) + t*d`` for ``t < k``,
where, with ``c = i // d``, ``m = i % d`` and subgrid length
``Ls = ceil((L - m) / d)``, ``start(i) = m + d * clip(c - k//2, 0, Ls - k)``.

Cross-scale NA (NAF's trick): K/V live on a low-res axis of length ``l``;
the reference nearest-exact-upsamples them to ``L`` and attends with
``d = L // l``. Composing the two index maps gives the LR cells each HR
query attends (:func:`cross_scale_lr_indices`), so K/V are never upsampled.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "na_window_start",
    "na_gather_indices",
    "cross_scale_lr_indices",
    "nearest_exact_src_index",
]


def na_window_start(idx: np.ndarray, length: int, kernel: int, dilation: int) -> np.ndarray:
    """Window start position for each query index (one axis, natten rule)."""
    if kernel % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {kernel}")
    if length < kernel * dilation:
        raise ValueError(
            f"axis length {length} must be >= kernel*dilation = {kernel * dilation}"
        )
    idx = np.asarray(idx)
    c = idx // dilation
    m = idx % dilation
    l_sub = -((-(length - m)) // dilation)  # ceil((L - m) / d), per query
    start_sub = np.clip(c - kernel // 2, 0, l_sub - kernel)
    return m + dilation * start_sub


@functools.lru_cache(maxsize=256)
def na_gather_indices(length: int, kernel: int, dilation: int) -> np.ndarray:
    """(length, kernel) table: attended positions per query index, one axis."""
    start = na_window_start(np.arange(length), length, kernel, dilation)
    return start[:, None] + dilation * np.arange(kernel)[None, :]


@functools.lru_cache(maxsize=256)
def nearest_exact_src_index(in_size: int, out_size: int) -> np.ndarray:
    """torch nearest-exact source index per output position (one axis)."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.floor((dst + 0.5) * (in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


@functools.lru_cache(maxsize=256)
def cross_scale_lr_indices(hr_size: int, lr_size: int, kernel: int) -> np.ndarray:
    """(hr_size, kernel) table of LOW-RES cells attended by each HR query.

    Reproduces the reference pipeline on one axis: nearest-exact upsample
    the LR axis to ``hr_size``, then dilated NA with
    ``dilation = hr_size // lr_size``. Valid for integer and ragged ratios.
    """
    dilation = max(hr_size // lr_size, 1)
    if kernel * dilation > hr_size:
        # natten cannot run windows wider than the grid; clamp to the
        # densest dilation that fits, so small grids (e.g. 16x16 targets
        # at ratio 2, kernel 9) degrade to a tighter neighbourhood.
        dilation = max(hr_size // kernel, 1)
    hr_pos = na_gather_indices(hr_size, kernel, dilation)  # (hr, k) HR positions
    src = nearest_exact_src_index(lr_size, hr_size)  # (hr,) HR pos -> LR cell
    return src[hr_pos]
