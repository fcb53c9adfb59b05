"""Adaptive average pooling with torch ``F.adaptive_avg_pool2d`` semantics, NHWC.

Counterpart of ``naf_tpu/ops/pool.py``. Output cell ``o`` of an axis of
length ``n`` pooled to ``m`` averages input ``[floor(o*n/m), ceil((o+1)*n/m))``;
the same rule pools down and up and covers ragged ratios. Each axis is one
small (out, in) matrix, so the 2-D pool is two matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["adaptive_avg_pool2d"]


@functools.lru_cache(maxsize=256)
def _pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging matrix for one axis, torch adaptive-pool rule."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        start = (o * in_size) // out_size
        end = -((-(o + 1) * in_size) // out_size)  # ceil
        mat[o, start:end] = 1.0 / (end - start)
    return mat


def adaptive_avg_pool2d(x: torch.Tensor, output_size: tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool of an NHWC (or ...HWC) tensor to ``output_size``.

    bf16 tensors pool with bf16 matrices and f32 accumulation, as the JAX
    package does; f32 tensors pool in f32.
    """
    h_out, w_out = int(output_size[0]), int(output_size[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_in, w_in) == (h_out, w_out):
        return x
    if not x.is_floating_point():
        x = x.float()
    if h_in != h_out:
        ph = torch.from_numpy(_pool_matrix(h_in, h_out)).to(x.device, x.dtype)
        x = torch.einsum("oh,...hwc->...owc", ph, x)
    if w_in != w_out:
        pw = torch.from_numpy(_pool_matrix(w_in, w_out)).to(x.device, x.dtype)
        x = torch.einsum("ow,...hwc->...hoc", pw, x)
    return x
