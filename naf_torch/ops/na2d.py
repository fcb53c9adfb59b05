"""Plain PyTorch 2-D neighborhood attention: the oracle of every attention kernel.

Counterpart of ``naf_tpu/ops/na2d.py``.

- :func:`na2d`: dense dilated neighborhood attention with natten semantics;
  Q/K/V on one (H, W) grid.
- :func:`cross_scale_na2d`: NAF's composition. K/V live on a low-res (h, w)
  grid; the reference nearest-exact-upsamples them to (H, W) and runs
  ``na2d`` with dilation (H//h, W//w). Composing the two index maps gathers
  the windows straight from the LR grid instead. Same outputs.

Layouts are channels-last: Q is (B, H, W, heads, d), K/V (B, h, w, heads, d).
Logits and softmax are f32; the output is cast back to Q's dtype.
"""

from __future__ import annotations

import torch

from naf_torch.ops.window import cross_scale_lr_indices, na_gather_indices
from naf_torch.utils.spans import to_device

__all__ = ["na2d", "cross_scale_na2d"]

# Bytes of gathered K/V windows one row block may hold.
_ROW_BLOCK_BYTES = 256 * 2**20


def _na2d_from_indices(q, k, v, idx_h, idx_w, scale, return_weights):
    """Attend each query (i, j) to k[idx_h[i, t], idx_w[j, s]]."""
    qf = q.float() * scale
    kg = k[:, idx_h][:, :, :, idx_w]  # (B, H, kh, W, kw, n, d)
    vg = v[:, idx_h][:, :, :, idx_w]
    logits = torch.einsum("bijnd,bitjsnd->bnijts", qf, kg.float())
    b, n, h, w, kh, kw = logits.shape
    flat = logits.reshape(b, n, h, w, kh * kw)
    weights = torch.softmax(flat, dim=-1).reshape(b, n, h, w, kh, kw)
    out = torch.einsum("bnijts,bitjsnd->bijnd", weights, vg.float()).to(q.dtype)
    if return_weights:
        # the reference returns the scaled pre-softmax scores (B, heads, H, W, k*k)
        return out, flat
    return out


def na2d(q, k, v, kernel_size, dilation=(1, 1), scale=None, return_weights=False):
    """Dense dilated 2-D neighborhood attention (natten semantics).

    q, k, v: (B, H, W, heads, d) on one grid; kernel_size int or (kh, kw),
    odd; dilation int or (dh, dw); scale defaults to d**-0.5.
    """
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    dh, dw = (dilation, dilation) if isinstance(dilation, int) else dilation
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dev = q.device
    idx_h = to_device(na_gather_indices(q.shape[1], kh, dh), dev)
    idx_w = to_device(na_gather_indices(q.shape[2], kw, dw), dev)
    return _na2d_from_indices(q, k, v, idx_h, idx_w, scale, return_weights)


def cross_scale_na2d(q, k, v, kernel_size, scale=None, return_weights=False,
                     row_block=None, row0: int = 0, full_hq=None):
    """Cross-scale neighborhood attention: HR queries over LR keys/values.

    Equal to nearest-exact upsampling K/V to Q's grid and running
    :func:`na2d` with dilation (H//h, W//w). Large query grids run in row
    blocks so the gathered windows stay under ~256 MB per block;
    ``row_block=0`` turns blocking off. ``row0``/``full_hq``: q holds rows
    [row0, row0 + H) of a ``full_hq``-row query grid, and the windows follow
    that global grid (banded execution).

    q: (B, H, W, heads, d); k: (B, h, w, heads, d); v: (B, h, w, heads, dv).
    Returns (B, H, W, heads, dv), and with ``return_weights`` also the scaled
    pre-softmax scores (B, heads, H, W, kh*kw).
    """
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, hq, wq = q.shape[:3]
    hk, wk = k.shape[1], k.shape[2]
    dev = q.device
    idx_h = to_device(cross_scale_lr_indices(full_hq or hq, hk, kh)[row0 : row0 + hq], dev)
    idx_w = to_device(cross_scale_lr_indices(wq, wk, kw), dev)
    if row_block is None:
        per_row = b * wq * kh * kw * q.shape[3] * (q.shape[4] + v.shape[4]) * 4
        row_block = max(min(_ROW_BLOCK_BYTES // max(per_row, 1), hq), 1)
    if not row_block or row_block >= hq:
        return _na2d_from_indices(q, k, v, idx_h, idx_w, scale, return_weights)
    outs, weights = [], []
    for i0 in range(0, hq, row_block):
        res = _na2d_from_indices(
            q[:, i0 : i0 + row_block], k, v, idx_h[i0 : i0 + row_block], idx_w,
            scale, return_weights,
        )
        if return_weights:
            outs.append(res[0])
            weights.append(res[1])
        else:
            outs.append(res)
    out = torch.cat(outs, dim=1)
    if return_weights:
        return out, torch.cat(weights, dim=2)
    return out
