"""NAF's restoration step in plain float32 PyTorch (valeoai/NAF
``denoising.py``; the ks15 ablation at ``denoising.py:427-451`` over
``config/base_denoising.yaml`` and ``config/optimizer/adamw.yaml``).
Independent of the program: it imports nothing of ``naf_torch``, and sets
TF32 off while it runs.

  guide  = the noisy image, normalised by ImageNet's statistics
  values = the noisy image itself, 3 channels at the image's own size
           (``denoising.py:212-213``: NAF as a restorer)
  pred   = NAF(guide, values) at the image's size
  loss   = w_l1 L1 + w_l2 L2 + w_ssim (1 - SSIM), SSIM from 3 x 3 average
           pools, zero-padded (``denoising.py:129-177``, ``149-166``)
  AdamW  = beta 0.9 / 0.999, eps 1e-8, decoupled weight decay

The model is ``reference/naf.py``'s encoder, pools and RoPE. Departures
from the published code, none of them in the arithmetic:

- The attention runs in blocks of query rows, each under
  ``torch.utils.checkpoint`` (at 448^2, batch 8 and k 15 the gathered keys
  of the whole grid would take hundreds of GB). A block takes the logits of
  its queries against every key of the rows its windows touch, as one
  matrix product, and keeps each query's k x k window from them: the same
  f32 dot products as ``reference/naf.py``'s ``cross_scale_attention``,
  summed in another order.
- The noise is data: each step takes the noisy batch the program drew
  (``step_generator(seed, step)``), and draws none of its own.
- The input guard (a bilinear downscale of a guide above 4x the output)
  never fires here, where the guide is the output's size, and is left out.
- SSIM pools contiguous NCHW copies (see :func:`ssim`).

``q8``, where given, rounds every tensor the model holds in its working
precision (weights, inputs, activations between layers, the attention
probabilities, the output) through that function, as in
``reference/naf.py``: the control of ``h100bench.check`` passes a float8
round trip.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.reference.naf import adaptive_pool, cross_scale_indices, encoder, rope

__all__ = ["blocked_attention", "restore", "ssim", "denoise_loss", "denoise_steps"]

IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
BLOCK_ROWS = 8  # query rows a block; at 448^2 x 8 its logits take 1.1 GB


def _id(t):
    return t


def _block(qb, keys, v, urows, idx, q8):
    """Queries ``qb`` (B, R, W, n, d), already scaled, against the keys and
    values of LR rows ``urows``; ``idx`` (R, W, k*k) gives each query's
    window in those rows' flattened (row, column) cells."""
    b, _, wk, n, d = keys.shape
    kr = keys[:, urows].reshape(b, -1, n, d)
    vr = v[:, urows].reshape(b, -1, n, v.shape[-1])
    dense = torch.einsum("brwnd,bund->brwnu", qb, kr)
    gi = idx[None, :, :, None, :].expand(b, -1, -1, n, -1)
    prob = q8(torch.softmax(dense.gather(-1, gi), dim=-1))  # (B, R, W, n, k*k)
    vg = vr[:, idx]  # (B, R, W, k*k, n, dv)
    return torch.einsum("brwnj,brwjnd->brwnd", prob, vg)


def blocked_attention(q, keys, v, heads: int, k: int, q8=_id, block_rows: int = BLOCK_ROWS):
    """``reference/naf.py``'s ``cross_scale_attention`` in blocks of query
    rows, each block recomputed in the backward: each query (i, j) of q
    (B, H, W, C) attends the keys and values at LR cells rows[i] x cols[j]
    (k x k), softmax in f32, scale d ** -0.5."""
    b, hq, wq, c = q.shape
    hk, wk = keys.shape[1], keys.shape[2]
    d = c // heads
    rows = cross_scale_indices(hq, hk, k)
    cols = cross_scale_indices(wq, wk, k)
    qh = q.reshape(b, hq, wq, heads, d) * d ** -0.5
    kh = keys.reshape(b, hk, wk, heads, d)
    vh = v.reshape(b, hk, wk, heads, v.shape[-1] // heads)
    blocks = []
    for r0 in range(0, hq, block_rows):
        r1 = min(r0 + block_rows, hq)
        urows, pos = np.unique(rows[r0:r1], return_inverse=True)
        pos = pos.reshape(r1 - r0, k)
        # window cell (t, s) of query (i, j): flattened cell pos[i, t] * wk + cols[j, s]
        idx = (pos[:, None, :, None] * wk + cols[None, :, None, :]).reshape(r1 - r0, wq, k * k)
        idx = torch.from_numpy(idx).to(q.device)
        urows = torch.from_numpy(urows).to(q.device)
        blocks.append(checkpoint(_block, qh[:, r0:r1], kh, vh, urows, idx, q8,
                                 use_reentrant=False))
    return torch.cat(blocks, dim=1).reshape(b, hq, wq, -1)


def restore(p: dict, model: dict, noisy, q8=_id):
    """NAF's restoration of a noisy (B, H, W, 3) batch, f32: the normalised
    batch is the guide, the batch itself the values, the output its size."""
    mean, std = (torch.tensor(s, dtype=torch.float32, device=noisy.device) for s in IMAGENET)
    p = {k: q8(v) for k, v in p.items()}
    guide, values = q8((noisy - mean) / std), q8(noisy)
    out_hw = noisy.shape[1:3]
    layers = model["img_layers"]
    x = torch.cat([encoder(guide, p, "image_encoder.encoder", layers, q8=q8),
                   encoder(guide, p, "image_encoder.sem_encoder", layers, q8=q8)], dim=-1)
    x = adaptive_pool(x, out_hw)
    q = q8(rope(x, model["heads_rope"], model["rope_base"]))
    keys = q8(adaptive_pool(q, values.shape[1:3]))
    return q8(blocked_attention(q, keys, values, model["heads_attn"], model["kernel_size"], q8))


def ssim(x, y, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Mean SSIM of two NHWC batches, the local statistics from 3 x 3
    average pools with zero padding (``F.avg_pool2d(t, 3, 1, 1)``), on
    contiguous NCHW copies: on the card (torch 2.11, CUDA 12.8) avg_pool2d's
    backward on a permuted NHWC view returns a wrong gradient, 105% of the
    exact one away, while its forward is exact."""
    x, y = x.permute(0, 3, 1, 2).contiguous(), y.permute(0, 3, 1, 2).contiguous()
    pool = lambda t: F.avg_pool2d(t, 3, 1, 1)  # noqa: E731
    mx, my = pool(x), pool(y)
    sx = pool(x * x) - mx * mx
    sy = pool(y * y) - my * my
    sxy = pool(x * y) - mx * my
    num = (2 * mx * my + c1) * (2 * sxy + c2)
    return (num / ((mx * mx + my * my + c1) * (sx + sy + c2))).mean()


def denoise_loss(pred, clean, den: dict):
    """w_l1 * L1 + w_l2 * L2 + w_ssim * (1 - SSIM)."""
    diff = pred - clean
    return (den["l1_weight"] * diff.abs().mean() + den["l2_weight"] * (diff * diff).mean()
            + den["ssim_weight"] * (1.0 - ssim(pred, clean)))


def denoise_steps(naf_init: dict, config: dict, cleans, noisies, q8=_id):
    """Run the steps on the clean (B, H, W, 3) batches ``cleans`` and the
    noisy batches ``noisies`` the program made of them, from the f32
    weights ``naf_init``; returns (each step's loss, the first step's
    gradient per leaf, each leaf's change after the last step, the first
    step's prediction). TF32 is off for the duration."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _steps(naf_init, config, cleans, noisies, q8)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _steps(naf_init, config, cleans, noisies, q8):
    tr, den = config["train"], config["denoising"]
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in naf_init.items()}
    opt = torch.optim.AdamW(params.values(), lr=tr["lr"], betas=(tr["b1"], tr["b2"]),
                            eps=tr["eps"], weight_decay=tr["weight_decay"], foreach=False)
    losses, grad1, pred1 = [], None, None
    for clean, noisy in zip(cleans, noisies):
        pred = restore(params, config["model"], noisy.float(), q8)
        loss = denoise_loss(pred, clean.float(), den)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grad1 is None:
            grad1 = {k: p.grad.detach().clone() for k, p in params.items()}
            pred1 = pred.detach()
        opt.step()
        losses.append(float(loss.detach()))
        del pred, loss
    delta = {k: params[k].detach() - naf_init[k].float() for k in params}
    return losses, grad1, delta, pred1
