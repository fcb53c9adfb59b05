"""The distillation teacher in plain float32 PyTorch: a DINOv2 ViT (arXiv
2304.07193) with timm's parameter names, independent of the program.

(B, H, W, 3) normalised image -> (B, H/ps, W/ps, C) layer-normed patch
tokens of the last block: conv patchify, a cls token, learned positions
(a ``pos_grid``^2 table with a cls row, resized to the patch grid by the
cubic resize of ``jax.image.resize``: Keys' kernel, a = -0.5, antialiased
when shrinking), pre-norm blocks with LayerScale, exact GELU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_weights", "vit_forward"]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a scale-and-translate cubic resize on one
    axis, the kernel widened by the inverse scale when shrinking and each
    output's weights renormalised."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / width)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return np.ascontiguousarray(w.T).astype(np.float32)


def _id(t):
    return t


def vit_forward(p: dict, cfg: dict, x: torch.Tensor, q8=_id) -> torch.Tensor:
    """``p``: f32 tensors under timm's names; ``cfg``: patch_size,
    embed_dim, depth, num_heads, pos_grid, ln_eps. ``q8`` rounds the
    weights, the input and each block's output (the control's float8)."""
    p = {k: q8(v) for k, v in p.items()}
    x = q8(x)
    b, h, w, _ = x.shape
    ps, c, nh = cfg["patch_size"], cfg["embed_dim"], cfg["num_heads"]
    eps = cfg["ln_eps"]
    gh, gw = h // ps, w // ps
    t = F.conv2d(x.permute(0, 3, 1, 2), p["patch_embed.proj.weight"], p["patch_embed.proj.bias"],
                 stride=ps).flatten(2).transpose(1, 2)
    pos = p["pos_embed"]
    g = cfg["pos_grid"]
    grid = pos[:, 1:].reshape(g, g, c)
    if (gh, gw) != (g, g):
        wh = torch.from_numpy(resize_weights(g, gh)).to(x.device)
        ww = torch.from_numpy(resize_weights(g, gw)).to(x.device)
        grid = torch.einsum("oh,hwc,pw->opc", wh, grid, ww)
    t = torch.cat([(p["cls_token"] + pos[:, :1]).expand(b, 1, c),
                   t + grid.reshape(1, gh * gw, c)], dim=1)
    d = c // nh
    for i in range(cfg["depth"]):
        k = f"blocks.{i}."
        y = F.layer_norm(t, (c,), p[k + "norm1.weight"], p[k + "norm1.bias"], eps)
        qkv = F.linear(y, p[k + "attn.qkv.weight"], p[k + "attn.qkv.bias"])
        q, kk, v = qkv.reshape(b, -1, 3, nh, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q * d ** -0.5) @ kk.transpose(-1, -2), dim=-1)
        y = F.linear((att @ v).transpose(1, 2).reshape(b, -1, c), p[k + "attn.proj.weight"],
                     p[k + "attn.proj.bias"])
        t = t + p[k + "ls1.gamma"] * y
        y = F.layer_norm(t, (c,), p[k + "norm2.weight"], p[k + "norm2.bias"], eps)
        y = F.linear(F.gelu(F.linear(y, p[k + "mlp.fc1.weight"], p[k + "mlp.fc1.bias"])),
                     p[k + "mlp.fc2.weight"], p[k + "mlp.fc2.bias"])
        t = q8(t + p[k + "ls2.gamma"] * y)
    t = F.layer_norm(t, (c,), p["norm.weight"], p["norm.bias"], eps)
    return t[:, 1:].reshape(b, gh, gw, c)
