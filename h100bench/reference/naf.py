"""NAF's forward in plain float32 PyTorch: the yardstick the served path is held to.

A frozen, self-contained statement of the model (valeoai/NAF,
``src/model/naf.py``, ``src/layers``), written from the published
description and independent of the program: it imports nothing of
``naf_torch``. NHWC throughout.

  image (B, H, W, 3) -> two conv stacks (a 1x1 "pixel" and a 3x3 "semantic"
  stack: stem conv, then blocks of GroupNorm -> SiLU -> reflect conv) -> x
  queries = RoPE(adaptive_pool(x -> output size))
  keys    = adaptive_pool(queries -> feature grid)
  out     = cross-scale neighbourhood attention of the queries over the
            k x k LR-cell window of keys, with the features as values

``q8``, where given, rounds every tensor the model holds in its serving
precision (weights, inputs, activations between layers, the attention
probabilities, the output) through that function: the control of
``h100bench.check`` passes a float8 round trip.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pool_matrix", "adaptive_pool", "encoder", "rope_angles", "rope",
           "cross_scale_indices", "cross_scale_attention", "naf_forward", "naf_params"]


def _id(t):
    return t


@functools.lru_cache(maxsize=64)
def pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of torch's adaptive average pool on one axis:
    output o averages inputs [floor(o n_in / n_out), ceil((o + 1) n_in / n_out))."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        a = (o * n_in) // n_out
        b = -((-(o + 1) * n_in) // n_out)
        m[o, a:b] = 1.0 / (b - a)
    return m


def adaptive_pool(x: torch.Tensor, size) -> torch.Tensor:
    """Adaptive average pool of the (H, W) axes of an NHWC tensor, f32."""
    h, w = x.shape[1], x.shape[2]
    ph = torch.from_numpy(pool_matrix(h, int(size[0]))).to(x.device)
    pw = torch.from_numpy(pool_matrix(w, int(size[1]))).to(x.device)
    return torch.einsum("oh,bhwc,pw->bopc", ph, x, pw)


def _conv(x, weight, bias):
    p = weight.shape[-1] // 2
    xc = x.permute(0, 3, 1, 2)
    if p:
        xc = F.pad(xc, (p, p, p, p), mode="reflect")
    return F.conv2d(xc, weight, bias).permute(0, 2, 3, 1)


def _group_norm(x, groups: int, weight, bias, eps: float = 1e-5):
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return y * weight + bias


def encoder(x, p: dict, prefix: str, layers: int, groups: int = 8, q8=_id):
    """One conv stack: stem conv, then ``layers`` blocks of two
    [GroupNorm -> SiLU -> conv] layers; every layer's output through ``q8``."""
    y = q8(_conv(x, p[f"{prefix}.0.weight"], p[f"{prefix}.0.bias"]))
    for i in range(1, layers + 1):
        for j in (1, 2):
            g = f"{prefix}.{i}.norm{j}"
            c = f"{prefix}.{i}.conv{j}"
            z = F.silu(_group_norm(y, groups, p[f"{g}.weight"], p[f"{g}.bias"]))
            y = q8(_conv(q8(z), p[f"{c}.weight"], p[f"{c}.bias"]))
    return y


def rope_angles(n: int, d_head: int, base: float, scale: float = 1.0) -> torch.Tensor:
    """(n, d_head // 4) angles of one axis: cell centres in [-1, 1], times
    ``scale`` (the train-time coordinate rescale), over a geometric period
    spectrum base ** (2 i / (d_head / 2))."""
    coords = torch.from_numpy(2.0 * (np.arange(n, dtype=np.float32) + 0.5) / n - 1.0)
    if scale != 1.0:
        coords = coords * torch.tensor(scale, dtype=torch.float32)
    nf = d_head // 4
    periods = torch.from_numpy(
        (base ** (2 * np.arange(nf, dtype=np.float32) / (d_head // 2))).astype(np.float32))
    return (2.0 * math.pi) * coords[:, None] / periods


def rope(x, heads: int, base: float, scale: float = 1.0):
    """Axial rotary embedding of an NHWC map, per head: the channels of a
    head are [u, v, u, v] quarters (row angles u, column angles v), rotated
    in halves: x cos + rotate_half(x) sin."""
    b, h, w, c = x.shape
    d = c // heads
    au = rope_angles(h, d, base, scale).to(x.device)[:, None, None, :]  # (h, 1, 1, d/4)
    av = rope_angles(w, d, base, scale).to(x.device)[None, :, None, :]  # (1, w, 1, d/4)
    q0, q1, q2, q3 = x.reshape(b, h, w, heads, 4, d // 4).unbind(-2)
    # rotate_half([q0 q1 | q2 q3]) = [-q2 -q3 | q0 q1]
    out = (q0 * au.cos() - q2 * au.sin(), q1 * av.cos() - q3 * av.sin(),
           q2 * au.cos() + q0 * au.sin(), q3 * av.cos() + q1 * av.sin())
    return torch.stack(out, dim=-2).reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def cross_scale_indices(hr: int, lr: int, k: int) -> np.ndarray:
    """(hr, k) LR cells each HR position attends on one axis: the LR axis
    nearest-exact upsampled to ``hr`` and natten's dilated window (dilation
    hr // lr, clamped to the densest that fits) on it."""
    dil = max(hr // lr, 1)
    if k * dil > hr:
        dil = max(hr // k, 1)
    i = np.arange(hr)
    c, m = i // dil, i % dil
    l_sub = -((-(hr - m)) // dil)
    start = m + dil * np.clip(c - k // 2, 0, l_sub - k)
    pos = start[:, None] + dil * np.arange(k)[None, :]
    src = np.clip(np.floor((np.arange(hr, dtype=np.float64) + 0.5) * (lr / hr)).astype(np.int64),
                  0, lr - 1)
    return src[pos]


def cross_scale_attention(q, keys, v, heads: int, k: int, q8=_id):
    """Each query (i, j) of q (B, H, W, C) attends keys and values at LR
    cells rows[i] x cols[j] (k x k), softmax in f32, scale d ** -0.5. Query
    rows that share a window row set are computed together."""
    b, hq, wq, c = q.shape
    hk, wk = keys.shape[1], keys.shape[2]
    d, dv = c // heads, v.shape[-1] // heads
    rows = cross_scale_indices(hq, hk, k)
    cols = torch.from_numpy(cross_scale_indices(wq, wk, k)).to(q.device)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    qh = q.reshape(b, hq, wq, heads, d) * d ** -0.5
    kh = keys.reshape(b, hk, wk, heads, d)
    vh = v.reshape(b, hk, wk, heads, dv)
    out = q.new_empty(b, hq, wq, heads, dv)
    for u, pattern in enumerate(uniq):
        sel = torch.from_numpy(np.nonzero(inv == u)[0]).to(q.device)
        rsel = torch.from_numpy(pattern).to(q.device)
        kg = kh[:, rsel][:, :, cols]  # (B, k, W, k, heads, d)
        vg = vh[:, rsel][:, :, cols]
        logits = torch.einsum("brwnd,btwsnd->brwnts", qh[:, sel], kg)
        prob = q8(torch.softmax(logits.flatten(-2), dim=-1)).reshape(logits.shape)
        out[:, sel] = torch.einsum("brwnts,btwsnd->brwnd", prob, vg)
    return out.reshape(b, hq, wq, heads * dv)


def naf_params(state: dict, dtype=torch.float32) -> dict:
    """The served weights as the reference computes with them: f32 copies."""
    return {k: v.detach().to(dtype) for k, v in state.items()}


def naf_forward(p: dict, model: dict, image, feats, out_hw, rescale: float = 1.0, q8=_id):
    """NAF's output (B, *out_hw, C) for an NHWC image and features, f32.

    ``model`` holds the configuration's widths (dim, heads_attn, heads_rope,
    kernel_size, img_layers, rope_base). ``rescale`` is the train-time RoPE
    coordinate rescale (1: inference). A guide larger than 4x the output is
    first downscaled bilinearly, as the published model does."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    p = {k: q8(v) for k, v in p.items()}
    image, feats = q8(image), q8(feats)
    h, w = image.shape[1], image.shape[2]
    if h > 4 * oh or w > 4 * ow:
        gh, gw = min(h, 4 * oh, 4 * ow), min(w, 4 * ow, 4 * oh)
        image = F.interpolate(image.permute(0, 3, 1, 2), size=(gh, gw), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
    layers = model["img_layers"]
    x = torch.cat([encoder(image, p, "image_encoder.encoder", layers, q8=q8),
                   encoder(image, p, "image_encoder.sem_encoder", layers, q8=q8)], dim=-1)
    x = adaptive_pool(x, (oh, ow))
    q = q8(rope(x, model["heads_rope"], model["rope_base"], rescale))
    keys = q8(adaptive_pool(q, feats.shape[1:3]))
    return q8(cross_scale_attention(q, keys, feats, model["heads_attn"], model["kernel_size"],
                                    q8=q8))
