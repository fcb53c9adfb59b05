"""DINOv3 ViT-7B/16 in plain float32 PyTorch (arXiv 2508.10104; the dinov3
hub entry ``dinov3_vit7b16``; HF's ``DINOv3ViTConfig``), and the pipeline
the cell ``naf-dinov3-vit7b16.512`` is held to: this ViT's features, then
``reference/naf.py``'s NAF on them. Independent of the program: it imports
nothing of ``naf_torch``. NHWC in and out.

  x = [cls; registers; patchify(img)]          no learned positions
  per block:  h = LN1(x)
              q, k, v = h W_q, h W_k, h W_v      heads of d, no bias
              q, k of the patch tokens: rotate-half 2D RoPE
              x += ls1 * (softmax(q k^T / sqrt(d)) v W_o + b_o)
              h = LN2(x)
              x += ls2 * (W3 (silu(W1 h + b1) * (W2 h + b2)) + b3)
  out = LN(x) of the patch tokens              (B, H/ps, W/ps, C)

The tensors are read under the port's names (``attn.qkv.weight`` holds W_q,
W_k and W_v stacked; SwiGLU's ``fc1_g`` is W1, ``fc1_x`` W2, ``fc2`` W3),
as drawn, in any dtype: each block's are cast to float32 as it runs, so the
model's float32 copy never exists whole (27 GB at the published widths).
Matmuls run with TF32 off where the caller turns it off.

Departures from the published model, each harmless to the comparison:
- The published LayerNorm (``layernormbf16``) and the blocks run in bf16;
  here everything is float32, the yardstick.
- The RoPE coordinates' training-time shift, jitter and rescale (x2) are
  off, as at inference; ``mask_token``, ``local_cls_norm`` and the cls
  token's own norm are not used for patch features and are left out.
- The published q/k/v carry no bias (``qkv_bias=False``); a ``qkv.bias`` in
  the tensors, where given, is added.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import naf as ref_naf

__all__ = ["rope_angles", "vit_forward", "pipeline"]


def _id(t):
    return t


def rope_angles(gh: int, gw: int, d: int, base: float) -> torch.Tensor:
    """(gh * gw, d) angles of the patch tokens, row-major: each axis's cell
    centres mapped to [-1, 1], over periods base ** (2 i / (d / 2)),
    i < d / 4; a token's row angles then its column angles, the pair
    repeated for the two halves that rotate-half pairs."""
    def axis(n):
        return 2.0 * (np.arange(n, dtype=np.float64) + 0.5) / n - 1.0

    periods = base ** (2.0 * np.arange(d // 4) / (d // 2))
    ay = 2.0 * math.pi * axis(gh)[:, None] / periods  # (gh, d/4)
    ax = 2.0 * math.pi * axis(gw)[:, None] / periods  # (gw, d/4)
    grid = np.concatenate([np.repeat(ay, gw, axis=0), np.tile(ax, (gh, 1))], axis=1)
    return torch.from_numpy(np.concatenate([grid, grid], axis=1).astype(np.float32))


def _rotate(x, angles):
    """x cos + rotate_half(x) sin, rotate_half([a | b]) = [-b | a]."""
    a, b = x.chunk(2, dim=-1)
    return x * angles.cos() + torch.cat([-b, a], dim=-1) * angles.sin()


def vit_forward(p: dict, cfg: dict, x: torch.Tensor, q8=_id) -> torch.Tensor:
    """``p``: the weights under the port's names; ``cfg``: patch_size,
    embed_dim, depth, num_heads, num_reg_tokens, rope_theta, ln_eps; ``x``:
    (B, H, W, 3) normalised image. ``q8`` rounds the weights, the input and
    each block's output (the control's float8)."""
    def w(name):
        t = p.get(name)
        return None if t is None else q8(t.float())

    x = q8(x.float())
    b, h, wd, _ = x.shape
    ps, c, nh = cfg["patch_size"], cfg["embed_dim"], cfg["num_heads"]
    nreg, eps, d = cfg["num_reg_tokens"], cfg["ln_eps"], cfg["embed_dim"] // cfg["num_heads"]
    gh, gw = h // ps, wd // ps
    t = F.conv2d(x.permute(0, 3, 1, 2), w("patch_embed.proj.weight"), w("patch_embed.proj.bias"),
                 stride=ps).flatten(2).transpose(1, 2)
    prefix = [w("cls_token").expand(b, 1, c)]
    if nreg:
        prefix.append(w("reg_token").expand(b, nreg, c))
    t = torch.cat(prefix + [t], dim=1)
    n0 = 1 + nreg
    angles = rope_angles(gh, gw, d, cfg["rope_theta"]).to(x.device)
    for i in range(cfg["depth"]):
        k = f"blocks.{i}."
        y = F.layer_norm(t, (c,), w(k + "norm1.weight"), w(k + "norm1.bias"), eps)
        qkv = F.linear(y, w(k + "attn.qkv.weight"), w(k + "attn.qkv.bias"))
        q, kk, v = qkv.reshape(b, -1, 3, nh, d).permute(2, 0, 3, 1, 4)
        q = torch.cat([q[:, :, :n0], _rotate(q[:, :, n0:], angles)], dim=2)
        kk = torch.cat([kk[:, :, :n0], _rotate(kk[:, :, n0:], angles)], dim=2)
        att = torch.softmax((q @ kk.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        y = F.linear((att @ v).transpose(1, 2).reshape(b, -1, c), w(k + "attn.proj.weight"),
                     w(k + "attn.proj.bias"))
        t = t + w(k + "ls1.gamma") * y
        y = F.layer_norm(t, (c,), w(k + "norm2.weight"), w(k + "norm2.bias"), eps)
        gate = F.linear(y, w(k + "mlp.fc1_g.weight"), w(k + "mlp.fc1_g.bias"))
        up = F.linear(y, w(k + "mlp.fc1_x.weight"), w(k + "mlp.fc1_x.bias"))
        y = F.linear(F.silu(gate) * up, w(k + "mlp.fc2.weight"), w(k + "mlp.fc2.bias"))
        t = q8(t + w(k + "ls2.gamma") * y)
    t = F.layer_norm(t, (c,), w("norm.weight"), w("norm.bias"), eps)
    return t[:, n0:].reshape(b, gh, gw, c)


@torch.no_grad()
def pipeline(vit_state: dict, vit_cfg: dict, naf_state: dict, model: dict, image, out_hw,
             q8=_id):
    """(features, output) of the reference pipeline, float32 NHWC: this
    ViT on ``image`` (normalised, NHWC), then ``reference/naf.py``'s NAF
    guided by the same image."""
    feats = vit_forward(vit_state, vit_cfg, image, q8=q8)
    out = ref_naf.naf_forward(ref_naf.naf_params(naf_state), model, image.float(), feats,
                              out_hw, q8=q8)
    return feats, out
