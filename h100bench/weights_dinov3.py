"""Seeded weights of a DINOv3 ViT under the port's names (SwiGLU FFN, no
qkv bias where the configuration says so), drawn on the device in parts.

``weights.draw`` draws a whole list in one ``rand`` and one ``randn`` of its
size: at 6.72 B parameters that is 54 GB of float32 at once. ``draw_parts``
draws the list in consecutive parts of at most ``part`` elements (a block of
the 7B is one part), each as ``weights.draw`` draws a list, so the same seed
gives the same tensors on any card and the transient is one part's.
"""

from __future__ import annotations

import math

import torch

from h100bench.weights import draw

__all__ = ["dinov3_specs", "draw_parts"]


def dinov3_specs(cfg: dict) -> list:
    """(name, shape, init) of a DINOv3 ViT, ``cfg`` the configuration's
    ``backbone``: linear and patch weights normal with std 1 / sqrt(fan_in),
    biases and tokens normal with std 0.02, LayerNorm scales in [0.9, 1.1],
    LayerScale in [0.1, 0.5] (the published init, 1e-5, would let a
    dropped block pass unseen)."""
    c, ps, hid = cfg["embed_dim"], cfg["patch_size"], cfg["mlp_hidden"]
    fan = lambda n: ("normal", 0.0, 1 / math.sqrt(n))
    small = ("normal", 0.0, 0.02)
    ln = ("uniform", 1.0, 0.1)
    ls = ("uniform", 0.3, 0.2)
    specs = [("patch_embed.proj.weight", (c, 3, ps, ps), fan(3 * ps * ps)),
             ("patch_embed.proj.bias", (c,), small), ("cls_token", (1, 1, c), small)]
    if cfg["num_reg_tokens"]:
        specs.append(("reg_token", (1, cfg["num_reg_tokens"], c), small))
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        specs += [(b + "norm1.weight", (c,), ln), (b + "norm1.bias", (c,), small),
                  (b + "attn.qkv.weight", (3 * c, c), fan(c))]
        if cfg["qkv_bias"]:
            specs.append((b + "attn.qkv.bias", (3 * c,), small))
        specs += [(b + "attn.proj.weight", (c, c), fan(c)), (b + "attn.proj.bias", (c,), small),
                  (b + "ls1.gamma", (c,), ls),
                  (b + "norm2.weight", (c,), ln), (b + "norm2.bias", (c,), small),
                  (b + "mlp.fc1_g.weight", (hid, c), fan(c)), (b + "mlp.fc1_g.bias", (hid,), small),
                  (b + "mlp.fc1_x.weight", (hid, c), fan(c)), (b + "mlp.fc1_x.bias", (hid,), small),
                  (b + "mlp.fc2.weight", (c, hid), fan(hid)), (b + "mlp.fc2.bias", (c,), small),
                  (b + "ls2.gamma", (c,), ls)]
    return specs + [("norm.weight", (c,), ln), ("norm.bias", (c,), small)]


def draw_parts(specs: list, gen: torch.Generator, dtype, part: int = 1 << 28) -> dict:
    """``weights.draw`` of ``specs`` in consecutive parts of at most ``part``
    elements (a larger tensor is a part of its own)."""
    out, group, n = {}, [], 0
    for spec in specs:
        m = math.prod(spec[1])
        if group and n + m > part:
            out.update(draw(group, gen, dtype))
            group, n = [], 0
        group.append(spec)
        n += m
    if group:
        out.update(draw(group, gen, dtype))
    return out
