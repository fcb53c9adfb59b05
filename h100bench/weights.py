"""Seeded weights and inputs, made on the device in a few large draws.

Every tensor a cell needs comes from ``--seed``: the same seed gives the
same weights and inputs, on any card. A model's weights are a list of
(name, shape, init) under the published state-dict names; one ``rand`` and
one ``randn`` draw of the whole list's size feed them all, so set-up makes
no draw per leaf and nothing on the host. The program loads the result
under those names, and the reference computes with the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["subseed", "generator", "naf_specs", "vit_specs", "draw", "uniform", "normal"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    words = [int(seed) % 2**32, int(seed) // 2**32 % 2**32, *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def naf_specs(model: dict) -> list:
    """NAF's parameters (``src/model/naf.py``): two conv stacks of
    ``dim // 2`` channels, 1x1 and 3x3. Convs take torch's default bound
    1 / sqrt(fan_in); GroupNorm scales lie in [0.75, 1.25], shifts in
    [-0.25, 0.25], so the norms are exercised."""
    hidden = model["dim"] // 2
    specs = []
    for prefix, k in (("image_encoder.encoder", 1), ("image_encoder.sem_encoder", 3)):
        p = f"{prefix}.0"
        bound = 1 / math.sqrt(3 * k * k)
        specs += [(f"{p}.weight", (hidden, 3, k, k), ("uniform", 0.0, bound)),
                  (f"{p}.bias", (hidden,), ("uniform", 0.0, bound))]
        bound = 1 / math.sqrt(hidden * k * k)
        for i in range(1, model["img_layers"] + 1):
            for j in (1, 2):
                p = f"{prefix}.{i}"
                specs += [(f"{p}.norm{j}.weight", (hidden,), ("uniform", 1.0, 0.25)),
                          (f"{p}.norm{j}.bias", (hidden,), ("uniform", 0.0, 0.25)),
                          (f"{p}.conv{j}.weight", (hidden, hidden, k, k), ("uniform", 0.0, bound)),
                          (f"{p}.conv{j}.bias", (hidden,), ("uniform", 0.0, bound))]
    return specs


def vit_specs(cfg: dict) -> list:
    """A DINOv2 ViT under timm's names: linear and patch weights normal
    with std 1 / sqrt(fan_in), biases, tokens and positions normal with
    std 0.02, LayerNorm scales in [0.9, 1.1], LayerScale in [0.1, 0.5]."""
    c, ps, g = cfg["embed_dim"], cfg["patch_size"], cfg["pos_grid"]
    hid = int(c * cfg["mlp_ratio"])
    fan = lambda n: ("normal", 0.0, 1 / math.sqrt(n))
    small = ("normal", 0.0, 0.02)
    ln = ("uniform", 1.0, 0.1)
    specs = [("patch_embed.proj.weight", (c, 3, ps, ps), fan(3 * ps * ps)),
             ("patch_embed.proj.bias", (c,), small), ("cls_token", (1, 1, c), small),
             ("pos_embed", (1, 1 + g * g, c), small)]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        specs += [(b + "norm1.weight", (c,), ln), (b + "norm1.bias", (c,), small),
                  (b + "attn.qkv.weight", (3 * c, c), fan(c)), (b + "attn.qkv.bias", (3 * c,), small),
                  (b + "attn.proj.weight", (c, c), fan(c)), (b + "attn.proj.bias", (c,), small),
                  (b + "ls1.gamma", (c,), ("uniform", 0.3, 0.2)),
                  (b + "norm2.weight", (c,), ln), (b + "norm2.bias", (c,), small),
                  (b + "mlp.fc1.weight", (hid, c), fan(c)), (b + "mlp.fc1.bias", (hid,), small),
                  (b + "mlp.fc2.weight", (c, hid), fan(hid)), (b + "mlp.fc2.bias", (c,), small),
                  (b + "ls2.gamma", (c,), ("uniform", 0.3, 0.2))]
    return specs + [("norm.weight", (c,), ln), ("norm.bias", (c,), small)]


def draw(specs: list, gen: torch.Generator, dtype) -> dict:
    """The tensors of ``specs`` in ``dtype`` on the generator's device:
    ("uniform", centre, half) is centre + half * U(-1, 1), ("normal",
    mean, std) is mean + std * N(0, 1)."""
    n = sum(math.prod(shape) for _, shape, _ in specs)
    dev = gen.device
    u = torch.rand(n, generator=gen, device=dev).mul_(2).sub_(1)
    z = torch.randn(n, generator=gen, device=dev)
    out, i = {}, 0
    for name, shape, (kind, a, b) in specs:
        m = math.prod(shape)
        src = u if kind == "uniform" else z
        out[name] = (src[i:i + m] * b + a).reshape(shape).to(dtype)
        i += m
    return out


def uniform(gen: torch.Generator, shape, dtype, lo: float = 0.0, hi: float = 1.0):
    return torch.rand(shape, generator=gen, device=gen.device).mul_(hi - lo).add_(lo).to(dtype)


def normal(gen: torch.Generator, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)
