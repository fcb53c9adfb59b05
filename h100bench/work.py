"""The yardstick's arithmetic: each card's peaks, the least time a piece of
work can take on it, and the operations and bytes of NAF's parts, counted
from their shapes whatever kernel runs them.

Peaks are NVIDIA's data-sheet figures, dense, at the full power limit.
An unknown card raises: a roofline against another card's peak would be a
wrong number, not a rough one.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peaks", "bound_s", "conv_layer", "k1_work", "k2_work", "attention_flops",
           "encoder_flops", "naf_forward_flops", "vit_forward_flops"]

# torch.cuda.get_device_name() -> (bytes/s, bf16 dense FLOP/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 989e12),  # H100 SXM5
}


def peaks(card: str):
    """(bytes/s, bf16 FLOP/s) of a card by its exact name."""
    try:
        return PEAKS[card]
    except KeyError:
        raise KeyError(f"no peaks recorded for card {card!r}; add its data-sheet figures "
                       "to h100bench/work.py") from None


def bound_s(flops: float, nbytes: float, card: str) -> float:
    """The least time the card could take: the larger of FLOPs over its
    bf16 peak and bytes over its memory bandwidth."""
    bw, fl = peaks(card)
    return max(nbytes / bw, flops / fl)


def conv_layer(b: int, h: int, w: int, cin: int, cout: int, k: int, elt: int = 2):
    """(FLOPs, bytes) of one fused [GroupNorm -> SiLU -> k x k conv] layer at
    (b, h, w): 2 h w cin cout k^2 per image; each tensor it is handed read
    or written once: the input, weight, bias, the f32 per-channel scale and
    shift, the output and its f32 channel sums."""
    flops = 2 * b * h * w * cin * cout * k * k
    nbytes = (elt * (b * h * w * cin + cin * cout * k * k + cout + b * h * w * cout)
              + 4 * (2 * b * cin + 2 * b * cout))
    return flops, nbytes


def k1_work(b: int, h: int, w: int, dim: int, layers: int, elt: int = 2):
    """(FLOPs, bytes) of one encoder's K1 layers: both stacks of dim // 2
    channels (k 1 and 3), 2 * layers fused layers each; the stems are not
    K1's."""
    hidden = dim // 2
    flops = nbytes = 0
    for k in (1, 3):
        f, n = conv_layer(b, h, w, hidden, hidden, k, elt)
        flops += 2 * layers * f
        nbytes += 2 * layers * n
    return flops, nbytes


def attention_flops(b: int, hq: int, wq: int, heads: int, k: int, d: int, dv: int) -> int:
    """Cross-scale neighbourhood attention: each query's k^2 logits (2 d
    each) and its weighted sum of k^2 values (2 dv each)."""
    return b * hq * wq * heads * k * k * 2 * (d + dv)


def k2_work(b: int, enc_hw, out_hw, lr_hw, dim: int, heads: int, k: int, c: int, elt: int = 2):
    """(FLOPs, bytes) of K2, pool-up + RoPE + attention: the attention's
    FLOPs; the encoder output, keys, values and f32 cos|sin row and column
    tables read once, the output written once."""
    (hi, wi), (oh, ow), (hk, wk) = enc_hw, out_hw, lr_hw
    flops = attention_flops(b, oh, ow, heads, k, dim // heads, c // heads)
    nbytes = (elt * (b * hi * wi * dim + b * hk * wk * dim + b * hk * wk * c + b * oh * ow * c)
              + 4 * 2 * dim * (oh + ow))
    return flops, nbytes


def encoder_flops(b: int, h: int, w: int, dim: int, layers: int) -> int:
    """Every conv of both stacks, stems included."""
    hidden = dim // 2
    total = 0
    for k in (1, 3):
        total += 2 * b * h * w * 3 * hidden * k * k
        total += 2 * layers * 2 * b * h * w * hidden * hidden * k * k
    return total


def naf_forward_flops(b: int, enc_hw, out_hw, model: dict, c: int) -> int:
    """NAF's forward: the encoder convs and the attention."""
    heads, dim = model["heads_attn"], model["dim"]
    return (encoder_flops(b, enc_hw[0], enc_hw[1], dim, model["img_layers"])
            + attention_flops(b, out_hw[0], out_hw[1], heads, model["kernel_size"],
                              dim // heads, c // heads))


def vit_forward_flops(b: int, h: int, w: int, cfg: dict) -> int:
    """A ViT's forward: the patch conv, then per block the qkv, output and
    MLP projections (2 T C^2 (3 + 1 + 2 r)) and the two attention products
    (4 T^2 C), with T the patch tokens plus the cls token."""
    c, ps = cfg["embed_dim"], cfg["patch_size"]
    g = (h // ps) * (w // ps)
    t = g + 1
    r = cfg["mlp_ratio"]
    block = 2 * t * c * c * (4 + 2 * r) + 4 * t * t * c
    return b * int(2 * g * c * 3 * ps * ps + cfg["depth"] * block)
