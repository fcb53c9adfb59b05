"""The operations and bytes of a ViT forward with the FFN kinds of
``naf_torch.backbones.vit``, counted from its shapes whatever kernels run it
(``work.vit_forward_flops`` counts the GELU MLP of the distillation teacher
and stays as it is).

FLOPs: the patch conv (2 g C 3 ps^2, g patch tokens); per block the q, k,
v and output projections and the FFN's (2 T C (4 C + n hidden), n = 3 for
SwiGLU's gate, up and down, 2 for GELU's), and the two attention products
(4 T^2 C), with T the patch tokens, the cls token and the registers.
Bytes: every weight read once, the residual stream read and written once a
block, the image read once and the features written once.
"""

from __future__ import annotations

__all__ = ["vit_params", "vit_work"]


def vit_params(cfg: dict) -> int:
    """The parameters of a ViT under ``cfg`` (the configuration's
    ``backbone``)."""
    c, ps, hid = cfg["embed_dim"], cfg["patch_size"], cfg["mlp_hidden"]
    n_ffn = 3 if cfg["ffn"] == "swiglu" else 2
    block = (3 * c * c + 3 * c * cfg["qkv_bias"] + c * c + c + 4 * c
             + n_ffn * c * hid + (n_ffn - 1) * hid + c + 2 * c * cfg["layerscale"])
    return (c * 3 * ps * ps + c + c * (1 + cfg["num_reg_tokens"]) + cfg["depth"] * block + 2 * c)


def vit_work(b: int, h: int, w: int, cfg: dict, elt: int = 2):
    """(FLOPs, bytes) of one forward of a (b, h, w, 3) image."""
    c, ps = cfg["embed_dim"], cfg["patch_size"]
    g = (h // ps) * (w // ps)
    t = g + 1 + cfg["num_reg_tokens"]
    n_ffn = 3 if cfg["ffn"] == "swiglu" else 2
    block = 2 * t * c * (4 * c + n_ffn * cfg["mlp_hidden"]) + 4 * t * t * c
    flops = b * (2 * g * c * 3 * ps * ps + cfg["depth"] * block)
    nbytes = elt * (vit_params(cfg) + cfg["depth"] * 2 * b * t * c + b * h * w * 3 + b * g * c)
    return flops, nbytes

