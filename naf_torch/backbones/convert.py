"""Pretrained ViT checkpoints onto the port's ViT (counterpart of
``naf_tpu/backbones/convert.py``).

Each converter maps one source layout onto the port's timm-named state dict
and infers the ``ViTConfig`` from tensor shapes, so a converted model loads
with ``ViT(cfg).load_state_dict(state)``:

- timm ``VisionTransformer`` (DINO, DINOv2 through timm, MAE, SigLIP-style
  trunks): ``convert_timm_vit``, the names already the port's;
- HuggingFace ``Dinov2Model`` / ``Dinov2WithRegistersModel``:
  ``convert_hf_dinov2``; ``DINOv3ViTModel``: ``convert_hf_dinov3``, its GELU
  MLP (``up_proj`` / ``down_proj``) or gated one (``gate_proj`` /
  ``up_proj`` / ``down_proj``, ViT-7B/16);
- the dinov3 repository's hub checkpoints (``storage_tokens``, a masked k
  bias, ``mlp.fc1`` / ``fc2`` or SwiGLU's ``mlp.w1`` / ``w2`` / ``w3``):
  ``convert_dinov3``;
- RADIO and CAPI hub checkpoints, a timm trunk under a prefix, registers as
  ``register_tokens`` / ``storage_tokens``: ``convert_radio``, ``convert_capi``;
- Franca, a timm trunk plus its RASA head: ``convert_franca``;
- the Perception Encoder's CLIP-lineage names: ``convert_pe``;
- ``vit_from_torch`` picks the converter from the keys. An unknown layout raises.

The cls position of a learned position table is read from its row count: a
perfect square has none, a square plus one has one, anything else raises.
(The JAX package's ``convert_timm_vit`` reads it from an odd count, which
misreads DINOv2's 1 + 37^2 = 1370 rows and a 37^2 = 1369 register-model
table; the port does not copy that.)
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import torch

from naf_torch.backbones.vit import ViT, ViTConfig

__all__ = [
    "convert_timm_vit",
    "convert_hf_dinov2",
    "convert_hf_dinov3",
    "convert_dinov3",
    "convert_radio",
    "convert_franca",
    "convert_capi",
    "convert_pe",
    "vit_from_torch",
]

def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().cpu()


def pos_layout(n_rows: int) -> Tuple[int, bool]:
    """(grid side, has a cls row) of a learned position table of ``n_rows``
    rows: a perfect square has no cls row, a square plus one has one."""
    for has_cls in (False, True):
        g = math.isqrt(n_rows - has_cls)
        if g * g == n_rows - has_cls:
            return g, has_cls
    raise ValueError(f"a position table of {n_rows} rows is neither g^2 nor 1 + g^2")


def _depth(state: Mapping, prefix: str, field: int) -> int:
    return 1 + max(int(k.split(".")[field]) for k in state if k.startswith(prefix))


def _keys(cfg: ViTConfig) -> List[str]:
    """The port ViT's state-dict keys for ``cfg`` (built on the meta device)."""
    with torch.device("meta"):
        return list(ViT(cfg).state_dict())


def convert_timm_vit(state: Mapping, num_heads: int) -> Tuple[dict, ViTConfig]:
    """timm VisionTransformer state dict -> (port state dict, config). Keys
    outside the trunk (heads, ``fc_norm``) are dropped."""
    pe_w = _t(state["patch_embed.proj.weight"])  # (C, 3, ps, ps)
    c, _, ps, _ = pe_w.shape
    grid, has_cls = pos_layout(_t(state["pos_embed"]).shape[1])
    cfg = ViTConfig(
        patch_size=ps,
        embed_dim=c,
        depth=_depth(state, "blocks.", 1),
        num_heads=num_heads,
        mlp_ratio=_t(state["blocks.0.mlp.fc1.weight"]).shape[0] / c,
        num_reg_tokens=_t(state["reg_token"]).shape[1] if "reg_token" in state else 0,
        layerscale="blocks.0.ls1.gamma" in state,
        pos_grid=grid,
        use_cls_pos=has_cls,
        ln_pre="norm_pre.weight" in state,
        patch_bias="patch_embed.proj.bias" in state,
    )
    return {k: _t(state[k]) for k in _keys(cfg)}, cfg


def _blocks(state: Mapping, cfg: ViTConfig, names: Mapping[str, str]) -> dict:
    """Per-block tensors renamed by ``names`` (port name -> source name, with
    ``{i}`` for the block index), those that ``cfg``'s ViT has."""
    want = set(_keys(cfg))
    return {f"blocks.{i}.{port}": _t(state[src.format(i=i)])
            for i in range(cfg.depth) for port, src in names.items()
            if f"blocks.{i}.{port}" in want}


def _finish(out: dict, cfg: ViTConfig) -> Tuple[dict, ViTConfig]:
    """Raise unless ``out`` holds exactly the keys of ``cfg``'s ViT."""
    want = set(_keys(cfg))
    if set(out) != want:
        raise ValueError(f"converted state misses {sorted(want - set(out))[:5]} and has "
                         f"extra {sorted(set(out) - want)[:5]}")
    return out, cfg


def convert_hf_dinov2(state: Mapping, num_heads: int) -> Tuple[dict, ViTConfig]:
    """HF Dinov2Model / Dinov2WithRegistersModel state dict -> (state, config)."""
    pe_w = _t(state["embeddings.patch_embeddings.projection.weight"])
    c, _, ps, _ = pe_w.shape
    pos = _t(state["embeddings.position_embeddings"])
    grid, has_cls = pos_layout(pos.shape[1])
    depth = _depth(state, "encoder.layer.", 2)
    p = "encoder.layer.{i}."
    cfg = ViTConfig(
        patch_size=ps,
        embed_dim=c,
        depth=depth,
        num_heads=num_heads,
        mlp_ratio=_t(state["encoder.layer.0.mlp.fc1.weight"]).shape[0] / c,
        num_reg_tokens=(_t(state["embeddings.register_tokens"]).shape[1]
                        if "embeddings.register_tokens" in state else 0),
        layerscale="encoder.layer.0.layer_scale1.lambda1" in state,
        pos_grid=grid,
        use_cls_pos=has_cls,
    )
    out = {
        "patch_embed.proj.weight": pe_w,
        "patch_embed.proj.bias": _t(state["embeddings.patch_embeddings.projection.bias"]),
        "pos_embed": pos,
        "cls_token": _t(state["embeddings.cls_token"]),
        "norm.weight": _t(state["layernorm.weight"]),
        "norm.bias": _t(state["layernorm.bias"]),
    }
    if cfg.num_reg_tokens:
        out["reg_token"] = _t(state["embeddings.register_tokens"])
    out.update(_blocks(state, cfg, {
        "norm1.weight": p + "norm1.weight", "norm1.bias": p + "norm1.bias",
        "attn.proj.weight": p + "attention.output.dense.weight",
        "attn.proj.bias": p + "attention.output.dense.bias",
        "ls1.gamma": p + "layer_scale1.lambda1", "ls2.gamma": p + "layer_scale2.lambda1",
        "norm2.weight": p + "norm2.weight", "norm2.bias": p + "norm2.bias",
        "mlp.fc1.weight": p + "mlp.fc1.weight", "mlp.fc1.bias": p + "mlp.fc1.bias",
        "mlp.fc2.weight": p + "mlp.fc2.weight", "mlp.fc2.bias": p + "mlp.fc2.bias",
    }))
    for i in range(depth):
        a = f"encoder.layer.{i}.attention.attention."
        for kind in ("weight", "bias"):
            out[f"blocks.{i}.attn.qkv.{kind}"] = torch.cat(
                [_t(state[f"{a}{m}.{kind}"]) for m in ("query", "key", "value")])
    return _finish(out, cfg)


def _ffn(state: Mapping, c: int, gated: str, plain: str) -> dict:
    """The FFN's ``ViTConfig`` fields from block 0's tensors: SwiGLU where
    ``gated`` (its gate's weight) is a key, else a GELU MLP whose first
    weight is ``plain``."""
    if gated in state:
        return dict(ffn="swiglu", mlp_hidden=_t(state[gated]).shape[0])
    return dict(mlp_ratio=_t(state[plain]).shape[0] / c)


def _qkv_bias(parts, c: int):
    """The fused qkv bias from its q, k and v parts (None where a part has
    none: zeros), or None where no part has one."""
    if all(b is None for b in parts):
        return None
    return torch.cat([torch.zeros(c) if b is None else _t(b) for b in parts])


def convert_hf_dinov3(state: Mapping, num_heads: int,
                      rope_theta: float = 100.0) -> Tuple[dict, ViTConfig]:
    """HF DINOv3ViTModel state dict -> (state, config): rotary positions in
    every block and no learned ones, separate q/k/v projections (k without a
    bias: zeros; ViT-7B/16 with none at all), up/down MLP names or the gated
    FFN's gate/up/down, LayerNorm eps 1e-5."""
    pe_w = _t(state["embeddings.patch_embeddings.weight"])
    c, _, ps, _ = pe_w.shape
    depth = _depth(state, "layer.", 1)
    p = "layer.{i}."
    cfg = ViTConfig(
        patch_size=ps,
        embed_dim=c,
        depth=depth,
        num_heads=num_heads,
        num_reg_tokens=_t(state["embeddings.register_tokens"]).shape[1],
        layerscale=True,
        ln_eps=1e-5,
        rope_theta=rope_theta,
        use_cls_pos=False,
        qkv_bias=any(f"layer.0.attention.{m}_proj.bias" in state for m in "qkv"),
        **_ffn(state, c, "layer.0.mlp.gate_proj.weight", "layer.0.mlp.up_proj.weight"),
    )
    out = {
        "patch_embed.proj.weight": pe_w,
        "patch_embed.proj.bias": _t(state["embeddings.patch_embeddings.bias"]),
        "cls_token": _t(state["embeddings.cls_token"]),
        "norm.weight": _t(state["norm.weight"]),
        "norm.bias": _t(state["norm.bias"]),
    }
    if cfg.num_reg_tokens:
        out["reg_token"] = _t(state["embeddings.register_tokens"])
    mlp = {"fc1_g": "gate_proj", "fc1_x": "up_proj", "fc2": "down_proj"} if cfg.ffn == "swiglu" \
        else {"fc1": "up_proj", "fc2": "down_proj"}
    names = {"norm1.weight": p + "norm1.weight", "norm1.bias": p + "norm1.bias",
             "attn.proj.weight": p + "attention.o_proj.weight",
             "attn.proj.bias": p + "attention.o_proj.bias",
             "ls1.gamma": p + "layer_scale1.lambda1", "ls2.gamma": p + "layer_scale2.lambda1",
             "norm2.weight": p + "norm2.weight", "norm2.bias": p + "norm2.bias"}
    for port, src in mlp.items():
        names.update({f"mlp.{port}.{kind}": f"{p}mlp.{src}.{kind}" for kind in ("weight", "bias")})
    out.update(_blocks(state, cfg, names))
    for i in range(depth):
        a = f"layer.{i}.attention."
        out[f"blocks.{i}.attn.qkv.weight"] = torch.cat(
            [_t(state[f"{a}{m}_proj.weight"]) for m in ("q", "k", "v")])
        bias = _qkv_bias([state.get(f"{a}{m}_proj.bias") for m in ("q", "k", "v")], c)
        if bias is not None:
            out[f"blocks.{i}.attn.qkv.bias"] = bias
    return _finish(out, cfg)


# Keys of the dinov3 repository's state that the port's ViT has no use for:
# the masked-token embedding, the cls token's own norms (the patch tokens take
# ``norm``) and the RoPE periods (rebuilt from ``rope_theta``).
_DINOV3_DROPPED = ("mask_token", "cls_norm.", "local_cls_norm.", "rope_embed.periods")


def convert_dinov3(state: Mapping, num_heads: int,
                   rope_theta: float = 100.0) -> Tuple[dict, ViTConfig]:
    """The dinov3 repository's ``DinoVisionTransformer`` state dict (its hub
    entries) -> (state, config): timm-like block names, registers as
    ``storage_tokens``, rotary positions (``rope_embed.periods``, rebuilt
    from ``rope_theta``) and no learned ones, LayerNorm eps 1e-5. The fused
    qkv bias, where there is one, is multiplied by its ``bias_mask`` (the
    masked k bias). The FFN is ``mlp.fc1`` / ``fc2`` or SwiGLU's ``mlp.w1``
    (gate), ``w2`` (up), ``w3`` (down). The keys of ``_DINOV3_DROPPED`` are
    dropped; any other key left unused raises, since the flags (registers,
    LayerScale, biases) are read from which keys are there."""
    pe_w = _t(state["patch_embed.proj.weight"])
    c, _, ps, _ = pe_w.shape
    depth = _depth(state, "blocks.", 1)
    cfg = ViTConfig(
        patch_size=ps,
        embed_dim=c,
        depth=depth,
        num_heads=num_heads,
        num_reg_tokens=_t(state["storage_tokens"]).shape[1] if "storage_tokens" in state else 0,
        layerscale="blocks.0.ls1.gamma" in state,
        ln_eps=1e-5,
        rope_theta=rope_theta,
        use_cls_pos=False,
        qkv_bias="blocks.0.attn.qkv.bias" in state,
        patch_bias="patch_embed.proj.bias" in state,
        **_ffn(state, c, "blocks.0.mlp.w1.weight", "blocks.0.mlp.fc1.weight"),
    )
    out = {k: _t(state[k]) for k in ("patch_embed.proj.weight", "patch_embed.proj.bias",
                                     "cls_token", "norm.weight", "norm.bias") if k in state}
    used = set(out)
    if cfg.num_reg_tokens:
        out["reg_token"] = _t(state["storage_tokens"])
        used.add("storage_tokens")
    p = "blocks.{i}."
    mlp = {"fc1_g": "w1", "fc1_x": "w2", "fc2": "w3"} if cfg.ffn == "swiglu" \
        else {"fc1": "fc1", "fc2": "fc2"}
    names = {k: p + k for k in ("norm1.weight", "norm1.bias", "attn.qkv.weight",
                                "attn.proj.weight", "attn.proj.bias", "ls1.gamma", "ls2.gamma",
                                "norm2.weight", "norm2.bias")}
    for port, src in mlp.items():
        names.update({f"mlp.{port}.{kind}": f"{p}mlp.{src}.{kind}" for kind in ("weight", "bias")})
    blocks = _blocks(state, cfg, names)
    out.update(blocks)
    used.update(names[k.split(".", 2)[2]].format(i=k.split(".")[1]) for k in blocks)
    for i in range(depth if cfg.qkv_bias else 0):
        bias = _t(state[f"blocks.{i}.attn.qkv.bias"])
        mask = state.get(f"blocks.{i}.attn.qkv.bias_mask")
        out[f"blocks.{i}.attn.qkv.bias"] = bias if mask is None else bias * _t(mask)
        used.update({f"blocks.{i}.attn.qkv.bias", f"blocks.{i}.attn.qkv.bias_mask"})
    unused = sorted(k for k in set(state) - used if not k.startswith(_DINOV3_DROPPED))
    if unused:
        raise ValueError(f"dinov3 state has keys the conversion does not use: {unused[:5]}")
    return _finish(out, cfg)


def _strip_prefix(state: Mapping, candidates) -> dict:
    """The sub-dict under the first prefix that holds a ViT trunk (timm-style
    ``blocks.N.`` keys), keys outside it dropped."""
    for pre in candidates:
        sub = {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
        if any(k.startswith("blocks.") for k in sub):
            return sub
    raise ValueError(f"no ViT trunk found under any of the prefixes {list(candidates)}")


# family-specific names of the same tensors (timm's on the left)
_TRUNK_KEY_ALIASES = {"reg_token": ("register_tokens", "storage_tokens")}


def _canonicalize_trunk(sub: Mapping) -> dict:
    out = dict(sub)
    for canon, aliases in _TRUNK_KEY_ALIASES.items():
        if canon not in out:
            for alias in aliases:
                if alias in out:
                    out[canon] = out.pop(alias)
                    break
    return out


def convert_radio(state: Mapping, num_heads: int) -> Tuple[dict, ViTConfig]:
    """NVlabs/RADIO hub checkpoint -> (trunk state, config). The timm trunk
    sits under ``radio_model.model.`` / ``base_model.model.`` / ``model.``;
    the input conditioner, summary heads and adaptors are dropped (the
    registry gives RADIO identity statistics)."""
    sub = _strip_prefix(state, ("radio_model.model.", "base_model.model.", "model.", ""))
    return convert_timm_vit(_canonicalize_trunk(sub), num_heads)


def convert_capi(state: Mapping, num_heads: int) -> Tuple[dict, ViTConfig]:
    """facebookresearch/capi hub checkpoint -> (trunk state, config): a
    registers ViT with timm names, registers possibly as ``storage_tokens``."""
    sub = _strip_prefix(state, ("backbone.", "encoder.", "teacher.", ""))
    return convert_timm_vit(_canonicalize_trunk(sub), num_heads)


def convert_franca(state: Mapping, num_heads: int):
    """valeoai/Franca hub checkpoint -> (trunk state, config, RASA layers).

    The RASA head is a stack of per-token linear layers (GELU between),
    returned as ``[(weight (out, in), bias (out,)), ...]``: the 2-D
    ``.weight`` tensors whose key holds "rasa", in the lexicographic order of
    their keys (as the JAX package orders them), a missing bias as zeros.
    Raises where there is none."""
    sub = _strip_prefix(state, ("backbone.", "teacher.backbone.", ""))
    trunk = {k: v for k, v in sub.items() if "rasa" not in k.lower()}
    out, cfg = convert_timm_vit(_canonicalize_trunk(trunk), num_heads)
    rasa_w = sorted(k for k in sub if "rasa" in k.lower() and k.endswith(".weight")
                    and _t(sub[k]).ndim == 2)
    if not rasa_w:
        raise ValueError("no RASA head tensors found in Franca checkpoint")
    rasa = []
    for wk in rasa_w:
        w = _t(sub[wk])
        bk = wk[: -len(".weight")] + ".bias"
        rasa.append((w, _t(sub[bk]) if bk in sub else torch.zeros(w.shape[0])))
    return out, cfg, rasa


def convert_pe(state: Mapping, num_heads: int) -> Tuple[dict, ViTConfig]:
    """Meta Perception Encoder (PE-Core / PE-Spatial) -> (state, config):
    the CLIP-lineage names (``conv1``, ``class_embedding``,
    ``positional_embedding``, ``ln_pre``, ``transformer.resblocks.N``,
    ``ln_post``); a bias-free patchify, learned positions plus the
    interleaved RoPE (theta 10000) in every block, LayerNorm eps 1e-5. The
    CLIP head (``attn_pool``, ``proj``) is dropped."""
    pe_w = _t(state["conv1.weight"])  # (C, 3, ps, ps), no bias
    c, _, ps, _ = pe_w.shape
    pos = _t(state["positional_embedding"])  # (rows, C)
    grid, has_cls = pos_layout(pos.shape[0])
    depth = _depth(state, "transformer.resblocks.", 2)
    p = "transformer.resblocks.{i}."
    cfg = ViTConfig(
        patch_size=ps,
        embed_dim=c,
        depth=depth,
        num_heads=num_heads,
        mlp_ratio=_t(state["transformer.resblocks.0.mlp.c_fc.weight"]).shape[0] / c,
        layerscale="transformer.resblocks.0.ls_1.gamma" in state,
        ln_eps=1e-5,
        pos_grid=grid,
        use_cls_pos=has_cls,
        rope_theta=10000.0,
        rope_style="interleaved",
        use_abs_pos=True,
        ln_pre=True,
        patch_bias=False,
    )
    out = {
        "patch_embed.proj.weight": pe_w,
        "pos_embed": pos[None],
        "cls_token": _t(state["class_embedding"]).reshape(1, 1, c),
        "norm_pre.weight": _t(state["ln_pre.weight"]),
        "norm_pre.bias": _t(state["ln_pre.bias"]),
        "norm.weight": _t(state["ln_post.weight"]),
        "norm.bias": _t(state["ln_post.bias"]),
    }
    out.update(_blocks(state, cfg, {
        "norm1.weight": p + "ln_1.weight", "norm1.bias": p + "ln_1.bias",
        "attn.qkv.weight": p + "attn.in_proj_weight", "attn.qkv.bias": p + "attn.in_proj_bias",
        "attn.proj.weight": p + "attn.out_proj.weight", "attn.proj.bias": p + "attn.out_proj.bias",
        "ls1.gamma": p + "ls_1.gamma", "ls2.gamma": p + "ls_2.gamma",
        "norm2.weight": p + "ln_2.weight", "norm2.bias": p + "ln_2.bias",
        "mlp.fc1.weight": p + "mlp.c_fc.weight", "mlp.fc1.bias": p + "mlp.c_fc.bias",
        "mlp.fc2.weight": p + "mlp.c_proj.weight", "mlp.fc2.bias": p + "mlp.c_proj.bias",
    }))
    return _finish(out, cfg)


def vit_from_torch(state: Mapping, num_heads: int) -> Tuple[dict, ViTConfig]:
    """Pick the converter from the checkpoint's keys; an unknown layout raises."""
    if any(k.startswith("encoder.layer.") for k in state):
        return convert_hf_dinov2(state, num_heads)
    if any(k.startswith("layer.") and "attention.q_proj" in k for k in state):
        return convert_hf_dinov3(state, num_heads)
    if any(k.startswith("transformer.resblocks.") for k in state):
        return convert_pe(state, num_heads)
    if "pos_embed" not in state and ("rope_embed.periods" in state or "storage_tokens" in state):
        return convert_dinov3(state, num_heads)  # the dinov3 repository's rotary trunk
    if any(k.startswith("blocks.") for k in state):
        return convert_timm_vit(_canonicalize_trunk(state), num_heads)
    # a timm trunk nested under a wrapper's prefix (RADIO-style)
    try:
        sub = _strip_prefix(state, ("radio_model.model.", "base_model.model.", "model.",
                                    "backbone.", "encoder."))
    except ValueError as e:
        raise ValueError("unrecognized ViT checkpoint layout") from e
    return convert_timm_vit(_canonicalize_trunk(sub), num_heads)
