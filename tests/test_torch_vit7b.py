"""DINOv3 ViT-7B/16 in the port, on the CPU at a small size (width 256, 4
heads of 64, SwiGLU hidden 512, 2 blocks, 4 registers, 64^2 image; seeded
random weights): the port's ViT against the plain reference
(``h100bench/reference/dinov3_vit.py``), the wrapper plus ``NAFUpsampler``
against the reference pipeline, the published shape both 7B names resolve
to, the gated-FFN converters of both checkpoint layouts on synthetic state
dicts, and the backbone's spans. No JAX: the JAX package has no SwiGLU
ViT."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench.reference import dinov3_vit
from h100bench.weights import draw, naf_specs
from h100bench.weights_dinov3 import dinov3_specs, draw_parts
from naf_torch.api import NAFUpsampler
from naf_torch.backbones import convert
from naf_torch.backbones.vit import SwiGLU, ViT, ViTConfig, rope_tables
from naf_torch.backbones.wrapper import (
    BACKBONE_REGISTRY, PUBLISHED_SHAPES, PretrainedViTWrapper, backbone_config,
)
from naf_torch.models.naf import NAF
from naf_torch.train.trainer import make_train_step
from naf_torch.utils import spans

torch.set_num_threads(1)
NAMES = ["dinov3_vit7b16", "vit_7b_patch16_dinov3.lvd1689m"]
SMALL = dict(num_heads=4, embed_dim=256, depth=2)
BCFG = {"name": "dinov3_vit7b16", "patch_size": 16, "embed_dim": 256, "depth": 2,
        "num_heads": 4, "ffn": "swiglu", "mlp_hidden": 512, "num_reg_tokens": 4,
        "rope_theta": 100.0, "ln_eps": 1e-5, "qkv_bias": False, "layerscale": True,
        "patch_bias": True}
NAF_MODEL = {"dim": 32, "heads_attn": 2, "heads_rope": 2, "kernel_size": 3, "img_layers": 2,
             "rope_base": 100.0, "rope_rescale": 2.0, "use_encoder": True}
TOL = dict(rtol=2e-4, atol=2e-4)


def _state(seed=0, cfg=BCFG):
    return draw_parts(dinov3_specs(cfg), torch.Generator().manual_seed(seed), torch.float32,
                      part=1 << 18)


def _image(seed=1, hw=(64, 64)):
    return torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(seed))


def _wrapper(state):
    return PretrainedViTWrapper("dinov3_vit7b16", device="cpu", state=state, **SMALL)


@pytest.mark.parametrize("name", NAMES)
def test_both_7b_names_resolve_to_the_published_shape(name):
    config, cfg = backbone_config(name)
    got = {k: getattr(cfg, k) for k in ("embed_dim", "depth", "num_heads", "ffn", "hidden",
                                        "num_reg_tokens", "rope_theta", "ln_eps", "qkv_bias",
                                        "patch_size", "use_cls_pos", "abs_pos")}
    assert got == {"embed_dim": 4096, "depth": 40, "num_heads": 32, "ffn": "swiglu",
                   "hidden": 8192, "num_reg_tokens": 4, "rope_theta": 100.0, "ln_eps": 1e-5,
                   "qkv_bias": False, "patch_size": 16, "use_cls_pos": False, "abs_pos": False}
    assert config["input_size"] == (3, 512, 512) and name not in BACKBONE_REGISTRY
    with torch.device("meta"):
        n = sum(p.numel() for p in ViT(cfg).parameters())
    assert n == 6_716_030_976  # 167.8 M a block


def test_registry_names_keep_the_gelu_mlp_and_qkv_bias():
    """The fields the JAX ViT has no counterpart of stay at their defaults
    for every name the family rule resolves."""
    for name in list(BACKBONE_REGISTRY) + ["vit_small_patch16_224", "some_unknown_model"]:
        _, cfg = backbone_config(name)
        assert (cfg.ffn, cfg.mlp_hidden, cfg.qkv_bias) == ("gelu", None, True), name
        assert name not in PUBLISHED_SHAPES


def test_a_shrunk_7b_keeps_its_head_width_and_ffn_ratio():
    _, cfg = backbone_config("dinov3_vit7b16", embed_dim=256, depth=2)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.hidden) == (256, 2, 2, 512)


def test_the_ports_vit_matches_the_reference():
    state = _state()
    wrap = _wrapper(state)
    assert isinstance(wrap.model.blocks[0].mlp, SwiGLU) and wrap.model.blocks[0].attn.qkv.bias is None
    x = wrap.normalize(_image())
    with torch.no_grad():
        got = wrap(x)
        ref = dinov3_vit.vit_forward(state, BCFG, x)
    assert got.shape == (1, 4, 4, 256)
    torch.testing.assert_close(got, ref, **TOL)


def test_the_references_rope_is_the_ports_tables():
    cfg = ViTConfig(patch_size=16, embed_dim=512, num_heads=4, rope_theta=100.0)
    sin, cos = rope_tables(cfg, 3, 5)
    angles = dinov3_vit.rope_angles(3, 5, 128, 100.0)
    torch.testing.assert_close(sin, angles.sin(), rtol=0, atol=2e-6)
    torch.testing.assert_close(cos, angles.cos(), rtol=0, atol=2e-6)


def test_wrapper_and_upsampler_match_the_reference_pipeline():
    state = _state(3)
    naf_state = draw(naf_specs(NAF_MODEL), torch.Generator().manual_seed(4), torch.float32)
    model = NAF(**NAF_MODEL)
    model.load_state_dict(naf_state, strict=False)
    wrap = _wrapper(state)
    img = _image(5)
    x = wrap.normalize(img)
    lr = wrap(x)
    out = NAFUpsampler(model=model.eval())(x, lr, (64, 64), channels_last=True)
    feats, ref = dinov3_vit.pipeline(state, BCFG, naf_state, NAF_MODEL, x, (64, 64))
    torch.testing.assert_close(lr, feats, **TOL)
    torch.testing.assert_close(out, ref, **TOL)


def test_the_wrapper_takes_a_state_as_it_is():
    state = _state(6)
    wrap = _wrapper(state)
    assert wrap.model.blocks[1].mlp.fc1_g.weight.data_ptr() == \
        state["blocks.1.mlp.fc1_g.weight"].data_ptr()
    assert not any(p.requires_grad for p in wrap.model.parameters())
    with pytest.raises(ValueError, match="not both"):
        PretrainedViTWrapper("dinov3_vit7b16", checkpoint="x.pth", state=state, device="cpu")


# ------------------------------------------------------------- converters ----


def _port(cfg, seed):
    vit = ViT(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in vit.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return vit.eval()


def _hf_layout(vit, cfg, qkv_bias_parts):
    """The port's state in HF DINOv3ViTModel's names."""
    st, c = vit.state_dict(), cfg.embed_dim
    out = {"embeddings.patch_embeddings.weight": st["patch_embed.proj.weight"],
           "embeddings.patch_embeddings.bias": st["patch_embed.proj.bias"],
           "embeddings.cls_token": st["cls_token"],
           "embeddings.register_tokens": st["reg_token"],
           "embeddings.mask_token": torch.zeros(1, 1, c),
           "norm.weight": st["norm.weight"], "norm.bias": st["norm.bias"]}
    mlp = ({"fc1_g": "gate_proj", "fc1_x": "up_proj", "fc2": "down_proj"} if cfg.ffn == "swiglu"
           else {"fc1": "up_proj", "fc2": "down_proj"})
    for i in range(cfg.depth):
        b, h = f"blocks.{i}.", f"layer.{i}."
        for m, w in zip("qkv", st[b + "attn.qkv.weight"].chunk(3)):
            out[f"{h}attention.{m}_proj.weight"] = w
        if cfg.qkv_bias:
            for m, w in zip("qkv", st[b + "attn.qkv.bias"].chunk(3)):
                if m in qkv_bias_parts:
                    out[f"{h}attention.{m}_proj.bias"] = w
        out[h + "attention.o_proj.weight"] = st[b + "attn.proj.weight"]
        out[h + "attention.o_proj.bias"] = st[b + "attn.proj.bias"]
        out[h + "layer_scale1.lambda1"], out[h + "layer_scale2.lambda1"] = \
            st[b + "ls1.gamma"], st[b + "ls2.gamma"]
        for n in ("norm1", "norm2"):
            out[f"{h}{n}.weight"], out[f"{h}{n}.bias"] = st[f"{b}{n}.weight"], st[f"{b}{n}.bias"]
        for port, src in mlp.items():
            for kind in ("weight", "bias"):
                out[f"{h}mlp.{src}.{kind}"] = st[f"{b}mlp.{port}.{kind}"]
    return out


def _dinov3_layout(vit, cfg):
    """The port's state in the dinov3 repository's names, a k-masked qkv
    bias where the configuration has one."""
    st = vit.state_dict()
    out = {"storage_tokens": st["reg_token"], "mask_token": torch.zeros(1, cfg.embed_dim),
           "rope_embed.periods": torch.ones(cfg.embed_dim // cfg.num_heads // 4)}
    mlp = {"fc1_g": "w1", "fc1_x": "w2", "fc2": "w3"} if cfg.ffn == "swiglu" else {}
    for k, v in st.items():
        if k == "reg_token":
            continue
        for port, src in mlp.items():
            k = k.replace(f".mlp.{port}.", f".mlp.{src}.")
        out[k] = v
    if cfg.qkv_bias:
        c = cfg.embed_dim
        for i in range(cfg.depth):
            mask = torch.ones(3 * c)
            mask[c:2 * c] = 0
            out[f"blocks.{i}.attn.qkv.bias_mask"] = mask
    return out


GATED = ViTConfig(patch_size=16, embed_dim=64, depth=2, num_heads=2, num_reg_tokens=4,
                  ln_eps=1e-5, rope_theta=100.0, use_cls_pos=False, ffn="swiglu",
                  mlp_hidden=128, qkv_bias=False)
LAYOUTS = {
    "hf_gated_no_qkv_bias": (GATED, "hf", "qkv"),
    "hf_gated_k_bias_free": (dataclasses.replace(GATED, qkv_bias=True), "hf", "qv"),
    "hf_gelu": (dataclasses.replace(GATED, ffn="gelu", mlp_hidden=None, qkv_bias=True),
                "hf", "qv"),
    "dinov3_gated": (GATED, "dinov3", ""),
    "dinov3_gated_masked_bias": (dataclasses.replace(GATED, qkv_bias=True), "dinov3", ""),
    "dinov3_gelu": (dataclasses.replace(GATED, ffn="gelu", mlp_hidden=None), "dinov3", ""),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gated_ffn_converters_round_trip(layout):
    cfg, kind, bias_parts = LAYOUTS[layout]
    vit = _port(cfg, seed=len(layout))
    if cfg.qkv_bias:  # the published k bias is none: zero it, as both layouts store it
        with torch.no_grad():
            for blk in vit.blocks:
                blk.attn.qkv.bias[cfg.embed_dim:2 * cfg.embed_dim] = 0
    src = _hf_layout(vit, cfg, bias_parts) if kind == "hf" else _dinov3_layout(vit, cfg)
    state, got = convert.vit_from_torch(src, cfg.num_heads)
    assert got == cfg
    ref = vit.state_dict()
    assert set(state) == set(ref)
    for k in ref:
        torch.testing.assert_close(state[k], ref[k], rtol=0, atol=0)
    back = ViT(got).eval()
    back.load_state_dict(state)
    x = _image(7, (32, 48)) - 0.5
    with torch.no_grad():
        torch.testing.assert_close(back(x), vit(x), rtol=0, atol=0)


def test_a_dinov3_checkpoint_through_the_wrapper(tmp_path):
    vit = _port(GATED, seed=11)
    path = tmp_path / "dinov3_vit7b16.pth"
    torch.save(_dinov3_layout(vit, GATED), path)
    wrap = PretrainedViTWrapper("dinov3_vit7b16", checkpoint=str(path), num_heads=2,
                                device="cpu")
    assert wrap.vit_config == GATED
    x = _image(12, (32, 32))
    with torch.no_grad():
        torch.testing.assert_close(wrap(x), vit(x), rtol=0, atol=0)


def _gamma_names(st):
    """LayerScale as ``gamma_1`` / ``gamma_2``, as older timm trunks name it."""
    return {k.replace(".ls1.gamma", ".gamma_1").replace(".ls2.gamma", ".gamma_2"): v
            for k, v in st.items()}


def test_a_timm_rope_state_without_pos_embed_still_raises():
    """A ``blocks.`` trunk without learned positions and without the dinov3
    repository's markers (``rope_embed.periods``, ``storage_tokens``) is not
    taken for a dinov3 checkpoint: timm's converter raises for the missing
    ``pos_embed``."""
    st = _gamma_names(_port(dataclasses.replace(GATED, ffn="gelu", mlp_hidden=None),
                            seed=3).state_dict())
    with pytest.raises(KeyError, match="pos_embed"):
        convert.vit_from_torch(st, GATED.num_heads)


DINOV3_MISREAD = {
    "layerscale_as_gamma": _gamma_names,
    "registers_as_reg_token": lambda st: {("reg_token" if k == "storage_tokens" else k): v
                                          for k, v in st.items()},
    "separate_q_bias": lambda st: {**st, "blocks.0.attn.q_bias": torch.zeros(GATED.embed_dim)},
}


@pytest.mark.parametrize("misread", sorted(DINOV3_MISREAD))
def test_the_dinov3_converter_raises_on_a_key_it_leaves_unused(misread):
    """The dinov3 converter reads its flags from which keys are there, so a
    key it does not use (LayerScale, registers or a bias under another name)
    raises instead of dropping that part."""
    st = DINOV3_MISREAD[misread](_dinov3_layout(_port(GATED, seed=5), GATED))
    with pytest.raises(ValueError, match="does not use"):
        convert.vit_from_torch(st, GATED.num_heads)


# ------------------------------------------------------------------ spans ----


def _records(fn):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    recs = spans.records()
    spans.clear()
    return recs


def test_backbone_span_once_a_call_and_mlp_span_once_a_block():
    wrap = _wrapper(_state(8))
    x = wrap.normalize(_image(9))
    recs = _records(lambda: [wrap(x) for _ in range(2)])
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in top] == ["naf.backbone", "naf.backbone"]
    mlp = [r for r in recs if r.name == "naf.backbone.mlp"]
    assert len(mlp) == 2 * BCFG["depth"] and all(r.parent.name == "naf.backbone" for r in mlp)


def test_backbone_span_once_a_step_in_the_trainer():
    """The trainer's ``naf.backbone`` around the wrapper's opens no second
    range of its name: one a step, holding both forwards' blocks."""
    model = NAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    wrap = PretrainedViTWrapper("vit_small_patch16_224", device="cpu", seed=0, num_heads=2,
                                embed_dim=32, depth=3)
    step = make_train_step(model, wrap, opt, use_bf16=False)
    image = torch.rand(1, 128, 128, 3)  # 8^2 target features, 4^2 values
    recs = _records(lambda: step(image, image, 0, (64, 64), (8, 8), (32, 32)))
    bb = [r for r in recs if r.name == "naf.backbone"]
    assert len(bb) == 1 and bb[0].parent is None
    mlp = [r for r in recs if r.name == "naf.backbone.mlp"]
    assert len(mlp) == 2 * 3 and all(r.parent is bb[0] for r in mlp)


def test_no_span_without_the_profiler():
    wrap = _wrapper(_state(10))
    spans.clear()
    with torch.no_grad():
        wrap(wrap.normalize(_image(11)))
    assert spans.records() == []
