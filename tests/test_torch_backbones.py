"""The port's backbones (naf_torch.backbones: the ViT variants, the checkpoint
converters, the wrapper's name resolution) against naf_tpu, f32 on the CPU,
from the same numpy inputs and weights.

Bars: every forward at atol = rtol = 2e-4 (the parity bar of the port's
tests). Small sizes: depth 2, width 64, two heads, images of 2-4 patches a
side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.backbones import PretrainedViTWrapper, ViT, ViTConfig, backbone_config
from naf_torch.backbones import convert as tconv
from naf_torch.backbones.wrapper import BACKBONE_REGISTRY
from naf_tpu.backbones import convert as jconv
from naf_tpu.backbones import wrapper as jwrapper
from naf_tpu.backbones.vit import ViT as JViT
from naf_tpu.backbones.vit import ViTConfig as JViTConfig

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
DIM, DEPTH, HEADS = 64, 2, 2
# ViTConfig fields the two packages share (JAX's adds ``precision``; the
# port's adds the FFN kind, its hidden width and the qkv bias flag, which
# the JAX ViT does not have: GELU, embed_dim * mlp_ratio, a bias)
FIELDS = [f.name for f in dataclasses.fields(ViTConfig)
          if f.name in {g.name for g in dataclasses.fields(JViTConfig)}]


def _flax_params(state, cfg):
    """The port's timm-named state dict as the JAX ViT's params."""
    st = {k: v.detach().numpy() for k, v in state.items()}
    c, n = cfg.embed_dim, cfg.num_heads
    d = c // n

    def ln(p):
        return {"scale": st[p + ".weight"], "bias": st[p + ".bias"]}

    pe = {"kernel": st["patch_embed.proj.weight"].transpose(2, 3, 1, 0)}
    if cfg.patch_bias:
        pe["bias"] = st["patch_embed.proj.bias"]
    out = {"patch_embed": pe, "cls_token": st["cls_token"], "norm": ln("norm")}
    if "pos_embed" in st:
        out["pos_embed"] = st["pos_embed"]
    if cfg.num_reg_tokens:
        out["reg_tokens"] = st["reg_token"]
    if cfg.ln_pre:
        out["norm_pre"] = ln("norm_pre")
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        blk = {"norm1": ln(p + ".norm1"), "norm2": ln(p + ".norm2"),
               "attn": {"qkv": {"kernel": st[p + ".attn.qkv.weight"].T.reshape(c, 3, n, d),
                                "bias": st[p + ".attn.qkv.bias"].reshape(3, n, d)},
                        "proj": {"kernel": st[p + ".attn.proj.weight"].T.reshape(n, d, c),
                                 "bias": st[p + ".attn.proj.bias"]}},
               "fc1": {"kernel": st[p + ".mlp.fc1.weight"].T, "bias": st[p + ".mlp.fc1.bias"]},
               "fc2": {"kernel": st[p + ".mlp.fc2.weight"].T, "bias": st[p + ".mlp.fc2.bias"]}}
        if cfg.layerscale:
            blk["ls1"], blk["ls2"] = st[p + ".ls1.gamma"], st[p + ".ls2.gamma"]
        out[f"block{i}"] = blk
    return out


def _jcfg(cfg):
    return JViTConfig(**{f: getattr(cfg, f) for f in FIELDS})


def _port_vit(cfg, seed=0):
    """A port ViT with seeded non-trivial weights (the init plus noise)."""
    vit = ViT(cfg)
    vit.reset_parameters(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in vit.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return vit.eval()


def _image(seed, h, w):
    return np.random.RandomState(seed).randn(2, h, w, 3).astype(np.float32)


def _close(port_vit, jcfg, params, x):
    want = np.asarray(JViT(jcfg).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_vit(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


VARIANTS = {
    "plain": dict(pos_grid=4),
    "registers": dict(pos_grid=4, num_reg_tokens=3, use_cls_pos=False),
    "dinov3_rope": dict(num_reg_tokens=4, use_cls_pos=False, rope_theta=100.0, ln_eps=1e-5),
    "pe_interleaved_rope": dict(pos_grid=4, rope_theta=10000.0, rope_style="interleaved",
                                use_abs_pos=True, ln_pre=True, patch_bias=False,
                                layerscale=False, ln_eps=1e-5),
}


@pytest.mark.parametrize("hw", [(64, 64), (48, 32)], ids=["native_grid", "resized_grid"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_vit_variant_matches_jax(variant, hw):
    cfg = ViTConfig(patch_size=16, embed_dim=DIM, depth=DEPTH, num_heads=HEADS,
                    **VARIANTS[variant])
    vit = _port_vit(cfg)
    _close(vit, _jcfg(cfg), _flax_params(vit.state_dict(), cfg), _image(2, *hw))


# ---------------------------------------------------------------- layouts ----


def _rng_tensor(rng):
    def t(*shape, scale=0.05, offset=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + offset).astype(np.float32))
    return t


def _timm_state(seed=0, patch=16, grid=4, cls_pos=True, regs=0, reg_name="reg_token"):
    t = _rng_tensor(np.random.RandomState(seed))
    s = {"patch_embed.proj.weight": t(DIM, 3, patch, patch), "patch_embed.proj.bias": t(DIM),
         "pos_embed": t(1, int(cls_pos) + grid * grid, DIM), "cls_token": t(1, 1, DIM),
         "norm.weight": t(DIM, offset=1.0), "norm.bias": t(DIM), "head.weight": t(10, DIM)}
    if regs:
        s[reg_name] = t(1, regs, DIM)
    for i in range(DEPTH):
        p = f"blocks.{i}."
        s.update({p + "norm1.weight": t(DIM, offset=1.0), p + "norm1.bias": t(DIM),
                  p + "attn.qkv.weight": t(3 * DIM, DIM), p + "attn.qkv.bias": t(3 * DIM),
                  p + "attn.proj.weight": t(DIM, DIM), p + "attn.proj.bias": t(DIM),
                  p + "ls1.gamma": t(DIM, offset=1.0), p + "ls2.gamma": t(DIM, offset=1.0),
                  p + "norm2.weight": t(DIM, offset=1.0), p + "norm2.bias": t(DIM),
                  p + "mlp.fc1.weight": t(4 * DIM, DIM), p + "mlp.fc1.bias": t(4 * DIM),
                  p + "mlp.fc2.weight": t(DIM, 4 * DIM), p + "mlp.fc2.bias": t(DIM)})
    return s


def _hf_dinov2_state(seed=1, regs=0):
    t = _rng_tensor(np.random.RandomState(seed))
    s = {"embeddings.patch_embeddings.projection.weight": t(DIM, 3, 14, 14),
         "embeddings.patch_embeddings.projection.bias": t(DIM),
         "embeddings.position_embeddings": t(1, 1 + 16, DIM),
         "embeddings.cls_token": t(1, 1, DIM), "embeddings.mask_token": t(1, DIM),
         "layernorm.weight": t(DIM, offset=1.0), "layernorm.bias": t(DIM)}
    if regs:
        s["embeddings.register_tokens"] = t(1, regs, DIM)
    for i in range(DEPTH):
        p = f"encoder.layer.{i}."
        s.update({p + "norm1.weight": t(DIM, offset=1.0), p + "norm1.bias": t(DIM),
                  p + "attention.output.dense.weight": t(DIM, DIM),
                  p + "attention.output.dense.bias": t(DIM),
                  p + "layer_scale1.lambda1": t(DIM, offset=1.0),
                  p + "layer_scale2.lambda1": t(DIM, offset=1.0),
                  p + "norm2.weight": t(DIM, offset=1.0), p + "norm2.bias": t(DIM),
                  p + "mlp.fc1.weight": t(4 * DIM, DIM), p + "mlp.fc1.bias": t(4 * DIM),
                  p + "mlp.fc2.weight": t(DIM, 4 * DIM), p + "mlp.fc2.bias": t(DIM)})
        for m in ("query", "key", "value"):
            s[p + f"attention.attention.{m}.weight"] = t(DIM, DIM)
            s[p + f"attention.attention.{m}.bias"] = t(DIM)
    return s


def _hf_dinov3_state(seed=2):
    t = _rng_tensor(np.random.RandomState(seed))
    s = {"embeddings.patch_embeddings.weight": t(DIM, 3, 16, 16),
         "embeddings.patch_embeddings.bias": t(DIM), "embeddings.cls_token": t(1, 1, DIM),
         "embeddings.register_tokens": t(1, 4, DIM), "embeddings.mask_token": t(1, 1, DIM),
         "norm.weight": t(DIM, offset=1.0), "norm.bias": t(DIM)}
    for i in range(DEPTH):
        p = f"layer.{i}."
        s.update({p + "norm1.weight": t(DIM, offset=1.0), p + "norm1.bias": t(DIM),
                  p + "attention.q_proj.weight": t(DIM, DIM), p + "attention.q_proj.bias": t(DIM),
                  p + "attention.k_proj.weight": t(DIM, DIM),
                  p + "attention.v_proj.weight": t(DIM, DIM), p + "attention.v_proj.bias": t(DIM),
                  p + "attention.o_proj.weight": t(DIM, DIM), p + "attention.o_proj.bias": t(DIM),
                  p + "layer_scale1.lambda1": t(DIM, offset=1.0),
                  p + "layer_scale2.lambda1": t(DIM, offset=1.0),
                  p + "norm2.weight": t(DIM, offset=1.0), p + "norm2.bias": t(DIM),
                  p + "mlp.up_proj.weight": t(4 * DIM, DIM), p + "mlp.up_proj.bias": t(4 * DIM),
                  p + "mlp.down_proj.weight": t(DIM, 4 * DIM), p + "mlp.down_proj.bias": t(DIM)})
    return s


def _pe_state(seed=3):
    t = _rng_tensor(np.random.RandomState(seed))
    s = {"conv1.weight": t(DIM, 3, 16, 16), "class_embedding": t(DIM),
         "positional_embedding": t(1 + 16, DIM), "ln_pre.weight": t(DIM, offset=1.0),
         "ln_pre.bias": t(DIM), "ln_post.weight": t(DIM, offset=1.0), "ln_post.bias": t(DIM),
         "proj": t(DIM, 32)}
    for i in range(DEPTH):
        p = f"transformer.resblocks.{i}."
        s.update({p + "ln_1.weight": t(DIM, offset=1.0), p + "ln_1.bias": t(DIM),
                  p + "attn.in_proj_weight": t(3 * DIM, DIM), p + "attn.in_proj_bias": t(3 * DIM),
                  p + "attn.out_proj.weight": t(DIM, DIM), p + "attn.out_proj.bias": t(DIM),
                  p + "ln_2.weight": t(DIM, offset=1.0), p + "ln_2.bias": t(DIM),
                  p + "mlp.c_fc.weight": t(4 * DIM, DIM), p + "mlp.c_fc.bias": t(4 * DIM),
                  p + "mlp.c_proj.weight": t(DIM, 4 * DIM), p + "mlp.c_proj.bias": t(DIM)})
    return s


def _franca_state(n_rasa=11):
    """A Franca checkpoint: the trunk under ``teacher.backbone.`` (patch 14)
    and a RASA stack of ``n_rasa`` square layers, whose keys' lexicographic
    order (0, 1, 10, 2, ...) is not their numeric one."""
    t = _rng_tensor(np.random.RandomState(5))
    s = {f"teacher.backbone.{k}": v for k, v in _timm_state(seed=4, patch=14).items()}
    for i in range(n_rasa):
        s[f"teacher.backbone.rasa_head.layers.{i}.weight"] = t(DIM, DIM, scale=0.2)
        if i != 3:  # a layer without a bias takes zeros
            s[f"teacher.backbone.rasa_head.layers.{i}.bias"] = t(DIM)
    return s


# layout -> (source state, converter name in both packages, image size)
LAYOUTS = {
    "hf_dinov2": (lambda: _hf_dinov2_state(), "convert_hf_dinov2", 56),
    "hf_dinov2_registers": (lambda: _hf_dinov2_state(regs=2), "convert_hf_dinov2", 56),
    "hf_dinov3": (_hf_dinov3_state, "convert_hf_dinov3", 64),
    "pe": (_pe_state, "convert_pe", 64),
    "radio_nested": (lambda: {**{f"radio_model.model.{k}": v for k, v in _timm_state().items()},
                              "radio_model.input_conditioner.norm_mean": torch.zeros(3),
                              "radio_model.summary_idxs": torch.zeros(2)},
                     "convert_radio", 64),
    "capi_storage_tokens": (lambda: {f"backbone.{k}": v for k, v in _timm_state(
        regs=3, reg_name="storage_tokens").items()}, "convert_capi", 64),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_converter_matches_jax(layout):
    make, fn, size = LAYOUTS[layout]
    state = make()
    params, jcfg = getattr(jconv, fn)(state, HEADS)
    got_state, cfg = getattr(tconv, fn)(state, HEADS)
    assert {f: getattr(cfg, f) for f in FIELDS} == {f: getattr(jcfg, f) for f in FIELDS}
    vit = ViT(cfg).eval()
    vit.load_state_dict(got_state)
    _close(vit, jcfg, jax.tree.map(jnp.asarray, params), _image(6, size, size))
    if layout not in ("radio_nested", "capi_storage_tokens"):
        # the dispatcher routes the layout to the same converter
        again, cfg2 = tconv.vit_from_torch(state, HEADS)
        assert cfg2 == cfg and all(torch.equal(again[k], got_state[k]) for k in got_state)
    if layout == "radio_nested":
        again, cfg2 = tconv.vit_from_torch(state, HEADS)
        assert cfg2 == cfg


def test_franca_checkpoint_through_the_wrapper_matches_jax(tmp_path):
    """Franca by name: the trunk, then the RASA head in the lexicographic
    order of its keys (GELU between layers), against the JAX wrapper on the
    same checkpoint file."""
    state = _franca_state()
    path = tmp_path / "franca.pth"
    torch.save(state, path)
    _, _, rasa = tconv.convert_franca(state, HEADS)
    order = sorted(f"{i}" for i in range(11))
    assert [int(i) for i in order] == [0, 1, 10, 2, 3, 4, 5, 6, 7, 8, 9]
    for (w, b), i in zip(rasa, order):
        torch.testing.assert_close(w, state[f"teacher.backbone.rasa_head.layers.{i}.weight"])
    assert not rasa[order.index("3")][1].any()

    port = PretrainedViTWrapper("franca_vitb14", checkpoint=str(path), num_heads=HEADS,
                                device="cpu")
    jax_wrap = jwrapper.PretrainedViTWrapper("franca_vitb14", checkpoint=str(path),
                                             num_heads=HEADS)
    assert port.patch_size == jax_wrap.patch_size == 14 and port.rasa is not None
    x = _image(7, 56, 42)
    want = np.asarray(jax_wrap(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_franca_without_rasa_and_unknown_layouts_raise():
    with pytest.raises(ValueError, match="RASA"):
        tconv.convert_franca(_timm_state(), HEADS)
    with pytest.raises(ValueError, match="unrecognized"):
        tconv.vit_from_torch({"foo.weight": torch.zeros(2)}, HEADS)
    with pytest.raises(ValueError, match="neither"):
        tconv.convert_timm_vit({**_timm_state(), "pos_embed": torch.zeros(1, 1371, DIM)}, HEADS)


@pytest.mark.parametrize("rows,regs", [(1370, 0), (1369, 4)], ids=["1370_cls", "1369_registers"])
def test_position_tables_of_37_squared_load_by_the_ports_rule(tmp_path, rows, regs):
    """1 + 37^2 rows hold a cls position; 37^2 rows (a register model's) hold
    none. The JAX converter's odd-count rule misreads both, so these are held
    against the port's own ViT built with the layout stated, on the same
    weights, through the converter and through the wrapper's checkpoint path."""
    cfg = ViTConfig(patch_size=14, embed_dim=DIM, depth=DEPTH, num_heads=HEADS, pos_grid=37,
                    use_cls_pos=rows == 1370, num_reg_tokens=regs)
    vit = _port_vit(cfg, seed=8)
    assert vit.pos_embed.shape[1] == rows
    state, got_cfg = tconv.convert_timm_vit(vit.state_dict(), HEADS)
    assert got_cfg == cfg
    path = tmp_path / "vit.pth"
    torch.save(vit.state_dict(), path)
    wrap = PretrainedViTWrapper("vit_base_patch14_reg4_dinov2", checkpoint=str(path),
                                num_heads=HEADS, device="cpu")
    assert wrap.vit_config == cfg
    x = torch.from_numpy(_image(9, 56, 42))
    with torch.no_grad():
        torch.testing.assert_close(wrap(x), vit(x), rtol=0, atol=0)


# ------------------------------------------------------------ resolution ----


class _NoInitViT:
    """Stands in for the JAX ViT so that the JAX wrapper resolves a name
    without drawing full-width weights."""

    def __init__(self, config):
        self.config = config

    def init(self, *args, **kwargs):
        return {"params": {}}


NAMES = sorted(BACKBONE_REGISTRY) + ["vit_small_patch16_224", "dvt_vit_base_patch14_dinov2.lvd142m",
                                     "fit3d_vit_base_patch16_224.dino", "some_unknown_model"]


@pytest.mark.parametrize("name", NAMES)
def test_name_resolution_matches_jax(monkeypatch, name):
    assert set(BACKBONE_REGISTRY) == set(jwrapper.BACKBONE_REGISTRY)
    monkeypatch.setattr(jwrapper, "ViT", _NoInitViT)
    jax_wrap = jwrapper.PretrainedViTWrapper(name)
    config, cfg = backbone_config(name)
    assert config == jax_wrap.config
    assert {f: getattr(cfg, f) for f in FIELDS} == {f: getattr(jax_wrap.vit_config, f)
                                                   for f in FIELDS}
    assert (cfg.patch_size, cfg.embed_dim) == (jax_wrap.patch_size, jax_wrap.embed_dim)


def test_random_wrappers_take_their_familys_layout():
    """Random weights in each family's layout at a small width: DINOv3's
    registers and RoPE, the PE's pre-norm and bias-free patchify, and any
    other name at 448 with ImageNet statistics."""
    kw = dict(device="cpu", depth=1, embed_dim=DIM, num_heads=HEADS)
    dinov3 = PretrainedViTWrapper("vit_base_patch16_dinov3.lvd1689m", **kw)
    assert dinov3.model.reg_token.shape == (1, 4, DIM) and not hasattr(dinov3.model, "pos_embed")
    pe = PretrainedViTWrapper("vit_pe_core_tiny_patch16_384.fb", **kw)
    assert pe.model.patch_embed.proj.bias is None and hasattr(pe.model, "norm_pre")
    assert pe.model.pos_embed.shape == (1, 1 + 24 * 24, DIM)
    other = PretrainedViTWrapper("vit_small_patch16_224", **kw)
    assert other.config["input_size"] == (3, 448, 448) and other.vit_config.pos_grid == 28
    dvt = PretrainedViTWrapper("dvt_vit_base_patch14_dinov2.lvd142m", **kw)
    assert dvt.finetune_tag == "dvt" and dvt.name == "vit_base_patch14_dinov2.lvd142m"
    for wrap, hw in ((dinov3, (48, 32)), (pe, (32, 64)), (other, (64, 64)), (dvt, (56, 28))):
        x = wrap.normalize(torch.rand(1, *hw, 3))
        out = wrap(x)
        assert out.shape == (1, hw[0] // wrap.patch_size, hw[1] // wrap.patch_size, DIM)
        assert bool(out.isfinite().all())
