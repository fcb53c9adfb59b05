"""The backbones and the LargeImg request on the card: a bf16 forward of one
registry name per RoPE style (none, DINOv3's rotate-half, the Perception
Encoder's interleaved) at full width and its own input size against the f32
forward of the same weights on the card (cosine > 0.999); the reference's
LargeImg request at 896^2 (ViT-B/16 DINO on the 448^2 bilinear downsample,
the production NAF to 896^2, bf16) with 8 K1 and 1 K2 launches, against the
f32 plain path on the card (cosine > 0.999).

Every test carries the marker ``cuda`` and skips without a card. The file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_backbones.py -q
"""

import pytest
import torch

from naf_torch import load_naf_params
from naf_torch.backbones import PretrainedViTWrapper
from naf_torch.backbones.vit import resize_jax
from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 18 runs the backbones there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("name,style", [
    ("vit_base_patch16_224.dino", "none"),
    ("vit_base_patch16_dinov3.lvd1689m", "rotate_half"),
    ("vit_pe_core_small_patch16_384.fb", "interleaved"),
])
def test_bf16_backbone_matches_f32_on_card(cuda_device, name, style):
    bf16 = PretrainedViTWrapper(name, device=cuda_device, dtype=torch.bfloat16, seed=1)
    f32 = PretrainedViTWrapper(name, device=cuda_device, seed=1)
    cfg = f32.vit_config
    assert ("none" if cfg.rope_theta is None else cfg.rope_style) == style
    size = f32.config["input_size"][1]
    x = torch.randn(1, size, size, 3, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    with torch.inference_mode():
        got, want = bf16(x.bfloat16()), f32(x)
    assert got.shape == want.shape == (1, size // cfg.patch_size, size // cfg.patch_size,
                                       cfg.embed_dim)
    assert _cos(got.float(), want) > 0.999


@pytest.mark.cuda
def test_large_img_896_launches_k1_and_k2_and_matches_plain(cuda_device):
    name, out, lr_side = "vit_base_patch16_224.dino", 896, 448
    bb = PretrainedViTWrapper(name, device=cuda_device, dtype=torch.bfloat16, seed=0)
    model = load_naf_params(seed=0, device=cuda_device, dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    image = torch.randn(1, out, out, 3, generator=gen, device=cuda_device).bfloat16()
    with torch.inference_mode():
        k1, k2 = gn_silu_conv_fused.launches, naf_upsample_attention.launches
        feats = bb(resize_jax(image, (lr_side, lr_side), "linear").bfloat16())
        got = model(image, feats, (out, out))
        torch.cuda.synchronize()
        assert (gn_silu_conv_fused.launches - k1, naf_upsample_attention.launches - k2) == (8, 1)
        assert feats.shape == (1, 28, 28, 768) and got.shape == (1, out, out, 768)

        # the f32 plain path: the encoder modules' own forward, K2's plain version
        bb32 = PretrainedViTWrapper(name, device=cuda_device, seed=0)
        m32 = load_naf_params(seed=0, device=cuda_device)
        x = image.float()
        feats32 = bb32(resize_jax(x, (lr_side, lr_side), "linear"))
        ie = m32.image_encoder
        enc = torch.cat([ie.encoder(x), ie.sem_encoder(x)], dim=-1)
        keys = ie.rope.pooled(enc, (out, out), (28, 28))
        sin_r, cos_r, sin_c, cos_c = ie.rope.tables(out, out)
        want = naf_upsample_attention_ref(
            enc, keys, feats32, torch.cat([cos_r, sin_r], dim=-1),
            torch.cat([cos_c, sin_c], dim=-1), ie.rope.d_head, num_heads=m32.heads_attn,
            kernel_size=m32.kernel_size)
    assert _cos(got.float(), want) > 0.999
