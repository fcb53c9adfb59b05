"""DINOv3 ViT-7B/16 feeding NAF on the card, at the published widths of the
cell ``naf-dinov3-vit7b16.512``:

- the 7B (4096 wide, 40 blocks, 32 heads of 128, SwiGLU 8192, 4 registers,
  no qkv bias) through ``PretrainedViTWrapper`` in bf16, its weights drawn
  on the card, against the float32 reference
  (``h100bench/reference/dinov3_vit.py``, a block's weights at a time) on
  one 512^2 image, within the cell's calibrated ``feat_rel_l2``;
- K2 at 1,024 value channels a head (4096 over ``heads_attn`` 4) at the
  cell's shape, 512^2 <- 32^2, k 9: the plan's box of 81 cells padded to
  96 (218,496 bytes of shared memory a block, one block per SM), on the
  tensor cores, against its plain version;
- at a ratio of 4 every 64-query tile's box holds 100 cells or more, which
  pads to 128 (288,256 bytes a block, above the SM's 227 KiB): K2 raises
  with its message.

Every test needs the card (marker ``cuda``) and skips without one. No JAX:

    python -m pytest -m cuda tests/test_torch_card_vit7b.py -q -s
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "h100bench" / "configs" / "naf-dinov3-vit7b16.json").read_text())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
def test_the_7b_at_published_widths_against_the_reference(cuda_device):
    from h100bench import check
    from h100bench.reference import dinov3_vit
    from h100bench.weights import generator
    from h100bench.weights_dinov3 import dinov3_specs, draw_parts
    from naf_torch.backbones import PretrainedViTWrapper

    bcfg = CONFIG["backbone"]
    state = draw_parts(dinov3_specs(bcfg), generator(2**31 + 26, "backbone", cuda_device),
                       torch.bfloat16)
    wrap = PretrainedViTWrapper(bcfg["name"], dtype=torch.bfloat16, device=cuda_device,
                                state=state)
    cfg = wrap.vit_config
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.hidden, cfg.ffn, cfg.qkv_bias) == \
        (4096, 40, 32, 8192, "swiglu", False)
    img01 = torch.rand(1, 512, 512, 3, generator=generator(7, "image", cuda_device),
                       device=cuda_device).bfloat16()
    with torch.inference_mode():
        feats = wrap(wrap.normalize(img01))
        mean = torch.tensor(wrap.config["mean"], device=cuda_device)
        std = torch.tensor(wrap.config["std"], device=cuda_device)
        ref = dinov3_vit.vit_forward(state, bcfg, (img01.float() - mean) / std)
    rel, cos = check.rel_l2(feats, ref), _cos(feats.float(), ref)
    limit = check.load_limits("naf-dinov3-vit7b16.512")["feat_rel_l2"]
    print(f"7B bf16 features against the f32 reference: rel_l2 {rel:.5f} (limit {limit}), "
          f"cosine {cos:.6f}, peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    assert feats.shape == (1, 32, 32, 4096) and rel <= limit and cos > 0.999


def _k2_inputs(dev, hi, out, hk, c, cv, heads, seed=0):
    from naf_torch.nn.rope import RoPE

    rng = np.random.RandomState(seed)
    enc = torch.from_numpy(rng.randn(1, hi, hi, c).astype(np.float32)).to(dev)
    values = torch.from_numpy(rng.randn(1, hk, hk, cv).astype(np.float32)).to(dev)
    rope = RoPE(c, heads).to(dev)
    keys = rope.pooled(enc, (out, out), (hk, hk)).contiguous()
    sin_r, cos_r, sin_c, cos_c = rope.tables(out, out)
    return [enc, keys, values, torch.cat([cos_r, sin_r], -1),
            torch.cat([cos_c, sin_c], -1)], rope.d_head


@pytest.mark.cuda
def test_k2_at_1024_value_channels_a_head_at_the_cells_box(cuda_device):
    from naf_torch.kernels import na2d_fused_q as t_q
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref

    args, dh = _k2_inputs(cuda_device, 512, 512, 32, 256, 4096, 4)
    plan = t_q._plan_k2(512, 512, 32, 32, 9, 64, 1024, str(cuda_device))
    assert (plan[2] * plan[3], plan[4], t_q._tc_smem(64, 1024, plan[4])) == (81, 96, 218496)
    assert 2 * t_q._tc_smem(64, 1024, plan[4]) > t_q.SMEM_MAX  # one block per SM
    want = naf_upsample_attention_ref(*args, dh, num_heads=4, kernel_size=9)
    before = dict(naf_upsample_attention.route_launches)
    got = naf_upsample_attention(*[t.bfloat16() for t in args[:3]], *args[3:], dh, num_heads=4,
                                 kernel_size=9)
    torch.cuda.synchronize()
    after = naf_upsample_attention.route_launches
    assert after["wgmma"] - before["wgmma"] == 1 and after["fma"] == before["fma"]
    cos = _cos(got.float(), want)
    print(f"K2 512^2 <- 32^2, dv 1024, box {plan[0]}x{plan[1]} queries over "
          f"{plan[2]}x{plan[3]} cells (NB {plan[4]}): cosine {cos:.7f}")
    assert got.shape == want.shape == (1, 512, 512, 4096) and cos > 0.9995


@pytest.mark.cuda
def test_k2_raises_at_a_128_cell_box_at_1024_value_channels(cuda_device):
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    args, dh = _k2_inputs(cuda_device, 128, 128, 32, 256, 4096, 4)
    with pytest.raises(ValueError, match="takes no 64-query tile"):
        naf_upsample_attention(*[t.bfloat16() for t in args[:3]], *args[3:], dh, num_heads=4,
                               kernel_size=9)
