"""The yardstick's FLOP and byte formulas against FlopCounterMode and the
tensors' sizes, at small shapes on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import work
from h100bench.reference import naf as ref_naf
from h100bench.reference import vit as ref_vit
from h100bench.weights import draw, naf_specs, vit_specs

MODEL = {"dim": 32, "heads_attn": 2, "heads_rope": 2, "kernel_size": 3, "img_layers": 2,
         "rope_base": 100.0, "rope_rescale": 2.0}


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _state(specs):
    return draw(specs, torch.Generator().manual_seed(0), torch.float32)


def test_encoder_flops():
    p = _state(naf_specs(MODEL))
    x = torch.randn(2, 12, 10, 3)
    counted = _flops(lambda: [ref_naf.encoder(x, p, f"image_encoder.{s}", 2)
                              for s in ("encoder", "sem_encoder")])
    assert counted == work.encoder_flops(2, 12, 10, MODEL["dim"], 2)


@pytest.mark.parametrize("hw,lr,k", [((16, 16), (4, 4), 3), ((12, 20), (6, 5), 3),
                                     ((8, 8), (8, 8), 5)])
def test_attention_flops(hw, lr, k):
    q = torch.randn(1, *hw, 16)
    keys = torch.randn(1, *lr, 16)
    v = torch.randn(1, *lr, 12)
    counted = _flops(lambda: ref_naf.cross_scale_attention(q, keys, v, 2, k))
    assert counted == work.attention_flops(1, *hw, 2, k, 8, 6)


def test_conv_layer_flops_and_bytes():
    b, h, w, cin, cout, k = 2, 6, 7, 8, 16, 3
    x = torch.randn(b, h, w, cin, dtype=torch.bfloat16)
    wt = torch.randn(cout, cin, k, k, dtype=torch.bfloat16)
    bias = torch.randn(cout, dtype=torch.bfloat16)
    counted = _flops(lambda: ref_naf._conv(x.float(), wt.float(), bias.float()))
    flops, nbytes = work.conv_layer(b, h, w, cin, cout, k)
    assert counted == flops
    y = torch.empty(b, h, w, cout, dtype=torch.bfloat16)
    scale = shift = torch.empty(b, cin)
    psums = torch.empty(b, 2, cout)
    handed = (x, wt, bias, y, scale, shift, psums)
    assert nbytes == sum(t.numel() * t.element_size() for t in handed)


def test_k1_work_sums_its_layers():
    flops, nbytes = work.k1_work(1, 10, 12, 32, 2)
    f1, n1 = work.conv_layer(1, 10, 12, 16, 16, 1)
    f3, n3 = work.conv_layer(1, 10, 12, 16, 16, 3)
    assert (flops, nbytes) == (4 * (f1 + f3), 4 * (n1 + n3))


def test_k2_bytes_are_its_tensors():
    b, dim, c, enc_hw, out_hw, lr_hw = 1, 32, 24, (14, 14), (28, 28), (7, 7)
    t = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt)
    handed = (t(b, *enc_hw, dim), t(b, *lr_hw, dim), t(b, *lr_hw, c), t(b, *out_hw, c),
              t(out_hw[0], 2 * dim, dt=torch.float32), t(out_hw[1], 2 * dim, dt=torch.float32))
    flops, nbytes = work.k2_work(b, enc_hw, out_hw, lr_hw, dim, 2, 3, c)
    assert nbytes == sum(x.numel() * x.element_size() for x in handed)
    assert flops == work.attention_flops(b, *out_hw, 2, 3, dim // 2, c // 2)


def test_vit_forward_flops():
    cfg = {"patch_size": 4, "embed_dim": 32, "depth": 2, "num_heads": 4, "mlp_ratio": 4.0,
           "pos_grid": 5, "ln_eps": 1e-6}
    p = _state(vit_specs(cfg))
    x = torch.randn(2, 20, 20, 3)
    counted = _flops(lambda: ref_vit.vit_forward(p, cfg, x))
    assert counted == work.vit_forward_flops(2, 20, 20, cfg)


def test_bound_and_unknown_card():
    card = "NVIDIA H100 80GB HBM3"
    assert work.bound_s(989e12, 0, card) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, card) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        work.peaks("NVIDIA H100 PCIe")
