"""K2 (fused pool-up + RoPE + cross-scale attention) on the card against its
plain version: bf16 on the tensor-core kernel (``csrc/na2d_fused_q.cu`` on
``csrc/na_tc.cuh``; cosine > 0.9995 against the f32 plain version) and f32
on the CUDA-core kernel (atol = rtol = 2e-4), each call counted on the route
its dtype chooses. Shapes: identity pool, 2x pool-up, ragged pool-up with
ragged windows, the input guard's 4:1 pool-down, RoPE heads that straddle
the attention heads, NAF(dim=96)'s width (d 24), dv 3 with one head, a
ratio-1 box above 192 cells (the chunked kernel), a slab band and a band
written into a shared output in place from its encoder rows alone (every
other row untouched), and NAF's 448^2 -> 448^2 and 448^2 -> 2048^2 with
Cv 384 and 1024 (dv 256).

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_card_fused_q.py -q
"""

import numpy as np
import pytest
import torch

from naf_torch.kernels import na2d_fused as t_na
from naf_torch.kernels import na2d_fused_q as t_q
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref
from naf_torch.nn.rope import RoPE

TOL = dict(atol=2e-4, rtol=2e-4)

# (encoder side, output side, LR side, C, Cv, attention heads, RoPE heads, k)
SHAPES = {
    "identity": (64, 64, 16, 128, 96, 2, 2, 9),
    "pool-up": (32, 64, 16, 128, 96, 2, 2, 9),
    "ragged": (28, 60, 16, 128, 96, 2, 2, 9),
    "pool-down": (128, 32, 8, 128, 96, 2, 2, 5),
    "rope2-attn4": (32, 32, 8, 128, 96, 4, 2, 5),
    "c96-4heads": (16, 32, 8, 96, 96, 4, 4, 5),
    "dv3": (32, 32, 8, 96, 3, 1, 4, 5),
    "box256": (24, 24, 24, 64, 48, 2, 2, 9),
    "448": (448, 448, 28, 256, 384, 4, 4, 9),
    "448->2048": (448, 2048, 28, 256, 384, 4, 4, 9),
    "dv256": (448, 448, 28, 256, 1024, 4, 4, 9),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, hi, out, hk=16, c=128, cv=96, rope_heads=2, seed=0):
    """enc (1, hi, hi, c) and values (1, hk, hk, cv) from numpy, the port's
    pooled RoPE'd keys and cos|sin tables of an out^2 output."""
    rng = np.random.RandomState(seed)
    enc = torch.from_numpy(rng.randn(1, hi, hi, c).astype(np.float32)).to(dev)
    values = torch.from_numpy(rng.randn(1, hk, hk, cv).astype(np.float32)).to(dev)
    rope = RoPE(c, rope_heads).to(dev)
    keys = rope.pooled(enc, (out, out), (hk, hk)).contiguous()
    sin_r, cos_r, sin_c, cos_c = rope.tables(out, out)
    return [enc, keys, values, torch.cat([cos_r, sin_r], -1),
            torch.cat([cos_c, sin_c], -1)], rope.d_head


def _case(dev, label):
    hi, out, hk, c, cv, n, rope_heads, ks = SHAPES[label]
    args, dh = _inputs(dev, hi, out, hk, c, cv, rope_heads)
    return args, dh, dict(num_heads=n, kernel_size=ks)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _bf16(args):
    return [t.bfloat16() for t in args[:3]] + args[3:]


@pytest.mark.cuda
@pytest.mark.parametrize("hi,out", [(64, 64), (32, 64)])
def test_k2_kernel_matches_plain_on_card(cuda_device, hi, out):
    args, dh = _inputs(cuda_device, hi, out)
    got = naf_upsample_attention(*args, dh, num_heads=2, kernel_size=9)
    want = naf_upsample_attention_ref(*args, dh, num_heads=2, kernel_size=9)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(SHAPES))
def test_k2_bf16_runs_the_tensor_cores_and_holds_the_bar(cuda_device, label):
    args, dh, kw = _case(cuda_device, label)
    want = naf_upsample_attention_ref(*args, dh, **kw)
    before = dict(naf_upsample_attention.route_launches)
    got = naf_upsample_attention(*_bf16(args), dh, **kw)
    torch.cuda.synchronize()
    after = naf_upsample_attention.route_launches
    assert (after["wgmma"] - before["wgmma"], after["fma"] - before["fma"]) == (1, 0)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _cos(got.float(), want) > 0.9995


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["identity", "ragged", "pool-down", "rope2-attn4",
                                   "c96-4heads", "dv3", "box256"])
def test_k2_f32_runs_the_cuda_cores_at_2e4(cuda_device, label):
    args, dh, kw = _case(cuda_device, label)
    before = dict(naf_upsample_attention.route_launches)
    got = naf_upsample_attention(*args, dh, **kw)
    torch.cuda.synchronize()
    after = naf_upsample_attention.route_launches
    assert (after["fma"] - before["fma"], after["wgmma"] - before["wgmma"]) == (1, 0)
    torch.testing.assert_close(got, naf_upsample_attention_ref(*args, dh, **kw), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_bands_on_card(cuda_device, dtype):
    """64^2 <- 16^2 at 2x pool-up, cell rows [4, 8): a slab, and the same
    rows written into a shared output in place from the band's encoder rows
    alone, every other row untouched."""
    args, dh, kw = _case(cuda_device, "pool-up")
    band = dict(row_cell0=4, band_cells=4)
    want = naf_upsample_attention_ref(*args, dh, **kw, **band)
    run = args if dtype == torch.float32 else _bf16(args)
    slab = naf_upsample_attention(*run, dh, **kw, **band)
    acc = torch.full((1, 64, 64, 96), 7.0, dtype=dtype, device=cuda_device)
    enc_band = run[0][:, 8:16].contiguous()  # 2 input rows per cell row
    got = naf_upsample_attention(enc_band, *run[1:], dh, **kw, **band, out_acc=acc,
                                 enc_banded=True)
    torch.cuda.synchronize()
    assert got is acc and slab.shape == want.shape == (1, 16, 64, 96)
    assert bool((acc[:, :16] == 7.0).all()) and bool((acc[:, 32:] == 7.0).all())
    if dtype == torch.float32:
        torch.testing.assert_close(slab, want, **TOL)
        torch.testing.assert_close(acc[:, 16:32], want, **TOL)
    else:
        assert _cos(slab.float(), want) > 0.9995 and _cos(acc[:, 16:32].float(), want) > 0.9995


@pytest.mark.cuda
def test_k2_tc_smem_matches_the_planner(cuda_device):
    """The bf16 kernel's shared memory is the planner's sum (K3's forward
    block and a row of window biases; chunked above 192 cells)."""
    lib = t_q._lib()
    for d, dv, nb in ((64, 96, 96), (32, 96, 96), (64, 256, 128), (96, 16, 256), (64, 96, 192)):
        assert lib.naf_fused_q_tc_smem(d, dv, nb) == t_q._tc_smem(d, dv, nb)
        assert t_q._tc_smem(d, dv, nb) >= t_na._tc_smem(d, dv, nb, False)
