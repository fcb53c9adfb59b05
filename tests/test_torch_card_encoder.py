"""K1 and K6 on the card against their plain versions: the tensor-core
kernels in bf16 (cosine > 0.9995 against the f32 plain version) and the
CUDA-core kernels in f32 (atol = rtol = 2e-4), at whole tiles, a banded-
encoder band (256 + 2 x 3 halo rows of a 452-wide image: ragged in both
axes of the 8 x 16 tile), batch 2 and, for K1, F = 64; and at other widths:
K1 at C = F of 48 (``NAF(dim=96)``, F zero-padded to 64 by the wrapper),
160 and 256, K6 at C = 48 and 96 per stack.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_card_encoder.py -q
"""

import numpy as np
import pytest
import torch

from naf_torch.kernels import encoder_fused as t_enc
from naf_torch.kernels.encoder_fused import (
    gn_silu_conv_dual_fused,
    gn_silu_conv_dual_ref,
    gn_silu_conv_fused,
    gn_silu_conv_ref,
)

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, s=1.0):
    return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _check(y, ps, y_ref, ps_ref, dtype, hw):
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_ref, **TOL)
        torch.testing.assert_close(ps / hw, ps_ref / hw, **TOL)  # GroupNorm reads means
    else:
        assert y.dtype == dtype
        assert _cos(y.float(), y_ref) > 0.9995 and _cos(ps, ps_ref) > 0.9995


# (k, batch, H, W, F)
K1_CARD = [(1, 2, 16, 16, 128), (3, 2, 16, 16, 128), (3, 1, 262, 452, 128),
           (1, 1, 262, 452, 128), (3, 2, 64, 64, 64), (1, 2, 24, 40, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,b,h,w,f", K1_CARD)
def test_k1_kernel_matches_plain_on_card(cuda_device, k, b, h, w, f, dtype):
    rng = np.random.RandomState(0)
    c = 128
    x, wt = _rand(rng, b, h, w, c), _rand(rng, f, c, k, k, s=(c * k * k) ** -0.5)
    sc = torch.from_numpy((rng.rand(b, c) + 0.5).astype(np.float32))
    sh, bias = _rand(rng, b, c, s=0.1), _rand(rng, f, s=0.1)
    x, wt, sc, sh, bias = (t.to(cuda_device) for t in (x, wt, sc, sh, bias))
    launches = gn_silu_conv_fused.launches
    y, ps = gn_silu_conv_fused(x.to(dtype), sc, sh, wt.to(dtype), bias)
    assert gn_silu_conv_fused.launches == launches + 1
    _check(y, ps, *gn_silu_conv_ref(x, sc, sh, wt, bias), dtype, h * w)
    tiles_h, tiles_w, _, _ = t_enc.tile_plan(h, w, k)
    assert t_enc._lib().naf_gn_silu_conv_tiles(h, w) == tiles_h * tiles_w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (2, 16, 16), (1, 262, 452), (2, 262, 452)])
def test_k6_kernel_matches_plain_on_card(cuda_device, b, h, w, dtype):
    rng = np.random.RandomState(20)
    c = 128
    x = _rand(rng, b, h, w, 2 * c)
    sc = torch.from_numpy((rng.rand(b, 2 * c) + 0.5).astype(np.float32))
    sh = _rand(rng, b, 2 * c, s=0.1)
    wp, ws = _rand(rng, c, c, 1, 1, s=0.09), _rand(rng, c, c, 3, 3, s=0.03)
    bp, bs = _rand(rng, c, s=0.1), _rand(rng, c, s=0.1)
    args = [t.to(cuda_device) for t in (x, sc, sh, wp, ws, bp, bs)]
    low = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(args)]
    launches = gn_silu_conv_dual_fused.launches
    y, ps = gn_silu_conv_dual_fused(*low)
    assert gn_silu_conv_dual_fused.launches == launches + 1
    _check(y, ps, *gn_silu_conv_dual_ref(*args), dtype, h * w)


# (C = F, k): NAF(dim=96)'s hidden width 48 (F padded to 64 by the
# wrapper), 160 (a zero stage past C, a halo in two chunks) and 256
K1_WIDTHS = [(48, 3), (48, 1), (160, 3), (256, 3), (256, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,k", K1_WIDTHS)
def test_k1_kernel_at_other_widths_on_card(cuda_device, c, k, dtype):
    rng = np.random.RandomState(1)
    b, h, w = 2, 24, 40
    x, wt = _rand(rng, b, h, w, c), _rand(rng, c, c, k, k, s=(c * k * k) ** -0.5)
    sc = torch.from_numpy((rng.rand(b, c) + 0.5).astype(np.float32))
    sh, bias = _rand(rng, b, c, s=0.1), _rand(rng, c, s=0.1)
    x, wt, sc, sh, bias = (t.to(cuda_device) for t in (x, wt, sc, sh, bias))
    launches = gn_silu_conv_fused.launches
    y, ps = gn_silu_conv_fused(x.to(dtype), sc, sh, wt.to(dtype), bias)
    assert gn_silu_conv_fused.launches == launches + 1 and y.shape == (b, h, w, c)
    _check(y, ps, *gn_silu_conv_ref(x, sc, sh, wt, bias), dtype, h * w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [48, 96])  # the tensor-core kernel's N = 64 and a partial N = 128
def test_k6_kernel_at_other_widths_on_card(cuda_device, c, dtype):
    rng = np.random.RandomState(21)
    b, h, w = 2, 24, 40
    x = _rand(rng, b, h, w, 2 * c)
    sc = torch.from_numpy((rng.rand(b, 2 * c) + 0.5).astype(np.float32))
    sh = _rand(rng, b, 2 * c, s=0.1)
    wp, ws = _rand(rng, c, c, 1, 1, s=c ** -0.5), _rand(rng, c, c, 3, 3, s=(9 * c) ** -0.5)
    bp, bs = _rand(rng, c, s=0.1), _rand(rng, c, s=0.1)
    args = [t.to(cuda_device) for t in (x, sc, sh, wp, ws, bp, bs)]
    low = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(args)]
    launches = gn_silu_conv_dual_fused.launches
    y, ps = gn_silu_conv_dual_fused(*low)
    assert gn_silu_conv_dual_fused.launches == launches + 1
    _check(y, ps, *gn_silu_conv_dual_ref(*args), dtype, h * w)
