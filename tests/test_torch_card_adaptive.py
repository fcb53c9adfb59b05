"""K5 (FeatUp's spatially varying conv) on the card against its plain
version: both routes of ``csrc/adaptive_conv.cu`` at their edges, C 8 (the
narrow route's widest) and 9 (the wide route's narrowest), C 3 (JBU's), C
not a multiple of 4, every odd k from 1 to 15, batch 2, H and W no multiple
of a tile; the wide route also at FeatUp's width (its first stage, 56^2,
whose blocks split the channels into chunks) and at chunks of several
32-channel stages ending in a tail. f32 at atol = rtol = 2e-4, bf16 at
cosine > 0.9995 against the f32 plain version, the gradient of
``adaptive_conv`` at 2e-3; each call counted once, on the route the plan
gives it.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_card_adaptive.py -q
"""

import numpy as np
import pytest
import torch

from naf_torch.kernels.adaptive_conv_fused import (
    _plan_k5,
    adaptive_conv_fused,
    adaptive_conv_fused_ref,
)
from naf_torch.ops.adaptive_conv import adaptive_conv

TOL = dict(atol=2e-4, rtol=2e-4)
KS = tuple(range(1, 16, 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds K5 on the card")
    return torch.device("cuda")


def _inputs(dev, seed, b, h, w, c, k):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(b, h + k - 1, w + k - 1, c).astype(np.float32))
    ker = torch.from_numpy(rng.rand(b, h, w, k, k).astype(np.float32))
    return src.to(dev), (ker / ker.sum(dim=(-2, -1), keepdim=True)).to(dev)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _counted(fn, route):
    launches, before = adaptive_conv_fused.launches, dict(adaptive_conv_fused.route_launches)
    out = fn()
    torch.cuda.synchronize()
    assert adaptive_conv_fused.launches == launches + 1
    assert {r: n - before[r] for r, n in adaptive_conv_fused.route_launches.items()} == {
        r: int(r == route) for r in before}
    return out


def _check(dev, shape, seed):
    b, h, w, c, k = shape
    src, ker = _inputs(dev, seed, *shape)
    route = "narrow" if c <= 8 else "wide"
    assert _plan_k5(b, h, w, c, k, torch.float32).route == route
    want = adaptive_conv_fused_ref(src, ker)
    got = _counted(lambda: adaptive_conv_fused(src, ker), route)
    torch.testing.assert_close(got, want, **TOL)
    gb = _counted(lambda: adaptive_conv_fused(src.bfloat16(), ker.bfloat16()), route)
    assert gb.dtype == torch.bfloat16
    assert _cos(gb.float(), want) > 0.9995


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("c", (3, 8, 9))
def test_routes_at_their_edges(cuda_device, c, k):
    _check(cuda_device, (2, 19, 37, c, k), seed=10 * c + k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 56, 56, 384, 7), (2, 150, 150, 200, 3),
                                   (2, 37, 53, 100, 5), (1, 45, 70, 1, 5)],
                         ids=("featup56", "stages", "ragged", "c1"))
def test_routes_at_model_widths(cuda_device, shape):
    _check(cuda_device, shape, seed=sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 24, 40, 64, 7), (2, 24, 40, 3, 11)],
                         ids=("wide", "narrow"))
def test_gradient_through_each_route(cuda_device, shape):
    src, ker = (t.requires_grad_() for t in _inputs(cuda_device, 7, *shape))
    cot = torch.from_numpy(np.random.RandomState(8).randn(*shape[:4]).astype(np.float32))
    cot = cot.to(cuda_device)
    got = torch.autograd.grad(adaptive_conv(src, ker), (src, ker), cot)
    want = torch.autograd.grad(adaptive_conv_fused_ref(src, ker), (src, ker), cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_misaligned_weights_and_source(cuda_device):
    """Views that start 4 bytes past an allocation: the narrow route's
    weights then begin inside a 16-byte piece, and the wide route's source
    comes in by plain loads."""
    for shape in ((2, 19, 37, 3, 5), (2, 19, 37, 100, 5)):
        b, h, w, c, k = shape
        src, ker = _inputs(cuda_device, 11, *shape)
        src_v = torch.cat([src.new_zeros(1), src.flatten()])[1:].view(src.shape)
        ker_v = torch.cat([ker.new_zeros(1), ker.flatten()])[1:].view(ker.shape)
        assert src_v.data_ptr() % 16 == 4 and ker_v.data_ptr() % 16 == 4
        got = _counted(lambda: adaptive_conv_fused(src_v, ker_v), "narrow" if c <= 8 else "wide")
        torch.testing.assert_close(got, adaptive_conv_fused_ref(src, ker), **TOL)
