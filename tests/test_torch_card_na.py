"""K3 and K4 on the card against their plain versions: bf16 on the
tensor-core kernels (``csrc/na_tc.cuh``; cosine > 0.9995 against the f32
plain versions) and f32 on the CUDA-core kernels (2e-4 forward, 2e-3
gradients), at the training shape, 48 <- 12, the ragged 100 <- 28 (repeated
cells in a window), the denoiser's dv = 3 (one head) and dv = 1 (three
heads, zero-padded channels), and boxes above 192 cells, which the bf16
kernels take in chunks: ratio 1 at k 9 (the denoiser's attention, also at
dv 3) and ratio 2 at k 11. K4's dk and dv are bitwise equal over two runs,
each call is counted on the route its dtype chooses, and K4 in bands of
query rows (a lowered partials budget) agrees with one launch.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_card_na.py -q
"""

import pytest
import torch

from naf_torch.kernels import na2d_fused as t_na
from naf_torch.kernels.na2d_fused import (
    cross_scale_na2d_fused,
    cross_scale_na2d_fused_bwd_ref,
    cross_scale_na2d_fused_ref,
)

# (batch, Hq, hk, k, heads, d, dv)
SHAPES = {
    "train": (4, 32, 16, 9, 4, 64, 192),
    "48<-12": (1, 48, 12, 5, 2, 32, 48),
    "100<-28": (1, 100, 28, 9, 4, 64, 96),
    "dv3": (1, 48, 12, 5, 1, 16, 3),
    "dv1": (1, 48, 12, 5, 3, 16, 1),
    "r1k9": (1, 64, 64, 9, 2, 32, 48),
    "r1k9dv3": (1, 64, 64, 9, 1, 32, 3),
    "r2k11": (2, 64, 32, 11, 4, 64, 96),
}
# bf16 only: the training widths at larger windows, whose boxes the f32
# route's CUDA-core K4 cannot hold in shared memory at any tile
TRAIN_WINDOWS = {"k11": (4, 64, 32, 11, 4, 64, 192), "k13": (4, 64, 32, 13, 4, 64, 192)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, shape, seed=0):
    b, hq, hk, _, n, d, dv = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, h, h, n, c, generator=gen, device=dev)
            for h, c in ((hq, d), (hk, d), (hk, dv), (hq, dv))]


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label", list(SHAPES))
def test_k3_k4_match_plain_on_card(cuda_device, label, dtype):
    shape = SHAPES[label]
    ks = shape[3]
    q, k, v, g = _inputs(cuda_device, shape)
    want = cross_scale_na2d_fused_ref(q, k, v, ks)
    want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
    route = t_na._route(dtype)
    before = dict(t_na.cross_scale_na2d_fused.route_launches)
    ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    out = cross_scale_na2d_fused(*ins, ks)
    got = torch.autograd.grad(out, ins, g.to(dtype))
    torch.cuda.synchronize()
    after = t_na.cross_scale_na2d_fused.route_launches
    assert after[route] == before[route] + 1 and after[f"{route}_bwd"] == before[f"{route}_bwd"] + 1
    assert out.dtype == dtype and out.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-4, rtol=2e-4)
        for a, w in zip(got, want_g):
            torch.testing.assert_close(a, w, atol=2e-3, rtol=2e-3)
    else:
        assert _cos(out.detach().float(), want) > 0.9995
        for a, w in zip(got, want_g):
            assert a.dtype == dtype and _cos(a.float(), w) > 0.9995


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(TRAIN_WINDOWS))
def test_k3_k4_bf16_at_training_widths_with_large_windows(cuda_device, label):
    shape = TRAIN_WINDOWS[label]
    ks = shape[3]
    q, k, v, g = _inputs(cuda_device, shape, seed=3)
    want = cross_scale_na2d_fused_ref(q, k, v, ks)
    want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
    before = dict(t_na.cross_scale_na2d_fused.route_launches)
    ins = [t.bfloat16().requires_grad_() for t in (q, k, v)]
    out = cross_scale_na2d_fused(*ins, ks)
    got = torch.autograd.grad(out, ins, g.bfloat16())
    torch.cuda.synchronize()
    after = t_na.cross_scale_na2d_fused.route_launches
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["wgmma_bwd"] == before["wgmma_bwd"] + 1
    assert _cos(out.detach().float(), want) > 0.9995
    for a, w in zip(got, want_g):
        assert _cos(a.float(), w) > 0.9995


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label", ["train", "100<-28", "r1k9"])
def test_k4_is_bitwise_reproducible_on_card(cuda_device, label, dtype):
    shape = SHAPES[label]
    q, k, v, g = (t.to(dtype) for t in _inputs(cuda_device, shape, seed=1))
    sc = shape[5] ** -0.5
    first = t_na._launch_bwd(q, k, v, g, shape[3], sc)
    second = t_na._launch_bwd(q, k, v, g, shape[3], sc)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tc_smem_matches_the_kernels(cuda_device):
    """The planner's shared-memory sums are the kernels' own."""
    lib = t_na._lib()
    for d, dv, nb in ((64, 192, 128), (64, 96, 96), (16, 16, 64), (32, 48, 192), (64, 192, 256),
                      (32, 16, 512)):
        for bwd in (0, 1):
            assert lib.naf_na_tc_smem(d, dv, nb, bwd) == t_na._tc_smem(d, dv, nb, bool(bwd))


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["100<-28", "r1k9"])
def test_k4_in_bands_matches_one_launch_on_card(cuda_device, label, monkeypatch):
    """A partials budget below the whole grid's runs K4 in bands of query
    rows (one launch each, dk and dv summed in f32); it agrees with one
    launch and with the plain version, and repeats bitwise."""
    shape = SHAPES[label]
    ks = shape[3]
    q, k, v, g = (t.bfloat16() for t in _inputs(cuda_device, shape, seed=2))
    sc = shape[5] ** -0.5
    whole = t_na._launch_bwd(q, k, v, g, ks, sc)
    plan = t_na._plan_tc(shape[1], shape[1], shape[2], shape[2], ks, shape[5],
                         -(-shape[6] // 16) * 16, True, str(cuda_device))
    tiles_h = -(-shape[1] // plan[0])
    monkeypatch.setattr(t_na, "PARTIAL_BUDGET", 1)  # one row of tiles per band
    before = t_na.cross_scale_na2d_fused.route_launches["wgmma_bwd"]
    banded = t_na._launch_bwd(q, k, v, g, ks, sc)
    again = t_na._launch_bwd(q, k, v, g, ks, sc)
    torch.cuda.synchronize()
    assert t_na.cross_scale_na2d_fused.route_launches["wgmma_bwd"] == before + 2 * tiles_h
    want = cross_scale_na2d_fused_bwd_ref(q.float(), k.float(), v.float(), g.float(), ks)
    for a, b, c, w in zip(banded, again, whole, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert _cos(a.float(), c.float()) > 0.99999 and _cos(a.float(), w) > 0.9995
