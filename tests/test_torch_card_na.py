"""K3 and K4 on the card against their plain versions: bf16 on the
tensor-core kernels (``csrc/na_tc.cuh``; cosine > 0.9995 against the f32
plain versions) and f32 on the CUDA-core kernels (2e-4 forward, 2e-3
gradients), at the training shape, 48 <- 12, the ragged 100 <- 28 (repeated
cells in a window), the denoiser's dv = 3 (one head) and dv = 1 (three
heads, zero-padded channels), and boxes above 192 cells, which the bf16
kernels take in chunks: ratio 1 at k 9 (the denoiser's attention, also at
dv 3) and ratio 2 at k 11. K4's dk and dv are bitwise equal over two runs,
each call is counted on the route its dtype chooses, and K4 in bands of
query rows (a lowered partials budget) agrees with one launch. On the
chunked boxes the bf16 K4 is two launches fed by K3's log-sum-exp (a
query-major one for dq, a key-major one for dk and dv) with no reduce pass
and no bands: held against the plain version and bitwise over two runs at
ratio 1 k 9, at the denoiser's shape (batch 2, one head, d 256, dv 3, k 15,
448^2 <- 448^2), at the ragged 50 <- 40, k 13 and at ratio 4, k 15; its
banded-rows calls sum to the whole call.

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
# bf16, boxes above 192 cells: K4's two launches
# (ratio 4 at k 15: key-major boxes of 64 x 64 queries, past the 16-bit
# division of the query-major masks)
CHUNKED = {"r1k9": SHAPES["r1k9"], "denoise": (2, 448, 448, 15, 1, 256, 3),
           "ragged": (1, 50, 40, 13, 2, 32, 48), "r4k15": (1, 64, 16, 15, 2, 32, 48)}


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


def _k4_banded_rows(q, k, v, g, ks, sc, cuts):
    """K4 as banded calls on the query rows between ``cuts`` (each with
    row_cell0 / full_hq at ratio 1, as a spatial band): dq concatenated,
    dk and dv summed in f32."""
    hq = q.shape[1]
    dq, dk, dv = [], 0.0, 0.0
    for y0, y1 in zip(cuts, cuts[1:]):
        a, b_, c = t_na._launch_bwd(q[:, y0:y1].contiguous(), k, v, g[:, y0:y1].contiguous(),
                                    ks, sc, y0, hq)
        dq.append(a)
        dk, dv = dk + b_.float(), dv + c.float()
    return torch.cat(dq, 1), dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["100<-28", "r1k9"])
def test_k4_in_bands_matches_one_launch_on_card(cuda_device, label, monkeypatch):
    """Whole-box boxes (100 <- 28): a partials budget below the whole grid's
    runs K4 in bands of query rows (one launch each, dk and dv summed in
    f32); it agrees with one launch and with the plain version, and repeats
    bitwise. Chunked boxes (r1k9) no longer band: the budget leaves one
    call, and banded-rows calls (row_cell0 / full_hq) agree with the whole
    call and the plain version."""
    shape = SHAPES[label]
    ks = shape[3]
    q, k, v, g = (t.bfloat16() for t in _inputs(cuda_device, shape, seed=2))
    sc = shape[5] ** -0.5
    whole = t_na._launch_bwd(q, k, v, g, ks, sc)
    want = cross_scale_na2d_fused_bwd_ref(q.float(), k.float(), v.float(), g.float(), ks)
    if label == "r1k9":
        monkeypatch.setattr(t_na, "PARTIAL_BUDGET", 1)
        before = dict(t_na.cross_scale_na2d_fused.route_launches)
        again = t_na._launch_bwd(q, k, v, g, ks, sc)
        after = t_na.cross_scale_na2d_fused.route_launches
        assert after["wgmma_bwd"] == before["wgmma_bwd"] + 1
        assert after["wgmma_chunked_bwd"] == before["wgmma_chunked_bwd"] + 1
        banded = _k4_banded_rows(q, k, v, g, ks, sc, (0, 16, 40, shape[1]))
        torch.cuda.synchronize()
        for a, b, c, w in zip(banded, again, whole, want):
            assert torch.equal(b, c)
            assert _cos(a.float(), c.float()) > 0.99999 and _cos(a.float(), w) > 0.9995
        return
    plan = t_na._plan_tc(shape[1], shape[1], shape[2], shape[2], ks, shape[5],
                         -(-shape[6] // 16) * 16, True, str(cuda_device))
    tiles_h = -(-shape[1] // plan[0])
    monkeypatch.setattr(t_na, "PARTIAL_BUDGET", 1)  # one row of tiles per band
    before = t_na.cross_scale_na2d_fused.route_launches["wgmma_bwd"]
    banded = t_na._launch_bwd(q, k, v, g, ks, sc)
    again = t_na._launch_bwd(q, k, v, g, ks, sc)
    torch.cuda.synchronize()
    assert t_na.cross_scale_na2d_fused.route_launches["wgmma_bwd"] == before + 2 * tiles_h
    for a, b, c, w in zip(banded, again, whole, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert _cos(a.float(), c.float()) > 0.99999 and _cos(a.float(), w) > 0.9995


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CHUNKED))
def test_chunked_k4_from_k3_statistics_on_card(cuda_device, label):
    """Chunked bf16 boxes: K3 leaves each query's log-sum-exp, and K4 runs
    as one call of two launches (dq query-major, dk and dv key-major) with
    no bands, counted once on "wgmma_chunked_bwd"; under autograd it reads
    the forward's statistics (no K3 in the backward), a direct call runs
    one K3 first. Against the plain version (cosine > 0.9995), and dq, dk,
    dv bitwise equal over two runs and between the two calls. (The
    denoiser step's profile in test_torch_card_backward_spans.py counts the
    two kernels and finds no reduce pass.)"""
    shape = CHUNKED[label]
    ks = shape[3]
    q, k, v, g = _inputs(cuda_device, shape, seed=4)
    want = cross_scale_na2d_fused_ref(q, k, v, ks)
    want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
    ins = [t.bfloat16().requires_grad_() for t in (q, k, v)]
    fused = t_na.cross_scale_na2d_fused
    counts = lambda: (fused.launches, fused.bwd_launches, dict(fused.route_launches))
    before = counts()
    out = cross_scale_na2d_fused(*ins, ks)
    got = torch.autograd.grad(out, ins, g.bfloat16(), retain_graph=True)
    torch.cuda.synchronize()
    after = counts()
    routes = {r: n - before[2][r] for r, n in after[2].items() if n != before[2][r]}
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    assert routes == {"wgmma": 1, "wgmma_bwd": 1, "wgmma_chunked_bwd": 1}
    assert _cos(out.detach().float(), want) > 0.9995
    for a, w in zip(got, want_g):
        assert a.dtype == torch.bfloat16 and _cos(a.float(), w) > 0.9995
    again = torch.autograd.grad(out, ins, g.bfloat16())
    qb, kb, vb, gb = (t.detach() for t in (*ins, g.bfloat16()))
    before = counts()
    direct = t_na._launch_bwd(qb, kb, vb, gb, ks, shape[5] ** -0.5)
    after = counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for a, b, c in zip(got, again, direct):
        assert torch.equal(a, b) and torch.equal(a, c)
