"""Spatially sharded training on the card (JAX-free: the card machine has no
flax).

K3/K4 on an interior band of query rows (``row_cell0``, ``full_hq``) under
autograd against their plain versions on the band: f32 on the CUDA-core
kernels (forward 2e-4, dq 2e-4, dk/dv 2e-3), bf16 on the tensor-core kernels
(cosine > 0.9995), one K3 and one K4 launch on the dtype's route. Then two
gloo ranks on ``cuda:0`` (data 1, space 2) take two f32 steps of
``naf_torch.parallel.naf_spatial_train_step`` at a small width, held against
the one-process step on the card from the same weights: losses at rel 1e-5,
the first step's gradients at cosine >= 0.999999 and rel 1e-5 in the 2-norm,
each rank's step on 8 K1, one banded K2, one K3 and K4 in one or more bands.

    python -m pytest -m cuda tests/test_torch_card_spatial_train.py -q
"""

import numpy as np
import pytest
import torch

from naf_torch.dryrun import each, spatial_train_case
from naf_torch.kernels import na2d_fused as na
from naf_torch.parallel import run_ranks

WIDE = dict(dim=128, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phases 4 and 17 run the banded K4 and "
                    "the spatial train step there")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_k4_matches_its_plain_version(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(*s, generator=gen, device=cuda_device) for s in (
        (1, 48, 48, 2, 32), (1, 12, 12, 2, 32), (1, 12, 12, 2, 48), (1, 48, 48, 2, 48)))
    band = dict(row_cell0=4, full_hq=48)
    q, g = q[:, 16:32].contiguous(), g[:, 16:32].contiguous()
    want = na.cross_scale_na2d_fused_ref(q, k, v, 5, **band)
    want_g = na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, 5, **band)
    route = na._route(dtype)
    routes = na.cross_scale_na2d_fused.route_launches
    before = (routes[route], routes[f"{route}_bwd"])
    ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    out = na.cross_scale_na2d_fused(*ins, 5, **band)
    got_g = torch.autograd.grad(out, ins, g.to(dtype))
    torch.cuda.synchronize()
    assert (routes[route], routes[f"{route}_bwd"]) == (before[0] + 1, before[1] + 1)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-4, rtol=2e-4)
        for got, w, tol in zip(got_g, want_g, (2e-4, 2e-3, 2e-3)):
            torch.testing.assert_close(got, w, atol=tol, rtol=tol)
    else:
        assert all(_cos(got.float(), w) > 0.9995 for got, w in zip(got_g, want_g))


@pytest.mark.cuda
def test_two_gloo_ranks_take_the_one_process_step(cuda_device, tmp_path):
    rng = np.random.RandomState(0)
    image = rng.randn(1, 64, 64, 3).astype(np.float32)
    feats = rng.randn(1, 16, 16, 64).astype(np.float32)
    target = rng.randn(1, 64, 64, 64).astype(np.float32)
    res = run_ranks(each, 2, args=([(spatial_train_case, dict(
        naf=WIDE, seed=0, image=image, feats=feats, target=target, out_hw=(64, 64), data=1,
        space=2, use_bf16=False, steps=2, one_process=True))],), device="cuda", timeout=300,
        workdir=str(tmp_path))
    res = [r[0] for r in res]
    one = res[0]["single"]
    for r in res:
        assert r["backend"] == "gloo"
        got = r["spatial"]
        for ln in got["launches"]:
            assert (ln["k1"], ln["k2"], ln["k2_fma"], ln["k3"], ln["k34_fma"]) == (8, 1, 1, 1, 1)
            assert ln["k4"] >= 1 and ln["k34_fma_bwd"] == ln["k4"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        g_sp = torch.cat([t.flatten() for t in got["grads"].values()])
        g_one = torch.cat([one["grads"][name].flatten() for name in got["grads"]])
        assert _cos(g_sp, g_one) >= 0.999999
        assert float((g_sp - g_one).norm() / g_one.norm()) <= 1e-5
