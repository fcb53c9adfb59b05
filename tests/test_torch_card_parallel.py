"""The parallel path on the card (JAX-free: the card machine has no flax).

Two ranks spawned on ``cuda:0`` over gloo (``naf_torch.parallel.run_ranks``)
run the spatially sharded forward at a small width, held against the
one-process forward on the card: f32 max abs err <= 2e-5 (the JAX package's
bar for this path), bf16 cosine >= 0.99999, each rank launching 8 K1 and 1
K2. One rank in an NCCL world takes two data-parallel f32 train steps
through its all_reduce: the losses at rel 1e-6 to the one-process steps,
and the first step's gradients at rel 1e-5 per tensor in the 2-norm (cuDNN
may take other algorithms in the two runs).

    python -m pytest -m cuda tests/test_torch_card_parallel.py -q
"""

import numpy as np
import pytest
import torch

from naf_torch.dryrun import spatial_case, train_case
from naf_torch.parallel import run_ranks

WIDE = dict(dim=128, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 17 runs the parallel path there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_gloo_ranks_on_one_card_match_the_one_process_forward(cuda_device, dtype, tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randn(1, 64, 64, 3).astype(np.float32)
    feats = rng.randn(1, 16, 16, 64).astype(np.float32)
    res = run_ranks(spatial_case, 2, args=(dict(
        naf=WIDE, seed=0, image=img, feats=feats, out_hw=(128, 128), data=1, space=2,
        dtype=dtype, compare=True),), device="cuda", timeout=300, workdir=str(tmp_path))
    route = "wgmma" if dtype == "bfloat16" else "fma"
    for r in res:
        assert r["backend"] == "gloo"
        assert (r["launches"]["k1"], r["launches"]["k2"], r["launches"][f"k2_{route}"]) == \
            (8, 1, 1)
        assert r["block"] == (1, 64, 128, 64)
    top = res[0]
    assert top["shape"] == (1, 128, 128, 64) and top["finite"]
    if dtype == "float32":
        assert top["max_abs_err"] <= 2e-5
    else:
        assert top["cos"] >= 0.99999


@pytest.mark.cuda
def test_one_rank_nccl_step_equals_the_one_process_step(cuda_device, tmp_path):
    rng = np.random.RandomState(1)
    img = rng.rand(2, 252, 252, 3).astype(np.float32)
    (res,) = run_ranks(train_case, 1, args=(dict(
        naf=dict(WIDE, kernel_size=9), seed=0,
        backbone=dict(name="vit_small_patch14_dinov2.lvd142m", embed_dim=64, depth=1,
                      num_heads=2, seed=0),
        ups=(img - 0.45) / 0.225, back=(img - 0.5) / 0.25, steps=2, lr_size=(126, 126),
        out_hw=(18, 18), crop_hw=(72, 72), use_bf16=False, one_process=True),),
        device="cuda", timeout=300, workdir=str(tmp_path))
    assert res["backend"] == "nccl"
    np.testing.assert_allclose(res["dp"]["losses"], res["single"]["losses"], rtol=1e-6)
    for name, g in res["dp"]["grads"].items():  # per tensor, in the 2-norm
        want = res["single"]["grads"][name]
        assert float((g - want).norm() / want.norm().clamp_min(1e-30)) <= 1e-5, name
