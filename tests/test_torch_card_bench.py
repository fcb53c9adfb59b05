"""The measurement layer on the card: the CUDA-event timer and the profiler
on a matmul, and one NAF row of the reference sweep (bf16, 448^2 + 28^2 x 384
-> 448^2, with backward) with its launch counts: 8 K1 and 1 K2 per forward,
K3 and K4 (K2's gradient) in every backward.

Every test carries the marker ``cuda`` and skips without a card. The file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_bench.py -q
"""

import json

import pytest
import torch

from naf_torch.bench import harness
from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
from naf_torch.models.naf import NAF
from naf_torch.utils import benchmarking, profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 20 runs the sweep there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_timer_on_the_card(cuda_device):
    x = torch.randn(2048, 2048, device=cuda_device)
    stats = benchmarking.device_time_stats(torch.mm, x, x, iters=5, repeats=3,
                                           device=cuda_device)
    assert 0 < stats["min"] <= stats["median"] <= stats["max"]
    # 17.2 GFLOP of f32: at least ~0.2 ms on any card of this generation
    assert stats["min"] > 0.05
    assert benchmarking.device_time_ms(torch.mm, x, x, iters=2, repeats=1) > 0


@pytest.mark.cuda
def test_profile_fn_traces_the_card(cuda_device, tmp_path):
    x = torch.randn(512, 512, device=cuda_device)
    profiling.profile_fn(torch.mm, x, x, log_dir=str(tmp_path), iters=3)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_naf_row_with_launch_counts(cuda_device, monkeypatch):
    calls = []
    forward = NAF.forward

    def counted(model, image, *args, **kwargs):
        if not image.is_cuda:  # the harness's FLOP census, on the CPU
            return forward(model, image, *args, **kwargs)
        k1, k2 = gn_silu_conv_fused.launches, naf_upsample_attention.launches
        out = forward(model, image, *args, **kwargs)
        calls.append((gn_silu_conv_fused.launches - k1, naf_upsample_attention.launches - k2,
                      torch.is_grad_enabled()))
        return out

    monkeypatch.setattr(NAF, "forward", counted)
    k3, k4 = cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches
    row = harness.benchmark_model("NAF", 448, 384, 28, out_size=448, dtype=torch.bfloat16,
                                  iters=2, repeats=2)
    k3, k4 = cross_scale_na2d_fused.launches - k3, cross_scale_na2d_fused.bwd_launches - k4
    assert row["device"] == torch.cuda.get_device_name(cuda_device)
    assert row["params"] == 662528 and row["gflops"] > 0
    assert row["fwd_ms_min"] <= row["fwd_ms"] <= row["fwd_ms_max"]
    assert row["fwd_mem_mb"] > 0 and row["bwd_mem_mb"] > row["fwd_mem_mb"]
    assert "bwd_ms" in row and "bwd_error" not in row
    assert calls and all(c[:2] == (8, 1) for c in calls)
    steps = sum(c[2] for c in calls)
    assert steps > 0 and k3 == k4 == steps
