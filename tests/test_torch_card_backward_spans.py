"""The backward's spans on the card: ``naf.attention.backward`` (the custom
Functions of K2 and of K3/K4) and ``naf.encoder.backward`` (the encoder
twin's), which run on the autograd engine's thread.

- One profiled denoiser step (NAF as a restorer: one head, k 15, 448^2 <-
  448^2 values, bf16; batch 1): each backward span once a step, under
  ``denoise.backward``; K3 and K4's chunked kernels (K4's two launches a
  step, and no reduce pass: the chunked K4 writes no partials) inside
  ``naf.attention.backward``'s device ranges (K3/K4's own span
  folds into K2's, so no range of that name overlaps another), the
  encoder twin's kernels inside ``naf.encoder.backward``'s, and none of the
  port's kernels there.
- The distillation cell, traced by the benchmark's command with the new
  spans and without them: the same ``h2d_copies_per_call.train`` and
  ``kernels_per_call.train``, and ``backbone_ms`` within 10%.

Every test carries the marker ``cuda`` and skips without a card. The file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_backward_spans.py -q -s
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

STEPS = 2
K34 = ("na_fwd_wgmma_chunked_kernel", "na_bwd_wgmma_chunked_kernel")
PORT = ("gn_silu_conv", "fused_q_", "na_fwd_", "na_bwd_", "rope_keys")
SPANS = ("naf.attention.backward", "naf.encoder.backward")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from naf_torch.kernels import _build

    _build.build()
    return torch.device("cuda")


def _events(prof):
    """({name: [(start, end)]} of GPU annotations, [(name, start, end)] of
    device operations) of a profile, in ns."""
    ann, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.is_user_annotation():
            ann.setdefault(e.name(), []).append((s, t))
        else:
            dev.append((e.name(), s, t))
    return ann, dev


def _under(dev, ranges):
    return [(n, s, t) for n, s, t in dev if any(a <= s < b for a, b in ranges)]


@pytest.fixture(scope="module")
def denoise_step(card):
    from h100bench import trace
    from naf_torch.api import _init_weights
    from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator
    from naf_torch.models.naf import NAF
    from naf_torch.train.denoise import (
        DenoiseConfig, make_denoise_chunk, make_denoise_step, make_optimizer,
    )
    from naf_torch.utils import spans

    model = NAF(dim=256, heads_attn=1, heads_rope=1, kernel_size=15, img_layers=2)
    _init_weights(model, 0)
    model.to(card)
    cfg = DenoiseConfig(noise_params={"std": 0.5})
    step = make_denoise_step(model, make_optimizer(model, cfg), DenoisingLoss(1.0, 5.0, 0.2),
                             NoiseGenerator("gaussian"), cfg.noise_params, (448, 448), True)
    chunk = make_denoise_chunk(step, 0)
    stack = torch.rand(4, 448, 448, 3, generator=torch.Generator(card).manual_seed(1),
                       device=card)
    idx = np.arange(STEPS)[:, None] % 4
    chunk(stack, idx, 0)
    torch.cuda.synchronize()
    n0 = len(spans.records())
    with trace.profiled() as holder:
        chunk(stack, idx, STEPS)
    return spans.records()[n0:], *_events(holder.prof)


@pytest.mark.cuda
def test_each_backward_span_once_a_step_under_the_callers(denoise_step):
    recs, ann, _ = denoise_step
    for name in SPANS:
        mine = [r for r in recs if r.name == name]
        assert len(mine) == STEPS and len(ann.get(name, ())) == STEPS, name
        assert all(r.parent is not None and r.parent.name == "denoise.backward" for r in mine)


@pytest.mark.cuda
def test_attention_backward_holds_k3_k4_and_counts_them_once(denoise_step):
    _, ann, dev = denoise_step
    ranges = sorted(ann["naf.attention.backward"])
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))  # no range inside another
    k34 = [op for op in dev if any(k in op[0] for k in K34)]
    under = _under(dev, ranges)
    assert {k for k in K34 if any(k in n for n, _, _ in k34)} == set(K34)
    assert sum("na_bwd_wgmma_chunked_kernel" in n for n, _, _ in k34) == 2 * STEPS
    assert not [n for n, _, _ in dev if "na_bwd_reduce_kernel" in n]
    assert all(op in under for op in k34)
    assert not _under(k34, ann["naf.encoder.backward"])
    ms = sum(t - s for _, s, t in under) / STEPS * 1e-6
    k34_ms = sum(t - s for _, s, t in k34) / STEPS * 1e-6
    print(f"naf.attention.backward {ms:.3f} ms a step at batch 1, K3/K4 {k34_ms:.3f} ms "
          f"({torch.cuda.get_device_name(0)})")


@pytest.mark.cuda
def test_encoder_backward_holds_the_twin(denoise_step):
    _, ann, dev = denoise_step
    under = _under(dev, ann["naf.encoder.backward"])
    assert under and not [n for n, _, _ in under if any(p in n for p in PORT)]
    ms = sum(t - s for _, s, t in under) / STEPS * 1e-6
    print(f"naf.encoder.backward {ms:.3f} ms a step at batch 1 over {len(under) / STEPS} "
          "operations")


# The benchmark's own command on the distillation cell, once as it is and
# once with the new spans made no-ops, each in a process of its own (a
# process's second profile has been seen to lose its first device events).
NO_NEW_SPANS = """
import contextlib
import naf_torch.kernels.encoder_fused as a, naf_torch.kernels.na2d_fused as b
import naf_torch.kernels.na2d_fused_q as c
for m in (a, b, c):
    m.span = lambda name: contextlib.nullcontext()
"""
RUN_CELL = """
import sys
from h100bench.run import main
sys.exit(main(["--workload", "naf-distill-dinov2-b14.train", "--seed", "2147483999",
               "--seconds", "2", "--trace", "1"]))
"""


def _distill_metrics(prelude: str) -> dict:
    out = subprocess.run([sys.executable, "-c", prelude + RUN_CELL], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return {k: v["value"] for k, v in json.loads(out.stdout.splitlines()[-1])["metrics"].items()}


@pytest.mark.cuda
def test_distillation_step_reads_the_same_without_the_new_spans(card):
    with_spans, without = _distill_metrics(""), _distill_metrics(NO_NEW_SPANS)
    print(f"distillation cell, with the backward spans {with_spans}, without {without}")
    for key in ("h2d_copies_per_call.train", "kernels_per_call.train"):
        assert with_spans[key] == without[key], key
    assert abs(with_spans["backbone_ms"] - without["backbone_ms"]) <= 0.1 * without["backbone_ms"]
