#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (naf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``naf_torch/kernels/csrc`` with nvcc (into
``build/naf_torch/``), then, each phase on its own lines:

1. K1 (fused GN -> SiLU -> conv encoder layer) against its plain PyTorch
   version at the production layer shape (1, 448, 448, 128), k = 1 and 3, f32
   (atol = rtol = 2e-4) and bf16 (cosine > 0.9995 against the f32 plain
   version), and once at batch 2;
2. K2 (fused pool-up + RoPE + cross-scale attention) against its plain
   version at the main path's shapes (448^2 -> 448^2, identity pool, and
   448^2 -> 2048^2, ragged pool-up) and at 224^2 -> 448^2, same bars;
3. the main path: ``NAFUpsampler`` with seeded random bf16 weights at the
   production config serves three 448^2 requests and one 448^2 -> 2048^2
   request, with launch counters showing 8 K1 and 1 K2 launches per forward;
   its output is held against the modular path (plain attention oracle) on
   the card and against an f32 copy of the model on the CPU (cosine > 0.999);
   a torch.profiler breakdown of device time per forward by kernel;
   one gradient of each wrapper is held against autograd of its plain
   version (2e-3); per-forward time and the forward's own peak memory;
4. K3 (cross-scale NA forward) and K4 (its recompute-P backward) against
   their plain versions at the training shape (4, 32^2 <- 16^2, 4 heads,
   d 64, dv 192) and at 448^2 <- 28^2 (d 64, dv 96), k 9: f32 forward
   atol = rtol = 2e-4 and gradients 2e-3, bf16 cosine > 0.9995 against the
   f32 plain versions; the K2 gradient check of phase 3 also shows that its
   backward ran K3 and K4;
5. the training path: ``train_upsampler`` on the production configuration
   (NAF dim 256, 4 + 4 heads, k 9, 2 layers, rope_rescale 2; AdamW 2e-4;
   batch 4; random ViT-B/14 DINOv2 backbone; img_size 448; bf16) for 20
   steps on seeded synthetic images, with 8 K1, 1 K3 and 1 K4 launches per
   step, finite losses, the last below 1.5x the first, a checkpoint written,
   reloaded and stepped once more, one step with use_checkpointing (2 K3
   launches), and one f32 step at batch 1 held against the same step on the
   CPU (loss rtol 1e-3, gradient cosine > 0.999); ms per step, a step's peak
   memory and a torch.profiler split of its device time;
6. K5 (FeatUp's spatially varying conv) against its plain version at
   FeatUp's last stage (1, 454, 454, 384) k 7, at JBU's (1, 458, 458, 3) k 11
   and at a ragged (2, 41, 57, 100) k 5: f32 atol = rtol = 2e-4, bf16 cosine
   > 0.9995 against the f32 plain version, and one gradient of
   ``adaptive_conv`` against autograd of the plain version (2e-3);
7. the baselines path: ``ModelWrapper`` with seeded random f32 weights serves
   FeatUp, JBU, AnyUp, JAFAR, JBF, Bilinear, Nearest and NAF at the reference
   sweep's defaults (448^2 image, 28^2 x 384 features, 448^2 output, ratio
   16), with launch counts per forward (FeatUp 4 K5, JBU 1 K5, AnyUp 1 K3 and
   0 K4, NAF 8 K1 and 1 K2, the others none); each output held against an f32
   copy of the model on the CPU (cosine > 0.999; AnyUp and JAFAR at a 224^2
   output) and AnyUp's against its own plain attention on the card; ms per
   forward over 10 forwards, the forward's own peak memory, and a
   torch.profiler split of FeatUp's and JBU's device time into K5 and the
   rest;
8. the time of each kernel at the production shape (K2 also at 2048^2, K3
   and K4 at both shapes of phase 4, K3 also at AnyUp's k 7 shape, K5 at
   FeatUp's and JBU's) beside its plain version's, a library yardstick and
   the card's bound.

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero on any failure,
and when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM / H200 SXM data-sheet peaks (dense): bytes/s and bf16 FLOP/s.
_PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}
# f32 FLOP/s on the CUDA cores (no tensor cores), the same on both parts.
F32_FLOPS = 67e12


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _peaks(name: str):
    for key, val in _PEAKS.items():
        if key in name:
            return val
    return _PEAKS["H100"]


def _cos(a, b) -> float:
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _check_close(name, got, want, tol):
    got, want = got.detach(), want.detach()
    err = (got.double() - want.double()).abs()
    bad = err > tol + tol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol=rtol={tol}, "
                             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def _check_cos(name, got, want, bar):
    c = _cos(got, want)
    if not c > bar:
        raise AssertionError(f"{name}: cosine {c:.6f} <= {bar}")
    return c


def phase_k1(dev):
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for b, k in ((1, 1), (1, 3), (2, 3)):
        h = w = 448
        c = f = 128
        x = torch.randn(b, h, w, c, generator=gen, device=dev)
        scale = torch.rand(b, c, generator=gen, device=dev) * 0.5 + 0.75
        shift = torch.randn(b, c, generator=gen, device=dev) * 0.1
        wt = torch.randn(f, c, k, k, generator=gen, device=dev) * (1.0 / (c * k * k)) ** 0.5
        bias = torch.randn(f, generator=gen, device=dev) * 0.1
        y_ref, ps_ref = gn_silu_conv_ref(x, scale, shift, wt, bias)
        y, ps = gn_silu_conv_fused(x, scale, shift, wt, bias)
        torch.cuda.synchronize()
        # psums feed GroupNorm as means: compare them per pixel
        e = _check_close(f"K1 f32 y b={b} k={k}", y, y_ref, 2e-4)
        _check_close(f"K1 f32 psums b={b} k={k}", ps / (h * w), ps_ref / (h * w), 2e-4)
        yb, psb = gn_silu_conv_fused(x.bfloat16(), scale, shift, wt.bfloat16(), bias)
        torch.cuda.synchronize()
        cy = _check_cos(f"K1 bf16 y b={b} k={k}", yb.float(), y_ref, 0.9995)
        cp = _check_cos(f"K1 bf16 psums b={b} k={k}", psb, ps_ref, 0.9995)
        errs[(b, k)] = e
        print(f"K1 b={b} k={k}: f32 max_abs_err {e:.3e}; bf16 cos y {cy:.6f} psums {cp:.6f}",
              flush=True)
    return errs[(1, 3)]


def _k2_inputs(dev, gen, hi, out=448, hk=28, c=256, cv=384, heads=4):
    from naf_torch.nn.rope import RoPE

    rope = RoPE(c, heads).to(dev)
    enc = torch.randn(1, hi, hi, c, generator=gen, device=dev)
    keys = rope.pooled(enc, (out, out), (hk, hk)).contiguous()
    values = torch.randn(1, hk, hk, cv, generator=gen, device=dev)
    sin_r, cos_r, sin_c, cos_c = rope.tables(out, out)
    return (enc, keys, values, torch.cat([cos_r, sin_r], -1), torch.cat([cos_c, sin_c], -1),
            rope.d_head)


def phase_k2(dev):
    from naf_torch.kernels.na2d_fused_q import (
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    # identity pool, integer pool-up, and the main path's 448^2 -> 2048^2
    # request (ragged 2048/448 pool rows, ragged 2048/28 window tables)
    for hi, out in ((448, 448), (224, 448), (448, 2048)):
        enc, keys, values, rt, ct, dh = _k2_inputs(dev, gen, hi, out=out)
        kw = dict(num_heads=4, kernel_size=9)
        want = naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw)
        got = naf_upsample_attention(enc, keys, values, rt, ct, dh, **kw)
        torch.cuda.synchronize()
        e = _check_close(f"K2 f32 enc {hi}^2 -> {out}^2", got, want, 2e-4)
        del got
        gb = naf_upsample_attention(enc.bfloat16(), keys.bfloat16(), values.bfloat16(),
                                    rt, ct, dh, **kw)
        torch.cuda.synchronize()
        cb = _check_cos(f"K2 bf16 enc {hi}^2 -> {out}^2", gb.float(), want, 0.9995)
        del gb, want
        errs[(hi, out)] = e
        print(f"K2 enc {hi}^2 -> {out}^2: f32 max_abs_err {e:.3e}; bf16 cos {cb:.6f}",
              flush=True)
    return max(errs.values())


def phase_main(dev, card):
    from naf_torch import NAFUpsampler, load_naf_params
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    ups = NAFUpsampler(seed=0, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    reqs = [((448, 448), (28, 28), (448, 448))] * 3 + [((448, 448), (28, 28), (2048, 2048))]
    inputs = [(torch.randn(1, 3, *im, generator=gen, device=dev),
               torch.randn(1, 384, *lr, generator=gen, device=dev), out)
              for im, lr, out in reqs]
    outs = []
    torch.cuda.synchronize()
    _zero_counts()
    for image, feats, out in inputs:
        k1, k2 = gn_silu_conv_fused.launches, naf_upsample_attention.launches
        o = ups(image, feats, out)
        if (gn_silu_conv_fused.launches - k1, naf_upsample_attention.launches - k2) != (8, 1):
            raise AssertionError("a forward did not launch K1 8 times and K2 once")
        outs.append(o)
    torch.cuda.synchronize()
    launches = {"k1": gn_silu_conv_fused.launches, "k2": naf_upsample_attention.launches}
    if launches != {"k1": 8 * len(reqs), "k2": len(reqs)}:
        raise AssertionError(f"launch counts {launches}")
    for (image, feats, out), o in zip(inputs, outs):
        if o.shape != (1, 384, *out) or o.dtype != torch.bfloat16 or not bool(o.isfinite().all()):
            raise AssertionError(f"bad output {tuple(o.shape)} {o.dtype} for {out}")
    print(f"main path: 3 x 448^2 and 1 x 448^2->2048^2 served; launches {launches}", flush=True)

    # the same model's modular path: plain attention oracle on the card
    image, feats, out = inputs[0]
    with torch.inference_mode():
        mod, weights = ups.model(image.bfloat16().permute(0, 2, 3, 1).contiguous(),
                                 feats.bfloat16().permute(0, 2, 3, 1).contiguous(), out,
                                 return_weights=True)
    c_mod = _check_cos("main path vs modular path", outs[0].permute(0, 2, 3, 1).float(),
                       mod.float(), 0.999)
    del outs, mod, weights

    # an f32 copy of the model on the CPU runs only plain code
    cpu_model = load_naf_params(seed=0, device="cpu", dtype=torch.float32)
    im224 = torch.randn(1, 3, 224, 224, generator=gen, device=dev)
    ft14 = torch.randn(1, 384, 14, 14, generator=gen, device=dev)
    got = ups(im224, ft14, (224, 224)).float().cpu()
    with torch.inference_mode():
        want = cpu_model(im224.cpu().permute(0, 2, 3, 1).contiguous(),
                         ft14.cpu().permute(0, 2, 3, 1).contiguous(), (224, 224))
    c_cpu = _check_cos("card bf16 vs CPU f32 at 224^2", got.permute(0, 2, 3, 1), want, 0.999)
    print(f"main path vs modular cos {c_mod:.6f}; vs CPU f32 cos {c_cpu:.6f}", flush=True)

    stats = {}
    for label, (image, feats, out) in (("448", inputs[0]), ("2048", inputs[3])):
        ms = _time_ms(lambda: ups(image, feats, out), iters=10 if label == "448" else 3)
        # the forward's own peak: above what is allocated before it (weights,
        # the requests' inputs, cached tables)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ups(image, feats, out)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        stats[label] = (ms, peak)
        print(f"forward 448^2 -> {label}^2 bf16: {ms:.3f} ms, peak {peak:.1f} MiB ({card})",
              flush=True)
        _profile(lambda: ups(image, feats, out), f"448^2 -> {label}^2")
    return launches, stats


def _profile(fn, label, reps=3):
    """Device time per forward by kernel (torch.profiler, CUPTI), and the
    share of the forward's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    rows = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): operator and autograd
        # records on the host carry their kernels' time again
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = e.self_device_time_total / reps / 1e3
    busy = sum(rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {label}: device busy {busy:.3f} of {wall:.3f} ms wall "
          f"({100 * busy / wall:.1f}%); top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)


def phase_grads(dev):
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
    from naf_torch.kernels.na2d_fused_q import (
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).requires_grad_()

    x, sc, sh = rnd(1, 16, 16, 128), rnd(1, 128, s=0.2), rnd(1, 128, s=0.1)
    w, b = rnd(128, 128, 3, 3, s=0.03), rnd(128, s=0.1)
    cy, cp = torch.randn(1, 16, 16, 128, generator=gen, device=dev), torch.randn(
        1, 2, 128, generator=gen, device=dev) * 1e-2
    ins = (x, sc, sh, w, b)
    grads = []
    # K1's backward recomputes its plain version, whose convolution backward
    # cuDNN may sum in another order on each call (one element 3.4e-3 apart
    # in one run): deterministic algorithms make the two comparable
    torch.backends.cudnn.deterministic = True
    for fn in (gn_silu_conv_fused, gn_silu_conv_ref):
        y, ps = fn(*ins)
        grads.append(torch.autograd.grad((y * cy).sum() + (ps * cp).sum(), ins))
    torch.backends.cudnn.deterministic = False
    for a, r, n in zip(*grads, ("x", "scale", "shift", "weight", "bias")):
        _check_close(f"K1 gradient d{n}", a, r, 2e-3)

    from naf_torch.nn.rope import RoPE

    rope = RoPE(128, 2).to(dev)
    enc, values = rnd(1, 32, 32, 128), rnd(1, 16, 16, 96)
    keys = rope.pooled(enc.detach(), (64, 64), (16, 16)).contiguous().requires_grad_()
    sin_r, cos_r, sin_c, cos_c = rope.tables(64, 64)
    rt, ct = torch.cat([cos_r, sin_r], -1), torch.cat([cos_c, sin_c], -1)
    cot = torch.randn(1, 64, 64, 96, generator=gen, device=dev)
    grads = []
    before = (cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches)
    for fn in (naf_upsample_attention, naf_upsample_attention_ref):
        o = fn(enc, keys, values, rt, ct, 64, num_heads=2, kernel_size=9)
        grads.append(torch.autograd.grad((o * cot).sum(), (enc, keys, values)))
    after = (cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches)
    if after != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"K2's backward did not run K3 and K4 once each: {before} -> {after}")
    for a, r in zip(*grads):
        _check_close("K2 gradient", a, r, 2e-3)
    print("gradients of K1 and K2 match autograd of their plain versions (2e-3); K2's "
          "backward ran K3 and K4", flush=True)


# (B, Hq, Hk, n, d, dv): the training step's attention and the K2 twin's 448^2 <- 28^2
K34_SHAPES = {"train": (4, 32, 16, 4, 64, 192), "448": (1, 448, 28, 4, 64, 96)}


def _k34_inputs(dev, gen, shape):
    b, hq, hk, n, d, dv = shape
    q = torch.randn(b, hq, hq, n, d, generator=gen, device=dev)
    k = torch.randn(b, hk, hk, n, d, generator=gen, device=dev)
    v = torch.randn(b, hk, hk, n, dv, generator=gen, device=dev)
    g = torch.randn(b, hq, hq, n, dv, generator=gen, device=dev)
    return q, k, v, g


def phase_k34(dev):
    from naf_torch.kernels.na2d_fused import (
        cross_scale_na2d_fused,
        cross_scale_na2d_fused_bwd_ref,
        cross_scale_na2d_fused_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {"k3": 0.0, "k4": 0.0}
    for label, shape in K34_SHAPES.items():
        q, k, v, g = _k34_inputs(dev, gen, shape)
        want = cross_scale_na2d_fused_ref(q, k, v, 9)
        want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9)
        for dt in (torch.float32, torch.bfloat16):
            ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
            out = cross_scale_na2d_fused(*ins, 9)
            got_g = torch.autograd.grad(out, ins, g.to(dt))
            torch.cuda.synchronize()
            if dt == torch.float32:
                e3 = _check_close(f"K3 f32 {label}", out, want, 2e-4)
                e4 = max(_check_close(f"K4 f32 {label} d{n}", a, w, 2e-3)
                         for a, w, n in zip(got_g, want_g, "qkv"))
                errs["k3"], errs["k4"] = max(errs["k3"], e3), max(errs["k4"], e4)
            else:
                c3 = _check_cos(f"K3 bf16 {label}", out.float(), want, 0.9995)
                c4 = [_check_cos(f"K4 bf16 {label} d{n}", a.float(), w, 0.9995)
                      for a, w, n in zip(got_g, want_g, "qkv")]
            del out, got_g, ins
        print(f"K3/K4 {label} {tuple(shape)}: f32 max_abs_err K3 {e3:.3e} K4 {e4:.3e}; "
              f"bf16 cos K3 {c3:.6f} K4 dq/dk/dv " + "/".join(f"{c:.6f}" for c in c4),
              flush=True)
        del q, k, v, g, want, want_g
        torch.cuda.empty_cache()
    return errs


PROD_NAF = dict(dim=256, heads_attn=4, heads_rope=4, kernel_size=9, use_encoder=True,
                img_layers=2, rope_rescale=2.0)
BACKBONE = "vit_base_patch14_dinov2.lvd142m"
IMG_SIZE, BATCH, STEPS = 448, 4, 20


def _images(batch, size, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    while True:
        yield rng.rand(batch, size, size, 3).astype(np.float32)


def _counts():
    """(K1, K3, K4) launch counts: the training path's kernels."""
    c = _all_counts()
    return c["k1"], c["k3"], c["k4"]


def _all_counts() -> dict:
    from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    return {"k1": gn_silu_conv_fused.launches, "k2": naf_upsample_attention.launches,
            "k3": cross_scale_na2d_fused.launches, "k4": cross_scale_na2d_fused.bwd_launches,
            "k5": adaptive_conv_fused.launches}


def _zero_counts():
    from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    gn_silu_conv_fused.launches = naf_upsample_attention.launches = 0
    cross_scale_na2d_fused.launches = cross_scale_na2d_fused.bwd_launches = 0
    adaptive_conv_fused.launches = 0


def _step_inputs(backbone, img, dev):
    from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

    x = torch.as_tensor(img, device=dev)
    ups = ((x - torch.tensor(IMAGENET_DEFAULT_MEAN, device=dev))
           / torch.tensor(IMAGENET_DEFAULT_STD, device=dev))
    return ups, backbone.normalize(x)


def phase_train(dev, card, workdir):
    import numpy as np

    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.models.naf import NAF
    from naf_torch.train.trainer import (
        TrainConfig,
        load_checkpoint,
        make_optimizer,
        make_train_step,
        train_upsampler,
    )

    # the bf16 run as users run it: PyTorch's default lets cuDNN use TF32
    # for the f32 convolutions (K1's plain backward); the f32 check below
    # turns it off again
    torch.backends.cudnn.allow_tf32 = True
    backbone = PretrainedViTWrapper(BACKBONE, dtype=torch.bfloat16, device=dev, seed=0)
    cfg = TrainConfig(train_steps=STEPS, img_size=IMG_SIZE, lr=2e-4, weight_decay=1e-5,
                      batch_size=BATCH, use_bf16=True, log_every=1, ckpt_every=STEPS,
                      viz_every=0, log_dir=os.path.join(workdir, "train"), seed=0)
    marks, events = [], []

    def counted(data):
        for batch in data:
            marks.append(_counts())
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch

    torch.cuda.synchronize()
    _zero_counts()
    model = train_upsampler(NAF(**PROD_NAF), backbone, counted(_images(BATCH, IMG_SIZE, 0)),
                            cfg, device=dev)
    torch.cuda.synchronize()
    marks.append(_counts())
    per_step = {tuple(b - a for a, b in zip(m0, m1)) for m0, m1 in zip(marks, marks[1:])}
    if len(marks) != STEPS + 1 or per_step != {(8, 1, 1)}:
        raise AssertionError(f"launches per step (K1, K3, K4) {per_step} over {len(marks) - 1} "
                             "steps, want (8, 1, 1) each")
    launches = dict(zip(("k1", "k3", "k4"), marks[-1]))
    loop_ms = [a.elapsed_time(b) for a, b in zip(events[1:], events[2:])]
    run = os.path.join(cfg.log_dir, "version_0")
    losses = [json.loads(line)["loss"] for line in open(os.path.join(run, "metrics.jsonl"))]
    if len(losses) != STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < 1.5 * losses[0]:
        raise AssertionError(f"loss diverged: first {losses[0]}, last {losses[-1]}")
    print(f"train: {STEPS} bf16 steps, batch {BATCH}, {IMG_SIZE}^2; launches per step K1 8, "
          f"K3 1, K4 1 (totals {launches}); loss {losses[0]:.5f} -> {losses[-1]:.5f}; loop "
          f"(loss read every step) median {sorted(loop_ms)[len(loop_ms) // 2]:.3f} ms/step",
          flush=True)

    # checkpoint written, reloaded into a fresh model, stepped once more
    saved = load_checkpoint(os.path.join(run, f"ckpt_{STEPS}.pt"))
    cfg2 = TrainConfig(**{**cfg.__dict__, "train_steps": STEPS + 1, "ckpt_every": STEPS + 1})
    resumed = train_upsampler(NAF(**PROD_NAF), backbone, _images(BATCH, IMG_SIZE, 1), cfg2,
                              params=saved["params"], opt_state=saved["opt_state"],
                              start_step=saved["step"], device=dev)
    rec = [json.loads(line) for line in
           open(os.path.join(cfg.log_dir, "version_1", "metrics.jsonl"))]
    if [r["step"] for r in rec] != [STEPS] or not np.isfinite(rec[0]["loss"]):
        raise AssertionError(f"resumed run logged {rec}")
    if not os.path.exists(os.path.join(cfg.log_dir, "version_1", f"ckpt_{STEPS + 1}.pt")):
        raise AssertionError("the resumed run wrote no checkpoint")
    del resumed
    print(f"train: checkpoint ckpt_{STEPS}.pt reloaded and stepped once more, loss "
          f"{rec[0]['loss']:.5f}", flush=True)

    # steady-state step time, a step's peak memory, the device split
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, backbone, opt, use_bf16=True, seed=0)
    ups, back = _step_inputs(backbone, next(_images(BATCH, IMG_SIZE, 2)), dev)
    args = ((IMG_SIZE // 2,) * 2, (IMG_SIZE // 14,) * 2, (min(224, 4 * IMG_SIZE // 14),) * 2)
    step_ms = _time_ms(lambda: step(ups, back, 0, *args), iters=10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(ups, back, 0, *args)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    split = _profile_step(lambda: step(ups, back, 0, *args))
    print(f"train step bf16 batch {BATCH} {IMG_SIZE}^2: {step_ms:.3f} ms/step (10 steps, CUDA "
          f"events), peak {peak:.1f} MiB above the {base / 2**20:.1f} MiB held before it "
          f"({card})", flush=True)
    print("train step split, torch.profiler device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items() if k not in ("top", "kernels"))
          + f"; {split['kernels']:.0f} kernels per step; device busy "
          f"{100 * split['device_total'] / step_ms:.1f}% of the step time", flush=True)
    print("  top kernels: " + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in split["top"]),
          flush=True)

    # use_checkpointing recomputes the forward: K3 twice
    step_ck = make_train_step(model, backbone, opt, use_bf16=True, use_checkpointing=True)
    before = _counts()
    loss_ck = float(step_ck(ups, back, 0, *args))
    delta = tuple(b - a for a, b in zip(before, _counts()))
    if delta != (16, 2, 1) or not np.isfinite(loss_ck):
        raise AssertionError(f"use_checkpointing step: launches (K1, K3, K4) {delta}, loss "
                             f"{loss_ck}")
    print(f"train: use_checkpointing step launched K1 16, K3 2, K4 1; loss {loss_ck:.5f}",
          flush=True)
    del model, opt, step, step_ck
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    agree = _card_vs_cpu_step(dev)
    split.pop("top")
    return launches, dict(step_ms=step_ms, loop_ms=loop_ms, peak_mib=peak, split=split,
                          losses=losses, **agree)


def _profile_step(fn, reps=3):
    """torch.profiler split of one train step's device time: the kernels
    launched under the trainer's naf.backbone / naf.forward / naf.optimizer
    ranges (their CPU-side annotations), and the rest, launched from
    autograd's device thread, as the backward. The device-side spans of the
    ranges are not kernels and are left out of the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    if not total > 0:
        raise AssertionError("torch.profiler recorded no device time")
    names = ("naf.backbone", "naf.forward", "naf.optimizer")
    ranges = {e.key: e.device_time_total / reps / 1e3 for e in ev
              if e.device_type == DeviceType.CPU and e.key in names}
    split = {k.split(".")[1]: ranges.get(k, 0.0) for k in names}
    split["backward"] = total - sum(split.values())
    split["device_total"] = total
    split["wall"] = wall
    split["kernels"] = sum(e.count for e in kernels) / reps
    split["top"] = sorted(((e.key, e.self_device_time_total / reps / 1e3) for e in kernels),
                          key=lambda kv: -kv[1])[:6]
    return split


def _card_vs_cpu_step(dev):
    """One f32 step of the production configuration at batch 1 on the card
    (K1, K3, K4) and on the CPU (plain code), from the same weights, image and
    rescale draw: the loss and the flattened gradients."""
    import numpy as np

    from naf_torch.api import _init_weights
    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.models.naf import NAF
    from naf_torch.nn.rope import RopeDraws
    from naf_torch.train.trainer import make_train_step

    src = NAF(**PROD_NAF)
    _init_weights(src, 5)
    img = next(_images(1, IMG_SIZE, 3))
    args = ((IMG_SIZE // 2,) * 2, (IMG_SIZE // 14,) * 2, (min(224, 4 * IMG_SIZE // 14),) * 2)
    res = {}
    for where in ("cpu", dev):
        model = NAF(**PROD_NAF)
        model.load_state_dict(src.state_dict())
        model.to(where)
        backbone = PretrainedViTWrapper(BACKBONE, dtype=torch.float32, device=where, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=0.0)  # the gradients are compared
        step = make_train_step(model, backbone, opt, use_bf16=False)
        ups, back = _step_inputs(backbone, img, where)
        before = _counts()
        loss = float(step(ups, back, 0, *args, draws=RopeDraws(rescale=1.37)))
        delta = tuple(b - a for a, b in zip(before, _counts()))
        res[str(where)] = (loss, torch.cat([p.grad.flatten().cpu() for p in model.parameters()]),
                           delta)
    (l_cpu, g_cpu, d_cpu), (l_gpu, g_gpu, d_gpu) = res["cpu"], res[str(dev)]
    if d_cpu != (0, 0, 0) or d_gpu != (8, 1, 1):
        raise AssertionError(f"launches (K1, K3, K4): CPU step {d_cpu}, card step {d_gpu}")
    if not abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu):
        raise AssertionError(f"card f32 loss {l_gpu} vs CPU {l_cpu}")
    c = _check_cos("card vs CPU f32 gradients", g_gpu, g_cpu, 0.999)
    print(f"train: f32 step batch 1, card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f} "
          f"(rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}); gradient cosine {c:.6f}", flush=True)
    return dict(cpu_loss=l_cpu, card_loss=l_gpu, grad_cos=c)


def _masked_sdpa_inputs(q, k, v, ks):
    """(B, n, Hq*Wq, d) queries over all (B, n, hk*wk, d) keys with a
    boolean mask of each query's k x k window: the library yardstick of K3."""
    from naf_torch.ops.window import cross_scale_lr_indices

    b, hq, wq, n, d = q.shape
    hk, wk = k.shape[1], k.shape[2]
    ih = torch.from_numpy(cross_scale_lr_indices(hq, hk, ks)).to(q.device)
    iw = torch.from_numpy(cross_scale_lr_indices(wq, wk, ks)).to(q.device)
    rows = torch.zeros(hq, hk, dtype=torch.bool, device=q.device)
    cols = torch.zeros(wq, wk, dtype=torch.bool, device=q.device)
    rows[torch.arange(hq, device=q.device)[:, None], ih] = True
    cols[torch.arange(wq, device=q.device)[:, None], iw] = True
    mask = (rows[:, None, :, None] & cols[None, :, None, :]).reshape(hq * wq, hk * wk)
    flat = lambda t: t.flatten(1, 2).transpose(1, 2)
    return flat(q), flat(k), flat(v), mask



# (B, H, W, C, k): FeatUp's last stage, JBU at 448^2, and a ragged shape
K5_SHAPES = {"featup": (1, 448, 448, 384, 7), "jbu": (1, 448, 448, 3, 11),
             "ragged": (2, 37, 53, 100, 5)}


def _k5_inputs(dev, gen, shape):
    """An f32 padded source and softmax-like per-pixel weights (positive,
    each window summing to 1, as FeatUp's and JBU's are)."""
    b, h, w, c, k = shape
    src = torch.randn(b, h + k - 1, w + k - 1, c, generator=gen, device=dev)
    ker = torch.rand(b, h, w, k, k, generator=gen, device=dev)
    return src, ker / ker.sum(dim=(-2, -1), keepdim=True)


def phase_k5(dev):
    from naf_torch.kernels.adaptive_conv_fused import (
        adaptive_conv_fused,
        adaptive_conv_fused_ref,
    )
    from naf_torch.ops.adaptive_conv import adaptive_conv

    gen = torch.Generator(device=dev).manual_seed(6)
    errs = {}
    for label, shape in K5_SHAPES.items():
        src, ker = _k5_inputs(dev, gen, shape)
        want = adaptive_conv_fused_ref(src, ker)
        got = adaptive_conv_fused(src, ker)
        torch.cuda.synchronize()
        e = _check_close(f"K5 f32 {label}", got, want, 2e-4)
        gb = adaptive_conv_fused(src.bfloat16(), ker.bfloat16())
        torch.cuda.synchronize()
        if gb.dtype != torch.bfloat16:
            raise AssertionError(f"K5 bf16 output came back as {gb.dtype}")
        cb = _check_cos(f"K5 bf16 {label}", gb.float(), want, 0.9995)
        errs[label] = e
        print(f"K5 {label} {shape}: f32 max_abs_err {e:.3e}; bf16 cos {cb:.6f}", flush=True)
        del src, ker, want, got, gb

    # one gradient: K5 forward + plain backward against autograd of the plain version
    src, ker = (t.requires_grad_() for t in _k5_inputs(dev, gen, (2, 24, 40, 64, 7)))
    cot = torch.randn(2, 24, 40, 64, generator=gen, device=dev)
    grads = [torch.autograd.grad(fn(src, ker), (src, ker), cot)
             for fn in (adaptive_conv, adaptive_conv_fused_ref)]
    for a, r, n in zip(*grads, ("source", "kernel")):
        _check_close(f"K5 gradient d{n}", a, r, 2e-3)
    print("gradient of adaptive_conv (K5 forward) matches autograd of its plain version "
          "(2e-3)", flush=True)
    return max(errs.values())


BASELINES = ("FeatUp", "JBU", "AnyUp", "JAFAR", "JBF", "Bilinear", "Nearest", "NAF")
# launches per forward on the baselines path; every other count stays
BASELINE_LAUNCHES = {"FeatUp": {"k5": 4}, "JBU": {"k5": 1}, "AnyUp": {"k3": 1},
                     "NAF": {"k1": 8, "k2": 1}}
RESTORERS = ("JBU", "JBF")  # forward(image_norm, image, output_size)


def phase_baselines(dev, card):
    from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    from naf_torch.models.registry import ModelWrapper

    gen = torch.Generator(device=dev).manual_seed(7)
    image = torch.rand(1, 3, 448, 448, generator=gen, device=dev)
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, device=dev)[:, None, None]
    std = torch.tensor(IMAGENET_DEFAULT_STD, device=dev)[:, None, None]
    image_norm = (image - mean) / std
    feats = torch.randn(1, 384, 28, 28, generator=gen, device=dev)
    out = (448, 448)

    def args(name):
        return (image_norm, image) if name in RESTORERS else (image_norm, feats)

    wrappers = {name: ModelWrapper(name, seed=0, device=dev) for name in BASELINES}
    outs = {}
    torch.cuda.synchronize()
    _zero_counts()
    for name in BASELINES:
        before = _all_counts()
        o = wrappers[name](*args(name), out)
        after = _all_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: BASELINE_LAUNCHES.get(name, {}).get(k, 0) for k in after}
        if delta != want:
            raise AssertionError(f"{name}: launches per forward {delta}, want {want}")
        c = 3 if name in RESTORERS else 384
        if o.shape != (1, c, *out) or o.dtype != torch.float32 or not bool(o.isfinite().all()):
            raise AssertionError(f"{name}: bad output {tuple(o.shape)} {o.dtype}")
        outs[name] = o
    torch.cuda.synchronize()
    launches = _all_counts()
    print(f"baselines path: {', '.join(BASELINES)} served 448^2 <- 28^2 x 384 in f32; "
          f"launches {launches}", flush=True)

    # AnyUp at 448^2 against its own plain attention on the card
    wrappers["AnyUp"].model.attention.impl = "xla"
    c_xla = _check_cos("AnyUp K3 vs plain attention at 448^2",
                       outs["AnyUp"], wrappers["AnyUp"](*args("AnyUp"), out), 0.999)
    wrappers["AnyUp"].model.attention.impl = "auto"

    stats = {}
    for name in BASELINES:
        size = (224, 224) if name in ("AnyUp", "JAFAR") else out
        got = outs.pop(name) if size == out else wrappers[name](*args(name), size)
        want = ModelWrapper(name, seed=0, device="cpu")(*(a.cpu() for a in args(name)), size)
        cos = _check_cos(f"{name} card vs CPU f32 at {size[0]}^2", got.cpu(), want, 0.999)
        del got, want
        fwd = lambda: wrappers[name](*args(name), out)
        ms = _time_ms(fwd, iters=10)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        stats[name] = dict(ms=ms, peak_mib=peak, cos_cpu=cos)
        print(f"{name} f32 448^2: {ms:.3f} ms per forward, peak {peak:.1f} MiB; card vs CPU "
              f"cos {cos:.6f} at {size[0]}^2 ({card})", flush=True)
        torch.cuda.empty_cache()
    print(f"AnyUp K3 vs plain attention on the card at 448^2: cos {c_xla:.6f}", flush=True)
    splits = {}
    for name in ("FeatUp", "JBU"):
        split = _split_k5(lambda: wrappers[name](*args(name), out))
        print(f"{name} profile per forward: K5 {split['k5']:.3f} ms ({split['k5_launches']:.0f} "
              f"launches), other kernels {split['other']:.3f} ms, device busy "
              f"{split['k5'] + split['other']:.3f} of {split['wall']:.3f} ms wall; top: "
              + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in split.pop("top")), flush=True)
        splits[name] = split
    for name in ("AnyUp", "JAFAR"):
        _profile(lambda: wrappers[name](*args(name), out), f"{name} f32 448^2")
    stats["AnyUp"]["cos_xla_448"] = c_xla
    return launches, stats, splits


def _split_k5(fn, reps=3):
    """torch.profiler device time per forward of a model that runs K5: K5's
    kernel against every other kernel (the glue)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    k5 = [e for e in kernels if "adaptive_conv_kernel" in e.key]
    if not k5:
        raise AssertionError("the profile shows no K5 kernel")
    t_k5 = sum(e.self_device_time_total for e in k5) / reps / 1e3
    total = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    return dict(k5=t_k5, other=total - t_k5, wall=wall,
                k5_launches=sum(e.count for e in k5) / reps,
                top=sorted(((e.key, e.self_device_time_total / reps / 1e3) for e in kernels),
                           key=lambda kv: -kv[1])[:5])


def _time_k5(dev, card, bw_peak):
    """K5 at FeatUp's last stage and at JBU's shape, f32 (the sweep's dtype)."""
    from naf_torch.kernels.adaptive_conv_fused import (
        adaptive_conv_fused,
        adaptive_conv_fused_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(8)
    res = {}
    for label in ("featup", "jbu"):
        b, h, w, c, k = K5_SHAPES[label]
        src, ker = _k5_inputs(dev, gen, K5_SHAPES[label])
        ms = _time_ms(lambda: adaptive_conv_fused(src, ker), iters=20)
        plain = _time_ms(lambda: adaptive_conv_fused_ref(src, ker), iters=3)
        nbytes = 4 * (src.numel() + ker.numel() + b * h * w * c)
        flops = 2 * b * h * w * c * k * k
        bound = max(nbytes / bw_peak, flops / F32_FLOPS) * 1e3
        by = "bytes" if nbytes / bw_peak > flops / F32_FLOPS else "operations"
        res[label] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by)
        print(f"K5 f32 {label} src {tuple(src.shape)} k {k}: {ms:.4f} ms; plain {plain:.4f} ms; "
              f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
              f"({card})", flush=True)
        del src, ker
    return res


def _time_k3_anyup(dev, card, bw_peak):
    """K3 at AnyUp's shape: q (1, 448, 448, 8, 32) <- k (1, 28, 28, 8, 32),
    v (1, 28, 28, 8, 48), k 7, f32; checked against its plain version."""
    from naf_torch.kernels.na2d_fused import _launch_fwd, cross_scale_na2d_fused_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, _ = _k34_inputs(dev, gen, (1, 448, 28, 8, 32, 48))
    sc = 32 ** -0.5
    err = _check_close("K3 f32 AnyUp shape", _launch_fwd(q, k, v, 7, sc),
                       cross_scale_na2d_fused_ref(q, k, v, 7, sc), 2e-4)
    ms = _time_ms(lambda: _launch_fwd(q, k, v, 7, sc), iters=10)
    plain = _time_ms(lambda: cross_scale_na2d_fused_ref(q, k, v, 7, sc), iters=1)
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + 448 * 448 * 8 * 48)
    flops = 2 * 448 * 448 * 8 * 49 * (32 + 48)
    bound = max(nbytes / bw_peak, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / bw_peak > flops / F32_FLOPS else "operations"
    print(f"K3 f32 AnyUp (1,448,448,8,32) <- 28^2, dv 48, k 7: {ms:.4f} ms; plain {plain:.4f} ms; "
          f"bound {bound:.4f} ms ({by}); f32 max_abs_err {err:.3e} ({card})", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, max_abs_err=err)


def phase_timing(dev, card):
    import torch.nn.functional as F

    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref
    from naf_torch.kernels.na2d_fused_q import (
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    bw_peak, fl_peak = _peaks(card)
    gen = torch.Generator(device=dev).manual_seed(4)
    res = {}
    for k in (3, 1):
        b, h, w, c, f = 1, 448, 448, 128, 128
        x = torch.randn(b, h, w, c, generator=gen, device=dev).bfloat16()
        scale = torch.rand(b, c, generator=gen, device=dev) + 0.5
        shift = torch.randn(b, c, generator=gen, device=dev) * 0.1
        wt = (torch.randn(f, c, k, k, generator=gen, device=dev) * 0.03).bfloat16()
        bias = torch.randn(f, generator=gen, device=dev) * 0.1
        ms = _time_ms(lambda: gn_silu_conv_fused(x, scale, shift, wt, bias))
        plain = _time_ms(lambda: gn_silu_conv_ref(x, scale, shift, wt, bias), iters=3)
        z = F.silu(x.float() * scale[:, None, None] + shift[:, None, None]).bfloat16()
        z = z.permute(0, 3, 1, 2)
        if k == 3:
            z = F.pad(z, (1, 1, 1, 1), mode="reflect")
        z = z.contiguous(memory_format=torch.channels_last)
        wl = wt.contiguous(memory_format=torch.channels_last)
        lib = _time_ms(lambda: F.conv2d(z, wl))
        nbytes = 2 * (b * h * w * (c + f) + k * k * c * f) + 4 * (2 * b * c + f + 2 * b * f)
        flops = 2 * b * h * w * c * f * k * k
        bound = max(nbytes / bw_peak, flops / fl_peak) * 1e3
        res[f"k1_k{k}"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                               bound_by="bytes" if nbytes / bw_peak > flops / fl_peak
                               else "operations")
        print(f"K1 k={k} bf16 (1,448,448,128): {ms:.4f} ms; plain {plain:.4f} ms; "
              f"F.conv2d alone {lib:.4f} ms; bound {bound:.4f} ms ({card})", flush=True)

    kw = dict(num_heads=4, kernel_size=9)
    for out in (448, 2048):
        enc, keys, values, rt, ct, dh = _k2_inputs(dev, gen, 448, out=out)
        enc, keys, values = enc.bfloat16(), keys.bfloat16(), values.bfloat16()
        ms = _time_ms(lambda: naf_upsample_attention(enc, keys, values, rt, ct, dh, **kw),
                      iters=10 if out == 448 else 3)
        plain = _time_ms(
            lambda: naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw), iters=1)
        nbytes = 2 * (enc.numel() + keys.numel() + values.numel() + out * out * 384) \
            + 4 * (rt.numel() + ct.numel()) + 4 * 2 * out * 9
        flops = 2 * out * out * 4 * 81 * (64 + 96)
        bound = max(nbytes / bw_peak, flops / fl_peak) * 1e3
        res[f"k2_{out}"] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                                bound_by="bytes" if nbytes / bw_peak > flops / fl_peak
                                else "operations")
        print(f"K2 bf16 448^2 -> {out}^2 <- 28^2x384: {ms:.4f} ms; plain {plain:.4f} ms; "
              f"bound {bound:.4f} ms ({card})", flush=True)

    from naf_torch.kernels.na2d_fused import (
        _launch_bwd,
        _launch_fwd,
        cross_scale_na2d_fused_bwd_ref,
        cross_scale_na2d_fused_ref,
    )

    def bound_of(nbytes, flops):
        return (max(nbytes / bw_peak, flops / fl_peak) * 1e3,
                "bytes" if nbytes / bw_peak > flops / fl_peak else "operations")

    for label, shape in K34_SHAPES.items():
        b, hq, hk, n, d, dv = shape
        q, k, v, g = (t.bfloat16() for t in _k34_inputs(dev, gen, shape))
        sc = d ** -0.5
        it = 10 if label == "train" else 3
        ms3 = _time_ms(lambda: _launch_fwd(q, k, v, 9, sc), iters=it)
        ms4 = _time_ms(lambda: _launch_bwd(q, k, v, g, 9, sc), iters=it)
        plain3 = _time_ms(lambda: cross_scale_na2d_fused_ref(q, k, v, 9), iters=1)
        plain4 = _time_ms(lambda: cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9), iters=1)
        # library yardstick: masked SDPA over all LR keys (integer ratio: no
        # window holds a cell twice, so it computes K3's function)
        sq, sk, sv, mask = _masked_sdpa_inputs(q, k, v, 9)
        ref = _launch_fwd(q, k, v, 9, sc)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, scale=sc)
        lib_cos = _check_cos(f"masked SDPA vs K3 {label}",
                             lib_out.transpose(1, 2).reshape(ref.shape).float(), ref.float(),
                             0.999)
        lib3 = _time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                               scale=sc), iters=it)
        lq, lk, lv = (t.detach().requires_grad_() for t in (sq, sk, sv))
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=sc)
        lg = g.flatten(1, 2).transpose(1, 2)
        lib4 = _time_ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), lg, retain_graph=True),
                        iters=it)
        pix, lr = b * hq * hq * n, b * hk * hk * n
        b3, by3 = bound_of(2 * (pix * (d + dv) + lr * (d + dv)), 2 * pix * 81 * (d + dv))
        b4, by4 = bound_of(2 * (pix * (2 * d + dv) + 2 * lr * (d + dv)),
                           2 * pix * 81 * (3 * d + 2 * dv))
        res[f"k3_{label}"] = dict(ms=ms3, plain_ms=plain3, library_ms=lib3, bound_ms=b3,
                                  bound_by=by3)
        res[f"k4_{label}"] = dict(ms=ms4, plain_ms=plain4, library_ms=lib4, bound_ms=b4,
                                  bound_by=by4)
        print(f"K3 bf16 {label} {tuple(shape)}: {ms3:.4f} ms; plain {plain3:.4f} ms; masked "
              f"SDPA {lib3:.4f} ms (cos vs K3 {lib_cos:.6f}); bound {b3:.4f} ms ({by3}) ({card})",
              flush=True)
        print(f"K4 bf16 {label} {tuple(shape)}: {ms4:.4f} ms; plain {plain4:.4f} ms; masked "
              f"SDPA backward {lib4:.4f} ms; bound {b4:.4f} ms ({by4}) ({card})", flush=True)
        del q, k, v, g, sq, sk, sv, mask, lq, lk, lv, lo, lg, lib_out, ref
        torch.cuda.empty_cache()
    res["k3_anyup"] = _time_k3_anyup(dev, card, bw_peak)
    res.update({f"k5_{k}": v for k, v in _time_k5(dev, card, bw_peak).items()})
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from naf_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"nvcc build {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)
    for name in built:
        log = (_build.BUILD_DIR / f"{name}.ptxas.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"spill stores up to {max(spills, default=0)} bytes", flush=True)

    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    launches, stats = phase_main(dev, card)
    phase_grads(dev)
    k34_err = phase_k34(dev)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        train_launches, train = phase_train(dev, card, work)
    k5_err = phase_k5(dev)
    base_launches, baselines, k5_splits = phase_baselines(dev, card)
    timing = phase_timing(dev, card)

    k1, k1b = timing["k1_k3"], timing["k1_k1"]
    kernels = [
        dict(name="gn_silu_conv_fused", route="cuda",
             source="naf_torch/kernels/csrc/encoder_fused.cu",
             replaces="naf_tpu/kernels/encoder_fused.py:390", launches=launches["k1"],
             max_abs_err=k1_err, **k1,
             ms_1x1=k1b["ms"], plain_ms_1x1=k1b["plain_ms"],
             library_ms_1x1=k1b["library_ms"], bound_ms_1x1=k1b["bound_ms"]),
        dict(name="naf_upsample_attention", route="cuda",
             source="naf_torch/kernels/csrc/na2d_fused_q.cu",
             replaces="naf_tpu/kernels/na2d_fused_q.py:767", launches=launches["k2"],
             max_abs_err=k2_err, **timing["k2_448"],
             ms_2048=timing["k2_2048"]["ms"], plain_ms_2048=timing["k2_2048"]["plain_ms"],
             bound_ms_2048=timing["k2_2048"]["bound_ms"]),
        # K3/K4: launches from the training path, times at its shape
        dict(name="cross_scale_na2d_fused", route="cuda",
             source="naf_torch/kernels/csrc/na2d_fused.cu",
             replaces="naf_tpu/kernels/na2d_fused.py:834", launches=train_launches["k3"],
             max_abs_err=k34_err["k3"], **timing["k3_train"],
             **{f"{k}_448": v for k, v in timing["k3_448"].items() if k != "bound_by"}),
        dict(name="cross_scale_na2d_fused_bwd", route="cuda",
             source="naf_torch/kernels/csrc/na2d_fused.cu",
             replaces="naf_tpu/kernels/na2d_fused.py:760", launches=train_launches["k4"],
             max_abs_err=k34_err["k4"], **timing["k4_train"],
             **{f"{k}_448": v for k, v in timing["k4_448"].items() if k != "bound_by"}),
        # K5: launches from the baselines path (FeatUp 4, JBU 1), times at
        # FeatUp's last stage and at JBU's shape
        dict(name="adaptive_conv_fused", route="cuda",
             source="naf_torch/kernels/csrc/adaptive_conv.cu",
             replaces="naf_tpu/kernels/adaptive_conv_fused.py:76", launches=base_launches["k5"],
             max_abs_err=k5_err, **timing["k5_featup"],
             **{f"{k}_jbu": v for k, v in timing["k5_jbu"].items() if k != "library_ms"}),
    ]
    kernels[2].update({"launches_anyup": base_launches["k3"],
                       **{f"{k}_anyup": v for k, v in timing["k3_anyup"].items()}})
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{**{k: kd[k] for k in order}, **kd} for kd in kernels]
    train_keys = ("step_ms", "peak_mib", "split", "losses", "cpu_loss", "card_loss", "grad_cos")
    print(json.dumps({"kernels": kernels, "forward_ms": {k: v[0] for k, v in stats.items()},
                      "peak_mib": {k: v[1] for k, v in stats.items()},
                      "train": {k: train[k] for k in train_keys},
                      "baselines": baselines, "k5_splits": k5_splits, "card": card}))
    print(_card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
