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
4. the time of each kernel at the production shape (K2 also at 2048^2)
   beside its plain version's, a library yardstick and the card's bound.

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero on any failure,
and when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

# H100 SXM / H200 SXM data-sheet peaks (dense): bytes/s and bf16 FLOP/s.
_PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}


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
    a, b = a.double().flatten(), b.double().flatten()
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
    gn_silu_conv_fused.launches = 0
    naf_upsample_attention.launches = 0
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
        _profile(lambda: ups(image, feats, out), label)
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
    print(f"profile 448^2 -> {label}^2: device busy {busy:.3f} of {wall:.3f} ms wall "
          f"({100 * busy / wall:.1f}%); top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)


def phase_grads(dev):
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref
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
    for fn in (gn_silu_conv_fused, gn_silu_conv_ref):
        y, ps = fn(*ins)
        grads.append(torch.autograd.grad((y * cy).sum() + (ps * cp).sum(), ins))
    for a, r in zip(*grads):
        _check_close("K1 gradient", a, r, 2e-3)

    from naf_torch.nn.rope import RoPE

    rope = RoPE(128, 2).to(dev)
    enc, values = rnd(1, 32, 32, 128), rnd(1, 16, 16, 96)
    keys = rope.pooled(enc.detach(), (64, 64), (16, 16)).contiguous().requires_grad_()
    sin_r, cos_r, sin_c, cos_c = rope.tables(64, 64)
    rt, ct = torch.cat([cos_r, sin_r], -1), torch.cat([cos_c, sin_c], -1)
    cot = torch.randn(1, 64, 64, 96, generator=gen, device=dev)
    grads = []
    for fn in (naf_upsample_attention, naf_upsample_attention_ref):
        o = fn(enc, keys, values, rt, ct, 64, num_heads=2, kernel_size=9)
        grads.append(torch.autograd.grad((o * cot).sum(), (enc, keys, values)))
    for a, r in zip(*grads):
        _check_close("K2 gradient", a, r, 2e-3)
    print("gradients of K1 and K2 match autograd of their plain versions (2e-3)", flush=True)


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

    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    launches, stats = phase_main(dev, card)
    phase_grads(dev)
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
    ]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{**{k: kd[k] for k in order}, **kd} for kd in kernels]
    print(json.dumps({"kernels": kernels, "forward_ms": {k: v[0] for k, v in stats.items()},
                      "peak_mib": {k: v[1] for k, v in stats.items()}, "card": card}))
    print(_card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
