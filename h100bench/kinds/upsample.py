"""Closed-loop upsampling: one caller that waits for each result, as the
probe and video evaluations call NAF (batch 1 per call).

The traffic file fixes the shapes (``batch``, ``image``, ``features``,
``output``), how many distinct requests the caller cycles through
(``distinct_inputs``, visited in an order drawn from the seed) and how many
calls of the window are held to the reference (``checked_calls``, drawn
from the seed among the first 20, plus the window's last call). The
configuration fixes the model's widths, the features' width and the
serving dtype.

The program is ``naf_torch.api.NAFUpsampler.__call__`` on NCHW tensors
resident on the card; its output stays there. Each call is timed from a
CUDA event recorded before it to one recorded after it, waited for: the
caller's latency, host launch gaps included. A checked call's output is
copied into a buffer set aside before the window, with the window's clock
stopped; the peak leaves those buffers out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from h100bench import check, trace, work
from h100bench.reference import naf as ref_naf
from h100bench.weights import IMAGENET_MEAN, IMAGENET_STD, draw, generator, naf_specs, normal, \
    subseed, uniform

__all__ = ["Program", "build", "guard_hw", "reference_output", "numbers", "work_per_call", "run"]

FIRST_CALLS = 20  # checked calls are drawn among these; a traced stretch makes at least as many
TRACE_MIN_S = 2.0


@dataclasses.dataclass
class Program:
    ups: object  # naf_torch.api.NAFUpsampler
    state: dict  # the weights, as drawn
    images: list  # NCHW, serving dtype
    feats: list  # NCHW, serving dtype
    order: np.ndarray  # call i serves request order[i % len(order)]
    checked: list  # call indices held to the reference
    out_hw: tuple


def guard_hw(h: int, w: int, oh: int, ow: int):
    """The encoder's input size: a guide above 4x the output is downscaled."""
    if h > 4 * oh or w > 4 * ow:
        return min(h, 4 * oh, 4 * ow), min(w, 4 * ow, 4 * oh)
    return h, w


def build(config: dict, traffic: dict, seed: int, device) -> Program:
    from naf_torch.api import NAFUpsampler
    from naf_torch.models.naf import NAF

    dtype = getattr(torch, config["dtype"])
    state = draw(naf_specs(config["model"]), generator(seed, "weights", device), dtype)
    with torch.device(device):
        model = NAF(**config["model"])
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) != {"image_encoder.rope.periods"}:
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    model = model.to(device, dtype).eval()
    gen = generator(seed, "inputs", device)
    b = traffic["batch"]
    c = config["values"]["channels"]
    mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
    images, feats = [], []
    for _ in range(traffic["distinct_inputs"]):
        img = uniform(gen, (b, 3, *traffic["image"]), torch.float32)
        images.append(((img - mean) / std).to(dtype))
        feats.append(normal(gen, (b, c, *traffic["features"]), dtype))
    rng = np.random.default_rng(subseed(seed, "order"))
    order = rng.permutation(traffic["distinct_inputs"])
    checked = sorted(int(i) for i in rng.choice(FIRST_CALLS, traffic["checked_calls"],
                                                replace=False))
    return Program(NAFUpsampler(model=model), state, images, feats, order, checked,
                   tuple(traffic["output"]))


@torch.no_grad()
def reference_output(config: dict, state: dict, image, feats, out_hw, q8=None):
    """The reference's output for one request, NCHW f32 (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = {} if q8 is None else {"q8": q8}
        out = ref_naf.naf_forward(ref_naf.naf_params(state), config["model"],
                                  image.permute(0, 2, 3, 1).float(),
                                  feats.permute(0, 2, 3, 1).float(), out_hw, **kw)
        return out.permute(0, 3, 1, 2)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def numbers(pairs) -> dict:
    """The worst over the checked (output, reference) pairs, taken one at a
    time, of ||out - ref|| / ||ref|| and of max |out - ref| / max |ref|."""
    rel = mx = 0.0
    for o, r in pairs:
        rel, mx = max(rel, check.rel_l2(o, r)), max(mx, check.max_err(o, r))
    return {"rel_l2": rel, "max_err": mx}


def work_per_call(config: dict, traffic: dict) -> dict:
    m, c, b = config["model"], config["values"]["channels"], traffic["batch"]
    (h, w), out_hw, lr_hw = traffic["image"], tuple(traffic["output"]), tuple(traffic["features"])
    enc_hw = guard_hw(h, w, *out_hw)
    return {"k1": work.k1_work(b, *enc_hw, m["dim"], m["img_layers"]),
            "k2": work.k2_work(b, enc_hw, out_hw, lr_hw, m["dim"], m["heads_attn"],
                               m["kernel_size"], c),
            "flops": work.naf_forward_flops(b, enc_hw, out_hw, m, c)}


def _counters():
    from naf_torch.kernels import launch_counts
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    return launch_counts(), dict(getattr(naf_upsample_attention, "route_launches", {}))


def run(config, traffic, seed, seconds, traced, device, t_start) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    prog = build(config, traffic, seed, dev)
    ups, hw = prog.ups, prog.out_hw
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for j in range(len(prog.images)):  # warm every request's shapes once
        out = ups(prog.images[j], prog.feats[j], hw)
    sync()
    keep = [torch.empty_strided(out.shape, out.stride(), dtype=out.dtype, device=dev)
            for _ in prog.checked]
    keep_bytes = sum(k.numel() * k.element_size() for k in keep)
    del out
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before, routes0 = _counters()
    e0, e1 = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              if cuda else (None, None))
    lat, host, paused, n = [], [], 0.0, 0
    setup_s = time.time() - t_start
    last = max(prog.checked)
    ctx = trace.profiled() if traced else contextlib.nullcontext()
    with ctx as holder:
        start = time.perf_counter()
        while True:
            j = int(prog.order[n % len(prog.order)])
            out = None  # the last output is freed before the next call, as a caller's would be
            if cuda:
                e0.record()
            t0 = time.perf_counter()
            if traced:
                with torch.profiler.record_function("bench.call"):
                    out = ups(prog.images[j], prog.feats[j], hw)
            else:
                out = ups(prog.images[j], prog.feats[j], hw)
            t1 = time.perf_counter()
            if cuda:
                e1.record()
                e1.synchronize()
                lat.append(e0.elapsed_time(e1))
            else:
                lat.append((time.perf_counter() - t0) * 1e3)
            host.append(t1 - t0)
            if n in prog.checked:
                p0 = time.perf_counter()
                keep[prog.checked.index(n)].copy_(out)
                sync()
                paused += time.perf_counter() - p0
            n += 1
            elapsed = time.perf_counter() - start - paused
            if n > last and (elapsed >= seconds if not traced else
                             (n >= FIRST_CALLS and elapsed >= TRACE_MIN_S)):
                break
        window_s = time.perf_counter() - start - paused
    peak = (torch.cuda.max_memory_allocated() - keep_bytes) if cuda else 0
    after, routes1 = _counters()
    launches = {k: (after[k] - before[k]) / n for k in after if after[k] != before[k]}
    routes = {k: v - routes0.get(k, 0) for k, v in routes1.items() if v != routes0.get(k, 0)}
    served = [(keep[i], c) for i, c in enumerate(prog.checked)] + [(out, n - 1)]
    del ups, prog.ups
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    def pairs():
        for o, c in served:
            j = int(prog.order[c % len(prog.order)])
            yield o, reference_output(config, prog.state, prog.images[j], prog.feats[j], hw)

    nums = numbers(pairs())
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    res = {
        "attempted": n, "failed": 0, "numbers": nums,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)},
        "e2e": {"img_per_s": n * traffic["batch"] / window_s,
                "latency_p95_ms": float(np.percentile(lat, 95)),
                "peak_mib": peak / 2**20, "setup_s": setup_s},
        "lines": [
            f"tf32: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}",
            f"window: {n} calls in {window_s!r} s (clock stopped {paused!r} s for the "
            f"{len(keep)} check copies); set-up {setup_s!r} s",
            f"launches per call: {launches}; K2 routes: {routes}",
            f"latency ms: median {float(np.median(lat))!r}, p95 "
            f"{float(np.percentile(lat, 95))!r}, max {max(lat)!r}",
            f"checked calls: {[c for _, c in served]}",
        ],
    }
    if traced:
        tr = trace.reduce_profile(holder.prof)
        res.update(trace=tr, trace_calls=n, host_s=host,
                   work=work_per_call(config, traffic))
        res["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
    return res
