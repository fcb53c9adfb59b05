"""The closed loop of the inference kinds that ``kinds/upsample.py`` does not
drive: one caller that waits for each result, timed as ``kinds/upsample.py``
times its calls (a CUDA event before the call to one after it, waited for;
host launch gaps included), its checked calls' outputs copied into buffers
set aside before the window with the window's clock stopped, the peak
leaving those buffers out.

``call(j)`` serves request ``j`` and returns a tuple of tensors (what the
check compares). Every request is served once before the window, so that
every shape is warm and nothing compiles inside it.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from h100bench import trace

__all__ = ["FIRST_CALLS", "TRACE_MIN_S", "draw_calls", "closed_loop", "result"]

FIRST_CALLS = 20  # checked calls are drawn among these; a traced stretch makes at least as many
TRACE_MIN_S = 2.0


def draw_calls(rng: np.random.Generator, distinct: int, checked: int):
    """(order, checked): the order requests are visited in, and the calls
    held to the reference, drawn among the first ``FIRST_CALLS``."""
    order = rng.permutation(distinct)
    return order, sorted(int(i) for i in rng.choice(FIRST_CALLS, checked, replace=False))


def _counters():
    from naf_torch.kernels import launch_counts
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    return launch_counts(), dict(getattr(naf_upsample_attention, "route_launches", {}))


def _copy(keep, out) -> None:
    """Copy a checked call's outputs into their buffers (in a function of
    its own: a loop variable left bound in the window would hold the output
    alive into the next call)."""
    for k, o in zip(keep, out):
        k.copy_(o)


def closed_loop(call, order, checked, seconds: float, traced: bool, dev, t_start: float) -> dict:
    """Run the window; returns its calls ``n``, latencies (ms), host times
    (s), ``window_s``, ``paused``, ``peak`` (bytes), ``launches`` and K2
    ``routes`` per call, ``setup_s``, ``served`` ([(outputs, call index)]:
    the checked calls', then the last call's; a kind pops it to free them),
    ``checked_calls`` and ``holder`` (the profile's, when traced)."""
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for j in range(len(order)):  # warm every request's shapes once
        out = call(j)
    sync()
    keep = [tuple(torch.empty_strided(o.shape, o.stride(), dtype=o.dtype, device=dev)
                  for o in out) for _ in checked]
    keep_bytes = sum(o.numel() * o.element_size() for k in keep for o in k)
    del out
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before, routes0 = _counters()
    e0, e1 = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              if cuda else (None, None))
    lat, host, paused, n = [], [], 0.0, 0
    setup_s = time.time() - t_start
    last = max(checked)
    ctx = trace.profiled() if traced else contextlib.nullcontext()
    with ctx as holder:
        start = time.perf_counter()
        while True:
            j = int(order[n % len(order)])
            out = None  # the last output is freed before the next call, as a caller's would be
            if cuda:
                e0.record()
            t0 = time.perf_counter()
            if traced:
                with torch.profiler.record_function("bench.call"):
                    out = call(j)
            else:
                out = call(j)
            t1 = time.perf_counter()
            if cuda:
                e1.record()
                e1.synchronize()
                lat.append(e0.elapsed_time(e1))
            else:
                lat.append((time.perf_counter() - t0) * 1e3)
            host.append(t1 - t0)
            if n in checked:
                p0 = time.perf_counter()
                _copy(keep[checked.index(n)], out)
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
    return {
        "n": n, "lat": lat, "host": host, "window_s": window_s, "paused": paused, "peak": peak,
        "launches": {k: (after[k] - before[k]) / n for k in after if after[k] != before[k]},
        "routes": {k: v - routes0.get(k, 0) for k, v in routes1.items()
                   if v != routes0.get(k, 0)},
        "setup_s": setup_s, "holder": holder, "copies": len(keep),
        "checked_calls": [*checked, n - 1],
        "served": [(k, c) for k, c in zip(keep, checked)] + [(out, n - 1)],
    }


def result(loop: dict, numbers: dict, batch: int, dev, traced: bool, work: dict, extra=()) -> dict:
    """The kind's result from the loop's record and the numbers compared."""
    cuda = dev.type == "cuda"
    lat, n, window_s = loop["lat"], loop["n"], loop["window_s"]
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    res = {
        "attempted": n, "failed": 0, "numbers": numbers,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(loop["peak"])},
        "e2e": {"img_per_s": n * batch / window_s,
                "latency_p95_ms": float(np.percentile(lat, 95)),
                "peak_mib": loop["peak"] / 2**20, "setup_s": loop["setup_s"]},
        "lines": [
            f"tf32: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}",
            f"window: {n} calls in {window_s!r} s (clock stopped {loop['paused']!r} s for the "
            f"{loop['copies']} check copies); set-up {loop['setup_s']!r} s",
            f"launches per call: {loop['launches']}; K2 routes: {loop['routes']}",
            f"latency ms: median {float(np.median(lat))!r}, p95 "
            f"{float(np.percentile(lat, 95))!r}, max {max(lat)!r}",
            f"checked calls: {loop['checked_calls']}",
            *extra,
        ],
    }
    if traced:
        tr = trace.reduce_profile(loop["holder"].prof)
        res.update(trace=tr, trace_calls=n, host_s=loop["host"], work=work)
        res["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
    return res
