"""Profiler traces (counterpart of ``naf_tpu/utils/profiling.py``, which
wraps ``jax.profiler``; the reference has none, only CUDA events).

    with trace("output/torch_trace") as prof:
        f(x)
    prof.key_averages()          # kernel and op times; the Chrome trace is in the folder

``profile_fn`` warms ``fn`` up outside the trace, then traces ``iters``
calls. Both trace the CPU and the card (``torch.profiler``'s CPU and CUDA
activities) and write ``trace.json``, a Chrome trace, into ``log_dir``
(open it in chrome://tracing or Perfetto). With ``device="cuda"`` (the
default) and no CUDA they raise; ``device="cpu"`` traces the CPU alone.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile

from naf_torch.utils.benchmarking import _check_device

__all__ = ["trace", "profile_fn"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Trace the block; yields the ``torch.profiler.profile`` and writes its
    Chrome trace to ``log_dir/trace.json`` when the block ends."""
    dev = _check_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def profile_fn(fn, *args, log_dir: str = "output/torch_trace", iters: int = 5,
               device="cuda") -> str:
    """Trace ``iters`` calls of ``fn(*args)`` after one untraced warm-up
    call; returns ``log_dir``."""
    fn(*args)
    with trace(log_dir, device=device):
        for _ in range(iters):
            fn(*args)
    return log_dir
