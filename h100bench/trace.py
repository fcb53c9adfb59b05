"""The traced run's reading of the device: one ``torch.profiler`` profile of
a stretch of steady calls, reduced to device intervals, busy time, kernel
times by name, the device time under the program's ``record_function``
ranges, and the idle gaps with what the host was doing across each.

Nothing is written to disk. A profile without device records fails the
run: CUPTI has been seen to hand none over, and a trace read as zeros
would report an idle device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections import defaultdict

import numpy as np

__all__ = ["Trace", "profiled", "reduce_profile", "matches", "WINDOW"]

WINDOW = "bench.window"  # the range around the whole traced stretch
_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced stretch's wall time
    busy_s: float  # union of device activity within it
    device: list  # (name, start_us, dur_us) of every kernel, memcpy and memset in it
    ranges_us: dict  # device time of the kernels launched under each host range name
    gaps: list  # (host op, seconds) of each idle gap, longest first

    def kernel_s(self, patterns) -> float:
        """Device seconds of the kernels whose names match any pattern."""
        return sum(d for n, _, d in self.device if matches(n, patterns)) * 1e-6

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for n, _, d in self.device:
            by[n[:160]] += d * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda t: -t[1])[:top]

    def idle_gaps(self, top: int = 10):
        by = defaultdict(float)
        for n, s in self.gaps:
            by[n] += s
        return sorted(([n, s] for n, s in by.items()), key=lambda t: -t[1])[:top]


def matches(name: str, patterns) -> bool:
    """Whether a kernel's name holds one of ``patterns`` as a whole
    identifier (``fused_q_kernel`` does not match ``fused_q_wgmma_kernel``)."""
    return any(re.search(r"(?<![A-Za-z0-9_])" + re.escape(p) + r"(?![A-Za-z0-9_])", name)
               for p in patterns)


@contextlib.contextmanager
def profiled():
    """A CPU + CUDA profile around the block, which runs inside the
    ``bench.window`` range; yields a holder whose ``.prof`` is the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {})()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder.prof = prof


def reduce_profile(prof) -> Trace:
    """Reduce the profile's raw kineto events (no Python event tree is
    built: a traced chunk of training steps holds around a million)."""
    w0 = w1 = None
    dev, cpu, ann = [], [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type().name == "CUDA":
            (ann[name].append((s, s + d)) if e.is_user_annotation() else dev.append((name, s, d)))
        elif name == WINDOW:
            w0, w1 = s, s + d
        elif not _RUNTIME.match(name):
            cpu.append((s, s + d, name))
    if w0 is None:
        raise RuntimeError("the profile holds no window range")
    dev = [(n, max(s, w0), min(s + d, w1) - max(s, w0)) for n, s, d in dev
           if min(s + d, w1) > max(s, w0)]
    if not dev:
        raise RuntimeError("the profile came back without device records")
    dev.sort(key=lambda t: t[1])
    starts = np.array([s for _, s, _ in dev], dtype=np.int64)
    ends = starts + np.array([d for _, _, d in dev], dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(ends - starts)])
    ranges = {}
    for name, spans in ann.items():
        tot = 0
        for s, t in spans:
            tot += int(csum[np.searchsorted(starts, t)] - csum[np.searchsorted(starts, s)])
        ranges[name] = tot * 1e-3
    merged = [[int(starts[0]), int(ends[0])]]
    for s, t in zip(starts[1:].tolist(), ends[1:].tolist()):
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    holes = [(w0, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    holes.append((merged[-1][1], w1))
    holes = np.array([h for h in holes if h[1] > h[0]], dtype=np.int64).reshape(-1, 2)
    gaps = list(zip(_host_ops(cpu, holes.sum(axis=1) // 2), (holes[:, 1] - holes[:, 0]) * 1e-9))
    device = [(n, s * 1e-3, d * 1e-3) for n, s, d in dev]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device=device, ranges_us=ranges,
                 gaps=gaps)


def _host_ops(cpu, points, back: int = 64):
    """The innermost host op running at each point: of the ``back`` host
    events that started last before it, the latest-starting one that is
    still running (host ops nest on a thread)."""
    names = np.array(["(no host op)"] + [c[2] for c in cpu], dtype=object)
    order = np.argsort([c[0] for c in cpu], kind="stable")
    starts = np.array([cpu[i][0] for i in order], dtype=np.int64)
    ends = np.array([cpu[i][1] for i in order], dtype=np.int64)
    last = np.searchsorted(starts, points, side="right") - 1
    pick = np.full(len(points), -1)
    for k in range(back):
        cand = last - k
        ok = (pick < 0) & (cand >= 0)
        ok[ok] &= ends[cand[ok]] >= points[ok]
        pick[ok] = cand[ok]
    return names[np.where(pick >= 0, order[np.maximum(pick, 0)] + 1, 0)].tolist()
