"""Spans at the port's layer boundaries and the one host-to-device copy
counter, read by ``torch.profiler`` and by the benchmark.

    with span("naf.encoder"):      # a layer boundary
        ...
    t = to_device(np_array, dev)   # every copy of a host array to the card

``span(name)`` costs one flag check while no profiler runs: it enters no
``record_function``, stamps nothing and stores nothing. Inside
``torch.profiler.profile`` it enters ``torch.profiler.record_function(name)``,
so the span lands in the profile (and its device time in the kernels it
launched, the profiler's GPU annotation), and keeps a :class:`Record` in
memory: name, parent, start and end stamped by ``time.time_ns()`` (the profiler's host clock is the Unix epoch, so the
stamps share the timebase of the profile's events) and the host-to-device
copies charged to it. ``records()`` returns them, ``clear()`` drops them.

``to_device(array, device, dtype=None)`` is ``torch.as_tensor(array,
dtype=dtype).to(device)``: the same pageable copy, counted. A copy from the
host to another device adds one to ``to_device.copies`` and its size to
``to_device.nbytes`` (process totals, always on, read as differences as the
kernels' ``.launches`` are); while a profiler runs it is also charged to the
innermost open span's record. A copy to the CPU, or of a tensor already on a
device, is not counted.

The spans of the inference path: ``naf.call`` (``api.naf``, the entry),
``naf.encoder`` (``ImageEncoder.encode_guarded``), ``naf.keys`` (the pooled
keys and RoPE tables of ``NAF._fused_q_inputs``), ``naf.attention`` (each
K2 call). The trainer's ``naf.backbone``, ``naf.forward``, ``naf.backward``
and ``naf.optimizer``, and the denoiser's ``denoise.*``, are spans too.
Inside the backward, ``naf.attention.backward`` (the custom Functions of K2
and of K3/K4) and ``naf.encoder.backward`` (the encoder twin's) run on the
autograd engine's thread: the stack of open records is the process's, so
they nest under the span the caller waits in (``naf.backward``,
``denoise.backward``), and their ranges hold that thread's kernels.

``breakdown(prof, recs, t0, t1, calls)`` reads a profiled stretch by its
spans: each span's own device, host and device idle time a call
(``python -m naf_torch.bench.headline --stages``).
"""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

__all__ = ["Record", "span", "to_device", "records", "clear", "breakdown"]


class Record:
    """One span while a profiler ran: ``parent`` is the enclosing span's
    record (None at the top), ``start_ns`` and ``end_ns`` ``time.time_ns()``
    stamps (``end_ns`` None while open), and the host-to-device copies and
    bytes charged to it."""

    __slots__ = ("id", "name", "parent", "start_ns", "end_ns", "copies", "nbytes")

    def __init__(self, rid: int, name: str, parent):
        self.id, self.name, self.parent = rid, name, parent
        self.start_ns = self.end_ns = None
        self.copies = self.nbytes = 0


_records: list = []
_ids = itertools.count()
# the open records, innermost last, of the process: a copy made on the
# autograd engine's thread is charged to the span the caller waits in
_open: list = []
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = Record(next(_ids), self.name, _open[-1] if _open else None)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec.start_ns = time.time_ns()
        self.rec = rec
        _records.append(rec)
        _open.append(rec)
        return rec

    def __exit__(self, *exc):
        try:
            return self.rf.__exit__(*exc)
        finally:  # stamped after the range closes, as its start after it opens
            self.rec.end_ns = time.time_ns()
            _open.remove(self.rec)


def span(name: str):
    """A context manager around one layer's work; a no-op unless a profiler
    runs, and inside a span of the same name (K3/K4's backward inside K2's):
    the profiler gives a range the device time from its first kernel to its
    last, so a nested range of one name would count the inner kernels
    twice."""
    if not _profiler._is_profiler_enabled or (_open and _open[-1].name == name):
        return _NULL
    return _Span(name)


def to_device(array, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(array, dtype=dtype).to(device)``, the port's one
    copy of a host array to a device, counted (see the module's doc). An
    array that is not a tensor is made on the CPU whatever the default
    device, so that the copy is this one."""
    if isinstance(array, torch.Tensor):
        src = array
    elif isinstance(array, np.ndarray):
        src = torch.from_numpy(array)
    else:
        src = torch.as_tensor(array, dtype=dtype, device="cpu")
    out = src.to(device) if dtype is None else src.to(device, dtype)
    if src.is_cpu and not out.is_cpu:
        nbytes = out.numel() * out.element_size()
        to_device.copies += 1
        to_device.nbytes += nbytes
        if _profiler._is_profiler_enabled and _open:
            _open[-1].copies += 1
            _open[-1].nbytes += nbytes
    return out


to_device.copies = 0
to_device.nbytes = 0


def records() -> list:
    """The records kept so far (spans entered while a profiler ran), in the
    order they opened."""
    return list(_records)


def clear() -> None:
    """Drop the records kept so far (open spans keep theirs)."""
    _records.clear()


def breakdown(prof, recs, t0: int, t1: int, calls: int) -> dict:
    """Per call of a profiled stretch [t0, t1) (``time.time_ns()``, the
    profiler's host clock) and the records of its spans: ``window_ms``,
    ``busy_ms`` (the union of the device's operations), and under ``spans``,
    for each span name: ``device_ms`` (the operations it launched while it
    was the innermost range: the profiler's GPU annotation of a range holds
    the kernels whose innermost range it is, so a parent's leaves out its
    children's; an operation is the span's where it starts inside one of the
    span's annotations), ``host_self_ms`` (the time it was the innermost open
    span: its time less its children's) and ``idle_ms`` (the device idle in
    that time); and for ``outside`` (no span open) the last two. The idle
    parts sum to the window's idle. Device operations are clipped to the
    stretch."""
    ops, ann = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.is_user_annotation():
            ann.setdefault(e.name(), []).append((s, t))
        elif t > t0 and s < t1:
            ops.append((max(s, t0), min(t, t1)))
    ops.sort()
    busy = []
    for s, t in ops:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    edges = [t0] + [x for b in busy for x in b] + [t1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    out = {}
    for name in dict.fromkeys(r.name for r in recs):  # in the order they first opened
        under = ann.get(name, ())
        out[name] = {"device_ms": sum(t - s for s, t in ops if any(a <= s < b for a, b in under))
                     / calls * 1e-6, "host_self_ms": 0.0, "idle_ms": 0.0}
    out["outside"] = {"host_self_ms": 0.0, "idle_ms": 0.0}
    # where each span is the innermost open one (the latest opened)
    marks = sorted({t0, t1, *(min(max(x, t0), t1) for r in recs
                              for x in (r.start_ns, r.end_ns))})
    for a, b in zip(marks, marks[1:]):
        inside = [r for r in recs if r.start_ns <= a and b <= r.end_ns]
        row = out[max(inside, key=lambda r: (r.start_ns, r.id)).name if inside else "outside"]
        row["host_self_ms"] += (b - a) / calls * 1e-6
        row["idle_ms"] += sum(max(0, min(b, t) - max(a, s)) for s, t in idle) / calls * 1e-6
    return {"window_ms": (t1 - t0) / calls * 1e-6,
            "busy_ms": sum(t - s for s, t in busy) / calls * 1e-6, "spans": out}
