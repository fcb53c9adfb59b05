"""What the per-layer metrics of the program's own spans read, per call (per
step in the training cell):

- a span's device time: the device operations it launched while it was
  the innermost span, as the profiler's GPU annotation of its
  ``record_function`` range gives them (``Trace.ranges_us``; an annotation
  holds the kernels whose innermost range it is);
- the device's idle time, split by the innermost program span open on the
  host across it: ``naf.encoder``, ``naf.keys``, ``naf.attention``,
  ``naf.call`` (its self time, the entry) and none (the caller, between
  calls). The parts sum to the window's idle time;
- the host-to-device copies, and their MiB, that the program charged to
  its spans.

The spans' records come from ``naf_torch.utils.spans.records()``: start and
end on the epoch clock of the profile's events, name and parent, and the
copies charged. A program without that module, or a run that kept no record
in the traced window, reads None; so does a trace without the span's range.

The device's idle intervals are the complement, within the traced window, of
the union of ``Trace.device``. ``Trace`` does not hold the window's ends: the
idle before the first and after the last device operation is read from
``Trace.gaps``. ``reduce_profile`` lists the gaps in time order (the field's
comment says longest first; ``h100bench/tests/test_h100bench_spans.py`` holds
the order). The window's length less the device's span gives the two ends'
sum, so the first gap is taken as the leading one, the last as the trailing
one, both or neither, as that sum allows. The gaps carry no times, so the
reader cannot check their order itself: it raises where neither end fits
the sum, and reads None where two choices fit and disagree (one end idle,
and the first and last gaps of one length).

``naf_torch.utils.spans.breakdown`` splits a profile the same way in the
program (``--stages``), from the window's ends; the tests hold the two
equal on a synthetic profile and on one of the card.
"""

from __future__ import annotations

__all__ = ["records", "device_ms", "idle_ms", "copies_per_call", "mib_per_call",
           "idle_by_span", "idle_intervals", "innermost"]

OUTSIDE = None  # the key of the idle time under no program span
_TOL_US = 1.0  # the gaps are exact ns; device intervals are epoch us in floats, to 5/8 us


def records():
    """The program's span records, or None where the program keeps none."""
    try:
        from naf_torch.utils import spans
    except ImportError:
        return None
    return spans.records()


def device_ms(ctx, name: str):
    """Device ms per call of the operations launched under the span ``name``."""
    us = ctx.trace.ranges_us.get(name)
    if us is None:
        return None
    return us * 1e-3 / ctx.calls


def idle_intervals(tr):
    """The device's idle intervals in the traced window, sorted (epoch us),
    and the window's ends (w0, w1); None where the window's ends cannot be
    told (see the module's doc)."""
    dev = sorted((s, s + d) for _, s, d in tr.device)
    merged = [list(dev[0])]
    for s, t in dev[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = [g * 1e6 for _, g in tr.gaps]
    idle_ends = tr.window_s * 1e6 - (merged[-1][1] - merged[0][0])  # lead + trail
    found = set()
    for k0 in (0, 1):  # whether the first gap is the leading one
        for k1 in (0, 1):  # whether the last is the trailing one
            if k0 + k1 <= len(gaps):
                lead, trail = (gaps[0] if k0 else 0.0), (gaps[-1] if k1 else 0.0)
                if abs(lead + trail - idle_ends) <= _TOL_US:
                    found.add((lead, trail))
    if not found:
        raise ValueError(f"neither of Trace.gaps' ends ({gaps[:1]}, {gaps[-1:]} us) makes up "
                         f"the window's {idle_ends} us of idle ends: not in time order")
    (lead, trail), other = min(found), max(found)
    if abs(lead - other[0]) > _TOL_US or abs(trail - other[1]) > _TOL_US:
        return None  # one end idle, the first and last gaps alike: which end it is is unknown
    w0, w1 = merged[0][0] - lead, merged[-1][1] + trail
    holes = [(w0, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    holes.append((merged[-1][1], w1))
    return [(s, t) for s, t in holes if t > s], (w0, w1)


def innermost(recs, w0: float, w1: float):
    """[(start, end, name)] in epoch us, sorted and disjoint: where a span is
    the innermost open one (the latest opened), within (w0, w1)."""
    events = []
    for r in recs:
        s = max(r.start_ns * 1e-3, w0)
        t = min((r.end_ns * 1e-3) if r.end_ns is not None else w1, w1)
        if t > s:
            events += [(s, 1, r), (t, 0, r)]
    events.sort(key=lambda e: (e[0], e[1]))  # at one time, ends before starts
    out, open_, last = [], [], None
    for t, start, r in events:
        if open_ and t > last:
            top = max(open_, key=lambda o: (o.start_ns, o.id))
            out.append((last, t, top.name))
        if start:
            open_.append(r)
        else:
            open_.remove(r)
        last = t
    return out


def _device_span(tr):
    """The first device operation's start and the last's end (epoch us): the
    calls of the window, whose host-to-device copies are counted, each
    overlap it."""
    return min(s for _, s, _ in tr.device), max(s + d for _, s, d in tr.device)


def _records_in(t0: float, t1: float):
    """The program's records of spans open between t0 and t1 (epoch us), or
    None."""
    recs = [r for r in records() or () if r.start_ns is not None and r.start_ns * 1e-3 <= t1
            and (r.end_ns is None or r.end_ns * 1e-3 >= t0)]
    return recs or None


def idle_by_span(ctx):
    """{span name or OUTSIDE: idle us over the window}, or None. Each idle
    interval is split exactly between the innermost spans open across it."""
    cached = getattr(ctx, "_idle_by_span", False)
    if cached is not False:
        return cached
    found = idle_intervals(ctx.trace) if records() and ctx.trace.device else None
    recs = _records_in(*found[1]) if found is not None else None
    out = None
    if recs is not None:
        holes, (w0, w1) = found
        segs = innermost(recs, w0, w1)
        out, j = {}, 0
        total = 0.0
        for s, t in holes:
            total += t - s
            while j < len(segs) and segs[j][1] <= s:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < t:
                part = min(t, segs[k][1]) - max(s, segs[k][0])
                if part > 0:
                    out[segs[k][2]] = out.get(segs[k][2], 0.0) + part
                k += 1
        out[OUTSIDE] = total - sum(out.values())
    ctx._idle_by_span = out
    return out


def idle_ms(ctx, name):
    """Device idle ms per call while the innermost program span was ``name``
    (OUTSIDE: no span)."""
    by = idle_by_span(ctx)
    if by is None:
        return None
    return by.get(name, 0.0) * 1e-3 / ctx.calls


def copies_per_call(ctx):
    """Host-to-device copies per call charged to the program's spans."""
    recs = _records_in(*_device_span(ctx.trace)) if ctx.trace.device else None
    if recs is None:
        return None
    return sum(r.copies for r in recs) / ctx.calls


def mib_per_call(ctx):
    """MiB per call copied from the host to the device, charged to the
    program's spans."""
    recs = _records_in(*_device_span(ctx.trace)) if ctx.trace.device else None
    if recs is None:
        return None
    return sum(r.nbytes for r in recs) / 2**20 / ctx.calls
