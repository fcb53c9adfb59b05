"""The readers of the program's spans (``metrics/program_spans.py``) on a
synthetic profile and synthetic span records: the idle time split exactly by
the innermost span, the parts summing to the window's idle time, the
window's ends recovered from the gaps (which ``reduce_profile`` lists in time
order), device time, copies and MiB per call, None where the program keeps
no records, and the same split as the program's own
(``naf_torch.utils.spans.breakdown``) on one profile."""

import types

import numpy as np
import pytest

from h100bench import run, trace
from h100bench.metrics import program_spans as ps

# epoch ns, so that the floats carry its rounding: a quarter of a us in an epoch us
BASE = 1_792_302_636_000_000_000
INFERENCE = ("encoder_device_ms", "keys_device_ms", "attention_device_ms", "encoder_idle_ms",
             "keys_idle_ms", "attention_idle_ms", "entry_idle_ms", "outside_idle_ms",
             "h2d_copies_per_call", "h2d_mib_per_call")
IDLE = ("encoder_idle_ms", "keys_idle_ms", "attention_idle_ms", "entry_idle_ms",
        "outside_idle_ms")


class Ev:
    def __init__(self, name, start_us, dur_us, dev="CPU", ann=False):
        self._n, self._s, self._d = name, BASE + int(start_us * 1000), int(dur_us * 1000)
        self._dev, self._ann = dev, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return types.SimpleNamespace(name=self._dev)

    def is_user_annotation(self):
        return self._ann


def _profile(window, device, ranges=()):
    events = [Ev(trace.WINDOW, window[0], window[1] - window[0]),
              Ev("aten::copy_", window[0], 1)]
    events += [Ev(f"kernel{i}", s, t - s, dev="CUDA") for i, (s, t) in enumerate(device)]
    events += [Ev(n, s, t - s, dev="CUDA", ann=True) for n, s, t in ranges]
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def _trace(window, device, ranges=()):
    return trace.reduce_profile(_profile(window, device, ranges))


def _records(spans):
    """Records from (name, start_us, end_us, parent index, copies)."""
    out = []
    for i, (name, s, t, parent, copies) in enumerate(spans):
        out.append(types.SimpleNamespace(
            id=i, name=name, parent=None if parent is None else out[parent],
            start_ns=BASE + int(s * 1000), end_ns=BASE + int(t * 1000), copies=copies,
            nbytes=4 * copies))
    return out


# two calls; device busy [100, 200], [300, 350], [600, 700] of a window [0, 1000]
DEVICE = [(100, 200), (300, 350), (600, 700)]
SPANS = [("naf.call", 50, 450, None, 0), ("naf.encoder", 60, 250, 0, 0),
         ("naf.keys", 250, 320, 0, 6), ("naf.attention", 330, 440, 0, 0),
         ("naf.call", 500, 900, None, 0), ("naf.encoder", 510, 650, 4, 1),
         ("naf.keys", 650, 655, 4, 6), ("naf.attention", 660, 880, 4, 0)]
RANGES = [("naf.encoder", 100, 200), ("naf.keys", 300, 350), ("naf.attention", 600, 700)]
# idle [0, 100]: none 50, call 10, encoder 40; [200, 300]: encoder 50, keys 50;
# [350, 600]: attention 90, call 10, none 50, call 10, encoder 90;
# [700, 1000]: attention 180, call 20, none 100
WANT_US = {"encoder_idle_ms": 180, "keys_idle_ms": 50, "attention_idle_ms": 270,
           "entry_idle_ms": 50, "outside_idle_ms": 200}


@pytest.fixture
def ctx(monkeypatch):
    recs = _records(SPANS)
    monkeypatch.setattr(ps, "records", lambda: recs)
    tr = _trace((0, 1000), DEVICE, RANGES)
    return run.MetricContext(tr, 2, [1e-3, 1e-3], {}, "NVIDIA H100 80GB HBM3")


def test_idle_split_exactly_by_the_innermost_span(ctx):
    for name, us in WANT_US.items():
        assert run._reader(name)(ctx) == pytest.approx(us * 1e-3 / 2, abs=5e-4), name


def test_idle_parts_sum_to_the_windows_idle_per_call(ctx):
    """To a us a call: the device intervals' epoch us carry a quarter of a
    us of rounding, the window's idle time none."""
    total = sum(run._reader(n)(ctx) for n in IDLE)
    idle_pct = run._reader("device_idle_pct")(ctx)
    assert total == pytest.approx(idle_pct / 100 * ctx.trace.window_s * 1e3 / ctx.calls,
                                  abs=1e-3)


def test_a_straddling_gap_is_split_between_spans(monkeypatch):
    """One idle gap [200, 300] under encoder, then keys: half to each."""
    recs = _records([("naf.call", 0, 400, None, 0), ("naf.encoder", 10, 250, 0, 0),
                     ("naf.keys", 250, 390, 0, 0)])
    monkeypatch.setattr(ps, "records", lambda: recs)
    tr = _trace((0, 400), [(0, 200), (300, 400)])
    c = run.MetricContext(tr, 1, [1e-3], {}, "H100")
    assert run._reader("encoder_idle_ms")(c) == pytest.approx(0.05, abs=5e-4)
    assert run._reader("keys_idle_ms")(c) == pytest.approx(0.05, abs=5e-4)
    assert run._reader("entry_idle_ms")(c) == pytest.approx(0.0, abs=5e-4)
    assert run._reader("outside_idle_ms")(c) == pytest.approx(0.0, abs=5e-4)


@pytest.mark.parametrize("window,lead,trail", [((0, 1000), 100, 300), ((100, 1000), 0, 300),
                                               ((0, 700), 100, 0), ((100, 700), 0, 0),
                                               ((50, 750), 50, 50)])
def test_the_windows_ends_from_the_gaps(window, lead, trail):
    tr = _trace(window, DEVICE)
    holes, (w0, w1) = ps.idle_intervals(tr)
    first, last = (BASE / 1000 + 100, BASE / 1000 + 700)
    assert w0 == pytest.approx(first - lead, abs=1) and w1 == pytest.approx(last + trail, abs=1)
    assert sum(t - s for s, t in holes) == pytest.approx(
        (tr.window_s - tr.busy_s) * 1e6, abs=1)


def test_the_gaps_in_time_order():
    """``reduce_profile`` lists the gaps in time order, not longest first:
    the readers of the spans find the window's ends by that order."""
    device = [(10, 20), (21, 30), (300, 310), (315, 400)]  # gaps 10, 1, 270, 5, 100
    tr = _trace((0, 500), device)
    assert [round(g * 1e6, 3) for _, g in tr.gaps] == [10, 1, 270, 5, 100]


def test_ends_with_gaps_shorter_than_the_rounding():
    """Gaps of a few ns, which the epoch us of the device intervals round
    away, are passed over; a long leading gap is still found."""
    device = [(100, 200), (200.004, 300), (300.003, 350), (600, 700)]
    tr = _trace((0, 1000), device)
    assert len(tr.gaps) == 5
    holes, (w0, w1) = ps.idle_intervals(tr)
    assert w0 == pytest.approx(BASE / 1000, abs=1) and w1 == pytest.approx(BASE / 1000 + 1000,
                                                                           abs=1)


def _rounded_trace(seed, n=3000):
    """A stretch of ``n`` device operations whose gaps are exact ns: none, a
    few ns, 100-300 ns (which the epoch us of ``Trace.device`` round to 0 or
    a quarter us) or 0.5-50 us, between idle ends of 0, 3 ns, 150 ns or 40 us."""
    rng = np.random.default_rng(seed)
    lead, trail = (int(x) for x in rng.choice([0, 3, 150, 40_000], 2))
    t, device = lead, []
    for kind in rng.integers(0, 4, n):
        dur = int(rng.integers(1_000, 20_000))
        device.append((t / 1000, (t + dur) / 1000))
        t += dur + int((0, rng.integers(1, 10), rng.integers(100, 300),
                        rng.integers(500, 50_000))[kind])
    end = device[-1][1] * 1000 + trail
    return _trace((0, end / 1000), device), lead, trail


@pytest.mark.parametrize("seed", range(8))
def test_the_windows_ends_under_the_rounding(seed):
    """Thousands of gaps, many shorter than the rounding, as a training
    chunk's profile has: the ends are still found, to a us."""
    tr, lead, trail = _rounded_trace(seed)
    holes, (w0, w1) = ps.idle_intervals(tr)
    first = min(s for _, s, _ in tr.device)
    last = max(s + d for _, s, d in tr.device)
    assert first - w0 == pytest.approx(lead / 1000, abs=1)
    assert w1 - last == pytest.approx(trail / 1000, abs=1)


def test_an_end_that_cannot_be_told_reads_none(monkeypatch):
    """One end idle and every gap of one length: lead and trail are alike,
    and the idle metrics read None rather than guess."""
    device = [(100, 200), (300, 400), (500, 600)]  # gaps 100, 100 and one end of 100
    assert ps.idle_intervals(_trace((0, 600), device)) is None
    assert ps.idle_intervals(_trace((100, 700), device)) is None
    recs = _records([("naf.call", 0, 600, None, 1)])
    monkeypatch.setattr(ps, "records", lambda: recs)
    c = run.MetricContext(_trace((0, 600), device), 1, [1e-3], {}, "H100")
    assert all(run._reader(n)(c) is None for n in IDLE)


def test_gaps_out_of_time_order_raise():
    tr = _trace((50, 750), DEVICE)
    tr.gaps = sorted(tr.gaps, key=lambda g: -g[1])  # longest first: 250, 100, 50, 50
    with pytest.raises(ValueError, match="time order"):
        ps.idle_intervals(tr)


def test_the_same_split_as_the_programs(monkeypatch):
    """The program's ``spans.breakdown``, given the window's ends, and these
    readers, which find them from the gaps, split one profile alike."""
    from naf_torch.utils import spans

    recs = _records(SPANS)
    monkeypatch.setattr(ps, "records", lambda: recs)
    for window in ((0, 1000), (100, 1000), (0, 700), (50, 750)):
        prof = _profile(window, DEVICE, RANGES)
        c = run.MetricContext(trace.reduce_profile(prof), 2, [1e-3, 1e-3], {}, "H100")
        t0, t1 = BASE + window[0] * 1000, BASE + window[1] * 1000
        theirs = spans.breakdown(prof, recs, t0, t1, 2)["spans"]
        for name, row in (("naf.call", "entry"), ("naf.encoder", "encoder"),
                          ("naf.keys", "keys"), ("naf.attention", "attention"),
                          ("outside", "outside")):
            assert run._reader(f"{row}_idle_ms")(c) == pytest.approx(
                theirs[name]["idle_ms"], abs=1e-3), (window, name)
        for name, row in (("naf.encoder", "encoder"), ("naf.keys", "keys"),
                          ("naf.attention", "attention")):
            assert run._reader(f"{row}_device_ms")(c) == pytest.approx(
                theirs[name]["device_ms"], abs=1e-9), (window, name)


def test_device_time_and_copies_per_call(ctx):
    assert run._reader("encoder_device_ms")(ctx) == pytest.approx(0.05)
    assert run._reader("keys_device_ms")(ctx) == pytest.approx(0.025)
    assert run._reader("attention_device_ms")(ctx) == pytest.approx(0.05)
    assert run._reader("h2d_copies_per_call")(ctx) == 6.5
    assert run._reader("h2d_copies_per_call.train")(ctx) == 6.5
    assert run._reader("h2d_mib_per_call")(ctx) == 4 * 13 / 2 / 2**20


def test_none_without_records_or_ranges(monkeypatch):
    tr = _trace((0, 1000), DEVICE)
    c = run.MetricContext(tr, 2, [1e-3, 1e-3], {}, "H100")
    for recs in (None, []):
        monkeypatch.setattr(ps, "records", lambda: recs)
        c._idle_by_span = False
        assert all(run._reader(n)(c) is None for n in INFERENCE), recs


def test_records_from_the_program():
    from naf_torch.utils import spans

    assert ps.records() == spans.records()
