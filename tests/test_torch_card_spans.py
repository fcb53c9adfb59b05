"""The port's spans and host-to-device copy counter on the card, over one
profiled stretch of the 448^2 + 128^2 x 384 -> 2048^2 bf16 forward through
``NAFUpsampler``: every span in every call, the records' stamps against the
profile's events of the same name (the median gap is printed), the
attention span's device time against K2's kernels, ``to_device``'s copies
against the profile's pageable host-to-device memcpys (none in the
inference call; ``RoPE.tables`` alone still copies), and the benchmark's
idle split by span (``h100bench/metrics/program_spans.py``, which finds the
window's ends from the gaps) against the program's own
(``spans.breakdown``, given them).

Every test carries the marker ``cuda`` and skips without a card. The file
imports no JAX (nor does ``h100bench``):

    python -m pytest -m cuda tests/test_torch_card_spans.py -q -s
"""

import re
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import run, trace
from h100bench.metrics import program_spans
from naf_torch.api import NAFUpsampler, load_naf_params
from naf_torch.utils import spans

CALLS = 4
NAMES = ("naf.call", "naf.encoder", "naf.keys", "naf.attention")
PAGEABLE_H2D = re.compile(r"Memcpy.HtoD.*Pageable")


@pytest.fixture(scope="module")
def stretch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from naf_torch.kernels import _build

    _build.build()
    ups = NAFUpsampler(model=load_naf_params(dtype=torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(0)
    image = torch.randn(1, 3, 448, 448, generator=gen, device="cuda").to(torch.bfloat16)
    feats = torch.randn(1, 384, 128, 128, generator=gen, device="cuda").to(torch.bfloat16)
    for _ in range(3):
        ups(image, feats, (2048, 2048))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # first range
        with spans.span("warm-up"):
            pass
    n0, c0 = len(spans.records()), spans.to_device.copies
    with trace.profiled() as holder:  # as the benchmark's traced runs profile
        for _ in range(CALLS):
            ups(image, feats, (2048, 2048))
    prof = holder.prof
    host, ann, dev = _events(prof)
    # a path that still copies host arrays: RoPE's tables alone, in a span
    n1, c1 = len(spans.records()), spans.to_device.copies
    with trace.profiled() as holder:
        for _ in range(CALLS):
            with spans.span("tables"):
                ups.model.image_encoder.rope.tables(2048, 2048)
        torch.cuda.synchronize()
    tables = {"records": spans.records()[n1:], "copies": spans.to_device.copies - c1,
              "dev": _events(holder.prof)[2]}
    return {"records": spans.records()[n0:n1], "copies": c1 - c0, "host": host, "ann": ann,
            "dev": dev, "prof": prof, "tables": tables}


def _events(prof):
    """({name: [(start, end)]} of host events, of GPU annotations, and
    [(name, start, end)] of device operations) of a profile, in ns."""
    host, ann, dev = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type().name != "CUDA":
            host.setdefault(e.name(), []).append((s, t))
        elif e.is_user_annotation():
            ann.setdefault(e.name(), []).append((s, t))
        else:
            dev.append((e.name(), s, t))
    return host, ann, dev


@pytest.mark.cuda
def test_every_span_in_every_call(stretch):
    recs = stretch["records"]
    assert [r.name for r in recs] == list(NAMES) * CALLS
    calls = [r for r in recs if r.name == "naf.call"]
    assert all(r.parent is None for r in calls)
    assert all(r.parent is calls[i // 4] for i, r in enumerate(recs) if r.name != "naf.call")


@pytest.mark.cuda
def test_stamps_within_50us_of_the_profile(stretch):
    gaps = []
    for name in NAMES:
        mine = sorted((r.start_ns, r.end_ns) for r in stretch["records"] if r.name == name)
        theirs = sorted(stretch["host"][name])
        assert len(mine) == len(theirs) == CALLS, name
        for (a, b), (s, t) in zip(mine, theirs):
            gaps += [abs(a - s), abs(b - t)]
    med = statistics.median(gaps)
    print(f"span stamps against the profile's events: median {med / 1e3:.1f} us, max "
          f"{max(gaps) / 1e3:.1f} us over {len(gaps)} stamps ({torch.cuda.get_device_name(0)})")
    assert med < 50_000


@pytest.mark.cuda
def test_attention_device_time_covers_k2(stretch):
    spans_ = stretch["ann"]["naf.attention"]
    under = sum(t - s for _, s, t in stretch["dev"] if any(a <= s <= b for a, b in spans_))
    k2 = sum(t - s for n, s, t in stretch["dev"] if "fused_q_wgmma" in n)
    print(f"attention span {under / CALLS / 1e6:.3f} ms a call on the device, K2 "
          f"{k2 / CALLS / 1e6:.3f} ms")
    assert 0 < k2 <= under


@pytest.mark.cuda
def test_copies_match_the_pageable_memcpys(stretch):
    """``to_device``'s count, the copies charged to the spans and the
    profile's pageable host-to-device memcpys agree: none in the inference
    calls (the keys kernel copies nothing from the host), and two a call of
    ``RoPE.tables`` alone (its row and column coordinates)."""
    for label, part, want in (("inference call", stretch, 0),
                              ("RoPE.tables", stretch["tables"], 2)):
        memcpys = [n for n, _, _ in part["dev"] if PAGEABLE_H2D.search(n)]
        charged = sum(r.copies for r in part["records"])
        print(f"host-to-device copies a {label}: to_device {part['copies'] / CALLS}, charged "
              f"{charged / CALLS}, pageable memcpys {len(memcpys) / CALLS}")
        assert part["copies"] == charged == len(memcpys) == want * CALLS, label


@pytest.mark.cuda
def test_the_benchmarks_idle_split_is_the_programs(stretch):
    """One profile read both ways: the benchmark's readers find the window's
    ends from the gaps, ``spans.breakdown`` is given them by the window's
    range. Each span's idle a call agrees to 2 us and 0.2%: the benchmark
    reads the device's operations as epoch us in floats, a start and a
    duration each rounded to a quarter us, and the error grows with the
    number of gaps (2.5 us a call in ``naf.keys``' 6.6 ms on an H100); an end
    given to the wrong span would move tens of us a call."""
    (t0, t1), = stretch["host"][trace.WINDOW]
    ours = spans.breakdown(stretch["prof"], stretch["records"], t0, t1, CALLS)["spans"]
    ctx = run.MetricContext(trace.reduce_profile(stretch["prof"]), CALLS, [], {},
                            torch.cuda.get_device_name(0))
    theirs = program_spans.idle_by_span(ctx)
    pairs = {name: (ours[name]["idle_ms"], theirs.get(key, 0.0) * 1e-3 / CALLS)
             for name, key in (("naf.call", "naf.call"), ("naf.encoder", "naf.encoder"),
                               ("naf.keys", "naf.keys"), ("naf.attention", "naf.attention"),
                               ("outside", program_spans.OUTSIDE))}
    print("idle ms a call, spans.breakdown against program_spans: " + "; ".join(
        f"{n} {a:.4f} {b:.4f}" for n, (a, b) in pairs.items()))
    for name, (a, b) in pairs.items():
        assert a == pytest.approx(b, abs=2e-3, rel=2e-3), name
    assert sum(a for a, _ in pairs.values()) > 0
